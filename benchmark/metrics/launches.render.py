"""Device kernels and copies a render call, from the traced slice."""

from benchmark.lib import window


def read(rec):
    return window.launches(rec, 'render', 'calls')
