"""Device kernels and copies an optimizer step (forward and backward),
from the traced slice."""

from benchmark.lib import window


def read(rec):
    return window.launches(rec, 'fit', 'steps')
