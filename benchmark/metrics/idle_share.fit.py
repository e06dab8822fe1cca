"""Share of the untraced window of fit calls in which no kernel or copy
ran on the device: a step's traced device-busy time over its untraced
wall."""

from benchmark.lib import window


def read(rec):
    return window.idle_share(rec, 'fit', 'steps')
