"""Host time an optimizer step takes that the device waits for: the
untraced window's wall a step less the device-busy time a step in the
traced slice."""

from benchmark.lib import window


def read(rec):
    return window.idle_ms(rec, 'fit', 'steps')
