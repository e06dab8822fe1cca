"""Host milliseconds an optimizer step spends in the program's span
``fit.sync``: the host waiting for a chunk's losses to reach it, which
waits for the device, spread over the chunk's steps (the spans slice of a
traced run, ``lib/spans.py``; per ``fit.forward`` span)."""

from benchmark.lib import spans


def read(rec):
    return spans.per(rec, 'fit', 'fit.sync', 'fit.forward')
