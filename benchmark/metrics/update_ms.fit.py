"""Host milliseconds an optimizer step spends in the program's span
``fit.update``: Adam's update of every trainable leaf (the spans slice of
a traced run, ``lib/spans.py``; per ``fit.forward`` span)."""

from benchmark.lib import spans


def read(rec):
    return spans.per(rec, 'fit', 'fit.update', 'fit.forward')
