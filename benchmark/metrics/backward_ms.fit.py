"""Host milliseconds an optimizer step spends in the program's span
``fit.backward``: ``torch.autograd.grad`` of the loss (the spans slice of
a traced run, ``lib/spans.py``; per ``fit.forward`` span)."""

from benchmark.lib import spans


def read(rec):
    return spans.per(rec, 'fit', 'fit.backward', 'fit.forward')
