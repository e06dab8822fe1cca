"""Host milliseconds an optimizer step spends in the program's span
``fit.loss``: the loss's call on the rendered audio, inside ``fit.forward``
(the spans slice of a traced run, ``lib/spans.py``; per ``fit.forward``
span).  Nothing where the program records no such span."""

from benchmark.lib import spans


def read(rec):
    got = spans.collect(rec) if rec['kind'] == 'fit' else None
    if not got or not spans.count(got['records'], 'fit.loss'):
        return None
    return spans.per(rec, 'fit', 'fit.loss', 'fit.forward')
