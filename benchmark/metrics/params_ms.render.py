"""Host milliseconds a render call spends in the program's span
``poly.params``: the parameter leaves read off the graph and copied to the
device, the per-voice overrides stacked (the spans slice of a traced run,
``lib/spans.py``)."""

from benchmark.lib import spans


def read(rec):
    return spans.per(rec, 'render', 'poly.params', 'poly.render')
