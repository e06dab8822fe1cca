"""Host milliseconds a render call spends in the program's span
``poly.plan``: the plan's eager lowering and enqueue, from the call of the
function ``PolyPatch.render_fn`` returns to its return (the spans slice of
a traced run, ``lib/spans.py``)."""

from benchmark.lib import spans


def read(rec):
    return spans.per(rec, 'render', 'poly.plan', 'poly.render')
