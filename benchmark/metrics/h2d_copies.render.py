"""Host-to-device copies a render call makes: the program's counter
``kernels.COPIES['h2d_copies']`` over the spans slice of a traced run, per
``poly.render`` span (``lib/spans.py``)."""

from benchmark.lib import spans


def read(rec):
    return spans.copies_per_call(rec)
