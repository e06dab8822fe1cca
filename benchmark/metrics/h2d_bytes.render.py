"""Bytes a render call copies from the host onto the device: the program's
counter ``kernels.COPIES['h2d_bytes']`` over the spans slice of a traced
run, per ``poly.render`` span (``lib/spans.py``).  Beside
``h2d_copies.render`` it tells a copy's size: small copies cost their
latency, not the bus."""

from benchmark.lib import spans


def read(rec):
    return spans.copies_per_call(rec, 'h2d_bytes')
