"""B2, the timeline-fed segment kernel's backward
(``seg_cascade_vjp<GEN=false>``) in the fit's step: share of its roofline,
one call a step, at the cell's shapes.  Counted as the port's kernel table
counts it (``chip_smoke.seg_vjp_work`` at one block a segment): every row
of every segment of context + F rows forward again and back
(``roofline.VJP_FLOP`` a section-row); bytes: the coefficients read and
their gradient written, the output cotangent read, the timeline read and
its cotangent written once (the windows' cotangents folded)."""

from benchmark.lib import roofline, window


def work(s):
    F, C, n, V, nsec = (s['block_frames'], s['context'], s['blocks'],
                        s['voices'], s['nsec'])
    flops = n * V * (C + F) * nsec * roofline.VJP_FLOP
    co = n * nsec * V * 11
    timeline = (C + n * F) * V
    nbytes = roofline.F32 * (2 * co + n * F * V + 2 * timeline)
    return flops, nbytes


def read(rec):
    return window.kernel_share(rec, 'fit', ('seg_cascade_vjp<false',), (),
                               work, 'steps')
