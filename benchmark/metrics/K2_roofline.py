"""K2, the timeline-fed segment kernel (``seg_cascade<GEN=false>``) in the
fit's forward: share of its roofline, one call a step, at the cell's
shapes.  Its count is K3's (``roofline.k3_work``): a segment of context +
F rows a block and lane from zero state, the timeline's distinct rows read
once, the kept rows written, the coefficients read."""

from benchmark.lib import roofline, window


def work(s):
    return roofline.k3_work(windows=s['blocks'], lanes=s['voices'],
                            context=s['context'], tail=s['block_frames'],
                            nsec=s['nsec'])


def read(rec):
    return window.kernel_share(rec, 'fit', ('seg_cascade<false',), ('vjp',),
                               work, 'steps')
