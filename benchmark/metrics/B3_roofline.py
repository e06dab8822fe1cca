"""B3, the batched replay's backward (``rows_cascade_vjp``) in the fit's
step: share of its roofline, one call a step, at the cell's shapes
(``roofline.b3_work``)."""

from benchmark.lib import roofline, window


def work(s):
    F, C, n = s['block_frames'], s['context'], s['blocks']
    return roofline.b3_work(windows=n, lanes=s['voices'], rows=C + F,
                            tail=F, nsec=s['nsec'],
                            timeline_rows=C + n * F)


def read(rec):
    return window.kernel_share(rec, 'fit', ('rows_cascade_vjp',), (), work,
                               'steps')
