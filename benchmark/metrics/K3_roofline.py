"""K3, the batched per-block replay (``rows_cascade``) with the voices
folded into its lanes: share of its roofline, one call a render, at the
cell's shapes (``roofline.k3_work``: a window of context + F rows a block
and voice, read in place from each voice's timeline)."""

from benchmark.lib import roofline, window


def work(s):
    return roofline.k3_work(windows=s['blocks'], lanes=s['voices'],
                            context=s['context'], tail=s['block_frames'],
                            nsec=s['nsec'])


def read(rec):
    return window.kernel_share(rec, 'render', ('rows_cascade',), ('vjp',),
                               work, 'calls')
