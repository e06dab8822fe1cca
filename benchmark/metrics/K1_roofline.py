"""K1, the generator-fed segment kernel (``seg_cascade<GEN=true>`` and
its ``sum_partials``): share of its roofline, one call a render, at the
cell's shapes (``roofline.k1_work``)."""

from benchmark.lib import roofline, window


def work(s):
    return roofline.k1_work(blocks=s['blocks'], voices=s['voices'],
                            context=s['context'],
                            blocks_per_seg=s['blocks_per_seg'],
                            block_frames=s['block_frames'], nsec=s['nsec'])


def read(rec):
    return window.kernel_share(rec, 'render', ('seg_cascade', 'sum_partials'),
                               ('vjp',), work, 'calls')
