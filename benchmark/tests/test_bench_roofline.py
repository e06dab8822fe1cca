"""The frozen roofline counts against the bounds that the port's kernel
table printed at its own shapes (K1 at the flagship's 64 voices, 256 and
2584 blocks; K3 at the render-ahead batch; B3 at the render-ahead batch
and the streaming fit's window)."""

import pytest

from benchmark.lib import roofline


@pytest.mark.parametrize('blocks, bound_ms, mflop', [
    (256, 0.0061, 17.8 * 23), (2584, 0.0618, 179.9 * 23)])
def test_k1_flagship_64_voices(blocks, bound_ms, mflop):
    flops, nbytes = roofline.k1_work(blocks=blocks, voices=64, context=512,
                                     blocks_per_seg=8, block_frames=1024)
    s, by = roofline.bound_s(flops, nbytes)
    assert by == 'operations'
    assert s * 1e3 == pytest.approx(bound_ms, abs=6e-5)
    assert flops / 1e6 == pytest.approx(mflop, rel=0.01)


def test_k3_render_ahead():
    flops, nbytes = roofline.k3_work(windows=8, lanes=16, context=128,
                                     tail=1024)
    s, by = roofline.bound_s(flops, nbytes)
    assert by == 'bytes'
    assert nbytes / 1e6 == pytest.approx(1.06, abs=0.005)
    assert s * 1e3 == pytest.approx(0.000317, abs=1e-6)
    assert flops == 1152 * 8 * 16 * 12


@pytest.mark.parametrize('kw, mb, bound_ms', [
    (dict(windows=8, lanes=16, rows=1152, tail=1024,
          timeline_rows=128 + 8 * 1024), 1.66, 0.0005),
    (dict(windows=1, lanes=16, rows=8192, tail=8192, state=True), 1.57,
     0.00047)])
def test_b3(kw, mb, bound_ms):
    flops, nbytes = roofline.b3_work(**kw)
    s, by = roofline.bound_s(flops, nbytes)
    assert by == 'bytes'
    assert nbytes / 1e6 == pytest.approx(mb, abs=0.005)
    assert s * 1e3 == pytest.approx(bound_ms, abs=1e-5)


def test_synth_rows_skip_negative_frames():
    # one segment of 8704 rows a lane starting 512 frames before 0: the
    # first 512 rows are zeros; from a later start every row is synthesised
    assert roofline.synth_rows(1, 8704, 512, 0, 1) == 8192
    assert roofline.synth_rows(2, 8704, 512, 8192 * 5, 3) == 2 * 8704 * 3
