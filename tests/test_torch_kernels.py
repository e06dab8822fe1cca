"""The port's segment kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version, which is held to
the JAX kernel run in interpret mode (as the JAX package's own tests run
it, ``tests/test_pallas_kernels.py:444-484, 755-802``), at the JAX tests'
sizes.  Tolerances: filtered lanes 1e-5 max-abs (the per-voice parity
budget; the kernels' f32 cascade orders differ at round-off), group sums
1e-5 of their max, and the identity-cascade saw source bit-exact (a
one-ulp phase error at a wrap is a 2.0 spike).

The ``cuda`` cases compare each CUDA kernel with its plain version on a
GPU (same tolerances), including lane groups wider than one thread block,
and render a 1024-voice flagship through the mix plan; they skip without a
GPU.  JAX is imported inside the JAX comparisons, so the card cases run on
a machine without JAX, from the repository root:
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from signals_tpu_torch.compiler import kernels as K
from signals_tpu_torch.compiler.filters import design_coupled
from signals_tpu_torch.core.xp import NP

RATE = 44100
TOL = 1e-5


def lowpass_coeffs(rng, n_blocks, lanes, lo=500.0, hi=5000.0):
    """Per-block, per-lane swept lowpass coefficients
    ``(n_blocks, 1, lanes, 11)`` from seeded random cutoffs."""
    cuts = rng.uniform(lo, hi, (1, n_blocks * lanes)).astype(np.float32)
    co = design_coupled(NP, 'lp', (cuts,), np.float32(RATE / 2))
    return np.ascontiguousarray(
        co.reshape(1, n_blocks, lanes, 11).transpose(1, 0, 2, 3))


def saw_lanes(rng, lanes, context):
    hz = rng.uniform(60.0, 900.0, lanes).astype(np.float32)
    lanef = np.stack([hz, np.zeros(lanes, np.float32),
                      np.ones(lanes, np.float32)])
    toff = (rng.integers(0, 4, lanes) * 4096 - context).astype(np.int32)
    return toff, lanef


def t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize('m,sum_groups', [(1, 0), (4, 0), (1, 64), (4, 64)])
def test_segments_gen_plain_matches_jax_interpret(m, sum_groups):
    from signals_tpu.compiler import pallas_kernels as PK
    rng = np.random.default_rng(10 * m + sum_groups)
    lanes, nb, F, C = 1024, 8, 512, 512
    co = lowpass_coeffs(rng, nb, lanes)
    toff, lanef = saw_lanes(rng, lanes, C)
    kw = dict(n_segments=nb, seg_frames=F, context=C, osc_code=PK.OSC_SAW,
              rate=RATE, sum_groups=sum_groups, blocks_per_seg=m)
    want = np.asarray(PK.sosfilt_segments_gen(co, toff, lanef,
                                              interpret=True, **kw))
    K.reset_launch_counts()
    got = K.sosfilt_segments_gen(t(co), t(toff), t(lanef), **kw).numpy()
    assert K.LAUNCHES == {'segments_gen': 0, 'segments': 0}
    assert got.shape == want.shape
    if sum_groups:
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    else:
        assert np.abs(got - want).max() <= TOL


def test_segments_gen_identity_saw_bit_exact():
    """Identity cascade (d0 = 1): the generator's saw equals the
    primitive-op sequence in numpy and the JAX kernel bit for bit."""
    from signals_tpu.compiler import pallas_kernels as PK
    S, F, C, lanes = 4, 256, 256, 1024
    hz = (110.0 * 2 ** (np.arange(lanes) % 12 / 12.0)).astype(np.float32)
    lanef = np.stack([hz, np.zeros(lanes, np.float32),
                      np.ones(lanes, np.float32)])
    toff = (np.repeat(np.arange(16, dtype=np.int32), 64) * S * F
            - C).astype(np.int32)
    tt = toff[None, :].astype(np.int64) + np.arange(C + S * F)[:, None]
    tf = tt.astype(np.float32)

    def frac(v):
        return v - np.floor(v)

    ph = frac(frac(tf * np.float32(1.0 / RATE) * hz[None, :]))
    x = np.where(tt >= 0, np.float32(2.0) * frac(ph - np.float32(0.5))
                 - np.float32(1.0), np.float32(0.0)).astype(np.float32)
    tails = np.stack([x[b * F + C:b * F + C + F] for b in range(S)])

    co_id = np.zeros((S, 1, lanes, 11), np.float32)
    co_id[..., 8] = 1.0
    kw = dict(n_segments=S, seg_frames=F, context=C, osc_code=PK.OSC_SAW,
              rate=RATE)
    got = K.sosfilt_segments_gen(t(co_id), t(toff), t(lanef), **kw).numpy()
    jax_got = np.asarray(PK.sosfilt_segments_gen(co_id, toff, lanef,
                                                 interpret=True, **kw))
    assert np.abs(got - tails).max() == 0.0
    assert np.abs(got - jax_got).max() == 0.0


@pytest.mark.parametrize('m,sum_groups', [(1, 0), (4, 0), (4, 64)])
def test_segments_plain_matches_jax_interpret(m, sum_groups):
    from signals_tpu.compiler import pallas_kernels as PK
    rng = np.random.default_rng(100 + m + sum_groups)
    ch, nb, F, C = 64, 8, 512, 512
    co = lowpass_coeffs(rng, nb, ch)
    x = rng.standard_normal((C + nb * F, ch)).astype(np.float32)
    kw = dict(n_segments=nb, seg_frames=F, context=C, sum_groups=sum_groups,
              blocks_per_seg=m)
    want = np.asarray(PK.sosfilt_segments(co, x, interpret=True, **kw))
    got = K.sosfilt_segments(t(co), t(x), **kw).numpy()
    assert got.shape == want.shape
    if sum_groups:
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    else:
        assert np.abs(got - want).max() <= TOL


def test_wrappers_reject_bad_geometry():
    co = torch.zeros((6, 1, 64, 11))
    toff = torch.zeros(64, dtype=torch.int32)
    lanef = torch.zeros((3, 64))
    with pytest.raises(ValueError, match='multiple of blocks_per_seg'):
        K.sosfilt_segments_gen(co, toff, lanef, n_segments=6, seg_frames=8,
                               context=8, osc_code=K.OSC_SAW, rate=RATE,
                               blocks_per_seg=4)
    with pytest.raises(ValueError, match='sum_groups'):
        K.sosfilt_segments(co, torch.zeros((56, 64)), n_segments=6,
                           seg_frames=8, context=8, sum_groups=48)
    with pytest.raises(ValueError, match='toff'):
        K.sosfilt_segments_gen(co, toff[:32], lanef, n_segments=6,
                               seg_frames=8, context=8, osc_code=K.OSC_SAW,
                               rate=RATE)
    with pytest.raises(ValueError, match='sections'):
        K.sosfilt_segments(torch.zeros((6, 2, 64, 11)), torch.zeros((56, 64)),
                           n_segments=6, seg_frames=8, context=8)


def test_plain_sum_of_one_wide_group_matches_lane_sum():
    """A sum group as wide as all the lanes (the mix plan at any voice
    count) is the lane sum of the full-width output, within 1e-5 of its
    max."""
    rng = np.random.default_rng(7)
    ch, nb, F, C = 256, 4, 64, 32
    co = t(lowpass_coeffs(rng, nb, ch))
    x = t(rng.standard_normal((C + nb * F, ch)).astype(np.float32))
    kw = dict(n_segments=nb, seg_frames=F, context=C, blocks_per_seg=2)
    lanes = K.sosfilt_segments(co, x, **kw)
    gsum = K.sosfilt_segments(co, x, sum_groups=ch, **kw)
    want = lanes.sum(-1, keepdim=True)
    assert gsum.shape == (nb, F, 1)
    assert float((gsum - want).abs().max()) <= TOL * float(want.abs().max())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('osc_code', [K.OSC_SINE, K.OSC_SQUARE, K.OSC_SAW,
                                      K.OSC_TRIANGLE])
def test_cuda_segments_gen_matches_plain(cuda_device, osc_code):
    rng = np.random.default_rng(osc_code)
    lanes, nb, F, C, m = 64, 16, 1024, 512, 8
    co = t(lowpass_coeffs(rng, nb, lanes)).to(cuda_device)
    toff, lanef = (t(a).to(cuda_device) for a in saw_lanes(rng, lanes, C))
    kw = dict(n_segments=nb, seg_frames=F, context=C, osc_code=osc_code,
              rate=RATE, blocks_per_seg=m)
    co_id = torch.zeros_like(co)
    co_id[..., 8] = 1.0
    src = K.gen_source_rows(toff, lanef, n_segments=nb // m,
                            seg_frames=m * F, context=C, osc_code=osc_code,
                            rate=RATE)[:, C:].reshape(nb, F, lanes)
    assert torch.equal(K.sosfilt_segments_gen(co_id, toff, lanef, **kw), src)
    for sg in (0, lanes):
        got = K.sosfilt_segments_gen(co, toff, lanef, sum_groups=sg, **kw)
        want = K.sosfilt_segments_gen_plain(co, toff, lanef, sum_groups=sg,
                                            **kw)
        scale = want.abs().max() if sg else 1.0
        assert float((got - want).abs().max()) <= TOL * float(scale)


@pytest.mark.cuda
@pytest.mark.parametrize('m,sum_groups', [(1, 0), (8, 0), (8, 64), (1, 16)])
def test_cuda_segments_matches_plain(cuda_device, m, sum_groups):
    rng = np.random.default_rng(m + sum_groups)
    ch, nb, F, C = 64, 16, 1024, 512
    co = t(lowpass_coeffs(rng, nb, ch)).to(cuda_device)
    x = t(rng.standard_normal((C + nb * F, ch)).astype(np.float32)).to(
        cuda_device)
    kw = dict(n_segments=nb, seg_frames=F, context=C, sum_groups=sum_groups,
              blocks_per_seg=m)
    got = K.sosfilt_segments(co, x, **kw)
    want = K.sosfilt_segments_plain(co, x, **kw)
    scale = want.abs().max() if sum_groups else 1.0
    assert float((got - want).abs().max()) <= TOL * float(scale)


@pytest.mark.cuda
@pytest.mark.parametrize('lanes,sum_groups', [(1024, 1024), (1024, 256),
                                              (384, 192)])
@pytest.mark.parametrize('gen', [True, False],
                         ids=['segments_gen', 'segments'])
def test_cuda_wide_sum_groups_match_plain(cuda_device, gen, lanes,
                                          sum_groups):
    """Groups wider than a thread block: tile partial sums plus the
    finishing pass, against the plain group sums (1e-5 of their max)."""
    rng = np.random.default_rng(lanes + sum_groups)
    nb, F, C, m = 16, 1024, 512, 8
    co = t(lowpass_coeffs(rng, nb, lanes)).to(cuda_device)
    geo = dict(n_segments=nb, seg_frames=F, context=C, blocks_per_seg=m,
               sum_groups=sum_groups)
    if gen:
        toff, lanef = (t(a).to(cuda_device)
                       for a in saw_lanes(rng, lanes, C))
        kw = dict(geo, osc_code=K.OSC_SAW, rate=RATE)
        got = K.sosfilt_segments_gen(co, toff, lanef, **kw)
        want = K.sosfilt_segments_gen_plain(co, toff, lanef, **kw)
    else:
        x = t(rng.standard_normal((C + nb * F, lanes)).astype(
            np.float32)).to(cuda_device)
        got = K.sosfilt_segments(co, x, **geo)
        want = K.sosfilt_segments_plain(co, x, **geo)
    assert got.shape == (nb, F, lanes // sum_groups)
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())


@pytest.mark.cuda
def test_cuda_1024_voice_flagship_mix_plan(cuda_device):
    """The flagship at 1024 voices renders through the mix plan (one K1
    launch with a 1024-lane group sum) and agrees with the per-voice plan
    within V x 1e-5 raw max-abs."""
    import chip_smoke as cs
    from signals_tpu_torch.parallel import PolyPatch
    V, nb = 1024, 16

    def poly(**kw):
        root, hz = cs.build_subtractive_voice()
        return PolyPatch(root, n_voices=V,
                         overrides={(hz, 'value'): cs.poly_freqs(V)},
                         block_frames=cs.F, rate=cs.RATE, device='cuda', **kw)

    mix_plan = poly()
    assert mix_plan.compiled.mega_mix(nb) is not None
    K.reset_launch_counts()
    got = mix_plan.render(n_blocks=nb)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {'segments_gen': 1, 'segments': 0}
    want = poly(mix_epilogue=False).render(n_blocks=nb)
    assert got.shape == (nb * cs.F, 1) and bool(torch.isfinite(got).all())
    assert float(want.abs().max()) > 0.1
    assert float((got - want).abs().max()) <= V * TOL
