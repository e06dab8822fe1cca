"""The port's cascade kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version, which is held to
the JAX kernel run in interpret mode (as the JAX package's own tests run
it, ``tests/test_pallas_kernels.py:20-106, 188-207, 444-484, 755-802``), at
the JAX tests' sizes.  Tolerances: filtered lanes 1e-5 max-abs (the
per-voice parity budget; the kernels' f32 cascade orders differ at
round-off), group sums 1e-5 of their max, and the identity-cascade saw
source bit-exact (a one-ulp phase error at a wrap is a 2.0 spike).

The ``cuda`` cases compare each CUDA kernel with its plain version on a
GPU (same tolerances) — the segment kernels at the edges of their
time-sliced scan (:data:`SEGMENT_EDGES`), lane groups wider than the
kernel's summed subgroups, the same call twice bit for bit — and render a 1024-voice flagship
through the mix plan; they skip without a GPU.  JAX is imported inside
the JAX comparisons, so the card cases run on a machine without JAX, from
the repository root:
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from signals_tpu_torch.compiler import kernels as K
from signals_tpu_torch.compiler.filters import design_coupled
from signals_tpu_torch.core.xp import NP

RATE = 44100
NYQ = np.float32(RATE / 2)
TOL = 1e-5


def lowpass_coeffs(rng, n_blocks, lanes, lo=500.0, hi=5000.0):
    """Per-block, per-lane swept lowpass coefficients
    ``(n_blocks, 1, lanes, 11)`` from seeded random cutoffs."""
    cuts = rng.uniform(lo, hi, (1, n_blocks * lanes)).astype(np.float32)
    co = design_coupled(NP, 'lp', (cuts,), np.float32(RATE / 2))
    return np.ascontiguousarray(
        co.reshape(1, n_blocks, lanes, 11).transpose(1, 0, 2, 3))


def band_coeffs(rng, n_blocks, lanes, btype='bp'):
    """Per-block, per-lane band coefficients ``(n_blocks, 2, lanes, 11)``:
    low edges 200-800 Hz, high edges 2-6 kHz."""
    lo = rng.uniform(200.0, 800.0, (1, n_blocks * lanes)).astype(np.float32)
    hi = rng.uniform(2000.0, 6000.0, lo.shape).astype(np.float32)
    co = design_coupled(NP, btype, (lo, hi), NYQ)
    return np.ascontiguousarray(
        co.reshape(2, n_blocks, lanes, 11).transpose(1, 0, 2, 3))


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
    assert not any(K.LAUNCHES.values())
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


@pytest.mark.parametrize('btype', ['bp', 'bs'])
def test_segments_two_sections_plain_matches_jax_interpret(btype):
    """Two sections per lane (band designs) through both segment kernels'
    plain versions, against the JAX kernels in interpret mode (the JAX
    test's geometry, ``tests/test_pallas_kernels.py:188-207``)."""
    from signals_tpu.compiler import pallas_kernels as PK
    rng = np.random.default_rng(22)
    F, C, nb, ch = 512, 512, 4, 32
    co = band_coeffs(rng, nb, ch, btype)
    x = rng.standard_normal((C + nb * F, ch)).astype(np.float32)
    kw = dict(n_segments=nb, seg_frames=F, context=C, blocks_per_seg=2)
    want = np.asarray(PK.sosfilt_segments(co, x, interpret=True, **kw))
    got = K.sosfilt_segments(t(co), t(x), **kw).numpy()
    assert got.shape == want.shape == (nb, F, ch)
    assert np.abs(got - want).max() <= TOL
    toff, lanef = saw_lanes(rng, 1024, C)
    co = band_coeffs(rng, nb, 1024, btype)
    kw = dict(kw, osc_code=PK.OSC_SAW, rate=RATE)
    want = np.asarray(PK.sosfilt_segments_gen(co, toff, lanef,
                                              interpret=True, **kw))
    got = K.sosfilt_segments_gen(t(co), t(toff), t(lanef), **kw).numpy()
    assert np.abs(got - want).max() <= TOL


def lowpass_windows(rng, B, ch):
    cuts = rng.uniform(200.0, 9000.0, (B, ch)).astype(np.float32)
    return np.stack([design_coupled(NP, 'lp', (cuts[b:b + 1],), NYQ)
                     for b in range(B)])                   # (B, 1, ch, 11)


def cascade_windows(rng, B, ch, nsec):
    """Per-window coefficients ``(B, nsec, ch, 11)`` of 1-4 sections: a
    low-pass, a band-pass, a low-pass then a band-pass, a band-pass then a
    band-stop."""
    lp = lowpass_windows(rng, B, ch)
    bp, bs = band_coeffs(rng, B, ch, 'bp'), band_coeffs(rng, B, ch, 'bs')
    parts = {1: (lp,), 2: (bp,), 3: (lp, bp), 4: (bp, bs)}[nsec]
    return np.ascontiguousarray(np.concatenate(parts, axis=1))


@pytest.mark.parametrize('case', ['padding', 'tail1024', 'tail700',
                                  'two_sections', 'four_sections'])
def test_batch_plain_matches_jax_interpret(case):
    """``sosfilt_batch``'s plain version against the JAX kernel in interpret
    mode at the JAX tests' shapes (``tests/test_pallas_kernels.py:66-106``):
    rows and lanes that need padding on the TPU, tails of 1024 and 700
    rows (not a multiple of its row chunk) from 2048, two sections, and
    four (a band-pass then a band-stop)."""
    from signals_tpu.compiler import pallas_kernels as PK
    rng = np.random.default_rng(11)
    tail = None
    if case == 'padding':
        L, B, ch = 300, 5, 3
        co = lowpass_windows(rng, B, ch)
    elif case == 'two_sections':
        L, B, ch = 400, 2, 1
        co = np.stack([design_coupled(
            NP, 'bp', (np.array([[300.0]], np.float32),
                       np.array([[4000.0 + 500 * b]], np.float32)), NYQ)
            for b in range(B)])                           # (B, 2, 1, 11)
    elif case == 'four_sections':
        L, B, ch, tail = 640, 3, 4, 500
        co = cascade_windows(rng, B, ch, 4)
    else:
        L, B, ch = 2048, 3, 2
        co = lowpass_windows(rng, B, ch)
        tail = int(case[4:])
    x = rng.standard_normal((L, B, ch)).astype(np.float32)
    want = np.asarray(PK.sosfilt_batch(co, x, interpret=True, tail=tail))
    got = K.sosfilt_batch(t(co), t(x), tail=tail).numpy()
    assert got.shape == want.shape == (tail or L, B, ch)
    assert np.abs(got - want).max() <= TOL


def _saw(n_frames):
    n = np.arange(n_frames, dtype=np.float32).reshape(-1, 1)
    ph = np.mod(n / np.float32(RATE) * np.float32(110), np.float32(1))
    return (2 * np.mod(ph - 0.5, 1) - 1).astype(np.float32)


@pytest.mark.parametrize('btype,crits', [
    ('lp', [1200.0]), ('hp', [500.0]), ('bp', [300.0, 3000.0]),
    ('bs', [300.0, 3000.0]), ('multichannel', None), ('lp+bp', None)])
def test_timeline_plain_matches_jax_interpret(btype, crits):
    """``sosfilt_timeline``'s plain version against ``sosfilt_pallas`` in
    interpret mode (``tests/test_pallas_kernels.py:20-51``): the four
    Butterworth types on a 1124-frame saw, and a (333, 3) noise input whose
    rows and channels need padding on the TPU, and a three-section
    cascade (a low-pass then a band-pass) on the saw."""
    from signals_tpu.compiler import pallas_kernels as PK
    if btype == 'multichannel':
        x = np.random.default_rng(3).standard_normal((333, 3)).astype(
            np.float32)
        co = design_coupled(NP, 'lp', (np.array([[500.0, 2000.0, 8000.0]],
                                                np.float32),), NYQ)
    elif btype == 'lp+bp':
        x = _saw(1124)
        co = cascade_windows(np.random.default_rng(4), 1, 1, 3)[0]
    else:
        x = _saw(1124)
        co = design_coupled(NP, btype, [np.array([[c]], np.float32)
                                        for c in crits], NYQ)
    want = np.asarray(PK.sosfilt_pallas(co, x, interpret=True))
    got = K.sosfilt_timeline(t(co), t(x)).numpy()
    assert got.shape == want.shape == x.shape
    assert np.abs(got - want).max() <= TOL


def test_zero_state_wrappers_broadcast_and_reject():
    """Channel axes broadcast to the wider count; section counts outside
    1..4 and tails outside [1, L] raise."""
    rng = np.random.default_rng(5)
    co = t(lowpass_windows(rng, 2, 1))                     # (2, 1, 1, 11)
    x = t(rng.standard_normal((64, 2, 3)).astype(np.float32))
    got = K.sosfilt_batch(co, x, tail=16)
    want = K.sosfilt_batch(co.expand(2, 1, 3, 11), x, tail=16)
    assert got.shape == (16, 2, 3) and torch.equal(got, want)
    y = K.sosfilt_timeline(co[0], x[:, 0, :1])
    assert y.shape == (64, 1)
    with pytest.raises(ValueError, match='sections'):
        K.sosfilt_timeline(torch.zeros((5, 1, 11)), x[:, 0])
    with pytest.raises(ValueError, match='sections'):
        K.sosfilt_batch(torch.zeros((2, 5, 1, 11)), x)
    with pytest.raises(ValueError, match='tail'):
        K.sosfilt_batch(co, x, tail=65)
    with pytest.raises(ValueError, match='windows'):
        K.sosfilt_batch(co[:1], x)


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
        K.sosfilt_segments(torch.zeros((6, 3, 64, 11)), torch.zeros((56, 64)),
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
@pytest.mark.parametrize('phased', [False, True], ids=['ph0', 'phased'])
@pytest.mark.parametrize('osc_code', [K.OSC_SINE, K.OSC_SQUARE, K.OSC_SAW,
                                      K.OSC_TRIANGLE])
def test_cuda_segments_gen_matches_plain(cuda_device, osc_code, phased):
    """The generator kernel's source rows bit-exact (identity cascade) and
    its lanes and 64-lane sums within 1e-5 of the plain version, for lanes
    of phase 0 and hz >= 0 (the flagship's; the kernel skips a phase
    reduction there) and for lanes with phases and negative hz."""
    rng = np.random.default_rng(osc_code)
    lanes, nb, F, C, m = 64, 16, 1024, 512, 8
    co = t(lowpass_coeffs(rng, nb, lanes)).to(cuda_device)
    toff, lanef = saw_lanes(rng, lanes, C)
    if phased:
        lanef[0] *= np.where(np.arange(lanes) % 3 == 0, -1, 1).astype(
            np.float32)
        lanef[1] = rng.uniform(-1.5, 1.5, lanes).astype(np.float32)
    toff, lanef = t(toff).to(cuda_device), t(lanef).to(cuda_device)
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


#: segment-kernel geometries for the card: (lanes, n_blocks, F, C, m,
#: sum_groups, sections, cutoff range in Hz).  The kernel cuts each carry
#: segment's C + m*F rows into slices of whole 16-row chunks and sums lane
#: groups in power-of-two subgroups, so the edges are a context that is no
#: multiple of either, one carry segment, lane counts that are no multiple
#: of 32 or of a power of two, two sections, and poles near the unit circle.
SEGMENT_EDGES = {
    'm1': (64, 16, 1024, 512, 1, 0, 1, (500.0, 5000.0)),
    'm8': (64, 16, 1024, 512, 8, 0, 1, (500.0, 5000.0)),
    'm8_sum64': (64, 16, 1024, 512, 8, 64, 1, (500.0, 5000.0)),
    'm1_sum16': (64, 16, 1024, 512, 1, 16, 1, (500.0, 5000.0)),
    'C300_lanes48_sum48': (48, 16, 1024, 300, 8, 48, 1, (500.0, 5000.0)),
    'C128_lanes5': (5, 8, 1024, 128, 1, 0, 1, (500.0, 5000.0)),
    'C128_lanes5_sum5': (5, 8, 1024, 128, 1, 5, 1, (500.0, 5000.0)),
    'one_segment_sum64': (64, 8, 1024, 512, 8, 64, 1, (500.0, 5000.0)),
    'two_sections_C300_lanes48': (48, 16, 512, 300, 4, 0, 2, None),
    'two_sections_sum48': (48, 16, 512, 300, 4, 48, 2, None),
    'lowpass30': (64, 16, 1024, 512, 8, 0, 1, (30.0, 30.0)),
    'lowpass30_sum64': (64, 16, 1024, 512, 8, 64, 1, (30.0, 30.0)),
}


def segment_pair(rng, device, gen, lanes, nb, F, C, m, sum_groups, nsec,
                 cuts):
    """``(kernel call, plain call)`` of one segment kernel at a geometry of
    :data:`SEGMENT_EDGES`: swept per-block LowPass (or band-pass, at two
    sections) coefficients, a saw through the generator or a noise
    timeline."""
    co = (lowpass_coeffs(rng, nb, lanes, *cuts) if nsec == 1
          else band_coeffs(rng, nb, lanes))
    co = t(co).to(device)
    geo = dict(n_segments=nb, seg_frames=F, context=C, blocks_per_seg=m,
               sum_groups=sum_groups)
    if gen:
        toff, lanef = (t(a).to(device) for a in saw_lanes(rng, lanes, C))
        kw = dict(geo, osc_code=K.OSC_SAW, rate=RATE)
        return (lambda: K.sosfilt_segments_gen(co, toff, lanef, **kw),
                lambda: K.sosfilt_segments_gen_plain(co, toff, lanef, **kw))
    x = t(rng.standard_normal((C + nb * F, lanes)).astype(np.float32)).to(
        device)
    return (lambda: K.sosfilt_segments(co, x, **geo),
            lambda: K.sosfilt_segments_plain(co, x, **geo))


@pytest.mark.cuda
@pytest.mark.parametrize('gen', [True, False],
                         ids=['segments_gen', 'segments'])
@pytest.mark.parametrize('case', list(SEGMENT_EDGES))
def test_cuda_segments_matches_plain(cuda_device, case, gen):
    """Each segment kernel at each edge geometry within 1e-5 of its plain
    version (group sums: 1e-5 of their max), one launch each."""
    lanes, nb, F, C, m, sum_groups, nsec, cuts = SEGMENT_EDGES[case]
    rng = np.random.default_rng(sorted(SEGMENT_EDGES).index(case) + gen)
    call, plain = segment_pair(rng, cuda_device, gen, lanes, nb, F, C, m,
                               sum_groups, nsec, cuts)
    K.reset_launch_counts()
    got = call()
    assert K.LAUNCHES['segments_gen' if gen else 'segments'] == 1
    want = plain()
    assert got.shape == want.shape == (nb, F, lanes // (sum_groups or 1))
    assert bool(torch.isfinite(got).all())
    scale = want.abs().max() if sum_groups else 1.0
    assert float((got - want).abs().max()) <= TOL * float(scale)


@pytest.mark.cuda
@pytest.mark.parametrize('sum_groups', [0, 64])
@pytest.mark.parametrize('gen', [True, False],
                         ids=['segments_gen', 'segments'])
def test_cuda_segments_deterministic(cuda_device, gen, sum_groups):
    """The same call twice gives the same bits: the group sums take a fixed
    order (no atomics), at the flagship's geometry and at the 60 s render's
    carry-segment count."""
    rng = np.random.default_rng(9)
    for nb in (16, 2584):
        call, _ = segment_pair(rng, cuda_device, gen, 64, nb, 1024, 512, 8,
                               sum_groups, 1, (500.0, 5000.0))
        assert torch.equal(call(), call())


@pytest.mark.cuda
@pytest.mark.parametrize('lanes,sum_groups', [(1024, 1024), (1024, 256),
                                              (384, 192), (256, 256)])
@pytest.mark.parametrize('gen', [True, False],
                         ids=['segments_gen', 'segments'])
def test_cuda_wide_sum_groups_match_plain(cuda_device, gen, lanes,
                                          sum_groups):
    """Groups wider than the kernel's summed subgroup (at most 32 lanes):
    subgroup partial sums plus the finishing pass, against the plain group
    sums (1e-5 of their max)."""
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
    assert K.LAUNCHES == {'segments_gen': 1, 'segments': 0, 'batch': 0,
                          'timeline': 0}
    want = poly(mix_epilogue=False).render(n_blocks=nb)
    assert got.shape == (nb * cs.F, 1) and bool(torch.isfinite(got).all())
    assert float(want.abs().max()) > 0.1
    assert float((got - want).abs().max()) <= V * TOL


@pytest.mark.cuda
@pytest.mark.parametrize('gen', [True, False],
                         ids=['segments_gen', 'segments'])
def test_cuda_segments_two_sections_match_plain(cuda_device, gen):
    """Both segment kernels at two sections (band coefficients, per-block,
    8-block carry segments), lanes and the 64-lane group sum."""
    rng = np.random.default_rng(2 + gen)
    lanes, nb, F, C, m = 64, 16, 1024, 512, 8
    co = t(band_coeffs(rng, nb, lanes)).to(cuda_device)
    geo = dict(n_segments=nb, seg_frames=F, context=C, blocks_per_seg=m)
    if gen:
        toff, lanef = (t(a).to(cuda_device)
                       for a in saw_lanes(rng, lanes, C))
        kw = dict(geo, osc_code=K.OSC_SAW, rate=RATE)

        def call(fn, **k):
            return fn(co, toff, lanef, **kw, **k)
        fns = K.sosfilt_segments_gen, K.sosfilt_segments_gen_plain
    else:
        x = t(rng.standard_normal((C + nb * F, lanes)).astype(
            np.float32)).to(cuda_device)

        def call(fn, **k):
            return fn(co, x, **geo, **k)
        fns = K.sosfilt_segments, K.sosfilt_segments_plain
    for sg in (0, lanes):
        got, want = call(fns[0], sum_groups=sg), call(fns[1], sum_groups=sg)
        scale = want.abs().max() if sg else 1.0
        assert float((got - want).abs().max()) <= TOL * float(scale)


@pytest.mark.cuda
@pytest.mark.parametrize('nsec', [1, 2, 3, 4])
def test_cuda_batch_matches_plain(cuda_device, nsec):
    """K3 at the render-ahead shape (L = C + F = 1152, 8 windows, 16
    channels, tail F) and at a ragged one (300 rows, 5 x 3, tail 77), at
    every section count it takes."""
    rng = np.random.default_rng(30 + nsec)
    for L, B, ch, tail in ((1152, 8, 16, 1024), (300, 5, 3, 77)):
        co = cascade_windows(rng, B, ch, nsec)
        co, x = (t(a).to(cuda_device) for a in (
            co, rng.standard_normal((L, B, ch)).astype(np.float32)))
        K.reset_launch_counts()
        got = K.sosfilt_batch(co, x, tail=tail)
        assert K.LAUNCHES['batch'] == 1
        want = K.sosfilt_batch_plain(co, x, tail=tail)
        assert got.shape == (tail, B, ch)
        assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize('nsec', [1, 2, 3, 4])
def test_cuda_timeline_matches_plain(cuda_device, nsec):
    """K4 at the step shape (1152, 16) and a mono one (1152, 1), at every
    section count it takes."""
    rng = np.random.default_rng(40 + nsec)
    for ch in (16, 1):
        co = cascade_windows(rng, 1, ch, nsec)[0]
        co, x = (t(a).to(cuda_device) for a in (
            co, rng.standard_normal((1152, ch)).astype(np.float32)))
        K.reset_launch_counts()
        got = K.sosfilt_timeline(co, x)
        assert K.LAUNCHES['timeline'] == 1
        want = K.sosfilt_timeline_plain(co, x)
        assert float((got - want).abs().max()) <= TOL
