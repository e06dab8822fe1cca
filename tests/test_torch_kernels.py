"""The port's cascade kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version, which is held to
the JAX kernel run in interpret mode (as the JAX package's own tests run
it, ``tests/test_pallas_kernels.py:20-106, 188-207, 444-484, 755-802``), at
the JAX tests' sizes.  Tolerances: filtered lanes 1e-5 max-abs (the
per-voice parity budget; the kernels' f32 cascade orders differ at
round-off), group sums 1e-5 of their max, and the identity-cascade saw
source bit-exact (a one-ulp phase error at a wrap is a 2.0 spike).

The zero-state kernels' time-sliced scan is modelled here in numpy f32
(:func:`slice_scan_model`) and held to the row-by-row scan, and their
wrappers take strided, overlapping and broadcast views.

The ``cuda`` cases compare each CUDA kernel with its plain version on a
GPU (same tolerances) — every kernel at the edges of its time-sliced scan
(:data:`SEGMENT_EDGES`, :data:`BATCH_EDGES`, :data:`TIMELINE_EDGES`, poles
near the unit circle), lane groups wider than the kernel's summed
subgroups, views read in place and the same call twice bit for bit, the
carried-state entry (a start state in, the end state out, at 1-4 sections,
a window cut into two calls, null states bit for bit the zero-state call)
— and render a 1024-voice flagship through the mix plan; they skip without
a GPU.  JAX is imported inside the JAX comparisons, so the card cases run on
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


def slice_rows(n_rows, lanes=1, fill=132 * 2048 // 4):
    """Rows per slice as ``csrc/rows.cu`` cuts a window of ``n_rows`` rows
    of ``lanes`` lanes (``scan.cuh``'s ``plan_slices`` with slices of one
    16-row chunk at least, an H100's 132 SMs)."""
    def slices(lt):
        return max(1, min(512 // lt, n_rows // 16))
    lt = 1
    while lt < lanes and lt < 32:
        lt *= 2
    while lt > 1:
        threads = -(-lanes // lt) * lt * slices(lt)
        if threads >= fill or slices(lt // 2) <= slices(lt):
            break
        lt //= 2
    w = slices(lt)
    return -(-(-(-n_rows // w)) // 16) * 16


def _cmul(a, b):
    """Complex product of (re, im) pairs of f32 arrays, as ``scan.cuh``."""
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def slice_scan_model(coeffs, x, tail):
    """A numpy float32 model of ``csrc/rows.cu``'s time-sliced scan over one
    window (``coeffs`` ``(nsec, ch, 11)``, ``x`` ``(L, ch)``): each slice's
    map (transfer per full 16-row chunk p^16, per row in a partial one; end
    state) from zero state, an exclusive Hillis-Steele scan of the maps per
    section in turn (section k's pass replays sections 0..k-1 from their
    true starts), then the replay of only the slices that hold one of the
    last ``tail`` rows.  Returns those rows, ``(tail, ch)``."""
    f32 = np.float32
    L, ch = x.shape
    nsec = coeffs.shape[0]
    S = slice_rows(L, ch)
    n = -(-L // S)
    rows = np.arange(n)[:, None] * S + np.arange(S)[None, :]
    valid = rows < L                                       # (n, S)
    xs = np.where(valid[..., None], x[np.minimum(rows, L - 1)], f32(0))
    rc, rs, d0, d1, d2 = (coeffs[:, :, k] for k in range(6, 11))
    p = [(rc[k], rs[k]) for k in range(nsec)]
    pk = list(p)
    for _ in range(4):
        pk = [_cmul(q, q) for q in pk]
    zero = np.zeros((n, ch), f32)

    def walk(state, ns, track, first=0):
        s = [tuple(c[first:] for c in st) for st in state[:ns]]
        a = (np.ones_like(zero[first:]), zero[first:].copy())
        ys = np.zeros((n - first, S, ch), f32)
        for i in range(S):
            ok = valid[first:, i][:, None]
            v = xs[first:, i]
            for k in range(ns):
                s1, s2 = s[k]
                y = d0[k] * v + d1[k] * s1 + d2[k] * s2
                s[k] = (np.where(ok, rc[k] * s1 - rs[k] * s2 + v, s1),
                        np.where(ok, rs[k] * s1 + rc[k] * s2, s2))
                v = y
            ys[:, i] = v
            if not track:
                continue
            full = valid[first:, i - i % 16 + 15 if i - i % 16 + 15 < S
                         else S - 1][:, None] & (i - i % 16 + 15 < S)
            per_row = _cmul(p[ns - 1], a)
            a = tuple(np.where(ok & ~full, r, c) for r, c in zip(per_row, a))
            if i % 16 == 15:
                chunk = _cmul(pk[ns - 1], a)
                a = tuple(np.where(full, r, c) for r, c in zip(chunk, a))
        return ys, s, a

    def exclusive_scan(a, e):
        d = 1
        while d < n:
            pa = tuple(np.concatenate([zero[:d], c[:-d]]) for c in a)
            pe = tuple(np.concatenate([zero[:d], c[:-d]]) for c in e)
            na, ne = _cmul(a, pa), _cmul(a, pe)
            keep = (np.arange(n) >= d)[:, None]
            a = tuple(np.where(keep, u, c) for u, c in zip(na, a))
            e = tuple(np.where(keep, u + c, c) for u, c in zip(ne, e))
            d *= 2
        return tuple(np.concatenate([zero[:1], c[:-1]]) for c in e)

    starts = [(zero, zero)] * nsec
    if n > 1:
        for sec in range(nsec):
            _, end, a = walk(starts[:sec] + [(zero, zero)], sec + 1, True)
            starts[sec] = exclusive_scan(a, end[sec])
    first = (L - tail) // S                 # slices wholly in the warmup
    ys, _, _ = walk(starts, nsec, False, first)
    return ys.reshape(-1, ch)[L - tail - first * S:L - first * S]


def unit_circle_coeffs(btype, nsec, ch):
    """``(nsec, ch, 11)``: ``nsec`` copies of a 30 Hz LowPass or a 20 Hz
    HighPass section (poles within ~0.3% of the unit circle at 44.1 kHz)."""
    hz = {'lp': 30.0, 'hp': 20.0}[btype]
    co = design_coupled(NP, btype, (np.full((1, ch), hz, np.float32),), NYQ)
    return np.ascontiguousarray(np.concatenate([co] * nsec))


#: the slice model's cases: (coefficients: a section count of
#: :func:`cascade_windows` or a near-unit-circle design, rows, tail, DC
#: offset of the noise input)
SCAN_MODEL_CASES = {
    'sections1_L1152_tail1024': (1, 1152, 1024, 0.0),
    'sections2_L300_tail77': (2, 300, 77, 0.0),
    'sections3_L1001': (3, 1001, 1001, 0.0),
    'sections4_L1152': (4, 1152, 1152, 0.0),
    'sections4_L129_tail1': (4, 129, 1, 0.0),
    'lowpass30_1': (('lp', 1), 1152, 1152, 1.0),
    'lowpass30_4_tail1': (('lp', 4), 1152, 1, 1.0),
    'highpass20_1': (('hp', 1), 1152, 1152, 1.0),
    'highpass20_4': (('hp', 4), 1152, 1024, 1.0),
}


@pytest.mark.parametrize('case', list(SCAN_MODEL_CASES))
def test_slice_scan_model_matches_scan(case):
    """The f32 algebra of the zero-state kernels' time-sliced scan (slice
    maps, exclusive scans section by section, the tail-only replay) meets
    the 1e-5 budget against the row-by-row ``sosfilt_scan`` — at 1-4
    sections, lengths that are no multiple of the slice, a tail of one row,
    and poles near the unit circle — before the kernel runs on a card."""
    kind, L, tail, dc = SCAN_MODEL_CASES[case]
    rng = np.random.default_rng(70 + list(SCAN_MODEL_CASES).index(case))
    ch = 4
    co = (cascade_windows(rng, 1, ch, kind)[0] if isinstance(kind, int)
          else unit_circle_coeffs(*kind, ch))
    x = (rng.standard_normal((L, ch)) + dc).astype(np.float32)
    got = slice_scan_model(co, x, tail)
    want = K.sosfilt_timeline(t(co), t(x)).numpy()[L - tail:]
    assert got.shape == want.shape == (tail, ch)
    assert np.abs(got - want).max() <= TOL
    n_slices = -(-L // slice_rows(L, ch))
    assert n_slices == {129: 5, 300: 10, 1001: 32, 1152: 72}[L]
    assert slice_rows(31) >= 31 and slice_rows(32) == 16


@pytest.mark.parametrize('case', ['batch_unfold', 'batch_sampled_unfold',
                                  'batch_broadcast', 'batch_strided',
                                  'timeline_strided', 'timeline_broadcast'])
def test_zero_state_wrappers_take_views(case):
    """``sosfilt_batch`` and ``sosfilt_timeline`` on strided, overlapping
    (``unfold``, as the filter lowerings pass their windows) and broadcast
    views give the bits of the same call on contiguous copies."""
    rng = np.random.default_rng(80)
    C, F, nb, ch = 128, 256, 4, 3
    xt = t(rng.standard_normal((C + nb * F, 2 * ch)).astype(np.float32))
    co = t(cascade_windows(rng, nb, ch, 2))
    if case.startswith('batch_'):
        if case == 'batch_unfold':
            view = xt[:, :ch].unfold(0, C + F, F)[:nb].permute(2, 0, 1)
            tail = F
        elif case == 'batch_sampled_unfold':
            view = xt[:, :ch].unfold(0, C + 1, F)[:nb].permute(2, 0, 1)
            tail = 1
        elif case == 'batch_broadcast':
            view, tail = xt[:C + F, None, :1].expand(C + F, nb, ch), F
        else:
            view, tail = xt[:C + F, None, ::2].expand(C + F, nb, ch), 7
        assert not view.is_contiguous()
        got = K.sosfilt_batch(co, view, tail=tail)
        want = K.sosfilt_batch(co, view.contiguous(), tail=tail)
        cob = co[:1, :, :1].expand(nb, 2, ch, 11)
        assert torch.equal(K.sosfilt_batch(cob, view, tail=tail),
                           K.sosfilt_batch(cob.contiguous(),
                                           view.contiguous(), tail=tail))
    else:
        view = (xt[:C + F:3, 1::2] if case == 'timeline_strided'
                else xt[:C + F, :1].expand(C + F, ch))
        got = K.sosfilt_timeline(co[0], view)
        want = K.sosfilt_timeline(co[0], view.contiguous())
    assert torch.equal(got, want)


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
@pytest.mark.parametrize('view', ['one_channel', 'every_other_column',
                                  'every_third_row'])
@pytest.mark.parametrize('sum_groups', [0, 64])
def test_cuda_segments_reads_views_in_place(cuda_device, view, sum_groups):
    """The timeline kernel reads its input through strides: a one-channel
    timeline under 64 coefficient lanes (the noise voice: lane stride 0),
    a column-strided and a row-strided view each give the bits of the same
    call on the view copied out to (T, 64)."""
    rng = np.random.default_rng(21)
    lanes, nb, F, C, m = 64, 16, 1024, 256, 8
    co = t(lowpass_coeffs(rng, nb // m, lanes, 1000.0, 4000.0)).to(
        cuda_device)
    T = C + nb * F
    base = t(rng.uniform(0, 1, (3 * T, 2 * lanes)).astype(np.float32)).to(
        cuda_device)
    x = {'one_channel': base[:T, :1],
         'every_other_column': base[:T, ::2],
         'every_third_row': base[::3, :lanes]}[view]
    geo = dict(n_segments=nb // m, seg_frames=m * F, context=C,
               sum_groups=sum_groups)
    got = K.sosfilt_segments(co, x, **geo)
    want = K.sosfilt_segments(co, x.expand(T, lanes).contiguous(), **geo)
    assert got.shape == (nb // m, m * F, lanes // (sum_groups or 1))
    assert torch.equal(got, want)
    plain = K.sosfilt_segments_plain(co, x.expand(T, lanes), **geo)
    scale = plain.abs().max() if sum_groups else 1.0
    assert float((got - plain).abs().max()) <= TOL * float(scale)


@pytest.mark.cuda
def test_cuda_1024_voice_flagship_mix_plan(cuda_device):
    """The flagship at 1024 voices renders through the mix plan (one K1
    launch with a 1024-lane group sum) and agrees with the per-voice plan
    within V x 1e-5 raw max-abs."""
    import torch_refs as refs
    from signals_tpu_torch.parallel import PolyPatch
    V, nb = 1024, 16

    def poly(**kw):
        root, hz = refs.build_subtractive_voice()
        return PolyPatch(root, n_voices=V,
                         overrides={(hz, 'value'): refs.poly_freqs(V)},
                         block_frames=refs.F, rate=refs.RATE, device='cuda',
                         **kw)

    mix_plan = poly()
    assert mix_plan.compiled.mega_mix(nb) is not None
    K.reset_launch_counts()
    got, carry = mix_plan.render(n_blocks=nb)
    assert carry == {}
    torch.cuda.synchronize()
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0) | {'segments_gen': 1}
    want, _ = poly(mix_epilogue=False).render(n_blocks=nb)
    assert got.shape == (nb * refs.F, 1) and bool(torch.isfinite(got).all())
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


#: K3 shapes for the card: (L, windows, channels, tail).  The kernel cuts
#: each window into slices of whole 16-row chunks (a window of fewer than
#: 32 rows is one slice, run without a scan) and replays only the slices
#: that hold output rows, so the edges are a window that is no multiple of
#: the slice, one slice, a tail of one row, of all rows and a ragged one,
#: and the main path's shapes: the render-ahead batch (C + F = 1152 rows,
#: 8 windows x 16 channels, tail F) and the sampled filter's windows
#: (C + 1 = 129 rows, tail 1).
BATCH_EDGES = {
    'render_ahead': (1152, 8, 16, 1024),
    'ragged_tail77': (300, 5, 3, 77),
    'L1000_tail_all': (1000, 3, 5, 1000),
    'L31_one_slice': (31, 4, 3, 31),
    'L17_one_slice_tail1': (17, 2, 2, 1),
    'L64': (64, 4, 3, 64),
    'tail1': (1152, 4, 16, 1),
    'sampled': (129, 8, 16, 1),
}

#: K4 shapes for the card: (rows, channels) — the static voice's step, the
#: mono step, a length that is no multiple of the slice, one slice, and a
#: timeline long enough for slices of several chunks (512 slices at most).
TIMELINE_EDGES = {
    'step': (1152, 16),
    'mono_step': (1152, 1),
    'N1001': (1001, 3),
    'N31_one_slice': (31, 2),
    'N20000': (20000, 2),
}


def plain_on_cpu(fn, *tensors, **kw):
    """A plain version run on the CPU (the same f32 ops as on the card, at
    a fraction of the launches), its result moved back to the card."""
    dev = tensors[0].device
    return fn(*(a.cpu() for a in tensors), **kw).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize('case', list(BATCH_EDGES))
@pytest.mark.parametrize('nsec', [1, 2, 3, 4])
def test_cuda_batch_matches_plain(cuda_device, nsec, case):
    """K3 at each edge of its time-sliced scan, at every section count it
    takes, within 1e-5 of the plain version; one launch."""
    L, B, ch, tail = BATCH_EDGES[case]
    rng = np.random.default_rng(30 + nsec + 10 * list(BATCH_EDGES).index(case))
    co = cascade_windows(rng, B, ch, nsec)
    co, x = (t(a).to(cuda_device) for a in (
        co, rng.standard_normal((L, B, ch)).astype(np.float32)))
    K.reset_launch_counts()
    got = K.sosfilt_batch(co, x, tail=tail)
    assert K.LAUNCHES['batch'] == 1
    want = plain_on_cpu(K.sosfilt_batch_plain, co, x, tail=tail)
    assert got.shape == (tail, B, ch)
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize('state', [False, True], ids=['zero', 'zi_zf'])
@pytest.mark.parametrize('case', list(BATCH_EDGES))
def test_batch_time_major_plain(case, state):
    """``time_major=True`` on the CPU: the plain version's rows written
    into the time-major buffer (strides ``(1, tail, B * tail)``), the
    lane-major call's values and end states exactly."""
    L, B, ch, tail = BATCH_EDGES[case]
    rng = np.random.default_rng(100 + list(BATCH_EDGES).index(case))
    co = t(cascade_windows(rng, B, ch, 2))
    x = t(rng.standard_normal((L, B, ch)).astype(np.float32))
    zi = (t(rng.standard_normal((B, 2, 2, ch)).astype(np.float32))
          if state else None)
    K.reset_launch_counts()
    lane = K.sosfilt_batch(co, x, tail=tail, zi=zi, return_state=state)
    tm = K.sosfilt_batch(co, x, tail=tail, zi=zi, return_state=state,
                         time_major=True)
    assert K.ROWS_OUT == {'time_major': 1, 'lane_major': 1}
    lane, tm = (a if state else (a,) for a in (lane, tm))
    assert lane[0].is_contiguous()
    assert tm[0].shape == (tail, B, ch)
    assert tm[0].stride() == (1, tail, B * tail)
    for a, b in zip(tm, lane):
        assert torch.equal(a, b)


#: K3's two output layouts on the card: (L, windows, channels, tail,
#: windows read in place from one timeline ``tail`` rows apart).  A tail of
#: 77 rows (no multiple of 4) and a 31-row single slice store row by row; 15
#: and 100 lanes are no multiple of a warp; the render-ahead batch, the
#: sampled filter's windows (tail 1) and the 64-voice score's whole 60 s
#: (2584 blocks, context 1024, tail 1024) read overlapping views.
LAYOUT_EDGES = {
    'render_ahead': (1152, 8, 16, 1024, True),
    'ragged_tail77': (300, 5, 3, 77, False),
    'L31_one_slice': (31, 4, 3, 31, False),
    'lanes100': (1088, 25, 4, 64, True),
    'sampled': (129, 8, 16, 1, True),
    'score': (2048, 2584, 64, 1024, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize('state', [False, True], ids=['zero', 'zi_zf'])
@pytest.mark.parametrize('case', list(LAYOUT_EDGES))
@pytest.mark.parametrize('nsec', [1, 2, 3, 4])
def test_cuda_batch_time_major_equals_lane_major(cuda_device, nsec, case,
                                                 state):
    """K3 storing through the time-major strides gives the lane-major
    launch's rows and end states bit for bit (the cascade and scan are the
    same; only the addresses differ), one launch each."""
    L, B, ch, tail, in_place = LAYOUT_EDGES[case]
    k = list(LAYOUT_EDGES).index(case)
    rng = np.random.default_rng(110 + nsec + 10 * k)
    # the score shares one cutoff across its voices: a broadcast lane
    co = t(cascade_windows(rng, B, 1 if case == 'score' else ch, nsec)).to(
        cuda_device).expand(B, nsec, ch, 11)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(120 + nsec + 10 * k)
    if in_place:
        xt = torch.randn((L - tail + B * tail, ch), generator=gen,
                         device=cuda_device)
        x = xt.unfold(0, L, tail)[:B].permute(2, 0, 1)
    else:
        x = torch.randn((L, B, ch), generator=gen, device=cuda_device)
    zi = (torch.randn((B, nsec, 2, ch), generator=gen, device=cuda_device)
          if state else None)
    K.reset_launch_counts()
    lane = K.sosfilt_batch(co, x, tail=tail, zi=zi, return_state=state)
    torch.cuda.synchronize()
    tm = K.sosfilt_batch(co, x, tail=tail, zi=zi, return_state=state,
                         time_major=True)
    torch.cuda.synchronize()
    assert K.LAUNCHES['batch'] == 2
    assert K.ROWS_OUT == {'time_major': 1, 'lane_major': 1}
    lane, tm = (a if state else (a,) for a in (lane, tm))
    assert tm[0].stride() == (1, tail, B * tail)
    assert bool(torch.isfinite(lane[0]).all())
    for a, b in zip(tm, lane):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize('case', list(TIMELINE_EDGES))
@pytest.mark.parametrize('nsec', [1, 2, 3, 4])
def test_cuda_timeline_matches_plain(cuda_device, nsec, case):
    """K4 at each edge of its time-sliced scan, at every section count it
    takes, within 1e-5 of the plain version; one launch."""
    n, ch = TIMELINE_EDGES[case]
    rng = np.random.default_rng(40 + nsec
                                + 10 * list(TIMELINE_EDGES).index(case))
    co = cascade_windows(rng, 1, ch, nsec)[0]
    co, x = (t(a).to(cuda_device) for a in (
        co, rng.standard_normal((n, ch)).astype(np.float32)))
    K.reset_launch_counts()
    got = K.sosfilt_timeline(co, x)
    assert K.LAUNCHES['timeline'] == 1
    want = plain_on_cpu(K.sosfilt_timeline_plain, co, x)
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize('nsec', [1, 4])
@pytest.mark.parametrize('btype', ['lp', 'hp'])
def test_cuda_zero_state_poles_near_unit_circle(cuda_device, btype, nsec):
    """The slices' composed maps near the unit circle (a 30 Hz LowPass, a
    20 Hz HighPass, 1 and 4 sections, an input with a DC offset that drives
    the state to ~1/(1 - |p|) of it): K4 at the step shape and K3 at the
    render-ahead shape within 1e-5 of the plain versions."""
    rng = np.random.default_rng(50 + nsec)
    co = t(unit_circle_coeffs(btype, nsec, 16)).to(cuda_device)
    x = t(rng.standard_normal((1152, 8, 16)).astype(np.float32) + 1.0).to(
        cuda_device)
    got = K.sosfilt_timeline(co, x[:, 0])
    want = plain_on_cpu(K.sosfilt_timeline_plain, co, x[:, 0])
    assert float((got - want).abs().max()) <= TOL
    cob = co[None].expand(8, nsec, 16, 11)
    got = K.sosfilt_batch(cob, x, tail=1024)
    want = plain_on_cpu(K.sosfilt_batch_plain, cob, x, tail=1024)
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
def test_cuda_zero_state_views_in_place(cuda_device):
    """The kernels read their inputs through strides: overlapping windows
    of one timeline (an ``unfold`` view, as ``_batch_compute`` and
    ``_sampled_kernel`` pass them) give the bits of their gathered copy, a
    broadcast channel and broadcast coefficients the bits of contiguous
    copies, and the same call twice the same bits."""
    rng = np.random.default_rng(60)
    C, F, nb, ch = 128, 1024, 8, 16
    xt = t(rng.standard_normal((C + nb * F, ch)).astype(np.float32)).to(
        cuda_device)
    co = t(cascade_windows(rng, nb, ch, 2)).to(cuda_device)
    for L, step, tail in ((C + F, F, F), (C + 1, F, 1)):
        view = xt.unfold(0, L, step)[:nb].permute(2, 0, 1)
        assert not view.is_contiguous()
        idx = (torch.arange(L, device=cuda_device)[:, None]
               + step * torch.arange(nb, device=cuda_device)[None, :])
        got = K.sosfilt_batch(co, view, tail=tail)
        assert torch.equal(got, K.sosfilt_batch(co, xt[idx], tail=tail))
        assert torch.equal(got, K.sosfilt_batch(co, view, tail=tail))
    mono = xt[:C + F, :1]
    co1 = co[:, :, :1]
    got = K.sosfilt_batch(co1, mono[:, None, :].expand(C + F, nb, ch),
                          tail=F)
    want = K.sosfilt_batch(co1.expand(nb, 2, ch, 11).contiguous(),
                           mono[:, None, :].expand(C + F, nb, ch).contiguous(),
                           tail=F)
    assert torch.equal(got, want)
    got = K.sosfilt_timeline(co[0], xt[:C + F:3])
    assert torch.equal(got, K.sosfilt_timeline(co[0],
                                                xt[:C + F:3].contiguous()))
    assert torch.equal(got, K.sosfilt_timeline(co[0], xt[:C + F:3]))


def state_err(got, want):
    """Max-abs error of a coupled-form state against its plain version, in
    units of the state's scale (a low cutoff's state is many times its
    input: ~1/(1 - |pole|))."""
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize('case', list(TIMELINE_EDGES))
@pytest.mark.parametrize('nsec', [1, 2, 3, 4])
def test_cuda_stream_matches_plain(cuda_device, nsec, case):
    """The carried-state entry over one window at each edge of the scan and
    every section count: ``y`` within 1e-5 and ``zf`` within 1e-5 of its
    scale of the frame loop, one launch; the window cut into two calls (off
    the slice grid) continues to the same rows and end state."""
    n, ch = TIMELINE_EDGES[case]
    rng = np.random.default_rng(70 + nsec
                                + 10 * list(TIMELINE_EDGES).index(case))
    co, x, zi = (t(a).to(cuda_device) for a in (
        cascade_windows(rng, 1, ch, nsec)[0],
        rng.standard_normal((n, ch)).astype(np.float32),
        rng.standard_normal((nsec, 2, ch)).astype(np.float32)))
    K.reset_launch_counts()
    y, zf = K.sosfilt_stream(co, x, zi)
    assert K.LAUNCHES['stream'] == 1 and K.LAUNCHES['timeline'] == 0
    wy, wzf = (a.to(cuda_device) for a in K.sosfilt_stream_plain(
        co.cpu(), x.cpu(), zi.cpu()))
    assert y.shape == (n, ch) and zf.shape == (nsec, 2, ch)
    assert float((y - wy).abs().max()) <= TOL
    assert state_err(zf, wzf) <= TOL
    cut = n // 3 + 5
    ya, za = K.sosfilt_stream(co, x[:cut], zi)
    yb, zb = K.sosfilt_stream(co, x[cut:], za)
    assert float((torch.cat([ya, yb]) - y).abs().max()) <= TOL
    assert state_err(zb, zf) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['render_ahead', 'ragged_tail77',
                                  'L31_one_slice', 'tail1'])
@pytest.mark.parametrize('nsec', [1, 2, 3, 4])
def test_cuda_batch_state_matches_plain(cuda_device, nsec, case):
    """K3 with a start state per window and the end states returned."""
    L, B, ch, tail = BATCH_EDGES[case]
    rng = np.random.default_rng(80 + nsec + 10 * list(BATCH_EDGES).index(case))
    co, x, zi = (t(a).to(cuda_device) for a in (
        cascade_windows(rng, B, ch, nsec),
        rng.standard_normal((L, B, ch)).astype(np.float32),
        rng.standard_normal((B, nsec, 2, ch)).astype(np.float32)))
    K.reset_launch_counts()
    y, zf = K.sosfilt_batch(co, x, tail=tail, zi=zi, return_state=True)
    assert K.LAUNCHES['batch'] == 1
    wy, wzf = (a.to(cuda_device) for a in K.sosfilt_batch_plain(
        co.cpu(), x.cpu(), tail=tail, zi=zi.cpu(), return_state=True))
    assert y.shape == (tail, B, ch) and zf.shape == (B, nsec, 2, ch)
    assert float((y - wy).abs().max()) <= TOL
    assert state_err(zf, wzf) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize('nsec', [1, 2, 3, 4])
def test_cuda_null_state_is_the_zero_state_call(cuda_device, nsec):
    """Without ``zi`` and ``zf`` the kernel is the zero-state kernel it was:
    a zero ``zi`` gives the bits of no ``zi``, and asking for the end state
    changes no output bit — at the step, render-ahead and one-slice
    shapes."""
    rng = np.random.default_rng(90 + nsec)
    for n, ch in ((1152, 16), (1152, 1), (31, 2)):
        co, x = (t(a).to(cuda_device) for a in (
            cascade_windows(rng, 1, ch, nsec)[0],
            rng.standard_normal((n, ch)).astype(np.float32)))
        want = K.sosfilt_timeline(co, x)
        zero = torch.zeros((nsec, 2, ch), device=cuda_device)
        assert torch.equal(K.sosfilt_stream(co, x, zero)[0], want)
    for L, B, ch, tail in (BATCH_EDGES['render_ahead'],
                           BATCH_EDGES['L31_one_slice']):
        co, x = (t(a).to(cuda_device) for a in (
            cascade_windows(rng, B, ch, nsec),
            rng.standard_normal((L, B, ch)).astype(np.float32)))
        want = K.sosfilt_batch(co, x, tail=tail)
        zero = torch.zeros((B, nsec, 2, ch), device=cuda_device)
        assert torch.equal(K.sosfilt_batch(co, x, tail=tail, zi=zero), want)
        y, zf = K.sosfilt_batch(co, x, tail=tail, return_state=True)
        assert torch.equal(y, want) and bool(torch.isfinite(zf).all())


@pytest.mark.cuda
def test_cuda_state_views_in_place(cuda_device):
    """The carried-state entry reads views in place: the blocks of one
    timeline as non-overlapping windows (``mega_step``'s permuted view), a
    strided timeline, a broadcast channel and a one-channel state give the
    bits of their contiguous copies."""
    rng = np.random.default_rng(95)
    F, nb, ch = 1024, 16, 8
    xb = t(rng.standard_normal((nb, F, ch)).astype(np.float32)).to(cuda_device)
    co = t(cascade_windows(rng, nb, ch, 1)).to(cuda_device)
    zi = t(rng.standard_normal((nb, 1, 2, ch)).astype(np.float32)).to(
        cuda_device)
    view = xb.permute(1, 0, 2)
    assert not view.is_contiguous()
    y, zf = K.sosfilt_batch(co, view, tail=F, zi=zi, return_state=True)
    wy, wzf = K.sosfilt_batch(co, view.contiguous(), tail=F, zi=zi,
                              return_state=True)
    assert torch.equal(y, wy) and torch.equal(zf, wzf)
    x = xb.reshape(nb * F, ch)
    co1, z1 = co[0], zi[0]
    y, zf = K.sosfilt_stream(co1, x[:3 * F:3], z1)
    wy, wzf = K.sosfilt_stream(co1, x[:3 * F:3].contiguous(), z1)
    assert torch.equal(y, wy) and torch.equal(zf, wzf)
    mono = x[:F, :1].expand(F, ch)
    y, zf = K.sosfilt_stream(co1, mono, z1[:, :, :1])
    wy, wzf = K.sosfilt_stream(co1, mono.contiguous(),
                               z1[:, :, :1].expand(1, 2, ch).contiguous())
    assert torch.equal(y, wy) and torch.equal(zf, wzf)
