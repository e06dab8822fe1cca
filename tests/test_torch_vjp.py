"""The backward of the port's cascade kernels.

On the CPU every kernel entry runs as a ``torch.autograd.Function`` whose
backward is the plain adjoint (``compiler/filters.py``
``sosfilt_stream_vjp_plain`` under each entry's window, fold and group
logic).  Held here:

* the plain adjoint against ``torch.autograd.grad`` through the plain
  forward (the frame loop, no Function): within 1e-5 of the largest
  |gradient| of each output — 1 and 2 sections, a start state with the end
  state's cotangent, carry segments with per-block coefficients;
* each entry's gradients against ``jax.vjp`` of the JAX entry's backward,
  the scan reference its custom VJP differentiates
  (``signals_tpu/compiler/pallas_kernels.py:1574-1869``), at the shapes of
  ``tests/test_pallas_kernels.py:502, 560, 662, 806``: within 1e-3 of the
  largest |gradient| (the JAX package holds two of its own lowerings to
  1e-2, ``tests/test_learn.py:204-206``);
* B2's fold of overlapping windows into the timeline: a context longer than
  a carry segment, one channel read by many lanes, group sums;
* a numpy float32 model of B1 / B2's time-sliced adjoint scan
  (:func:`sliced_adjoint_model`) and one of B3's
  (:func:`rows_adjoint_model`) against the plain adjoint within 1e-5 at
  the edges of each scan (:data:`MODEL_CASES`, :data:`ROWS_MODEL_CASES`),
  and against the JAX package's gradients within 1e-3 at the kernels' own
  slicing;
* ``torch_refs.exact_rows_vjp``, the float64 reference B3 is held to on
  the card where a window is too long for the plain adjoint, against the
  plain adjoint.

The ``cuda`` cases hold each backward kernel (``csrc/adjoint.cu``: B1, B2,
B3) to its plain adjoint on the card, within 1e-5 of each output's largest
|value|, and two calls to the same bits — at the edges of their scans
(:data:`GEN_VJP_CASES`, :data:`SEG_VJP_CASES`, :data:`ROWS_VJP_CASES`);
they skip without a GPU.  JAX is
imported inside the JAX comparisons only, so they run on a machine without
JAX, from the repository root:
``python -m pytest --noconftest -m cuda tests/test_torch_vjp.py``.
"""

import numpy as np
import pytest
import torch

from signals_tpu_torch.compiler import kernels as K
from signals_tpu_torch.compiler.filters import (design_coupled,
                                                sosfilt_stream_scan,
                                                sosfilt_stream_vjp_plain)
from signals_tpu_torch.core.xp import NP

RATE = 44100
NYQ = np.float32(RATE / 2)
PLAIN_TOL = 1e-5     # plain adjoint vs autograd of the plain forward
JAX_TOL = 1e-3       # the port's entries vs jax.grad of the JAX entries


def lowpass(rng, n_blocks, lanes, lo=500.0, hi=5000.0):
    """Per-block, per-lane lowpass coefficients ``(n_blocks, 1, lanes,
    11)``."""
    cuts = rng.uniform(lo, hi, (1, n_blocks * lanes)).astype(np.float32)
    co = design_coupled(NP, 'lp', (cuts,), NYQ)
    return np.ascontiguousarray(
        co.reshape(1, n_blocks, lanes, 11).transpose(1, 0, 2, 3))


def bandpass(rng, n_blocks, lanes):
    """Per-block, per-lane band-pass coefficients ``(n_blocks, 2, lanes,
    11)``."""
    lo = rng.uniform(200.0, 800.0, (1, n_blocks * lanes)).astype(np.float32)
    hi = rng.uniform(2000.0, 6000.0, lo.shape).astype(np.float32)
    co = design_coupled(NP, 'bp', (lo, hi), NYQ)
    return np.ascontiguousarray(
        co.reshape(2, n_blocks, lanes, 11).transpose(1, 0, 2, 3))


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def torch_vjp(fn, inputs, cot):
    """``(outputs, grads)`` of ``fn`` at the numpy ``inputs`` (None: not
    differentiated) with cotangent ``cot`` (one array per output)."""
    ts = [None if a is None else torch.tensor(a).requires_grad_()
          for a in inputs]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    diff = [t for t in ts if t is not None]
    grads = torch.autograd.grad(outs, diff,
                                [torch.tensor(c) for c in cot])
    return [o.detach().numpy() for o in outs], [g.numpy() for g in grads]


# --- the plain adjoint against autograd of the plain forward --------------

@pytest.mark.parametrize('nsec,state', [(1, False), (2, False), (1, True),
                                        (2, True)])
def test_plain_adjoint_matches_autograd(nsec, state):
    rng = np.random.default_rng(nsec + 2 * state)
    n, ch = 96, 5
    co = (lowpass if nsec == 1 else bandpass)(rng, 1, ch)[0]
    x = normal(rng, n, ch)
    zi = (0.3 * normal(rng, nsec, 2, ch) if state
          else np.zeros((nsec, 2, ch), np.float32))
    gy, gzf = normal(rng, n, ch), normal(rng, nsec, 2, ch)
    _, want = torch_vjp(sosfilt_stream_scan, [co, x, zi],
                        [gy, gzf if state else np.zeros_like(gzf)])
    gco, gx, gzi = sosfilt_stream_vjp_plain(
        torch.tensor(co), torch.tensor(x), torch.tensor(zi),
        torch.tensor(gy), torch.tensor(gzf) if state else None)
    for name, g, w in (('coeffs', gco, want[0]), ('x', gx, want[1]),
                       ('zi', gzi, want[2])):
        assert rel_err(g.numpy(), w) <= PLAIN_TOL, name
    assert np.abs(gco.numpy()[..., :6]).max() == 0.0


@pytest.mark.parametrize('nsec', [1, 2])
def test_plain_adjoint_carry_segments_match_autograd(nsec):
    """Carry segments with per-block coefficients (m = 3), context rows
    under block 0's: the windows' adjoint against autograd through the
    plain forward."""
    rng = np.random.default_rng(10 + nsec)
    nb, F, C, lanes, m = 6, 32, 48, 4, 3
    co = (lowpass if nsec == 1 else bandpass)(rng, nb, lanes)
    x = normal(rng, C + nb * F, lanes)
    kw = dict(n_segments=nb, seg_frames=F, context=C, blocks_per_seg=m)
    gy = normal(rng, nb, F, lanes)
    _, want = torch_vjp(lambda c, xx: K.sosfilt_segments_plain(c, xx, **kw),
                        [co, x], [gy])
    gco, gx = K.sosfilt_segments_vjp_plain(torch.tensor(co), torch.tensor(x),
                                           torch.tensor(gy), **kw)
    assert rel_err(gco.numpy(), want[0]) <= PLAIN_TOL
    assert rel_err(gx.numpy(), want[1]) <= PLAIN_TOL


@pytest.mark.parametrize('case', ['long_context', 'one_channel', 'groups'])
def test_segments_fold(case):
    """B2's fold of the overlapping windows' input cotangents into the
    timeline: a context longer than a carry segment (three windows overlap
    a row), one channel read by every lane (its cotangent is the sum over
    the lanes), group sums (lane l reads group l // g's cotangent) — the
    entry's Function against autograd through the plain forward."""
    rng = np.random.default_rng({'long_context': 0, 'one_channel': 1,
                                 'groups': 2}[case])
    nb, F, lanes = 6, 16, 8
    C, m, g, ch_x = {'long_context': (80, 2, 0, lanes),
                     'one_channel': (48, 2, 0, 1),
                     'groups': (32, 1, 4, lanes)}[case]
    co = lowpass(rng, nb, lanes)
    x = normal(rng, C + nb * F, ch_x)
    kw = dict(n_segments=nb, seg_frames=F, context=C, blocks_per_seg=m,
              sum_groups=g)
    gy = normal(rng, nb, F, lanes // g if g else lanes)

    def plain(c, xx):
        c, xx = K._timeline(c, xx, nb, F, C)
        return K.sosfilt_segments_plain(c, xx, **kw)

    _, want = torch_vjp(plain, [co, x], [gy])
    _, got = torch_vjp(lambda c, xx: K.sosfilt_segments(c, xx, **kw),
                       [co, x], [gy])
    assert got[1].shape == x.shape
    for a, b in zip(got, want):
        assert rel_err(a, b) <= PLAIN_TOL


def test_fold_windows_sums_in_window_order():
    """``_fold_windows`` against an explicit loop over windows."""
    rng = np.random.default_rng(3)
    n_units, W, step, lanes = 5, 23, 7, 3
    gxw = normal(rng, n_units, W, lanes)
    n_rows = (n_units - 1) * step + W
    want = np.zeros((n_rows, lanes), np.float32)
    for u in range(n_units):
        want[u * step:u * step + W] += gxw[u]
    got = K._fold_windows(torch.tensor(gxw), n_rows, step).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# --- the entries' Functions against jax.grad of the JAX entries ------------
#
# The JAX package's entries run their Pallas kernel forward and, backward,
# the VJP of their scan reference (``pallas_kernels._make_cv``): their
# gradients are ``jax.vjp`` of that reference, which is what these tests
# take (the interpret-mode forward would only add minutes of CPU time).


def jax_vjp(fn, inputs, cot):
    """``jax.vjp`` of ``fn`` at the numpy ``inputs`` with cotangent ``cot``
    (an array or a tuple of arrays), jitted as one program (op-by-op
    dispatch compiles every primitive on its own: several times slower)."""
    import jax
    import jax.numpy as jnp

    def run(args, c):
        return jax.vjp(fn, *args)[1](c)

    cot = (tuple(map(jnp.asarray, cot)) if isinstance(cot, tuple)
           else jnp.asarray(cot))
    grads = jax.jit(run)(tuple(jnp.asarray(a) for a in inputs), cot)
    return [np.asarray(g) for g in grads]


def jax_windows_ref(context, seg_frames, blocks_per_seg, sum_groups):
    """The JAX package's segment reference (``pallas_kernels.py:1752-1772``):
    ``(coeffs (n_blocks, nsec, lanes, 11), xw (n_units, C + m*F, lanes)) ->
    (n_blocks, F, lanes or lanes // g)``: the context rows under block 0's
    coefficients from zero state, then the blocks with the state carried."""
    import jax
    import jax.numpy as jnp
    from signals_tpu.compiler.filters import sosfilt_scan, sosfilt_stream
    C, F, m = context, seg_frames, blocks_per_seg

    def one_seg(co_m, xw):
        if m == 1:                   # the reference of _segments_cv at m = 1
            return sosfilt_scan(co_m[0], xw)[C:]
        nsec, ch = co_m.shape[1], xw.shape[1]
        z = jnp.zeros((nsec, 2, ch), jnp.float32)
        _, z = sosfilt_stream(co_m[0], xw[:C], z)

        def body(z, args):
            y, z = sosfilt_stream(*args, z)
            return z, y

        _, ys = jax.lax.scan(body, z, (co_m, xw[C:].reshape(m, F, ch)))
        return ys.reshape(m * F, ch)

    def ref(co, xw):
        n_units = xw.shape[0]
        co_m = co.reshape((n_units, m) + co.shape[1:])
        y = jax.vmap(one_seg)(co_m, xw).reshape(n_units * m, F, -1)
        if sum_groups:
            y = y.reshape(y.shape[0], F, -1, sum_groups).sum(axis=3)
        return y

    return ref


def test_batch_grads_match_jax():
    """``sosfilt_batch`` at ``tests/test_pallas_kernels.py:502``'s shape
    against ``_batch_cv``'s reference (a vmap of ``sosfilt_scan``)."""
    import jax
    from signals_tpu.compiler.filters import sosfilt_scan
    rng = np.random.default_rng(0)
    B, L, ch, tail = 3, 64, 4, 32
    co, x = lowpass(rng, B, ch), normal(rng, L, B, ch)
    gy = normal(rng, tail, B, ch)
    want = jax_vjp(lambda c, xx: jax.vmap(sosfilt_scan, in_axes=(0, 1),
                                          out_axes=1)(c, xx)[L - tail:],
                   [co, x], gy)
    _, got = torch_vjp(lambda c, xx: K.sosfilt_batch(c, xx, tail=tail),
                       [co, x], [gy])
    for a, b in zip(got, want):
        assert rel_err(a, b) <= JAX_TOL


def test_timeline_grads_match_jax():
    """``sosfilt_timeline`` (two sections) against ``_pallas_cv``'s
    reference, ``sosfilt_scan``."""
    from signals_tpu.compiler.filters import sosfilt_scan
    rng = np.random.default_rng(1)
    co, x = bandpass(rng, 1, 6)[0], normal(rng, 200, 6)
    gy = normal(rng, 200, 6)
    want = jax_vjp(sosfilt_scan, [co, x], gy)
    _, got = torch_vjp(K.sosfilt_timeline, [co, x], [gy])
    for a, b in zip(got, want):
        assert rel_err(a, b) <= JAX_TOL


@pytest.mark.parametrize('nsec', [1, 2])
def test_stream_grads_match_jax(nsec):
    """``sosfilt_stream`` from a non-zero start state, with the end state's
    cotangent, against ``jax.grad`` of the JAX package's
    ``filters.sosfilt_stream`` (an associative scan in its XLA program)."""
    from signals_tpu.compiler import filters as JF
    rng = np.random.default_rng(4 + nsec)
    ch, n = 4, 160
    co = (lowpass if nsec == 1 else bandpass)(rng, 1, ch)[0]
    x, zi = normal(rng, n, ch), 0.5 * normal(rng, nsec, 2, ch)
    gy, gzf = normal(rng, n, ch), normal(rng, nsec, 2, ch)
    want = jax_vjp(JF.sosfilt_stream, [co, x, zi], (gy, gzf))
    _, got = torch_vjp(K.sosfilt_stream, [co, x, zi], [gy, gzf])
    for name, a, b in zip(('coeffs', 'x', 'zi'), got, want):
        assert rel_err(a, b) <= JAX_TOL, name


def test_segments_grads_match_jax():
    """``sosfilt_segments`` with group sums at
    ``tests/test_pallas_kernels.py:502``'s second shape against
    ``_segments_cv``'s reference over the gathered windows."""
    rng = np.random.default_rng(2)
    ns, sf, C, chs = 4, 128, 128, 64
    co, x = lowpass(rng, ns, chs), normal(rng, C + ns * sf, chs)
    kw = dict(n_segments=ns, seg_frames=sf, context=C, sum_groups=8)
    gy = normal(rng, ns, sf, chs // 8)
    idx = np.arange(ns)[:, None] * sf + np.arange(C + sf)[None, :]
    ref = jax_windows_ref(C, sf, 1, 8)
    want = jax_vjp(lambda c, xx: ref(c, xx[idx]), [co, x], gy)
    _, got = torch_vjp(lambda c, xx: K.sosfilt_segments(c, xx, **kw),
                       [co, x], [gy])
    for a, b in zip(got, want):
        assert rel_err(a, b) <= JAX_TOL


@pytest.mark.parametrize('osc', ['sine', 'saw_carry'])
def test_segments_gen_grads_match_jax(osc):
    """``sosfilt_segments_gen`` against ``_segments_gen_cv``'s reference
    (``_gen_source_rows`` then the segment reference): a sine over
    per-block segments summed over every lane (``tests/test_pallas_kernels.
    py:560``, 256 lanes here; the hertz gradients must be non-zero) and a
    saw with phases over 4-block carry segments (``:806``); coefficient and
    ``lanef`` gradients."""
    import jax.numpy as jnp
    from signals_tpu.compiler.pallas_kernels import _gen_source_rows
    rng = np.random.default_rng(5)
    if osc == 'sine':
        ns, sf, C, lanes, m, code, g = 2, 128, 128, 256, 1, K.OSC_SINE, 256
    else:
        ns, sf, C, lanes, m, code, g = 4, 256, 256, 16, 4, K.OSC_SAW, 8
    co = lowpass(rng, ns, lanes)
    toff = np.full((lanes,), -C, np.int32)
    lanef = np.stack([rng.uniform(100.0, 1000.0, lanes),
                      rng.uniform(0.0, 0.5, lanes) if m > 1
                      else np.zeros(lanes),
                      np.ones(lanes)]).astype(np.float32)
    kw = dict(n_segments=ns, seg_frames=sf, context=C, osc_code=code,
              rate=RATE, sum_groups=g, blocks_per_seg=m)
    gy = normal(rng, ns, sf, lanes // g)
    ref = jax_windows_ref(C, sf, m, g)

    def jax_fn(c, lf):
        xw = _gen_source_rows(jnp.asarray(toff), lf, n_segments=ns // m,
                              seg_frames=m * sf, context=C, osc_code=code,
                              rate=RATE)
        return ref(c, xw)

    want = jax_vjp(jax_fn, [co, lanef], gy)
    _, got = torch_vjp(lambda c, lf: K.sosfilt_segments_gen(
        c, torch.tensor(toff), lf, **kw), [co, lanef], [gy])
    assert np.abs(got[1][0]).max() > 0          # hertz gradients
    for name, a, b in zip(('coeffs', 'lanef'), got, want):
        assert rel_err(a, b) <= JAX_TOL, name


@pytest.mark.parametrize('entry', ['segments', 'batch'])
def test_squared_loss_grads_match_jax(entry):
    """``sum(y ** 2)`` through ``sosfilt_segments`` (20 segments, sum of 8)
    and ``sosfilt_batch`` (20 windows, tail 32) at
    ``tests/test_pallas_kernels.py:662``'s shapes, random coefficients,
    against ``jax.grad`` of the same loss on the JAX package's scan
    reference."""
    import jax
    import jax.numpy as jnp
    from signals_tpu.compiler.filters import sosfilt_scan
    rng = np.random.default_rng(8)
    if entry == 'segments':
        ns, sf, C, chs = 20, 64, 64, 64
        x = normal(rng, C + ns * sf, chs)
        co = 0.1 * normal(rng, ns, 1, chs, 11)
        idx = np.arange(ns)[:, None] * sf + np.arange(C + sf)[None, :]

        def jloss(c, xx):
            yb = jax.vmap(sosfilt_scan)(c, xx[idx])[:, C:, :]
            return jnp.sum(yb.reshape(ns, sf, -1, 8).sum(axis=3) ** 2)

        def ploss(c, xx):
            return (K.sosfilt_segments(c, xx, n_segments=ns, seg_frames=sf,
                                       context=C, sum_groups=8) ** 2).sum()
    else:
        B, L, ch, tail = 20, 64, 4, 32
        x = normal(rng, L, B, ch)
        co = 0.1 * normal(rng, B, 1, ch, 11)

        def jloss(c, xx):
            y = jax.vmap(sosfilt_scan, in_axes=(0, 1), out_axes=1)(c, xx)
            return jnp.sum(y[L - tail:] ** 2)

        def ploss(c, xx):
            return (K.sosfilt_batch(c, xx, tail=tail) ** 2).sum()

    want = [np.asarray(g) for g in jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jnp.asarray(co), jnp.asarray(x))]
    ts = [torch.tensor(a).requires_grad_() for a in (co, x)]
    got = torch.autograd.grad(ploss(*ts), ts)
    for name, a, b in zip(('coeffs', 'x'), got, want):
        assert rel_err(a.numpy(), b) <= JAX_TOL, name


def test_no_grad_calls_save_nothing():
    """Without an input that requires grad an entry runs its plain forward:
    no autograd node, the serving paths' launch counts and memory."""
    rng = np.random.default_rng(6)
    co = torch.tensor(lowpass(rng, 1, 4)[0])
    x = torch.tensor(normal(rng, 64, 4))
    assert K.sosfilt_timeline(co, x).grad_fn is None
    with torch.no_grad():
        y = K.sosfilt_timeline(co, x.requires_grad_())
    assert y.grad_fn is None


# --- a numpy model of B1 / B2's time-sliced adjoint scan --------------------
#
# ``csrc/adjoint.cu``'s ``seg_cascade_vjp`` cuts each carry segment's rows
# into slices and runs the forward and the adjoint recurrences as scans of
# affine maps over complex numbers; it runs only on a card.  This model
# follows it step for step in float32 (as ``tests/test_torch_kernels.py``'s
# ``slice_scan_model`` follows the forward's scan), so that its algebra is
# held to the plain adjoint and to the JAX package's gradients here.


def _cmul(a, b):
    """Complex product of (re, im) pairs of f32 arrays, as ``scan.cuh``."""
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def _pow16(p):
    """``adjoint.cu``'s ``pow_rows_rn``: p^16 by squaring in float64,
    rounded once."""
    re, im = p[0].astype(np.float64), p[1].astype(np.float64)
    for _ in range(4):
        re, im = re * re - im * im, 2.0 * re * im
    return re.astype(np.float32), im.astype(np.float32)


def _scan_maps(a, e, reverse=False):
    """``scan.cuh``'s ``slice_start``: the exclusive Hillis-Steele scan of
    the slices' maps ``z -> a*z + e`` along axis 0 (``reverse``: from the
    last slice down, ``slice_start<true>``); the first slice in scan order
    starts from zero."""
    if reverse:
        flip = [c[::-1] for c in a], [c[::-1] for c in e]
        return tuple(c[::-1] for c in _scan_maps(*flip))
    n = a[0].shape[0]
    d = 1
    while d < n:
        pa = tuple(np.concatenate([np.zeros_like(c[:d]), c[:-d]]) for c in a)
        pe = tuple(np.concatenate([np.zeros_like(c[:d]), c[:-d]]) for c in e)
        na, ne = _cmul(a, pa), _cmul(a, pe)
        keep = (np.arange(n) >= d)[:, None]
        a = tuple(np.where(keep, u, c) for u, c in zip(na, a))
        e = tuple(np.where(keep, u + c, c) for u, c in zip(ne, e))
        d *= 2
    return tuple(np.concatenate([np.zeros_like(c[:1]), c[:-1]]) for c in e)


def vjp_slice_rows(n_units, lanes, n_rows, min_slice=64, most=512,
                   fill=132 * 2048 // 4):
    """Rows per slice as ``scan.cuh``'s ``plan_slices`` cuts ``n_units``
    runs on an H100 (132 SMs): ``seg_cascade_vjp``'s carry segments with
    the defaults (slices of 64 rows at least, 512 threads a block at most),
    ``rows_cascade_vjp``'s windows with ``min_slice=16`` and ``most`` its
    threads a block (256 at 3-4 sections)."""
    def slices(lt):
        return max(1, min(most // lt, n_rows // min_slice))
    lt = 1
    while lt < lanes and lt < 32:
        lt *= 2
    while lt > 1:
        threads = n_units * -(-lanes // lt) * lt * slices(lt)
        if threads >= fill or slices(lt // 2) <= slices(lt):
            break
        lt //= 2
    return -(-(-(-n_rows // slices(lt))) // 16) * 16


def sliced_adjoint_model(coeffs, xw, gy, *, seg_frames, context,
                         blocks_per_seg, sum_groups, slice_rows):
    """``(gxw, gcoeffs)`` as :func:`K._cascade_windows_vjp_plain` returns
    them, computed as ``seg_cascade_vjp`` does with slices of
    ``slice_rows`` rows (a multiple of 16): (1) per section, first to last,
    each slice's forward map from zero state (the transfer per 16-row chunk
    p^16 where the chunk is one coefficient block, per row elsewhere) and
    the exclusive scan of the maps, the last pass keeping each chunk's
    start states and the last section's transfer so far; (2) per section,
    last to first, each slice's lambda map from zero, its transfer the
    conjugate of the forward's, and the reversed scan (section s-1's pass
    replays section s's lambda from its true value); (3) per chunk from the
    last, the forward rows recomputed from the chunk's start states and
    each section's adjoint rows back over them, one partial gradient per
    slice and coefficient block; (4) each block's partials summed in slice
    order."""
    f32 = np.float32
    F, C, m, S = seg_frames, context, blocks_per_seg, slice_rows
    n_blocks, nsec, lanes, _ = coeffs.shape
    U, R = n_blocks // m, C + m * F
    n, n_ch, NL = -(-R // S), S // 16, U * lanes
    rows = np.arange(n)[:, None] * S + np.arange(S)[None, :]
    valid = rows < R                                      # (n, S)
    rr = np.minimum(rows, R - 1)
    blk = np.where(rr < C + F, 0, np.minimum((rr - C) // F, m - 1))
    taps = coeffs.reshape(U, m, nsec, lanes, 11)[:, blk]  # (U, n, S, ...)
    taps = taps.transpose(3, 5, 1, 2, 0, 4).reshape(nsec, 11, n, S, NL)
    rc, rs, d0, d1, d2 = (taps[:, k] for k in range(6, 11))
    x = np.where(valid[..., None],
                 xw.transpose(1, 0, 2).reshape(R, NL)[rr], f32(0))
    gl = np.repeat(gy, sum_groups, axis=-1) if sum_groups else gy
    gl = gl.reshape(U, m * F, lanes).transpose(1, 0, 2).reshape(m * F, NL)
    gl = np.concatenate([np.zeros((C, NL), f32), gl])
    g_rows = np.where(valid[..., None], gl[rr], f32(0))
    first = rows[:, ::16]
    straight = (first + 15 < R) & (blk[:, ::16] == blk[:, 15::16])
    zero = np.zeros((n, NL), f32)
    one = np.ones((n, NL), f32)

    def step(s, j, v, st, ok):
        s1, s2 = st
        y = d0[s, :, j] * v + d1[s, :, j] * s1 + d2[s, :, j] * s2
        n1 = rc[s, :, j] * s1 - rs[s, :, j] * s2 + v
        n2 = rs[s, :, j] * s1 + rc[s, :, j] * s2
        return y, (np.where(ok, n1, s1), np.where(ok, n2, s2))

    def lam_step(s, j, g, lam, ok):
        l1, l2 = lam
        gv = d0[s, :, j] * g + l1
        n1 = rc[s, :, j] * l1 + rs[s, :, j] * l2 + d1[s, :, j] * g
        n2 = rc[s, :, j] * l2 - rs[s, :, j] * l1 + d2[s, :, j] * g
        return gv, (np.where(ok, n1, l1), np.where(ok, n2, l2))

    # 1. the forward states' true starts, section by section
    st = [(zero, zero)] * nsec
    starts, trans, ck = [None] * nsec, [None] * nsec, []
    for sec in range(nsec):
        state = [starts[s] for s in range(sec)] + [(zero, zero)]
        a = (one, zero)
        for c in range(n_ch):
            if sec == nsec - 1:
                ck.append(list(state) + [a])
            j0 = 16 * c
            pk = _pow16((rc[sec, :, j0], rs[sec, :, j0]))
            for i in range(16):
                j = j0 + i
                ok = valid[:, j][:, None]
                v = x[:, j]
                for s in range(sec + 1):
                    v, state[s] = step(s, j, v, state[s], ok)
                row = _cmul((rc[sec, :, j], rs[sec, :, j]), a)
                a = tuple(np.where(ok & ~straight[:, c, None], r, q)
                          for r, q in zip(row, a))
            a = tuple(np.where(straight[:, c, None], r, q)
                      for r, q in zip(_cmul(pk, a), a))
        trans[sec] = a
        starts[sec] = _scan_maps(a, state[sec])

    # 2. lambda after each slice, section by section from the last
    lam_end = [None] * nsec
    for sec in range(nsec - 1, -1, -1):
        lam = [lam_end[s] if s > sec else (zero, zero) for s in range(nsec)]
        for j in range(S - 1, -1, -1):
            ok = valid[:, j][:, None]
            g = g_rows[:, j]
            for s in range(nsec - 1, sec - 1, -1):
                g, lam[s] = lam_step(s, j, g, lam[s], ok)
        conj = (trans[sec][0], -trans[sec][1])
        lam_end[sec] = _scan_maps(conj, lam[sec], reverse=True)

    # 3. the replay from the last chunk back, a partial per slice and block
    lam = list(lam_end)
    part = np.zeros((nsec, n, m, 5, NL), f32)
    acc = np.zeros((nsec, 5, n, NL), f32)
    ab = np.repeat(blk[np.arange(n), np.minimum(S, R - np.arange(n) * S)
                       - 1][None], nsec, axis=0)
    gx = np.zeros((n, S, NL), f32)
    ks = np.arange(n)
    for c in range(n_ch - 1, -1, -1):
        cs = list(ck[c][:nsec])
        fix = _cmul(ck[c][nsec], starts[nsec - 1])
        cs[-1] = (cs[-1][0] + fix[0], cs[-1][1] + fix[1])
        cols = range(16 * c, 16 * c + 16)
        vs = [[x[:, j] for j in cols]]
        for s in range(nsec - 1):
            state, out = cs[s], []
            for j in cols:
                y, state = step(s, j, vs[s][j - 16 * c], state,
                                valid[:, j][:, None])
                out.append(y)
            vs.append(out)
        g = [g_rows[:, j] for j in cols]
        for s in range(nsec - 1, -1, -1):
            state, lagged = cs[s], []
            for j in cols:
                lagged.append(state)
                _, state = step(s, j, vs[s][j - 16 * c], state,
                                valid[:, j][:, None])
            for i in range(15, -1, -1):
                j = 16 * c + i
                ok = valid[:, j]
                moved = ok & (blk[:, j] != ab[s])
                part[s, ks[moved], ab[s][moved]] = acc[s][:, moved].transpose(
                    1, 0, 2)
                acc[s][:, moved] = 0
                ab[s] = np.where(moved, blk[:, j], ab[s])
                (s1, s2), l1, l2 = lagged[i], lam[s][0], lam[s][1]
                terms = (l1 * s1 + l2 * s2, l2 * s1 - l1 * s2,
                         g[i] * vs[s][i], g[i] * s1, g[i] * s2)
                for t, term in enumerate(terms):
                    acc[s][t] = np.where(ok[:, None], acc[s][t] + term,
                                         acc[s][t])
                g[i], lam[s] = lam_step(s, j, g[i], lam[s], ok[:, None])
        for i, j in enumerate(cols):
            gx[:, j] = g[i]
    for s in range(nsec):
        part[s, ks, ab[s]] = acc[s].transpose(1, 0, 2)

    # 4. each block's partials summed in slice order
    gco = np.zeros((n_blocks, nsec, lanes, 11), f32)
    for b in range(m):
        ra = 0 if b == 0 else C + b * F
        rb = C + (b + 1) * F if b + 1 < m else R
        total = np.zeros((nsec, 5, NL), f32)
        for k in range(ra // S, (rb - 1) // S + 1):
            total = total + part[:, k, b]
        total = total.reshape(nsec, 5, U, lanes).transpose(2, 0, 3, 1)
        gco[b::m, :, :, 6:] = total
    gxw = gx.reshape(n * S, NL)[:R].reshape(R, U, lanes).transpose(1, 0, 2)
    return gxw, gco


#: the model's edges: (sections, lanes, blocks, F, C, m, sum group, slice
#: rows, LowPass cutoffs or None for a band-pass)
MODEL_CASES = {
    # C 40, F 48: the context ends and blocks 1-2 begin inside slices and
    # inside 16-row chunks
    'block_and_context_boundaries': (1, 3, 6, 48, 40, 3, 0, 32,
                                     (500.0, 5000.0)),
    'one_slice': (1, 4, 4, 32, 40, 2, 0, 112, (500.0, 5000.0)),
    'ragged_last_slice': (1, 4, 4, 40, 24, 2, 0, 48, (500.0, 5000.0)),
    'two_sections': (2, 3, 6, 48, 40, 3, 0, 32, None),
    'groups': (1, 8, 4, 32, 32, 2, 4, 32, (500.0, 5000.0)),
    # F 12 < 16: chunks that hold two block boundaries, a slice touching
    # four blocks
    'short_blocks_two_sections_groups': (2, 6, 8, 12, 20, 4, 3, 48, None),
    'pole_near_unit_circle': (1, 3, 4, 64, 64, 2, 0, 32, (30.0, 30.0)),
    'pole_far_from_unit_circle': (1, 3, 4, 64, 64, 2, 0, 32,
                                  (15000.0, 18000.0)),
}


@pytest.mark.parametrize('case', list(MODEL_CASES))
def test_sliced_adjoint_model_matches_plain(case):
    """The f32 algebra of B1 / B2's time-sliced adjoint scan meets the
    plain adjoint (``_cascade_windows_vjp_plain``) within 1e-5 of each
    output's largest |value|: slices that straddle a coefficient-block and
    the context/segment boundary, one slice, a ragged last slice, two
    sections, group sums, chunks with two block boundaries, and poles near
    (30 Hz) and far (15-18 kHz) from the unit circle."""
    nsec, lanes, nb, F, C, m, g, S, cuts = MODEL_CASES[case]
    rng = np.random.default_rng(90 + list(MODEL_CASES).index(case))
    co = (bandpass(rng, nb, lanes) if cuts is None
          else lowpass(rng, nb, lanes, *cuts))
    R = C + m * F
    xw = normal(rng, nb // m, R, lanes) + np.float32(0.5)
    gy = normal(rng, nb, F, lanes // g if g else lanes)
    kw = dict(seg_frames=F, context=C, blocks_per_seg=m, sum_groups=g)
    got = sliced_adjoint_model(co, xw, gy, slice_rows=S, **kw)
    want = K._cascade_windows_vjp_plain(torch.tensor(co), torch.tensor(xw),
                                        torch.tensor(gy), **kw)
    for name, a, b in zip(('gxw', 'gcoeffs'), got, want):
        assert rel_err(a, b.numpy()) <= PLAIN_TOL, name
    if case == 'one_slice':
        assert R <= S
    if case == 'ragged_last_slice':
        assert -(-R // S) == 3 and R % S
    if case == 'block_and_context_boundaries':
        # block 1 starts at row 88 and block 2 at 136, inside slices 2 and 4
        assert (C + F) % S and (C + 2 * F) % S and C % S


@pytest.mark.parametrize('entry', ['segments', 'segments_gen'])
def test_sliced_adjoint_model_matches_jax(entry):
    """The model at the kernel's own slicing on an H100 against ``jax.vjp``
    of the JAX package's segment reference, at the shapes of
    :func:`test_segments_grads_match_jax` (sum of 8) and the saw over
    4-block carry segments of :func:`test_segments_gen_grads_match_jax`
    (the source rows' cotangent taken to ``lanef`` as the entry does)."""
    import jax.numpy as jnp
    from signals_tpu.compiler.pallas_kernels import _gen_source_rows
    rng = np.random.default_rng(5 if entry == 'segments_gen' else 2)
    if entry == 'segments':
        ns, sf, C, lanes, m, g = 4, 128, 128, 64, 1, 8
        co, x = lowpass(rng, ns, lanes), normal(rng, C + ns * sf, lanes)
        idx = np.arange(ns)[:, None] * sf + np.arange(C + sf)[None, :]
        xw = x[idx]
    else:
        ns, sf, C, lanes, m, g = 4, 256, 256, 16, 4, 8
        co = lowpass(rng, ns, lanes)
        toff = np.full((lanes,), -C, np.int32)
        lanef = np.stack([rng.uniform(100.0, 1000.0, lanes),
                          rng.uniform(0.0, 0.5, lanes),
                          np.ones(lanes)]).astype(np.float32)
        gen = dict(n_segments=ns // m, seg_frames=m * sf, context=C,
                   osc_code=K.OSC_SAW, rate=RATE)
        xw = K.gen_source_rows(torch.tensor(toff), torch.tensor(lanef),
                               **gen).numpy()
    gy = normal(rng, ns, sf, lanes // g)
    S = vjp_slice_rows(ns // m, lanes, C + m * sf)
    assert -(-(C + m * sf) // S) > 1
    gxw, gco = sliced_adjoint_model(co, xw, gy, seg_frames=sf, context=C,
                                    blocks_per_seg=m, sum_groups=g,
                                    slice_rows=S)
    ref = jax_windows_ref(C, sf, m, g)
    if entry == 'segments':
        want = jax_vjp(ref, [co, xw], gy)
        got = [gco, gxw]
    else:
        def jax_fn(c, lf):
            return ref(c, _gen_source_rows(jnp.asarray(toff), lf, **gen))
        want = jax_vjp(jax_fn, [co, lanef], gy)
        kw = dict(gen, n_segments=ns, seg_frames=sf, blocks_per_seg=m)
        glanef = K._source_lanef_grad(torch.tensor(toff),
                                      torch.tensor(lanef),
                                      torch.tensor(gxw), kw)
        got = [gco, glanef.numpy()]
    for name, a, b in zip(('coeffs', 'input'), got, want):
        assert rel_err(a, b) <= JAX_TOL, name


# --- a numpy model of B3's time-sliced adjoint scan --------------------------
#
# ``csrc/adjoint.cu``'s ``rows_cascade_vjp`` cuts each window's L rows into
# slices as ``csrc/rows.cu`` does and runs the same scans as B1 / B2 under
# one coefficient set a window, with the window's first slice starting from
# ``zi`` and its last slice's lambda from ``gzf``.  This model follows it
# step for step in float32.


def rows_adjoint_model(coeffs, x_t, gy, *, tail, zi, gzf, slice_rows):
    """``(gcoeffs, gx, gzi)`` as :func:`K.sosfilt_batch_vjp_plain` returns
    them, computed as ``rows_cascade_vjp`` does with slices of
    ``slice_rows`` rows (a multiple of 16) over windows ``x_t`` ``(L, B,
    ch)`` under ``coeffs`` ``(B, nsec, ch, 11)``: (1) per section, first to
    last, each slice's forward map from zero state (the first slice from
    ``zi``; the transfer p^16 a 16-row chunk, per row in a ragged last
    chunk) and the exclusive scan, the last pass keeping each chunk's start
    states and the last section's transfer so far where a slice holds more
    than one chunk; (2) per section, last to first, each slice's lambda map
    from zero (the last slice from ``gzf``), its transfer the conjugate of
    the forward's, through the warmup rows too, and the reversed scan; (3)
    per chunk from the last, the forward rows recomputed from the
    checkpoints (one chunk a slice: the true starts) and each section's
    adjoint rows back over them, ``gzi`` lambda before the first row; (4)
    one partial gradient per slice, summed in slice order."""
    f32 = np.float32
    L, B, ch = x_t.shape
    nsec, NL, S = coeffs.shape[1], B * ch, slice_rows
    n, n_ch = -(-L // S), S // 16
    rows = np.arange(n)[:, None] * S + np.arange(S)[None, :]
    valid = rows < L                                       # (n, S)
    rr = np.minimum(rows, L - 1)
    taps = coeffs.transpose(1, 3, 0, 2).reshape(nsec, 11, NL)
    rc, rs, d0, d1, d2 = (taps[:, k] for k in range(6, 11))
    x = np.where(valid[..., None], x_t.reshape(L, NL)[rr], f32(0))
    gl = np.concatenate([np.zeros((L - tail, NL), f32),
                         gy.reshape(tail, NL)])
    g_rows = np.where(valid[..., None], gl[rr], f32(0))
    straight = rows[:, ::16] + 15 < L                      # (n, n_ch)
    zero = np.zeros((n, NL), f32)
    ks = np.arange(n)[:, None]

    def edge(z, k):
        """Section states of z at slice k only: zi (k = 0), gzf (last)."""
        if z is None:
            return [(zero, zero)] * nsec
        z = z.transpose(1, 2, 0, 3).reshape(nsec, 2, NL)
        return [tuple(np.where(ks == k, z[s, j][None], f32(0))
                      for j in (0, 1)) for s in range(nsec)]

    def step(s, v, st, ok):
        s1, s2 = st
        y = d0[s] * v + d1[s] * s1 + d2[s] * s2
        n1 = rc[s] * s1 - rs[s] * s2 + v
        n2 = rs[s] * s1 + rc[s] * s2
        return y, (np.where(ok, n1, s1), np.where(ok, n2, s2))

    def lam_step(s, g, lam, ok):
        l1, l2 = lam
        gv = d0[s] * g + l1
        n1 = rc[s] * l1 + rs[s] * l2 + d1[s] * g
        n2 = rc[s] * l2 - rs[s] * l1 + d2[s] * g
        return gv, (np.where(ok, n1, l1), np.where(ok, n2, l2))

    def add(u, w):
        return u[0] + w[0], u[1] + w[1]

    # 1. the forward states' true starts, section by section
    init, ginit = edge(zi, 0), edge(gzf, n - 1)
    start, trans, ck, last = [None] * nsec, [None] * nsec, [], None
    for sec in range(nsec):
        state = [start[s] for s in range(sec)] + [init[sec]]
        p = (rc[sec], rs[sec])
        pk = _pow16(p)
        a = (np.ones((n, NL), f32), zero)
        for c in range(n_ch):
            if sec == nsec - 1 and n_ch > 1:
                ck.append(list(state) + [a])
            for i in range(16):
                j = 16 * c + i
                ok = valid[:, j][:, None]
                v = x[:, j]
                for s in range(sec + 1):
                    v, state[s] = step(s, v, state[s], ok)
                row = _cmul(p, a)
                a = tuple(np.where(ok & ~straight[:, c, None], r, q)
                          for r, q in zip(row, a))
            a = tuple(np.where(straight[:, c, None], r, q)
                      for r, q in zip(_cmul(pk, a), a))
        trans[sec] = a
        last = _scan_maps(a, state[sec])
        start[sec] = add(last, init[sec])

    # 2. lambda after each slice, section by section from the last
    lam_end = [None] * nsec
    for sec in range(nsec - 1, -1, -1):
        lam = [lam_end[s] if s > sec else ginit[s] if s == sec
               else (zero, zero) for s in range(nsec)]
        for j in range(S - 1, -1, -1):
            ok = valid[:, j][:, None]
            g = g_rows[:, j]
            for s in range(nsec - 1, sec - 1, -1):
                g, lam[s] = lam_step(s, g, lam[s], ok)
        conj = (trans[sec][0], -trans[sec][1])
        lam_end[sec] = add(_scan_maps(conj, lam[sec], reverse=True),
                           ginit[sec])

    # 3. the replay from the last chunk back, one partial per slice
    lam = list(lam_end)
    acc = np.zeros((nsec, 5, n, NL), f32)
    gx = np.zeros((n, S, NL), f32)
    for c in range(n_ch - 1, -1, -1):
        if n_ch == 1:
            cs = list(start)
        else:
            cs = list(ck[c][:nsec])
            cs[-1] = add(cs[-1], _cmul(ck[c][nsec], last))
        cols = range(16 * c, 16 * c + 16)
        vs = [[x[:, j] for j in cols]]
        for s in range(nsec - 1):
            state, out = cs[s], []
            for j in cols:
                y, state = step(s, vs[s][j - 16 * c], state,
                                valid[:, j][:, None])
                out.append(y)
            vs.append(out)
        g = [g_rows[:, j] for j in cols]
        for s in range(nsec - 1, -1, -1):
            state, lagged = cs[s], []
            for j in cols:
                lagged.append(state)
                _, state = step(s, vs[s][j - 16 * c], state,
                                valid[:, j][:, None])
            for i in range(15, -1, -1):
                ok = valid[:, 16 * c + i][:, None]
                (s1, s2), (l1, l2) = lagged[i], lam[s]
                terms = (l1 * s1 + l2 * s2, l2 * s1 - l1 * s2,
                         g[i] * vs[s][i], g[i] * s1, g[i] * s2)
                for t, term in enumerate(terms):
                    acc[s, t] = np.where(ok, acc[s, t] + term, acc[s, t])
                g[i], lam[s] = lam_step(s, g[i], lam[s], ok)
        for i, j in enumerate(cols):
            gx[:, j] = g[i]

    # 4. each gradient's partials summed in slice order
    total = np.zeros((nsec, 5, NL), f32)
    for k in range(n):
        total = total + acc[:, :, k]
    gco = np.zeros((B, nsec, ch, 11), f32)
    gco[..., 6:] = total.reshape(nsec, 5, B, ch).transpose(2, 0, 3, 1)
    gzi = None
    if zi is not None:
        gzi = np.stack([np.stack([lam[s][0][0], lam[s][1][0]])
                        for s in range(nsec)])
        gzi = gzi.reshape(nsec, 2, B, ch).transpose(2, 0, 1, 3)
    return gco, gx.reshape(n * S, NL)[:L].reshape(L, B, ch), gzi


#: the model's edges: (sections, windows, channels, rows L, tail, zi, gzf,
#: LowPass cutoffs (Hz) of every section, layout ('unfold': windows of one
#: timeline tail rows apart; 'broadcast': one channel under every lane),
#: slice rows)
ROWS_MODEL_CASES = {
    # one 16-row chunk a slice: the starts stay in registers
    'slices_16_render_ahead': (1, 3, 4, 1152, 1024, False, False,
                               (500.0, 5000.0), 'unfold', 16),
    'slices_16_zi_gzf_two_sections': (2, 2, 3, 400, 400, True, True,
                                      (500.0, 5000.0), 'dense', 16),
    # slices of 3 and 5 chunks: the checkpoints and their fix-up
    'slices_48_checkpoints': (2, 2, 3, 1152, 1024, True, True,
                              (500.0, 5000.0), 'dense', 48),
    'slices_80_checkpoints_L1157': (1, 1, 4, 1157, 1157, True, True,
                                    (500.0, 5000.0), 'dense', 80),
    'L1157_three_sections': (3, 1, 3, 1157, 1157, True, True,
                             (500.0, 5000.0), 'dense', 16),
    # fewer than 32 rows: one slice (of two chunks), no scan
    'one_slice_L20': (2, 2, 3, 20, 20, True, True, (500.0, 5000.0), 'dense',
                      32),
    'one_slice_L9_tail4': (1, 3, 2, 9, 4, True, True, (500.0, 5000.0),
                           'dense', 16),
    # slices wholly in the warmup (rows before L - tail)
    'warmup_slices_tail100': (1, 2, 3, 400, 100, True, True, (500.0, 1000.0),
                              'dense', 48),
    'warmup_tail1_checkpoints': (2, 2, 3, 300, 1, False, True,
                                 (500.0, 1000.0), 'dense', 32),
    'zi_only': (1, 2, 3, 300, 300, True, False, (500.0, 5000.0), 'dense',
                16),
    'gzf_only': (1, 2, 3, 300, 300, False, True, (500.0, 5000.0), 'dense',
                 48),
    'four_sections': (4, 1, 3, 600, 600, True, True, (500.0, 5000.0),
                      'dense', 16),
    'four_sections_checkpoints': (4, 1, 2, 600, 500, True, True,
                                  (500.0, 5000.0), 'dense', 64),
    'poles_30Hz': (2, 1, 3, 2000, 2000, True, True, (30.0, 30.0), 'dense',
                   80),
    'poles_18kHz': (1, 2, 3, 600, 600, True, True, (15000.0, 18000.0),
                    'dense', 48),
    'overlapping_windows': (1, 4, 3, 320, 64, False, False, (500.0, 5000.0),
                            'unfold', 32),
    'broadcast_channel': (1, 3, 4, 300, 300, False, True, (500.0, 5000.0),
                          'broadcast', 16),
}


def rows_model_inputs(case):
    """The numpy inputs of a :data:`ROWS_MODEL_CASES` case: ``(coeffs
    (B, nsec, ch, 11), x_t (L, B, ch), gy (tail, B, ch), zi, gzf)``."""
    nsec, B, ch, L, tail, z, g, cuts, layout, _ = ROWS_MODEL_CASES[case]
    rng = np.random.default_rng(60 + list(ROWS_MODEL_CASES).index(case))
    co = np.concatenate([lowpass(rng, B, ch, *cuts) for _ in range(nsec)],
                        axis=1)
    if layout == 'unfold':
        xt = normal(rng, L - tail + B * tail, ch)
        x = np.stack([xt[b * tail:b * tail + L] for b in range(B)], axis=1)
    else:
        x = normal(rng, L, B, 1 if layout == 'broadcast' else ch)
        x = np.ascontiguousarray(np.broadcast_to(x, (L, B, ch)))
    gy = normal(rng, tail, B, ch)
    zi = 0.5 * normal(rng, B, nsec, 2, ch) if z else None
    gzf = normal(rng, B, nsec, 2, ch) if g else None
    return co, x, gy, zi, gzf


@pytest.mark.parametrize('case', list(ROWS_MODEL_CASES))
def test_rows_adjoint_model_matches_plain(case):
    """The f32 algebra of B3's time-sliced adjoint scan meets the plain
    adjoint within 1e-5 of each output's largest |value|: 16-row slices
    (no checkpoints) and 32-80-row ones (checkpoints), L = 1157, fewer than
    32 rows, slices wholly in the warmup, ``zi`` / ``gzf`` zero and not,
    1-4 sections, 30 Hz and 15-18 kHz poles, overlapping windows and a
    broadcast channel; one-window cases through
    ``sosfilt_stream_vjp_plain``."""
    co, x, gy, zi, gzf = rows_model_inputs(case)
    L, B, ch = x.shape
    tail = gy.shape[0]
    S = ROWS_MODEL_CASES[case][-1]
    got = rows_adjoint_model(co, x, gy, tail=tail, zi=zi, gzf=gzf,
                             slice_rows=S)
    if B == 1 and zi is not None and gzf is not None and tail == L:
        want = sosfilt_stream_vjp_plain(
            torch.tensor(co[0]), torch.tensor(x[:, 0]), torch.tensor(zi[0]),
            torch.tensor(gy[:, 0]), torch.tensor(gzf[0]))
        want = (want[0][None], want[1][:, None], want[2][None])
    else:
        want = K.sosfilt_batch_vjp_plain(
            *(None if a is None else torch.tensor(a)
              for a in (co, x, gy)), tail=tail,
            zi=None if zi is None else torch.tensor(zi),
            gzf=None if gzf is None else torch.tensor(gzf))
    for name, a, b in zip(('gcoeffs', 'gx', 'gzi'), got, want):
        if b is None:
            assert a is None, name
            continue
        assert rel_err(a, b.numpy()) <= PLAIN_TOL, name
    n = -(-L // S)
    if case.startswith('one_slice'):
        assert n == 1
    if 'checkpoints' in case:
        assert S > 16 and n > 1
    if case.startswith('warmup'):
        assert (L - tail) // S >= 1


@pytest.mark.parametrize('entry', ['batch', 'timeline', 'stream'])
def test_rows_adjoint_model_matches_jax(entry):
    """The model at the kernel's own slicing on an H100 against
    ``jax.vjp`` of the JAX references that :func:`test_batch_grads_match_jax`,
    :func:`test_timeline_grads_match_jax` and
    :func:`test_stream_grads_match_jax` take: a vmap of ``sosfilt_scan``
    (``sosfilt_batch``'s), ``sosfilt_scan`` (``sosfilt_pallas``'s) and the
    JAX package's ``filters.sosfilt_stream`` from a start state with the end
    state's cotangent."""
    import jax
    from signals_tpu.compiler import filters as JF
    from signals_tpu.compiler.filters import sosfilt_scan
    if entry == 'batch':
        rng = np.random.default_rng(0)
        B, L, ch, tail = 3, 64, 4, 32
        co, x = lowpass(rng, B, ch), normal(rng, L, B, ch)
        gy = normal(rng, tail, B, ch)
        want = jax_vjp(lambda c, xx: jax.vmap(sosfilt_scan, in_axes=(0, 1),
                                              out_axes=1)(c, xx)[L - tail:],
                       [co, x], gy)
        zi = gzf = None
    elif entry == 'timeline':
        rng = np.random.default_rng(1)
        co, x = bandpass(rng, 1, 6), normal(rng, 200, 1, 6)
        gy = normal(rng, 200, 1, 6)
        want = jax_vjp(sosfilt_scan, [co[0], x[:, 0]], gy[:, 0])
        want = [want[0][None], want[1][:, None]]
        zi = gzf = None
    else:
        rng = np.random.default_rng(6)
        co = bandpass(rng, 1, 4)
        x, zi = normal(rng, 160, 1, 4), 0.5 * normal(rng, 1, 2, 2, 4)
        gy, gzf = normal(rng, 160, 1, 4), normal(rng, 1, 2, 2, 4)
        want = jax_vjp(JF.sosfilt_stream, [co[0], x[:, 0], zi[0]],
                       (gy[:, 0], gzf[0]))
        want = [want[0][None], want[1][:, None], want[2][None]]
    L, B, ch = x.shape
    S = vjp_slice_rows(1, B * ch, L, min_slice=16,
                       most=512 if co.shape[1] <= 2 else 256)
    assert -(-L // S) > 1
    got = rows_adjoint_model(co, x, gy, tail=gy.shape[0], zi=zi, gzf=gzf,
                             slice_rows=S)
    for name, a, b in zip(('coeffs', 'x', 'zi'), got, want):
        assert rel_err(a, b) <= JAX_TOL, name


@pytest.mark.parametrize('nsec,tail,state', [(1, 300, True), (2, 100, True),
                                              (3, 300, False)])
def test_exact_rows_vjp_matches_plain(nsec, tail, state):
    """``torch_refs.exact_rows_vjp`` (the float64 reference B3 is held to
    on the card where a window is too long for the plain adjoint's frame
    loop) against the plain adjoint on float64 inputs: within 1e-6 of each
    output's largest |value| (the plain adjoint keeps its gradient sums in
    float32)."""
    import torch_refs
    rng = np.random.default_rng(40 + nsec)
    B, ch, L = 2, 3, 300
    co = torch.tensor(np.concatenate([lowpass(rng, B, ch)] * nsec, axis=1))
    x, gy = torch.tensor(normal(rng, L, B, ch)), torch.tensor(
        normal(rng, tail, B, ch))
    zi = torch.tensor(normal(rng, B, nsec, 2, ch)) if state else None
    gzf = torch.tensor(normal(rng, B, nsec, 2, ch)) if state else None

    def f64(t):
        return None if t is None else t.double()

    got = torch_refs.exact_rows_vjp(co, x, gy, tail, zi, gzf)
    want = K.sosfilt_batch_vjp_plain(f64(co), f64(x), f64(gy), tail=tail,
                                     zi=f64(zi), gzf=f64(gzf))
    for name, a, b in zip(('gcoeffs', 'gx', 'gzi'), got, want):
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == torch.float64 and rel_err(a, b) <= 1e-6, name


# --- the backward kernels on the card ---------------------------------------

@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return torch.device('cuda')


def held_on_card(got, want):
    """Each output within 1e-5 of its largest |value| (the plain adjoint's
    on the card)."""
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        err = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        assert torch.isfinite(a).all() and err <= PLAIN_TOL, err


def same_bits(first, second):
    for a, b in zip(first, second):
        if a is not None:
            assert torch.equal(a, b)


def card_coeffs(rng, nb, lanes, nsec, cuts, device):
    """Per-block coefficients on the card: a LowPass over ``cuts`` (Hz) at
    one section, a band-pass at two."""
    co = bandpass(rng, nb, lanes) if nsec == 2 else lowpass(rng, nb, lanes,
                                                             *cuts)
    return torch.tensor(co, device=device)


#: B1 / B2 on the card: (oscillator or None for B2's timeline, lanes,
#: blocks, F, C, m, sum group, sections, LowPass cutoffs); the edges of the
#: time-sliced adjoint scan as :data:`MODEL_CASES` has them, at the
#: kernel's own slicing
GEN_VJP_CASES = {
    'saw_m8_sum64': (K.OSC_SAW, 64, 16, 256, 128, 8, 64, 1),
    'saw_m8': (K.OSC_SAW, 64, 16, 256, 128, 8, 0, 1),
    'sine_two_sections': (K.OSC_SINE, 64, 16, 256, 128, 1, 0, 2),
    'triangle_m2_sum16': (K.OSC_TRIANGLE, 64, 16, 256, 128, 2, 16, 1),
    'square_two_sections_sum32': (K.OSC_SQUARE, 64, 16, 256, 128, 1, 32, 2),
    'one_segment_sum64': (K.OSC_SAW, 64, 8, 1024, 512, 8, 64, 1),
    'C300_lanes5_sum5': (K.OSC_SAW, 5, 8, 256, 300, 4, 5, 1),
    'two_sections_C300_lanes48_sum48': (K.OSC_SAW, 48, 8, 256, 300, 4, 48,
                                        2),
    'F24_m8': (K.OSC_SAW, 64, 16, 24, 40, 8, 0, 1),
    'lowpass30_sum64': (K.OSC_SAW, 64, 16, 256, 128, 8, 64, 1, (30.0, 30.0)),
    'far_poles': (K.OSC_SAW, 64, 16, 256, 128, 8, 0, 1, (15000.0, 18000.0)),
    # 128 carry segments of 8704 rows: the checkpoints of 32 lanes a block
    # overflow shared memory, so the launch halves its lanes a block
    'flagship_1024_blocks_sum64': (K.OSC_SAW, 64, 1024, 1024, 512, 8, 64, 1),
}
SEG_VJP_CASES = {
    'C1024_sum64': (64, 8, 256, 1024, 1, 64, False, 1),
    'C256_m8_one_channel_sum64': (64, 8, 256, 256, 8, 64, True, 1),
    'C512_m2_two_sections': (64, 8, 256, 512, 2, 0, False, 2),
    'C96_one_channel': (64, 8, 256, 96, 1, 0, True, 1),
    'C300_lanes5': (5, 8, 256, 300, 4, 0, False, 1),
    'F24_m8_two_sections': (48, 16, 24, 40, 8, 0, False, 2),
    'one_segment_one_channel_sum64': (64, 8, 1024, 256, 8, 64, True, 1),
    'lowpass30_m8': (64, 8, 256, 512, 8, 0, False, 1, (30.0, 30.0)),
    'far_poles': (64, 8, 256, 128, 2, 0, False, 1, (15000.0, 18000.0)),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', list(GEN_VJP_CASES))
def test_cuda_segments_gen_vjp_matches_plain(gpu, case):
    osc, lanes, nb, F, C, m, g, nsec, *cuts = GEN_VJP_CASES[case]
    rng = np.random.default_rng(list(GEN_VJP_CASES).index(case))
    co = card_coeffs(rng, nb, lanes, nsec, cuts[0] if cuts else
                     (500.0, 5000.0), gpu)
    toff = torch.full((lanes,), -C, dtype=torch.int32, device=gpu)
    lanef = torch.tensor(np.stack([rng.uniform(100.0, 1000.0, lanes),
                                   rng.uniform(0.0, 0.5, lanes),
                                   np.ones(lanes)]).astype(np.float32),
                         device=gpu)
    kw = dict(n_segments=nb, seg_frames=F, context=C, osc_code=osc,
              rate=RATE, sum_groups=g, blocks_per_seg=m)
    gy = torch.tensor(normal(rng, nb, F, lanes // g if g else lanes),
                      device=gpu)
    K.reset_launch_counts()
    got = K.sosfilt_segments_gen_vjp(co, toff, lanef, gy, **kw)
    again = K.sosfilt_segments_gen_vjp(co, toff, lanef, gy, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES['segments_gen_vjp'] == 2
    held_on_card(got, K.sosfilt_segments_gen_vjp_plain(co, toff, lanef, gy,
                                                       **kw))
    same_bits(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize('case', list(SEG_VJP_CASES))
def test_cuda_segments_vjp_matches_plain(gpu, case):
    lanes, nb, F, C, m, g, one_channel, nsec, *cuts = SEG_VJP_CASES[case]
    rng = np.random.default_rng(C + m + list(SEG_VJP_CASES).index(case))
    co = card_coeffs(rng, nb, lanes, nsec, cuts[0] if cuts else
                     (500.0, 5000.0), gpu)
    x = torch.tensor(normal(rng, C + nb * F, 1 if one_channel else lanes),
                     device=gpu)
    kw = dict(n_segments=nb, seg_frames=F, context=C, sum_groups=g,
              blocks_per_seg=m)
    co, x = K._timeline(co, x, nb, F, C)
    gy = torch.tensor(normal(rng, nb, F, lanes // g if g else lanes),
                      device=gpu)
    got = K.sosfilt_segments_vjp(co, x, gy, **kw)
    again = K.sosfilt_segments_vjp(co, x, gy, **kw)
    torch.cuda.synchronize()
    held_on_card(got, K.sosfilt_segments_vjp_plain(co, x, gy, **kw))
    same_bits(got, again)


#: B3 on the card: (entry, sections, windows, channels, rows L, tail, zi
#: and gzf given, LowPass cutoffs (Hz) of every section, layout: 'unfold'
#: windows of one timeline tail rows apart, 'dense', or 'broadcast' one
#: channel under every lane); the old render-ahead, step and carried-state
#: shapes at 1-4 sections, then the edges of the time-sliced adjoint scan
#: as :data:`ROWS_MODEL_CASES` has them, at the kernel's own slicing
ROWS_VJP_CASES = {
    **{f'render_ahead_{n}sec': ('batch', n, 8, 16, 1152, 1024, False,
                                (500.0, 5000.0), 'unfold')
       for n in (1, 2, 3, 4)},
    **{f'step_timeline_{n}sec': ('timeline', n, 1, 16, 1152, 1152, False,
                                 (500.0, 5000.0), 'dense')
       for n in (1, 2, 3, 4)},
    **{f'stream_zi_gzf_{n}sec': ('stream', n, 1, 16, 1024, 1024, True,
                                 (500.0, 5000.0), 'dense')
       for n in (1, 2, 3, 4)},
    'L1157_zi_gzf_2sec': ('batch', 2, 3, 5, 1157, 1157, True,
                          (500.0, 5000.0), 'dense'),
    'L20_one_slice_3sec': ('batch', 3, 4, 6, 20, 20, True, (500.0, 5000.0),
                           'dense'),
    'L9_tail4': ('batch', 1, 3, 2, 9, 4, True, (500.0, 5000.0), 'dense'),
    # slices wholly in the warmup, at the sampled filter's tail 1 too
    'warmup_tail100_zi_gzf': ('batch', 1, 4, 8, 400, 100, True,
                              (500.0, 1000.0), 'dense'),
    'sampled_tail1': ('batch', 1, 8, 16, 129, 1, False, (500.0, 5000.0),
                      'unfold'),
    'poles30_2sec': ('stream', 2, 1, 16, 4096, 4096, True, (30.0, 30.0),
                     'dense'),
    'poles18k_4sec': ('batch', 4, 2, 8, 3000, 3000, True,
                      (15000.0, 18000.0), 'dense'),
    'broadcast_channel': ('batch', 1, 8, 16, 1152, 1024, False,
                          (500.0, 5000.0), 'broadcast'),
    # the streaming fit's window and the echo's segment
    'stream_8192x16': ('stream', 1, 1, 16, 8192, 8192, True,
                       (500.0, 5000.0), 'dense'),
    'stream_16384x1': ('stream', 1, 1, 1, 16384, 16384, True,
                       (500.0, 5000.0), 'dense'),
    # 2048-row slices: the checkpoints outgrow shared memory and go to the
    # call's buffer; held to torch_refs.exact_rows_vjp (float64): the plain
    # adjoint's frame loop would take minutes (torch_refs.b3_calls)
    'stream_2pow20_2sec': ('stream', 2, 1, 1, 1 << 20, 1 << 20, True,
                           (500.0, 5000.0), 'dense'),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', list(ROWS_VJP_CASES))
def test_cuda_rows_vjp_matches_plain(gpu, case):
    """B3 behind the three row entries — the render-ahead batch (windows of
    one timeline read in place, tail F), the step's timeline, the
    carried-state entry from a start state with the end state's cotangent,
    at 1-4 sections — and at the edges of its time-sliced scan: a ragged
    last slice, one slice, slices wholly in the warmup, 30 Hz and 15-18 kHz
    poles, a broadcast channel, the streaming fit's (8192, 16), the echo's
    (16384, 1) and 2^20 rows at two sections (checkpoints in the call's
    buffer); each output within 1e-5 of its largest, two calls the same
    bits."""
    import torch_refs
    rng = np.random.default_rng(20 + list(ROWS_VJP_CASES).index(case))
    call, plain, _, _ = torch_refs.b3_calls(rng, gpu, *ROWS_VJP_CASES[case])
    got, again = call(), call()
    torch.cuda.synchronize()
    held_on_card(got, plain())
    same_bits(got, again)


@pytest.mark.cuda
def test_cuda_functions_match_cpu(gpu):
    """The entries' Functions on the card (forward kernels, backward
    kernels) against the same calls on the CPU (plain forward, plain
    adjoint)."""
    rng = np.random.default_rng(30)
    nb, F, C, lanes = 8, 256, 128, 32
    co = lowpass(rng, nb, lanes)
    x = normal(rng, C + nb * F, lanes)
    kw = dict(n_segments=nb, seg_frames=F, context=C, sum_groups=lanes,
              blocks_per_seg=4)
    gy = normal(rng, nb, F, 1)
    results = []
    for dev in ('cpu', gpu):
        ts = [torch.tensor(a, device=dev).requires_grad_() for a in (co, x)]
        y = K.sosfilt_segments(*ts, **kw)
        grads = torch.autograd.grad(y, ts, torch.tensor(gy, device=dev))
        results.append([g.cpu() for g in grads])
    held_on_card(results[1], results[0])
