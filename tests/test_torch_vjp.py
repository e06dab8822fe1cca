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
  a carry segment, one channel read by many lanes, group sums.

The ``cuda`` cases hold each backward kernel (``csrc/adjoint.cu``: B1, B2,
B3) to its plain adjoint on the card, within 1e-5 of each output's largest
|value|, and two calls to the same bits; they skip without a GPU.  JAX is
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


@pytest.mark.cuda
@pytest.mark.parametrize('osc,m,g,nsec', [
    (K.OSC_SAW, 8, 64, 1), (K.OSC_SAW, 8, 0, 1), (K.OSC_SINE, 1, 0, 2),
    (K.OSC_TRIANGLE, 2, 16, 1), (K.OSC_SQUARE, 1, 32, 2)])
def test_cuda_segments_gen_vjp_matches_plain(gpu, osc, m, g, nsec):
    rng = np.random.default_rng(osc + 4 * m)
    nb, F, C, lanes = 16, 256, 128, 64
    co = torch.tensor((lowpass if nsec == 1 else bandpass)(rng, nb, lanes),
                      device=gpu)
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
@pytest.mark.parametrize('C,m,g,one_channel,nsec', [
    (1024, 1, 64, False, 1), (256, 8, 64, True, 1), (512, 2, 0, False, 2),
    (96, 1, 0, True, 1)])
def test_cuda_segments_vjp_matches_plain(gpu, C, m, g, one_channel, nsec):
    rng = np.random.default_rng(C + m)
    nb, F, lanes = 8, 256, 64
    co = torch.tensor((lowpass if nsec == 1 else bandpass)(rng, nb, lanes),
                      device=gpu)
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


@pytest.mark.cuda
@pytest.mark.parametrize('nsec', [1, 2, 3, 4])
def test_cuda_rows_vjp_matches_plain(gpu, nsec):
    """B3 behind the three row entries: the render-ahead batch (windows of
    one timeline read in place, tail F), the step's timeline, and the
    carried-state entry from a start state with the end state's
    cotangent."""
    rng = np.random.default_rng(20 + nsec)
    co = np.concatenate([lowpass(rng, 8, 16)] * nsec, axis=1)
    co = torch.tensor(co, device=gpu)
    F_, C_, nb, ch = 1024, 128, 8, 16
    x = torch.tensor(normal(rng, C_ + nb * F_, ch), device=gpu)
    xw = x.unfold(0, C_ + F_, F_)[:nb].permute(2, 0, 1)
    gy = torch.tensor(normal(rng, F_, nb, ch), device=gpu)
    got = K.sosfilt_batch_vjp(co, xw, gy, tail=F_)
    held_on_card(got, K.sosfilt_batch_vjp_plain(co, xw, gy, tail=F_))
    same_bits(got, K.sosfilt_batch_vjp(co, xw, gy, tail=F_))
    c1, x1 = co[0], x[:C_ + F_]
    gy1 = torch.tensor(normal(rng, C_ + F_, ch), device=gpu)
    held_on_card(K.sosfilt_timeline_vjp(c1, x1, gy1),
                 K.sosfilt_timeline_vjp_plain(c1, x1, gy1))
    zi = torch.tensor(0.5 * normal(rng, nsec, 2, ch), device=gpu)
    gzf = torch.tensor(normal(rng, nsec, 2, ch), device=gpu)
    xs, gys = x[:F_], gy1[:F_]
    got = K.sosfilt_stream_vjp(c1, xs, zi, gys, gzf)
    held_on_card(got, K.sosfilt_stream_vjp_plain(c1, xs, zi, gys, gzf))
    same_bits(got, K.sosfilt_stream_vjp(c1, xs, zi, gys, gzf))


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
