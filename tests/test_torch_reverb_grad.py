"""The ``Reverb`` under autograd and ``torch.func.vmap`` in the port
(``compiler/kernels.py`` ``fdn_advance`` / ``fdn_advance_vjp`` and their
``autograd.Function``) against the JAX package.

On the CPU, at small sizes (256-frame blocks, windows of 16-32 blocks, so
that every line, the longest 3515 frames, is read), the same numbers
through both packages:

* the plain network against an out-of-place turn loop bit for bit, and
  the plain adjoint against ``torch.autograd`` of that loop within 1e-5 of
  the largest gradient: one lane at the reverb's delays, three lanes with
  per-lane gains, a window shorter than a turn, lines clamped to a block;
* a numpy float32 model of the adjoint kernel's walk (turns aligned at the
  timeline's end, straddling the carried rows; the Walsh-Hadamard
  transform) against the plain adjoint;
* the entry under ``vmap``: one plain call for three voices with per-voice
  gains, bit for bit the three calls, no per-voice fallback, and its
  gradients;
* gradients of a spectral loss through the port's ``Reverb`` against
  ``jax.grad`` of the JAX package's within ``GRAD_TOL`` (1e-3 relative):
  an upstream gain, ``t60`` and ``mix`` through ``mega_step`` and through
  the per-block ``step``, the carried lines, and a patch with the
  ``Compressor`` after the reverb (a filter cutoff upstream too);
* ``PolyPatch(layout='vmap')`` with a per-voice ``t60``: within V x 1e-5 of
  the JAX package's vmap layout, one plain network call a render, and a
  fit through the reverb that lowers the loss.

On the card (``-m cuda``, skipped here): both kernels against their plain
versions at one lane and at 64 folded lanes with per-lane gains, the
forward bit for bit, the adjoint within 1e-5 and the same bits twice.
"""

import importlib
import warnings

import numpy as np
import pytest
import torch

from signals_tpu_torch import learn
from signals_tpu_torch.compiler import compile_node
from signals_tpu_torch.compiler import kernels as K

RATE = 44100
F = 256
TOL = 1e-5
GRAD_TOL = 1e-3      # the port's gradients vs jax.grad of the JAX package's
JAX, PORT = 'signals_tpu', 'signals_tpu_torch'
#: the reverb's delays at 44.1 kHz, size 1.0 (``Reverb._lengths``)
BUS_LENGTHS = (1310, 1636, 1813, 1927, 2351, 2721, 3056, 3515)


def mods(pkg):
    return {m: importlib.import_module(f'{pkg}.{m}')
            for m in ('nodes.dyn', 'nodes.fixed', 'nodes.fx', 'nodes.osc',
                      'nodes.reverb', 'parallel')}


def fixed(mod, value):
    f = mod['nodes.fixed'].Fixed()
    f.get_state().value = np.atleast_2d(np.asarray(value, np.float32))
    return f


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def to_np(t):
    return t.detach().cpu().numpy()


# --- the network and its adjoint ------------------------------------------------

#: name: (lanes, window frames, delays)
FDN_CASES = {
    'bus': (1, 16 * F, BUS_LENGTHS),
    'lanes': (3, 5000, BUS_LENGTHS),
    'short': (2, 700, BUS_LENGTHS),
    'clamped': (1, 9 * 1024, (1024,) * 8),
}


def fdn_inputs(name, seed=0):
    lanes, T, lengths = FDN_CASES[name]
    rng = np.random.default_rng(seed)
    L = max(lengths)
    lines = 0.2 * rng.standard_normal((L, 8, lanes))
    inject = 0.1 * rng.standard_normal((T, lanes))
    g = rng.uniform(0.5, 0.95, (8, lanes))
    return [torch.tensor(a, dtype=torch.float32) for a in (lines, inject, g)
            ] + [lengths]


def fdn_out_of_place(lines, inject, g, lengths):
    """The network as an out-of-place loop over turns (what autograd can
    record): the plain version's operations without its in-place
    writes."""
    L = lines.shape[0]
    cols = torch.as_tensor(K.H8_COLS)
    tl, turn = lines, min(lengths)
    for t0 in range(0, inject.shape[0], turn):
        t1 = min(t0 + turn, inject.shape[0])
        reads = torch.stack([tl[L + t0 - d:L + t1 - d, i]
                             for i, d in enumerate(lengths)], dim=1)
        new = K.hadamard_mix(cols, reads * g[None]) + inject[t0:t1, None, :]
        tl = torch.cat([tl, new])
    return tl


@pytest.mark.parametrize('name', sorted(FDN_CASES))
def test_fdn_plain_equals_out_of_place_loop(name):
    lines, inject, g, lengths = fdn_inputs(name)
    got = K.fdn_advance(lines, inject, g, lengths)
    want = fdn_out_of_place(lines, inject, g, lengths)
    assert got.shape == (lines.shape[0] + inject.shape[0], 8, g.shape[1])
    assert torch.equal(got, want)
    assert torch.equal(got[:lines.shape[0]], lines)


@pytest.mark.parametrize('name', sorted(FDN_CASES))
def test_fdn_plain_vjp_matches_autograd(name):
    lines, inject, g, lengths = fdn_inputs(name)
    L = lines.shape[0]
    gtl = torch.tensor(np.random.default_rng(1).standard_normal(
        (L + inject.shape[0], 8, g.shape[1])), dtype=torch.float32)
    leaves = [t.clone().requires_grad_() for t in (lines, inject, g)]
    want = torch.autograd.grad(
        (fdn_out_of_place(*leaves, lengths) * gtl).sum(), leaves)
    tl = K.fdn_advance(lines, inject, g, lengths)
    got = K.fdn_advance_vjp(tl, g, gtl, lengths, L)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def fwht8(v):
    """``(H v) / h`` over axis 1 (the lines): the kernel's butterflies."""
    v = v.copy()
    s = 1
    while s < 8:
        for i in range(8):
            if not i & s:
                a, b = v[:, i].copy(), v[:, i + s].copy()
                v[:, i], v[:, i + s] = a + b, a - b
        s <<= 1
    return v


def fdn_vjp_kernel_model(tl, g, gtl, lengths, L):
    """The walk of ``csrc/fdn.cu``'s ``fdn_advance_vjp`` in numpy float32:
    turns of ``min(lengths)`` rows from the timeline's end down to row 0
    (a turn may hold carried rows and window rows), each row's cotangent
    read from the rows ``d_j`` later through the stored ``H u``."""
    tl, g, gtl = (np.asarray(a, np.float32) for a in (tl, g, gtl))
    T = tl.shape[0] - L
    lanes = tl.shape[2]
    h = np.float32(K.H8[0, 0])
    ha = np.zeros((T, 8, lanes), np.float32)
    glines = np.zeros((L, 8, lanes), np.float32)
    ginject = np.zeros((T, lanes), np.float32)
    gg = np.zeros((8, lanes), np.float32)
    turn = min(lengths)
    p1 = L + T
    while p1 > 0:
        p0 = max(p1 - turn, 0)
        p = np.arange(p0, p1)
        u = gtl[p0:p1].copy()
        for j, d in enumerate(lengths):
            q = p + d
            ok = (q >= L) & (q < L + T)
            u[ok, j] += g[j] * ha[q[ok] - L, j]
        low = p < L
        glines[p[low]] = u[low]
        hi = ~low
        t = p[hi] - L
        ginject[t] = u[hi].sum(axis=1)
        hu = h * fwht8(u[hi])
        ha[t] = hu
        for j, d in enumerate(lengths):
            gg[j] += (tl[p[hi] - d, j] * hu[:, j]).sum(axis=0)
        p1 -= turn
    return glines, ginject, gg


@pytest.mark.parametrize('name', sorted(FDN_CASES))
def test_fdn_vjp_kernel_model_matches_plain(name):
    lines, inject, g, lengths = fdn_inputs(name)
    L = lines.shape[0]
    gtl = torch.tensor(np.random.default_rng(2).standard_normal(
        (L + inject.shape[0], 8, g.shape[1])), dtype=torch.float32)
    tl = K.fdn_advance(lines, inject, g, lengths)
    want = K.fdn_advance_vjp(tl, g, gtl, lengths, L)
    got = fdn_vjp_kernel_model(tl, g, gtl, lengths, L)
    for a, b in zip(got, want):
        assert float(np.abs(a - to_np(b)).max()) <= (
            1e-5 * float(b.abs().max()))


def test_fdn_entry_under_vmap_is_one_call(monkeypatch):
    """Three voices with per-voice gains: one plain call, bit for bit the
    three separate calls, no op falls back to a per-voice loop; under grad
    the vmapped call's gradients equal the separate calls'."""
    V = 3
    parts = [fdn_inputs('lanes', seed=s) for s in range(V)]
    lengths = parts[0][3]
    lines, inject, g = (torch.stack([p[i] for p in parts]) for i in range(3))
    calls = []
    plain = K.fdn_advance_plain

    def counted(*a):
        calls.append(a[0].shape)
        return plain(*a)

    monkeypatch.setattr(K, 'fdn_advance_plain', counted)
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings('error', message='.*performance drop.*')
            got = torch.func.vmap(
                lambda a, b, c: K.fdn_advance(a, b, c, lengths))(
                    lines, inject, g)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    assert calls == [(lines.shape[1], 8, V * 3)]
    for v in range(V):
        assert torch.equal(got[v], plain(*parts[v]))
    w = torch.tensor(np.random.default_rng(3).standard_normal(got.shape),
                     dtype=torch.float32)
    leaves = [t.clone().requires_grad_() for t in (lines, inject, g)]
    vg = torch.autograd.grad(
        (torch.func.vmap(lambda a, b, c: K.fdn_advance(a, b, c, lengths))(
            *leaves) * w).sum(), leaves)
    for v in range(V):
        one = [p.clone().requires_grad_() for p in parts[v][:3]]
        sg = torch.autograd.grad(
            (K.fdn_advance(*one, lengths) * w[v]).sum(), one)
        for a, b in zip(vg, sg):
            assert float((a[v] - b).abs().max()) <= 1e-6 * float(
                b.abs().max())


# --- gradients through the Reverb against jax.grad ------------------------------

def sine_reverb(pkg):
    """Sine 220 Hz -> gain 0.5 -> Reverb (t60 0.8, mix 0.4)."""
    mod = mods(pkg)
    vol = fixed(mod, 0.5)
    o = mod['nodes.osc'].Sine()
    o.hertz = fixed(mod, 220.0)
    g = mod['nodes.fx'].Gain()
    g.left = o
    g.right = vol
    rv = mod['nodes.reverb'].Reverb()
    rv.input = g
    st = rv.get_state()
    st.t60, st.mix = 0.8, 0.4
    return rv, {'vol': (vol, 'value'), 't60': (rv, 't60'),
                'mix': (rv, 'mix')}


def small_bus(pkg):
    """The master bus at two voices' width: saws -> LowPass 1500 Hz
    (context 128) -> gain 2 -> Reverb -> Compressor (the bus's threshold
    0.25 and ratio 4, window 512: driven well past its threshold, output
    peak ~0.87) -> gain 0.9.  (At threshold 0.05 and gain 0.25 the
    compressor holds the level nearly constant, and ``mix``'s gradient is
    a near-cancelling sum 1e-3 of ``vol``'s: the JAX package's own
    whole-window and per-block plans then differ by 6.5e-3 relative on
    it.)"""
    mod = mods(pkg)
    saw = mod['nodes.osc'].Sawtooth()
    saw.hertz = fixed(mod, [[110.0, 165.0]])
    cut, vol = fixed(mod, 1500.0), fixed(mod, 2.0)
    lp = mod['nodes.fx'].LowPass()
    lp.input = saw
    lp.cutoff = cut
    lp.get_state().context = 128
    g = mod['nodes.fx'].Gain()
    g.left = lp
    g.right = vol
    rv = mod['nodes.reverb'].Reverb()
    rv.input = g
    st = rv.get_state()
    st.t60, st.mix = 1.2, 0.35
    comp = mod['nodes.dyn'].Compressor()
    cst = comp.get_state()
    cst.window, cst.threshold, cst.ratio = 2 * F, 0.25, 4.0
    comp.input = rv
    out = mod['nodes.fx'].Gain()
    out.left = comp
    out.right = fixed(mod, 0.9)
    return out, {'cut': (cut, 'value'), 'vol': (vol, 'value'),
                 't60': (rv, 't60'), 'mix': (rv, 'mix')}


#: name: (build function, blocks, channels)
GRAD_CASES = {'sine_reverb': (sine_reverb, 24, 1),
              'bus': (small_bus, 16, 2)}


def grad_target(name):
    _, nb, ch = GRAD_CASES[name]
    rng = np.random.default_rng(len(name))
    return (0.2 * rng.standard_normal((nb * F, ch))).astype(np.float32)


def jax_grads(name):
    import jax
    from signals_tpu.compiler import compile_node as jcompile
    from signals_tpu.learn import make_loss_fn as jmake
    build, nb, ch = GRAD_CASES[name]
    root, named = build(JAX)
    c = jcompile(root, block_frames=F, rate=RATE, channels=ch)
    grads = jax.jit(jax.grad(jmake(c, grad_target(name)), allow_int=True))(
        c.params())
    return {k: np.asarray(grads[c.index.info(n).uid][p])
            for k, (n, p) in named.items()}


@pytest.mark.parametrize('name', sorted(GRAD_CASES))
@pytest.mark.parametrize('plan', ['mega', 'blocks'])
def test_reverb_grads_match_jax(name, plan):
    """``mega_step`` (one network call, its adjoint in the backward) and
    the per-block ``step`` both give ``jax.grad``'s gradients."""
    want = jax_grads(name)
    build, nb, ch = GRAD_CASES[name]
    root, named = build(PORT)
    c = compile_node(root, block_frames=F, rate=RATE, channels=ch,
                     device='cpu')
    c.enable_mega = plan == 'mega'
    assert c.plan(nb) == plan
    params, leaves = c.params(), {}
    for k, (n, p) in named.items():
        uid = c.index.info(n).uid
        params[uid][p] = leaves[k] = params[uid][p].clone().requires_grad_()
    value = learn.make_loss_fn(c, grad_target(name))(params)
    got = dict(zip(leaves, map(to_np, torch.autograd.grad(
        value, list(leaves.values())))))
    for k in want:
        assert np.isfinite(got[k]).all() and np.abs(want[k]).max() > 0, k
        assert rel_err(got[k], want[k]) <= GRAD_TOL, (k, got[k], want[k])


def test_reverb_carried_lines_grad_matches_jax():
    """The gradient reaching the carried lines (a start from a seeded
    non-zero state, 20 blocks from block 5) through ``render_core``."""
    import jax
    import jax.numpy as jnp
    from signals_tpu.compiler import compile_node as jcompile
    from signals_tpu.learn import spectral_loss as jloss
    nb, pos = 20, 5 * F
    target = grad_target('sine_reverb')[:nb * F]
    root, _ = sine_reverb(JAX)
    jc = jcompile(root, block_frames=F, rate=RATE, channels=1)
    (uid,) = jc.carry0
    lines = (0.3 * np.random.default_rng(4).standard_normal(
        np.shape(jc.carry0[uid]['lines']))).astype(np.float32)
    jcore = jc.render_core(nb)

    def jfn(lines):
        blocks, _, _ = jcore(jc.params(), {uid: {'lines': lines}}, pos,
                             jc.stage_host(pos, nb))
        return jloss(blocks.reshape(nb * F, 1), jnp.asarray(target))

    want = np.asarray(jax.jit(jax.grad(jfn))(jnp.asarray(lines)))
    root, _ = sine_reverb(PORT)
    c = compile_node(root, block_frames=F, rate=RATE, device='cpu')
    assert c.plan(nb) == 'mega' and list(c.carry0) == [uid]
    t = torch.tensor(lines, requires_grad=True)
    blocks, _, _ = c.render_core(nb)(c.params(), {uid: {'lines': t}}, pos)
    (got,) = torch.autograd.grad(
        learn.spectral_loss(blocks.reshape(nb * F, 1), torch.tensor(target)),
        t)
    assert np.abs(want).max() > 0
    assert rel_err(to_np(got), want) <= GRAD_TOL


# --- the vmap layout ------------------------------------------------------------

FREQS = np.array([110.0, 220.0, 330.0], np.float32)
T60S = np.array([0.5, 1.0, 2.0], np.float32)


def saw_reverb(pkg):
    """Saw -> LowPass 1500 Hz (context 128) -> gain 0.25 -> Reverb (mix
    0.4)."""
    mod = mods(pkg)
    hz = fixed(mod, 220.0)
    saw = mod['nodes.osc'].Sawtooth()
    saw.hertz = hz
    lp = mod['nodes.fx'].LowPass()
    lp.input = saw
    lp.cutoff = fixed(mod, 1500.0)
    lp.get_state().context = 128
    g = mod['nodes.fx'].Gain()
    g.left = lp
    g.right = fixed(mod, 0.25)
    rv = mod['nodes.reverb'].Reverb()
    rv.input = g
    rv.get_state().mix = 0.4
    return rv, hz


def vmap_poly(pkg, root, hz, **kw):
    kw = dict(kw, device='cpu') if pkg == PORT else kw
    return mods(pkg)['parallel'].PolyPatch(
        root, n_voices=len(FREQS),
        overrides={(hz, 'value'): FREQS, (root, 't60'): T60S},
        block_frames=F, rate=RATE, channels=1, layout='vmap', **kw)


def test_vmap_layout_per_voice_t60_matches_jax(monkeypatch):
    nb, V = 24, len(FREQS)
    root, hz = saw_reverb(JAX)
    want, _ = vmap_poly(JAX, root, hz).render(n_blocks=nb)
    root, hz = saw_reverb(PORT)
    poly = vmap_poly(PORT, root, hz)
    assert poly.compiled.plan(nb) == 'mega'
    calls = []
    plain = K.fdn_advance_plain

    def counted(*a):
        calls.append(a[2].shape)
        return plain(*a)

    monkeypatch.setattr(K, 'fdn_advance_plain', counted)
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings('error', message='.*performance drop.*')
            got, carry = poly.render(n_blocks=nb)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    assert calls == [(8, V)]            # one call, a lane (and a g) a voice
    (lines,) = [c['lines'] for c in carry.values()]
    assert lines.shape == (V, max(BUS_LENGTHS), 8, 1)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= V * TOL
    assert np.abs(np.asarray(want)).max() > 100 * TOL


def test_vmap_layout_fit_through_reverb_lowers_loss():
    """The per-voice ``t60`` and the shared ``mix`` fitted in the vmap
    layout against a mix rendered at other values."""
    nb = 16
    root, hz = saw_reverb(PORT)
    poly = vmap_poly(PORT, root, hz)
    poly.set_override(root, 't60', np.array([1.5, 0.4, 0.9], np.float32))
    root.get_state().mix = 0.7
    target, _ = poly.render(n_blocks=nb)
    poly.set_override(root, 't60', T60S)
    root.get_state().mix = 0.4
    res = poly.fit(target.numpy(), [(root, 't60'), (root, 'mix')], steps=12,
                   learning_rate=0.05, apply=False)
    assert np.isfinite(res.losses).all()
    assert res.losses[-1] < 0.9 * res.losses[0]
    assert res.params[poly.compiled.index.info(root).uid]['t60'].shape[0] \
        == len(FREQS)


# --- on the card ----------------------------------------------------------------


def card_inputs(lanes, T, seed):
    rng = np.random.default_rng(seed)
    lines = 0.2 * rng.standard_normal((max(BUS_LENGTHS), 8, lanes))
    inject = 0.1 * rng.standard_normal((T, lanes))
    g = rng.uniform(0.5, 0.99, (8, lanes))
    return [torch.tensor(a, dtype=torch.float32, device='cuda')
            for a in (lines, inject, g)]


@pytest.mark.cuda
@pytest.mark.parametrize('lanes,T', [(1, 64 * 1024), (64, 16 * 1024)])
def test_cuda_fdn_advance_matches_plain(lanes, T):
    """The kernel gives the plain turn loop's bits, one lane at the master
    bus's delays and 64 lanes (folded voices) with per-lane gains."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    lines, inject, g = card_inputs(lanes, T, 5)
    K.reset_launch_counts()
    got = K.fdn_advance(lines, inject, g, BUS_LENGTHS)
    torch.cuda.synchronize()
    assert K.LAUNCHES['fdn'] == 1
    assert torch.equal(got, K.fdn_advance_plain(lines, inject, g,
                                                BUS_LENGTHS))


@pytest.mark.cuda
@pytest.mark.parametrize('lanes,T', [(1, 64 * 1024), (64, 16 * 1024)])
def test_cuda_fdn_advance_vjp_matches_plain(lanes, T):
    """The adjoint kernel within 1e-5 of each plain output's largest value,
    the same bits twice."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    lines, inject, g = card_inputs(lanes, T, 6)
    L = lines.shape[0]
    tl = K.fdn_advance(lines, inject, g, BUS_LENGTHS)
    gtl = torch.randn(tl.shape, device='cuda',
                      generator=torch.Generator('cuda').manual_seed(7))
    K.reset_launch_counts()
    got = K.fdn_advance_vjp(tl, g, gtl, BUS_LENGTHS, L)
    again = K.fdn_advance_vjp(tl, g, gtl, BUS_LENGTHS, L)
    torch.cuda.synchronize()
    assert K.LAUNCHES['fdn_vjp'] == 2
    want = K.fdn_advance_vjp_plain(tl, g, gtl, BUS_LENGTHS, L)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        assert float((a - w).abs().max()) <= 1e-5 * float(w.abs().max())
