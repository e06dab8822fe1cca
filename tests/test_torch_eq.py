"""The RBJ EQ family, ``Pan``, ``Quantize`` and swept filters behind carried
state in the port against the JAX package.

On the CPU, at small sizes (F 256-1024, a few blocks, at most 4 voices),
the same graphs built in both packages from the same numbers:

* ``_design64`` / ``design_coupled`` for the five EQ types over a grid of
  frequency, gain and Q (the clip region, ``q <= 0``, gains past ±40 dB,
  frequencies past Nyquist included): the port's numpy design bit for bit
  the JAX package's, its torch float64 design within 1e-12 relative of the
  JAX function's under x64, the coupled form's clip bound held;
* each EQ node through the per-block plan, the whole-window plan, the
  streaming plan and the mix plan (4 voices), against the JAX render and
  the port's pull oracle at ``tests/test_eq.py``'s Q-scaled tolerances
  (1e-5 up to Q 4, 1e-4 at Q 8, 2.5e-4 at Q 16), and the flagship voice
  with a swept ``Peak`` in place of its LowPass at F 1024 (carry
  segments; the timeline and the generator-fed entries);
* ``Pan`` within 1e-5 and ``Quantize`` within 2e-5 relative, its ties to
  the first candidate;
* a swept filter with carry segments after a delay and after a streaming
  filter (once refused at compile time), from aligned and unaligned
  starts, on every plan that renders it, within 1e-5 of the JAX render and
  of the port's oracle.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

from signals_tpu_torch.compiler import compile_node
from signals_tpu_torch.compiler import filters as FI
from signals_tpu_torch.core.xp import NP, TorchXP
from signals_tpu_torch.parallel import PolyPatch

RATE = 44100
NYQ = RATE / 2.0
TOL = 1e-5
JAX, PORT = 'signals_tpu', 'signals_tpu_torch'
EQ_TYPES = (FI.PEAK, FI.NOTCH, FI.ALLPASS, FI.LOWSHELF, FI.HIGHSHELF)


def nodes(pkg):
    return {m: importlib.import_module(f'{pkg}.nodes.{m}')
            for m in ('delay', 'env', 'fixed', 'fx', 'osc')}


def fixed(mod, value):
    f = mod['fixed'].Fixed()
    f.get_state().value = np.atleast_2d(np.asarray(value, np.float32))
    return f


def osc(mod, kind, hz):
    o = getattr(mod['osc'], kind)()
    o.hertz = fixed(mod, hz)
    return o


def lfo(mod, hz, centre, depth):
    """``centre + depth * Sine(hz)`` as a Mix (both packages' idiom)."""
    g = mod['fx'].Gain()
    g.left = osc(mod, 'Sine', hz)
    g.right = fixed(mod, 2 * depth)
    m = mod['fx'].Mix()
    m.left = g
    m.right = fixed(mod, 2 * centre)
    m.mix = fixed(mod, 0.5)
    return m


def eq(mod, kind, inp, freq, q=None, gain=None, **state):
    node = getattr(mod['fx'], kind)()
    node.input = inp
    node.freq = freq if not isinstance(freq, float) else fixed(mod, freq)
    if q is not None:
        node.q = fixed(mod, q)
    if gain is not None:
        node.gain = fixed(mod, gain)
    for k, v in state.items():
        setattr(node.get_state(), k, v)
    return node


def pull_oracle(pkg, root, n, channels, F, start=0):
    core = importlib.import_module(f'{pkg}.core')
    return np.concatenate([np.broadcast_to(root.respond(core.Request(
        requestor=None, port='test',
        loc=core.BlockLoc(position=i * F, rate=RATE,
                          shape=core.Shape(F, channels)))), (F, channels))
        for i in range(start, start + n)])


def jax_compile(root, F, channels):
    import signals_tpu.compiler as C
    C._compile_cache.clear()
    return C.compile_node(root, block_frames=F, rate=RATE, channels=channels)


def port_compile(root, F, channels):
    return compile_node(root, block_frames=F, rate=RATE, channels=channels,
                        device='cpu')


def err(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max())


# --- the design ---------------------------------------------------------------

FREQS = [0.0, 5.0, 30.0, 120.0, 1000.0, 8000.0, 21000.0, 30000.0]
GAINS = [-55.0, -24.0, -4.0, 0.0, 3.0, 12.0, 45.0]
QS = [-1.0, 0.0, 0.05, 0.06, 0.3, 0.7071, 1.4, 4.0, 16.0, 60.0]


def design_grid(btype):
    f, g, q = np.meshgrid(FREQS, GAINS, QS, indexing='ij')
    f, g, q = (a.reshape(1, -1) for a in (f, g, q))
    return (f, g, q) if btype in FI._EQ_GAIN_TYPES else (f, q)


@pytest.mark.parametrize('btype', EQ_TYPES)
def test_design_eq_matches_jax_in_float64(btype):
    import jax
    import jax.numpy as jnp
    from signals_tpu.compiler import filters as JF
    crits = design_grid(btype)
    want_np = JF._design64(np, btype, crits, NYQ)
    got_np = FI._design64(NP, btype, crits, NYQ)
    assert got_np.dtype == np.float64 and np.array_equal(got_np, want_np)
    assert np.array_equal(FI.design_coupled(NP, btype, crits, NYQ),
                          JF.design_coupled(np, btype, crits, NYQ))
    xp = TorchXP('cpu')
    got = FI._design64(xp, btype, tuple(torch.as_tensor(c) for c in crits),
                       NYQ)
    assert got.dtype == torch.float64
    with jax.enable_x64(True):
        want = np.asarray(JF._design64(jnp, btype, tuple(
            jnp.asarray(c) for c in crits), NYQ))
    assert want.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)
    co = FI.design_coupled(xp, btype, tuple(torch.as_tensor(
        c.astype(np.float32)) for c in crits), np.float32(NYQ))
    assert co.dtype == torch.float32 and torch.isfinite(co).all()
    # the complex-pole-pair clip: |a1| <= 2 sqrt(a2) (1 - 1e-10), a2 in
    # [1e-12, 1 - 1e-9], and the coupled rotation's rs > 0
    a1, a2 = got[..., 4], got[..., 5]
    assert float(a2.min()) >= 1e-12 and float(a2.max()) <= 1 - 1e-9
    assert bool((a1.abs() <= 2 * a2.sqrt() * (1 - 1e-10)).all())
    assert float(co[..., 7].min()) > 0


def test_design_eq_domain_rules():
    """``q <= 0`` means the default Q, gains clip to ±40 dB, and a deep
    low-Q cut (real poles) lands on the clip bound."""
    def one(btype, *crits):
        return FI._design64(NP, btype, tuple(np.array([[c]]) for c in crits),
                            NYQ)
    default = one(FI.PEAK, 1000.0, 6.0, FI._Q_DEFAULT)
    assert np.array_equal(one(FI.PEAK, 1000.0, 6.0, 0.0), default)
    assert np.array_equal(one(FI.PEAK, 1000.0, 6.0, -3.0), default)
    assert np.array_equal(one(FI.LOWSHELF, 200.0, 70.0, 1.0),
                          one(FI.LOWSHELF, 200.0, 40.0, 1.0))
    cut = one(FI.PEAK, 1000.0, -24.0, 0.06)[0, 0]
    assert abs(cut[4]) == pytest.approx(2 * np.sqrt(cut[5]) * (1 - 1e-10),
                                        rel=1e-15)


# --- EQ nodes in every plan ---------------------------------------------------

EQ_CASES = {
    'peak': ('Peak', 660.0, 2.0, 9.0, TOL),
    'notch': ('Notch', 440.0, 4.0, None, TOL),
    'allpass': ('Allpass', 700.0, 1.0, None, TOL),
    'lowshelf': ('LowShelf', 500.0, None, -12.0, TOL),
    'highshelf': ('HighShelf', 2000.0, 1.0, 6.0, TOL),
    'lowshelf_120': ('LowShelf', 120.0, None, 3.0, TOL),
    'notch_q8': ('Notch', 440.0, 8.0, None, 1e-4),
    'peak_q16': ('Peak', 1000.0, 16.0, 6.0, 2.5e-4),
}


def eq_voice(pkg, case, plan, hz=(220.0,)):
    kind, freq, q, gain, _ = EQ_CASES[case]
    mod = nodes(pkg)
    saw = osc(mod, 'Sawtooth', np.asarray(hz, np.float32).reshape(1, -1))
    state = {'context': 1024}
    if plan == 'streaming':
        state['streaming'] = True
    node = eq(mod, kind, saw, freq, q, gain, **state)
    out = mod['fx'].Gain()
    out.left = node
    out.right = fixed(mod, 0.5)
    return out, saw


@pytest.mark.parametrize('plan', ['blocks', 'mega', 'streaming'])
@pytest.mark.parametrize('case', list(EQ_CASES))
def test_eq_nodes_match_jax_and_oracle(case, plan):
    F, nb, tol = 256, 8, EQ_CASES[case][4]
    pc = port_compile(eq_voice(PORT, case, plan)[0], F, 1)
    if plan == 'blocks':
        pc.enable_mega = False
    assert pc.plan(nb) == ('blocks' if plan == 'blocks' else 'mega')
    got, _ = pc.render(position=F, n_blocks=nb)
    want, _ = jax_compile(eq_voice(JAX, case, plan)[0], F, 1).render(
        position=F, n_blocks=nb)
    assert err(got, want) <= tol
    # the oracle's pull starts at block 1 too (a streaming filter's state
    # starts there)
    oracle = pull_oracle(PORT, eq_voice(PORT, case, plan)[0], nb, 1, F,
                         start=1)
    assert err(got, oracle) <= tol


@pytest.mark.parametrize('case', ['peak', 'lowshelf', 'peak_q16'])
def test_eq_mix_plan_matches_jax(case):
    """Four saws through one EQ, voice-summed on the mix plan (the static
    crits' timeline segments, the sum in the kernel)."""
    from signals_tpu.parallel import PolyPatch as JPoly
    F, nb, hz = 256, 6, 110.0 * 2 ** (np.arange(4) / 12.0)
    tol = 4 * EQ_CASES[case][4]
    out = {}
    for pkg, cls, kw in ((PORT, PolyPatch, {'device': 'cpu',
                                            'mix_epilogue': True}),
                         (JAX, JPoly, {})):
        root, saw = eq_voice(pkg, case, 'mega')
        poly = cls(root, n_voices=4, overrides={
            (saw._ports['hertz'].sig, 'value'): hz.astype(np.float32)},
            block_frames=F, rate=RATE, **kw)
        if pkg == PORT:
            assert poly.compiled.mega_mix(nb) is not None
        out[pkg] = poly.render(n_blocks=nb)[0]
    assert err(out[PORT], out[JAX]) <= tol
    root, _ = eq_voice(PORT, case, 'mega', hz)
    oracle = pull_oracle(PORT, root, nb, 4, F).sum(axis=1, keepdims=True)
    assert err(out[PORT], oracle) <= tol


def swept_peak_voice(pkg, n_voices=4):
    """The flagship voice with a ``Peak`` (+6 dB, Q 1, its freq swept by
    the 0.5 Hz LFO around 1 kHz) in place of its LowPass."""
    mod = nodes(pkg)
    hz = fixed(mod, (110.0 * 2 ** (np.arange(n_voices) / 12.0)
                     ).reshape(1, n_voices))
    saw = mod['osc'].Sawtooth()
    saw.hertz = hz
    pk = eq(mod, 'Peak', saw, lfo(mod, 0.5, 1000.0, 450.0), 1.0, 6.0,
            context=512)
    gate = osc(mod, 'Square', 2.0)
    env = mod['env'].ADSR()
    env.gate = gate
    voiced = mod['fx'].RingMod()
    voiced.left = pk
    voiced.right = env
    out = mod['fx'].Gain()
    out.left = voiced
    out.right = fixed(mod, 1.0 / n_voices)
    return out


@functools.lru_cache(maxsize=None)
def jax_render(build, F, channels, start, nb, *args):
    """The JAX render of ``build(JAX, *args)`` (compiled once per graph)."""
    compiled = jax_compiled(build, F, channels, *args)
    return np.asarray(compiled.render(position=start * F, n_blocks=nb)[0])


@functools.lru_cache(maxsize=None)
def jax_compiled(build, F, channels, *args):
    return jax_compile(build(JAX, *args), F, channels)


@pytest.mark.parametrize('gen', [False, True], ids=['timeline', 'gen'])
def test_swept_peak_flagship_matches_jax(gen):
    """F 1024: the Peak's carry segments, through the timeline segment
    entry and the generator-fed one (the mix plan of the card), against
    the JAX render from block 0 and block 3 and the oracle."""
    F, nb = 1024, 10
    old = FI.SEG_SOURCE_GEN
    FI.SEG_SOURCE_GEN = gen
    try:
        pc = port_compile(swept_peak_voice(PORT), F, 4)
    finally:
        FI.SEG_SOURCE_GEN = old
    assert pc.carry_seg_align == 8 and pc.plan(nb) == 'mega'
    for start in (0, 3):
        got, _ = pc.render(position=start * F, n_blocks=nb)
        assert err(got, jax_render(swept_peak_voice, F, 4, start, nb)) <= TOL
    oracle = pull_oracle(PORT, swept_peak_voice(PORT), nb, 4, F)
    got, _ = pc.render(n_blocks=nb)
    assert err(got, oracle) <= TOL
    mix = pc.mega_mix(nb)
    assert mix is not None
    summed = mix(pc.params(), 0).reshape(nb * F, 1)
    assert err(summed, oracle.sum(axis=1, keepdims=True)) <= 4 * TOL


@pytest.mark.parametrize('kind,freq,q,gain', [
    ('LowShelf', 120.0, None, 3.0), ('Notch', 60.0, 4.0, None)])
def test_low_poles_follow_the_float64_design(kind, freq, q, gain):
    """Poles near the unit circle (the bounce's 120 Hz shelf and 60 Hz
    notch, a 55 Hz saw through them): the port within 1e-5 of the JAX
    render and of the oracle with its design kept in float64
    (``torch_refs.exact_design``); the oracle on its float32-rounded b/a
    coefficients lies further off the float64 design than the port."""
    import torch_refs
    F, nb = 1024, 4

    def build(pkg):
        mod = nodes(pkg)
        return eq(mod, kind, osc(mod, 'Sawtooth', 55.0), freq, q, gain)

    got, _ = port_compile(build(PORT), F, 1).render(n_blocks=nb)
    want, _ = jax_compile(build(JAX), F, 1).render(n_blocks=nb)
    assert err(got, want) <= TOL
    with torch_refs.exact_design():
        exact = pull_oracle(PORT, build(PORT), nb, 1, F)
    assert err(got, exact) <= TOL
    rounded = pull_oracle(PORT, build(PORT), nb, 1, F)
    assert err(got, exact) < err(rounded, exact)


# --- Pan and Quantize ---------------------------------------------------------

def pan_patch(pkg, stereo_in=False):
    mod = nodes(pkg)
    src = osc(mod, 'Sawtooth', [[220.0, 330.0]] if stereo_in else 220.0)
    p = mod['fx'].Pan()
    p.input = src
    p.position = lfo(mod, 1.5, 0.0, 0.9)
    return p


@pytest.mark.parametrize('stereo_in', [False, True])
def test_pan_matches_jax_and_oracle(stereo_in):
    F, nb = 256, 6
    pc = port_compile(pan_patch(PORT, stereo_in), F, 2)
    assert pc.root.channels == 2
    for mega in (True, False):
        pc.enable_mega = mega
        pc._render_cache.clear()
        got, _ = pc.render(n_blocks=nb)
        want, _ = jax_compile(pan_patch(JAX, stereo_in), F, 2).render(
            n_blocks=nb)
        assert err(got, want) <= TOL
        assert err(got, pull_oracle(PORT, pan_patch(PORT, stereo_in), nb, 2,
                                    F)) <= TOL


def quantize_patch(pkg, scale=(0, 2, 4, 5, 7, 9, 11)):
    mod = nodes(pkg)
    q = mod['fx'].Quantize()
    q.input = lfo(mod, 3.0, 500.0, 380.0)
    q.get_state().scale = np.asarray([scale], np.float32)
    q.get_state().root = 261.6256
    return q


def test_quantize_matches_jax_and_oracle():
    F, nb = 256, 6
    got, _ = port_compile(quantize_patch(PORT), F, 1).render(n_blocks=nb)
    want, _ = jax_compile(quantize_patch(JAX), F, 1).render(n_blocks=nb)
    oracle = pull_oracle(PORT, quantize_patch(PORT), nb, 1, F)
    for ref in (np.asarray(want), oracle):
        rel = np.abs(got.numpy() - ref) / np.abs(ref)
        assert float(rel.max()) <= 2e-5


def test_quantize_ties_pick_the_first_candidate():
    """A pitch exactly between two tones of the scale: numpy's ``argmin``
    and the port's pick the first (lower) candidate."""
    from signals_tpu_torch.core.xp import TorchXP as X
    d = torch.tensor([[[3.0, 1.0, 1.0, 2.0], [0.5, 0.5, 0.5, 0.5]]])
    assert X('cpu').argmin(d, axis=2).tolist() == [[1, 0]]
    assert np.argmin(d.numpy(), axis=2).tolist() == [[1, 0]]
    F = 256
    mod = nodes(PORT)
    q = mod['fx'].Quantize()
    q.input = fixed(mod, 261.6256 * 2 ** (1 / 12))    # C#: between C and D
    q.get_state().scale = np.asarray([[0, 2]], np.float32)
    got, _ = port_compile(q, F, 1).render(n_blocks=1)
    oracle = pull_oracle(PORT, q, 1, 1, F)
    assert err(got, oracle) <= 2e-5 * float(np.abs(oracle).max())


# --- swept filters behind carried state ---------------------------------------

def swept_behind(pkg, what, kind='LowPass'):
    """A saw -> [a 2-block + 100-frame delay | a streaming LowPass 3 kHz]
    -> a filter swept by a 0.5 Hz LFO (carry segments of 8 blocks, context
    512)."""
    mod = nodes(pkg)
    src = osc(mod, 'Sawtooth', 110.0)
    if what == 'delay':
        up = mod['delay'].Delay()
        up.get_state().frames = 2 * 1024 + 100
        up.get_state().channels = 1
        up.input = src
    else:
        up = mod['fx'].LowPass()
        up.input = src
        up.cutoff = fixed(mod, 3000.0)
        up.get_state().streaming = True
    sweep = lfo(mod, 0.5, 1200.0, 700.0)
    if kind == 'LowPass':
        sw = mod['fx'].LowPass()
        sw.input = up
        sw.cutoff = sweep
        sw.get_state().context = 512
    else:
        sw = eq(mod, 'Peak', up, sweep, 2.0, 6.0, context=512)
    out = mod['fx'].Gain()
    out.left = sw
    out.right = fixed(mod, 0.5)
    return out


@pytest.mark.parametrize('start', [0, 3])
@pytest.mark.parametrize('plan', ['whole', 'blocks'])
@pytest.mark.parametrize('what,kind', [('delay', 'LowPass'),
                                       ('streaming', 'LowPass'),
                                       ('streaming', 'Peak')])
def test_swept_behind_carried_state(what, kind, plan, start):
    """From block 0 and from block 3 (inside a carry segment), on the
    whole-window plan and per block, 10 blocks (past a segment boundary)."""
    F, nb = 1024, 10
    pc = port_compile(swept_behind(PORT, what, kind), F, 1)
    assert pc.carry_seg_align == 8
    if plan == 'blocks':
        pc.enable_mega = False
    else:
        assert pc.plan(nb) == ('delay_mega' if what == 'delay' else 'mega')
    got, _ = pc.render(position=start * F, n_blocks=nb)
    want = jax_render(swept_behind, F, 1, start, nb, what, kind)
    assert err(got, want) <= TOL
    if start == 0 and plan == 'whole':
        oracle = pull_oracle(PORT, swept_behind(PORT, what, kind), nb, 1, F)
        assert err(got, oracle) <= TOL


def test_swept_behind_streaming_history_ring():
    """The collect pass sizes the streaming producer's ``hist`` ring for
    the swept filter's lookback: 7 blocks and the context, as the render
    from block 7 reads the segment from block 0."""
    pc = port_compile(swept_behind(PORT, 'streaming'), 1024, 1)
    (hist,) = [c['hist'] for c in pc.carry0.values() if 'hist' in c]
    assert tuple(hist.shape) == (7 * 1024 + 512, 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('btype,crits', [
    (FI.LOWSHELF, (30.0, 6.0, 0.7071)), (FI.PEAK, (1000.0, 6.0, 16.0))])
def test_cuda_kernels_on_rbj_poles(cuda_device, btype, crits):
    """K2-K4 on RBJ coefficients (a 30 Hz low shelf, a Q 16 peak) against
    their plain versions on the card, the same bits twice."""
    from signals_tpu_torch.compiler import kernels as K
    dev = cuda_device
    rng = np.random.default_rng(0)
    lanes, nb, F, C = 32, 16, 1024, 512
    co1 = FI.design_coupled(TorchXP(dev), btype, tuple(
        torch.full((1, nb * lanes), c, device=dev) for c in crits),
        np.float32(NYQ))
    co = co1.reshape(1, nb, lanes, 11).permute(1, 0, 2, 3).contiguous()
    x = torch.as_tensor(rng.standard_normal((C + nb * F, lanes))
                        .astype(np.float32), device=dev)
    calls = [
        (lambda: K.sosfilt_segments(co, x, n_segments=nb, seg_frames=F,
                                    context=C, blocks_per_seg=8),
         lambda: K.sosfilt_segments_plain(co, x, n_segments=nb, seg_frames=F,
                                          context=C, blocks_per_seg=8)),
        (lambda: K.sosfilt_timeline(co[0], x[:C + F]),
         lambda: K.sosfilt_timeline_plain(co[0], x[:C + F])),
        (lambda: K.sosfilt_batch(co, x.unfold(0, C + F, F)[:nb].permute(
            2, 0, 1), tail=F),
         lambda: K.sosfilt_batch_plain(co, x.unfold(0, C + F, F)[:nb].permute(
             2, 0, 1), tail=F))]
    for call, plain in calls:
        got = call()
        assert torch.equal(got, call())
        assert float((got - plain()).abs().max()) <= 1e-4
