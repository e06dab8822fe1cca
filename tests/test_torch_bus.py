"""The master bus and the noise sources of the port against the JAX package.

Same graphs or same seeded numpy inputs through the JAX function and its
counterpart in the port, on the CPU, at small sizes:

* every name ``core/xp.py`` gained, against numpy;
* ``core.rng.uniform01`` bit for bit against the JAX package under numpy
  and ``jax.numpy``: frame indices near 0, negative (context rows wrap
  through uint32), above 2**24 and at both ends of int32, salts 0 and >= 1,
  seeds 0 and large;
* ``White``, ``Pink``, ``SampleHold`` bit for bit: the port's pull engine
  and compiled render against the JAX pull engine and compiled render;
* the explicit-channels walk of ``PolyPatch`` (a mono noise source under a
  wide consumer is accepted, a wide input into a narrow explicit-channel
  node refused with the JAX package's message) and the timeline segment
  kernel's wrapper on a one-channel input;
* ``Reverb``: the pull engines bit for bit, ``mega_step`` against steps and
  the JAX render, split windows, a carry begun in the JAX package;
* ``Compressor``, ``Gate``, ``Limiter`` against the JAX pull engine and
  compiled render within 1e-5; the float64 cumulative sum of ``_rms_env``;
* the master bus (bench c7) whole, split, through the ``Transport``, block
  by block, and with a one-block tail window; on the card (``-m cuda``)
  its network kernel bit for bit the plain turn loop.
"""

import importlib

import numpy as np
import pytest
import torch

from signals_tpu_torch.compiler import compile_node
from signals_tpu_torch.compiler import kernels as K
from signals_tpu_torch.core.xp import NP, TorchXP
from signals_tpu_torch.interop import carry_from_jax, params_from_jax
from signals_tpu_torch.runtime import Transport

RATE = 44100
TOL = 1e-5
JAX, PORT = 'signals_tpu', 'signals_tpu_torch'
XP = TorchXP('cpu')


def mods(pkg):
    return {m: importlib.import_module(f'{pkg}.nodes.{m}')
            for m in ('delay', 'dyn', 'env', 'fixed', 'fx', 'noise', 'osc',
                      'reverb')}


def fixed(mod, value):
    f = mod['fixed'].Fixed()
    f.get_state().value = np.atleast_2d(np.asarray(value, np.float32))
    return f


def saw(mod, hz):
    o = mod['osc'].Sawtooth()
    o.hertz = fixed(mod, hz)
    return o


def gain(mod, left, amount):
    g = mod['fx'].Gain()
    g.left = left
    g.right = fixed(mod, amount)
    return g


def pull(pkg, root, n_blocks, frames, channels, position=0):
    core = importlib.import_module(f'{pkg}.core')
    return np.concatenate([np.broadcast_to(root.respond(core.Request(
        requestor=None, port='test',
        loc=core.BlockLoc(position=position + i * frames, rate=RATE,
                          shape=core.Shape(frames, channels)))),
        (frames, channels)) for i in range(n_blocks)])


def jax_patch(root, frames, channels):
    import signals_tpu.compiler as C
    C._compile_cache.clear()
    return C.compile_node(root, block_frames=frames, rate=RATE,
                          channels=channels)


def port_patch(root, frames, channels):
    return compile_node(root, block_frames=frames, rate=RATE,
                        channels=channels, device='cpu')


# --- core/xp.py ---------------------------------------------------------------


def _xp_cases():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((12, 5)).astype(np.float32)
    b = rng.standard_normal((6, 4, 3)).astype(np.float32)
    n = rng.integers(-2 ** 31, 2 ** 31 - 1, (9, 2)).astype(np.int32)
    return {
        'exp': (lambda xp, t: xp.exp(t(a)), None),
        'sum': (lambda xp, t: xp.sum(t(b), axis=1), 1e-6),
        'mean': (lambda xp, t: xp.mean(t(a), axis=1), 1e-6),
        'min': (lambda xp, t: xp.min(t(b), axis=1), 0),
        'max': (lambda xp, t: xp.max(t(b), axis=1), 0),
        'cumsum': (lambda xp, t: xp.cumsum(
            xp.astype(t(a), xp.float64), axis=0), 1e-12),
        'reshape': (lambda xp, t: xp.reshape(t(b), (12, 6)), 0),
        'pad': (lambda xp, t: xp.pad(t(a), ((3, 0), (0, 0))), 0),
        'pad_after': (lambda xp, t: xp.pad(t(a), ((0, 2), (0, 0))), 0),
        'fft.rfft': (lambda xp, t: xp.abs(xp.fft.rfft(t(a[:, 0]))), 1e-5),
        'rshift': (lambda xp, t: t(n) >> 5, 0),
        'xor': (lambda xp, t: t(n) ^ 0x5BD1E995, 0),
        'and': (lambda xp, t: (t(n) >> 16) & 0xFFFF, 0),
    }


@pytest.mark.parametrize('name', list(_xp_cases()))
def test_xp_name_behaves_as_numpy(name):
    fn, tol = _xp_cases()[name]
    want = np.asarray(fn(NP, np.asarray))
    got = fn(XP, torch.as_tensor)
    assert isinstance(got, torch.Tensor)
    got = got.numpy()
    assert got.shape == want.shape
    if tol is None:                     # a library function: 1 ulp
        np.testing.assert_allclose(got, want, rtol=2.0 ** -22)
    elif tol == 0:
        assert got.dtype == want.dtype and np.array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= tol


# --- core/rng.py ----------------------------------------------------------------

BASES = {'zero': 0, 'negative': -300, 'above_2^24': (1 << 24) - 50,
         'near_2^31': (1 << 31) - 200, 'int32_min': -(1 << 31)}


@pytest.mark.parametrize('salt', [0, 1, 7])
@pytest.mark.parametrize('seed', [0, 123456789, 2 ** 31 - 1])
@pytest.mark.parametrize('base', list(BASES))
def test_uniform01_bit_exact(base, seed, salt):
    import jax.numpy as jnp
    from signals_tpu.core.rng import uniform01 as want_fn
    from signals_tpu_torch.core.rng import uniform01
    f = (BASES[base] + np.arange(200, dtype=np.int64)).astype(
        np.int32).reshape(-1, 1)
    want = want_fn(np, seed, f, 3, salt=salt)
    jax_out = np.asarray(want_fn(jnp, jnp.int32(seed), jnp.asarray(f), 3,
                                 salt=salt))
    got_np = uniform01(NP, seed, f, 3, salt=salt)
    got = uniform01(XP, torch.tensor(seed, dtype=torch.int32),
                    torch.as_tensor(f), 3, salt=salt)
    assert got.dtype == torch.float32 and got.shape == (200, 3)
    assert np.array_equal(want, jax_out)
    assert np.array_equal(got_np, want)
    assert np.array_equal(got.numpy(), want)
    assert 0.0 <= want.min() and want.max() < 1.0


# --- nodes/noise.py ---------------------------------------------------------------


def noise_node(pkg, name):
    mod = mods(pkg)
    node = getattr(mod['noise'], name)()
    st = node.get_state()
    st.channels, st.seed = 3, 20240607
    if name == 'SampleHold':
        node.rate = fixed(mod, [[7.0, 31.0, 440.0]])
    return node


@pytest.mark.parametrize('position', [0, 5859 * 512],
                         ids=['from_0', 'at_68s'])
@pytest.mark.parametrize('name', ['White', 'Pink', 'SampleHold'])
def test_noise_nodes_bit_exact(name, position):
    frames, nb = 512, 4
    want = pull(JAX, noise_node(JAX, name), nb, frames, 3, position)
    jax_out, _ = jax_patch(noise_node(JAX, name), frames, 3).render(
        position=position, n_blocks=nb)
    got_pull = pull(PORT, noise_node(PORT, name), nb, frames, 3, position)
    got = port_patch(noise_node(PORT, name), frames, 3).render(
        position=position, n_blocks=nb)[0].numpy()
    assert np.array_equal(np.asarray(jax_out), want)
    assert np.array_equal(got_pull, want)
    assert np.array_equal(got, want)
    assert 0.0 <= want.min() and want.max() < 1.0 and want.std() > 0.05


def test_white_seed_is_a_traced_int32_param():
    node = noise_node(PORT, 'White')
    patch = port_patch(node, 256, 3)
    params = patch.params()
    seed = next(p['seed'] for p in params.values() if 'seed' in p)
    assert seed.dtype == torch.int32 and int(seed) == 20240607
    a = patch.render(n_blocks=2)[0]
    node.get_state().seed = 5
    b = patch.render(n_blocks=2)[0]           # no recompilation
    assert not torch.equal(a, b)
    fresh = noise_node(PORT, 'White')
    fresh.get_state().seed = 5
    assert torch.equal(b, port_patch(fresh, 256, 3).render(n_blocks=2)[0])


# --- PolyPatch: explicit channels ---------------------------------------------


def noise_voice(pkg):
    mod = mods(pkg)
    lp = mod['fx'].LowPass()
    lp.input = mod['noise'].White()
    cut = fixed(mod, 2000.0)
    lp.cutoff = cut
    lp.get_state().context = 256
    return gain(mod, lp, 1.0 / 64), cut


def narrow_delay_voice(pkg):
    mod = mods(pkg)
    hz = fixed(mod, 110.0)
    osc = mod['osc'].Sawtooth()
    osc.hertz = hz
    d = mod['delay'].Delay()
    d.get_state().frames = 2048
    d.input = osc                      # V wide into one explicit channel
    m = mod['fx'].Mix()
    m.left = osc
    m.right = d
    m.mix = fixed(mod, 0.5)
    return m, hz


def test_poly_accepts_a_mono_source_and_refuses_a_narrow_delay():
    from signals_tpu.parallel import PolyPatch as JaxPoly
    from signals_tpu_torch.parallel import PolyPatch
    cuts = np.linspace(1000.0, 4000.0, 4).astype(np.float32)
    root, cut = noise_voice(PORT)
    poly = PolyPatch(root, n_voices=4, overrides={(cut, 'value'): cuts},
                     block_frames=256, rate=RATE, device='cpu')
    assert poly.render(n_blocks=2)[0].shape == (512, 1)
    hz = np.float32([110.0, 220.0, 330.0, 440.0])
    messages = []
    for pkg, cls, kw in ((JAX, JaxPoly, {}), (PORT, PolyPatch,
                                              {'device': 'cpu'})):
        root, node = narrow_delay_voice(pkg)
        with pytest.raises(ValueError) as e:
            cls(root, n_voices=4, overrides={(node, 'value'): hz},
                block_frames=256, rate=RATE, **kw)
        messages.append(str(e.value).replace(pkg, 'PKG'))
    assert messages[0] == messages[1]
    assert 'declares 1 explicit channel(s) but its input is 4 wide' \
        in messages[1]


@pytest.mark.parametrize('sum_groups', [0, 8])
def test_segments_one_channel_input_is_the_broadcast_input(sum_groups):
    """A (T, 1) timeline under 8 coefficient lanes gives the bits of the
    same timeline copied into 8 lanes."""
    from signals_tpu_torch.compiler.filters import design_coupled
    rng = np.random.default_rng(3)
    nb, frames, C, m, lanes = 4, 64, 32, 2, 8
    cuts = torch.as_tensor(rng.uniform(500.0, 4000.0, (1, lanes))
                           .astype(np.float32))
    co = design_coupled(XP, 'lp', (cuts,), np.float32(RATE / 2))
    co = torch.broadcast_to(co[None], (nb // m, 1, lanes, 11))
    x = torch.as_tensor(rng.uniform(0, 1, (C + nb * frames, 1))
                        .astype(np.float32))
    kw = dict(n_segments=nb // m, seg_frames=m * frames, context=C,
              sum_groups=sum_groups)
    narrow = K.sosfilt_segments(co, x, **kw)
    wide = K.sosfilt_segments(co, x.expand(-1, lanes).contiguous(), **kw)
    assert narrow.shape == (nb // m, m * frames,
                            1 if sum_groups else lanes)
    assert torch.equal(narrow, wide)


# --- nodes/reverb.py ----------------------------------------------------------------


def reverb_patch(pkg, channels=1, size=1.0, t60=1.2, mix=0.4):
    mod = mods(pkg)
    hz = 110.0 * (1 + 0.37 * np.arange(channels, dtype=np.float32))
    rv = mod['reverb'].Reverb()
    rv.input = gain(mod, saw(mod, hz.reshape(1, -1)), 0.5)
    st = rv.get_state()
    st.size, st.t60, st.mix = size, t60, mix
    return rv


@pytest.mark.parametrize('frames,channels,size', [(256, 1, 1.0),
                                                  (1024, 2, 0.5)])
def test_reverb_pull_bit_exact_vs_jax_pull(frames, channels, size):
    """The stacked Hadamard sum performs the reference's products and sums,
    element for element."""
    nb = 12
    want = pull(JAX, reverb_patch(JAX, channels, size), nb, frames, channels)
    got = pull(PORT, reverb_patch(PORT, channels, size), nb, frames,
               channels)
    assert np.array_equal(got, want)
    assert np.abs(want[-frames:]).max() > 0.05


@pytest.mark.parametrize('frames,nb,channels,size', [
    (256, 4, 1, 1.0),      # one turn (1024 frames < the 1310-frame line)
    (256, 24, 2, 1.0),     # several turns, the last one short
    (1024, 9, 1, 0.5),     # lines clamped to a block: a turn is a block
])
def test_reverb_mega_step_matches_steps_and_jax(frames, nb, channels, size):
    jax_out, jcarry = jax_patch(reverb_patch(JAX, channels, size), frames,
                                channels).render(n_blocks=nb)
    patch = port_patch(reverb_patch(PORT, channels, size), frames, channels)
    assert patch.plan(nb) == 'mega'
    got, carry = patch.render(n_blocks=nb)
    params, c, blocks = patch.params(), patch.carry0, []
    for i in range(nb):
        block, c = patch.step(params, c, i * frames)
        blocks.append(block)
    steps = torch.cat(blocks)
    oracle = pull(PORT, reverb_patch(PORT, channels, size), nb, frames,
                  channels)
    assert float((got - steps).abs().max()) <= 1e-6
    assert np.abs(got.numpy() - np.asarray(jax_out)).max() <= TOL
    assert np.abs(got.numpy() - oracle).max() <= TOL
    (lines,) = [v['lines'] for v in carry.values()]
    (step_lines,) = [v['lines'] for v in c.values()]
    (jax_lines,) = [np.asarray(v['lines']) for v in jcarry.values()]
    assert lines.shape == step_lines.shape == jax_lines.shape
    assert float((lines - step_lines).abs().max()) <= 1e-6
    assert np.abs(lines.numpy() - jax_lines).max() <= TOL


def test_reverb_continues_a_jax_carry_and_jax_params():
    frames, channels = 256, 2
    jp = jax_patch(reverb_patch(JAX, channels, t60=0.7, mix=0.9), frames,
                   channels)
    whole, _ = jp.render(n_blocks=20)
    _, jcarry = jp.render(n_blocks=7)
    patch = port_patch(reverb_patch(PORT, channels), frames, channels)
    params = params_from_jax(jp.params(), 'cpu')
    assert params.keys() == patch.params().keys()
    leaves = {k for p in params.values() for k in p}
    assert {'t60', 'mix'} <= leaves
    carry = carry_from_jax(jcarry, 'cpu')
    blocks, _, _ = patch.render_core(13)(params, carry, 7 * frames)
    got = blocks.reshape(13 * frames, channels).numpy()
    assert np.abs(got - np.asarray(whole)[7 * frames:]).max() <= TOL


# --- nodes/dyn.py ---------------------------------------------------------------------


def dyn_patch(pkg, name):
    """A loud two-channel saw, amplitude-modulated by a slow sine so that
    the envelope crosses the thresholds, through ``name``."""
    mod = mods(pkg)
    lfo = mod['osc'].Sine()
    lfo.hertz = fixed(mod, 3.0)
    am = mod['fx'].RingMod()
    am.left = saw(mod, [[110.0, 173.0]])
    am.right = lfo
    node = getattr(mod['dyn'], name)()
    node.input = am
    st = node.get_state()
    if name == 'Compressor':
        st.window, st.threshold, st.ratio, st.makeup = 300, 0.25, 4.0, 1.5
    elif name == 'Gate':
        st.window, st.threshold, st.ratio, st.floor = 300, 0.3, 3.0, 0.05
    else:
        st.lookahead, st.ceiling = 37, 0.6
    return node


@pytest.mark.parametrize('name', ['Compressor', 'Gate', 'Limiter'])
def test_dynamics_match_jax(name):
    frames, nb = 256, 24
    want = pull(JAX, dyn_patch(JAX, name), nb, frames, 2)
    jax_out, _ = jax_patch(dyn_patch(JAX, name), frames, 2).render(
        n_blocks=nb)
    got_pull = pull(PORT, dyn_patch(PORT, name), nb, frames, 2)
    patch = port_patch(dyn_patch(PORT, name), frames, 2)
    got = patch.render(n_blocks=nb)[0].numpy()
    params = patch.params()
    steps = torch.cat([patch.step(params, {}, i * frames)[0]
                       for i in range(nb)]).numpy()
    assert np.abs(got_pull - want).max() <= TOL
    assert np.abs(got - want).max() <= TOL
    assert np.abs(got - np.asarray(jax_out)).max() <= TOL
    assert np.abs(steps - want).max() <= TOL
    # the node did something: it is not the dry signal
    dry = pull(PORT, dyn_patch(PORT, name)._ports['input'].sig, nb, frames,
               2)
    assert np.abs(want[frames:] - dry[frames:]).max() > 0.05
    if name == 'Limiter':
        assert np.abs(got).max() <= 0.6 + 1e-6
    leaves = {k for p in params_from_jax(
        jax_patch(dyn_patch(JAX, name), frames, 2).params(),
        'cpu').values() for k in p}
    assert leaves >= {'Compressor': {'threshold', 'ratio', 'makeup'},
                      'Gate': {'threshold', 'ratio', 'floor'},
                      'Limiter': {'ceiling'}}[name]


def test_rms_env_cumulative_sum_is_float64(monkeypatch):
    seen = []
    real = torch.cumsum

    def spy(x, *a, **kw):
        seen.append(x.dtype)
        return real(x, *a, **kw)

    monkeypatch.setattr(torch, 'cumsum', spy)
    patch = port_patch(dyn_patch(PORT, 'Compressor'), 256, 2)
    out = patch.render(n_blocks=4)[0]
    assert seen and all(d == torch.float64 for d in seen)
    assert out.dtype == torch.float32


# --- the master bus (bench.py:256-278) ------------------------------------------------

F = 1024


def master_bus(pkg):
    mod = mods(pkg)
    lfo = mod['osc'].Sine()
    lfo.hertz = fixed(mod, 0.5)
    cutoff = mod['fx'].Mix()
    cutoff.left = gain(mod, lfo, 900.0)
    cutoff.right = fixed(mod, 2000.0)
    cutoff.mix = fixed(mod, 0.5)
    lp = mod['fx'].LowPass()
    lp.input = saw(mod, 110.0)
    lp.cutoff = cutoff
    lp.get_state().context = 512
    gate = mod['osc'].Square()
    gate.hertz = fixed(mod, 2.0)
    env = mod['env'].ADSR()
    env.gate = gate
    st = env.get_state()
    st.attack, st.decay, st.sustain, st.release = 0.01, 0.08, 0.6, 0.1
    voiced = mod['fx'].RingMod()
    voiced.left = lp
    voiced.right = env
    rv = mod['reverb'].Reverb()
    rv.input = gain(mod, voiced, 1.0 / 64)
    comp = mod['dyn'].Compressor()
    st = comp.get_state()
    st.window, st.threshold, st.ratio = 2 * F, 0.25, 4.0
    comp.input = rv
    return gain(mod, comp, 0.9)


@pytest.fixture(scope='module')
def bus():
    """The port's patch, its 32-block render, the port's oracle and the
    JAX render."""
    patch = port_patch(master_bus(PORT), F, 1)
    whole, carry = patch.render(n_blocks=32)
    oracle = pull(PORT, master_bus(PORT), 32, F, 1)
    jax_out, _ = jax_patch(master_bus(JAX), F, 1).render(n_blocks=32)
    return patch, whole, carry, oracle, np.asarray(jax_out)


def test_master_bus_plan_and_parity(bus):
    patch, whole, carry, oracle, jax_out = bus
    assert patch.plan(32) == 'mega' and patch.carry_seg_align == 8
    assert sorted(k for c in carry.values() for k in c) == ['hist', 'lines']
    assert np.abs(whole.numpy() - oracle).max() <= TOL
    assert np.abs(whole.numpy() - jax_out).max() <= TOL
    assert np.abs(oracle).max() > 500 * TOL


@pytest.mark.parametrize('cut', [13, 8, 31])
def test_master_bus_split_equals_whole(bus, cut):
    """13 + 19 (the second part starts off the carry-segment grid), 8 + 24,
    and 31 + a one-block tail window (``step``)."""
    patch, whole, _, _, _ = bus
    a, carry = patch.render(n_blocks=cut)
    b, _ = patch.render(position=cut * F, n_blocks=32 - cut, carry=carry)
    assert float((torch.cat([a, b]) - whole).abs().max()) <= 1e-6


def test_master_bus_through_the_transport(bus):
    patch, whole, _, oracle, _ = bus
    tr = Transport(patch, consumer=None, blocks_per_call=8)
    got = np.concatenate([tr.render(8) for _ in range(4)])
    assert np.abs(got - whole.numpy()).max() <= 1e-6
    assert np.abs(got - oracle).max() <= TOL


def test_master_bus_block_by_block(bus):
    patch, whole, _, _, _ = bus
    patch.enable_mega = False
    patch._render_cache.clear()
    try:
        assert patch.plan(12) == 'blocks'
        got, _ = patch.render(n_blocks=12)
    finally:
        patch.enable_mega = True
        patch._render_cache.clear()
    assert float((got - whole[:12 * F]).abs().max()) <= 1e-6


def test_reverb_in_a_feedback_scan_with_a_one_block_tail():
    """A delay ahead of the reverb: the segmented scan's windows
    ``mega_step`` the reverb, and the one-block tail takes ``step``."""
    def build(pkg):
        mod = mods(pkg)
        d = mod['delay'].Delay()
        d.get_state().frames = 4 * 256 + 3
        shaper = mod['fx'].Drive()
        shaper.input = gain(mod, d, 0.5)
        shaper.drive = fixed(mod, 2.0)
        m = mod['fx'].Mix()
        m.left = saw(mod, 110.0)
        m.right = shaper
        m.mix = fixed(mod, 0.6)
        d.input = m
        rv = mod['reverb'].Reverb()
        rv.input = m
        return rv

    patch = port_patch(build(PORT), 256, 1)
    assert patch.plan(13) == 'segment_scan'
    got = patch.render(n_blocks=13)[0].numpy()
    want = pull(PORT, build(PORT), 13, 256, 1)
    assert np.abs(got - want).max() <= TOL
    jax_steps = pull(JAX, build(JAX), 13, 256, 1)
    assert np.abs(got - jax_steps).max() <= TOL


# --- on the card ------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_master_bus_fdn_kernel_equals_plain_turns(monkeypatch):
    """On a GPU the reverb advances through the FDN kernel: the same bits
    as the plain turn loop, audio and carry, and the oracle's values; the
    voice ahead of it takes one generator-kernel launch and the reverb one
    network launch."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    patch = compile_node(master_bus(PORT), block_frames=F, rate=RATE,
                         channels=1, device='cuda')
    K.reset_launch_counts()
    a, ca = patch.render(n_blocks=64)
    torch.cuda.synchronize()
    assert {k: v for k, v in K.LAUNCHES.items() if v} == {
        'segments_gen': 1, 'fdn': 1}

    def plain(lines, inject, g, lengths):
        lines, inject, g = K._check_fdn(lines, inject, g, lengths)
        return K.fdn_advance_plain(lines, inject, g, lengths)

    monkeypatch.setattr(K, 'fdn_advance', plain)
    b, cb = patch.render(n_blocks=64)
    assert torch.equal(a, b)
    assert all(torch.equal(ca[u][k], cb[u][k]) for u in ca for k in ca[u])
    oracle = pull(PORT, master_bus(PORT), 16, F, 1)
    assert np.abs(a[:16 * F].cpu().numpy() - oracle).max() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['White', 'Pink', 'SampleHold'])
def test_cuda_noise_nodes_bit_exact(name):
    """The int32 hash on the card gives the numpy oracle's bits, from 0 and
    68 s into the timeline."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    frames, nb = 512, 4
    patch = compile_node(noise_node(PORT, name), block_frames=frames,
                         rate=RATE, channels=3, device='cuda')
    for position in (0, 5859 * frames):
        want = pull(PORT, noise_node(PORT, name), nb, frames, 3, position)
        got = patch.render(position=position, n_blocks=nb)[0].cpu().numpy()
        assert np.array_equal(got, want)
