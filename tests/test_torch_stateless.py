"""The ``'stateless'`` plan of the port's compiler (``CompiledPatch.
stateless_core``): the reference's ``vmap`` of the one-block step over a
carry-free, host-fed batch, against the per-block plan and the JAX package.

On the CPU, at small sizes (256-frame blocks, 12-16 blocks, 1-2 channels),
seeded numpy audio written to a file and read by a ``FileReader`` in both
packages:

* ``plan()`` names it for a ``FileReader`` -> EQ chain and a source
  device, and not for one block, a stateful patch (a streaming filter), a
  swept filter on the carry grid, ``enable_mega = False`` or a patch
  without a host source;
* the four-EQ bounce into a ``FileWriter``: audio and taps bit for bit the
  per-block plan's from block 0 and block 3, as many plain timeline calls
  a batch as the per-block plan makes a block, each on every block's
  lanes, the written file the returned audio; no op falls back to a
  per-block loop under ``vmap`` (the chain's 60 Hz notch is the pole near
  the unit circle whose float32 design differs between the packages by
  more than 1e-5 in every plan: the EQs are held to the JAX package in
  ``tests/test_torch_eq.py``, the plan to it below);
* every read of the render position as tensor arithmetic (an oscillator's
  phase, the noise hash, an envelope, the zeroed context before frame 0):
  bit for bit the per-block plan;
* a ``make_loss_fn`` gradient through the plan within 1e-6 relative of the
  per-block plan's and 1e-3 of ``jax.grad``;
* ``PolyPatch`` over a host-fed voice in both layouts (the vmap layout
  nests the voices' ``vmap`` around the blocks') against each other and
  the JAX package's vmap layout.
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
JAX, PORT = 'signals_tpu', 'signals_tpu_torch'
#: the offline bounce's EQ chain (``chip_smoke.EQ_CHAIN``): node, freq Hz,
#: q or None, gain dB or None
EQ_CHAIN = (('LowShelf', 120.0, None, 3.0), ('Peak', 1000.0, 1.4, -4.0),
            ('Notch', 60.0, 4.0, None), ('HighShelf', 8000.0, None, 2.0))


def mods(pkg):
    return {m: importlib.import_module(f'{pkg}.{m}')
            for m in ('nodes.env', 'nodes.files', 'nodes.fixed', 'nodes.fx',
                      'nodes.noise', 'nodes.osc', 'parallel',
                      'runtime.sndfile')}


def fixed(mod, value):
    f = mod['nodes.fixed'].Fixed()
    f.get_state().value = np.atleast_2d(np.asarray(value, np.float32))
    return f


def track(path, frames, channels, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(frames)[:, None] / RATE
    x = (0.4 * np.sin(2 * np.pi * 55.0 * (1 + 0.01 * np.arange(channels))
                      * t)
         + 0.1 * rng.standard_normal((frames, channels))).astype(np.float32)
    w = mods(PORT)['runtime.sndfile'].open_writer(
        str(path), rate=RATE, channels=channels, subtype='float32')
    w.write(x)
    w.close()
    return str(path)


def reader(mod, path):
    rd = mod['nodes.files'].FileReader()
    rd.get_state().path = path
    return rd


def eq_bounce(pkg, src, out=None):
    """``FileReader`` -> the four EQs -> with ``out`` a float32
    ``FileWriter``."""
    mod = mods(pkg)
    node = reader(mod, src)
    for kind, freq, q, gain in EQ_CHAIN:
        eq = getattr(mod['nodes.fx'], kind)()
        eq.input = node
        eq.freq = fixed(mod, freq)
        if q is not None:
            eq.q = fixed(mod, q)
        if gain is not None:
            eq.gain = fixed(mod, gain)
        node = eq
    if out is None:
        return node
    wr = mod['nodes.files'].FileWriter()
    wr.get_state().path = str(out)
    wr.input = node
    return wr


def positional(pkg, src):
    """A ``FileReader`` ring-modulated by a 440 Hz sine, white noise mixed
    in, an ADSR gated by a 3 Hz square on it, then a LowPass (context
    128) and a gain: every lowering read of the render position."""
    mod = mods(pkg)
    ring = mod['nodes.fx'].RingMod()
    ring.left = reader(mod, src)
    sine = mod['nodes.osc'].Sine()
    sine.hertz = fixed(mod, 440.0)
    ring.right = sine
    mix = mod['nodes.fx'].Mix()
    mix.left = ring
    mix.right = mod['nodes.noise'].White()
    mix.mix = fixed(mod, 0.2)
    gate = mod['nodes.osc'].Square()
    gate.hertz = fixed(mod, 3.0)
    env = mod['nodes.env'].ADSR()
    env.gate = gate
    voiced = mod['nodes.fx'].RingMod()
    voiced.left = mix
    voiced.right = env
    cut, vol = fixed(mod, 1500.0), fixed(mod, 0.5)
    lp = mod['nodes.fx'].LowPass()
    lp.input = voiced
    lp.cutoff = cut
    lp.get_state().context = 128
    out = mod['nodes.fx'].Gain()
    out.left = lp
    out.right = vol
    return out, {'cut': (cut, 'value'), 'vol': (vol, 'value')}


def port_compile(root, channels, frames=F):
    return compile_node(root, block_frames=frames, rate=RATE,
                        channels=channels, device='cpu')


def jax_compile(root, channels, frames=F):
    import signals_tpu.compiler as C
    C._compile_cache.clear()
    return C.compile_node(root, block_frames=frames, rate=RATE,
                          channels=channels)


def per_block(pc, n_blocks, position):
    """``render_core`` on the per-block plan."""
    pc.enable_mega = False
    pc._render_cache.clear()
    try:
        assert pc.plan(n_blocks) == 'blocks'
        return pc.render_core(n_blocks)(pc.params(), {}, position)
    finally:
        pc.enable_mega = True
        pc._render_cache.clear()


def no_fallback(fn):
    """``fn()`` with ``vmap``'s per-element fallback made an error."""
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings('error', message='.*performance drop.*')
            return fn()
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)


def test_plan_names_stateless(tmp_path):
    src = track(tmp_path / 'in.wav', 40 * 1024, 1, 1)
    mod = mods(PORT)
    pc = port_compile(eq_bounce(PORT, src), 1)
    assert not pc.carry0 and not pc.mega_compatible
    assert pc.plan(16) == 'stateless' and pc.plan(1) == 'blocks'
    pc.enable_mega = False
    assert pc.plan(16) == 'blocks'
    jc = jax_compile(eq_bounce(JAX, src), 1)
    assert not jc.carry0 and not jc._use_mega        # its vmap branch
    lp = mod['nodes.fx'].LowPass()
    lp.input = reader(mod, src)
    lp.cutoff = fixed(mod, 900.0)
    lp.get_state().streaming = True                  # carried state
    assert port_compile(lp, 1).plan(16) == 'blocks'
    swept = mod['nodes.fx'].LowPass()                # the carry grid
    swept.input = reader(mod, src)
    swept.cutoff = reader(mod, src)
    swept_pc = port_compile(swept, 1, frames=1024)
    assert swept_pc.carry_seg_align == 8 and swept_pc.plan(16) == 'blocks'
    sine = mod['nodes.osc'].Sine()
    sine.hertz = fixed(mod, 220.0)
    eq = mod['nodes.fx'].Peak()
    eq.input = sine
    eq.freq = fixed(mod, 1000.0)
    assert port_compile(eq, 1).plan(16) == 'mega'    # no host source


@pytest.mark.parametrize('start', [0, 3])
def test_stateless_bounce_equals_per_block(tmp_path, monkeypatch, start):
    nb, ch = 16, 2
    src = track(tmp_path / 'in.wav', (nb + 6) * F, ch, 2)
    out = tmp_path / 'out.wav'
    pc = port_compile(eq_bounce(PORT, src, out), ch)
    assert pc.plan(nb) == 'stateless'
    calls = []
    plain = K.sosfilt_timeline_plain

    def counted(coeffs, x):
        calls.append(x.shape)
        return plain(coeffs, x)

    monkeypatch.setattr(K, 'sosfilt_timeline_plain', counted)
    blocks, carry, taps = no_fallback(
        lambda: pc.render_core(nb)(pc.params(), {}, start * F))
    # the per-block plan's calls of one block, the blocks folded into lanes
    per_batch = len(calls)
    assert per_batch >= len(EQ_CHAIN)
    assert all(s[1] == nb * ch for s in calls)
    calls.clear()
    want, _, want_taps = per_block(pc, nb, start * F)
    assert len(calls) == per_batch * nb
    assert carry == {} and torch.equal(blocks, want)
    assert taps.keys() == want_taps.keys() and len(taps) == 1
    assert all(torch.equal(taps[u], want_taps[u]) for u in taps)
    assert np.abs(blocks.numpy()).max() > 0.1
    # through render(): the FileWriter is handed the blocks
    audio, _ = no_fallback(lambda: pc.render(position=start * F,
                                             n_blocks=nb))
    (wr,) = pc.tap_nodes.values()
    wr.destroy()
    back = mods(PORT)['runtime.sndfile'].open_reader(str(out))
    assert back.frames >= nb * F
    assert np.array_equal(back.read(back.frames - nb * F, nb * F),
                          audio.numpy())


@pytest.mark.parametrize('start', [0, 5])
def test_stateless_position_reads_equal_per_block(tmp_path, start):
    nb = 12
    src = track(tmp_path / 'in.wav', (nb + 8) * F, 1, 3)
    root, _ = positional(PORT, src)
    pc = port_compile(root, 1)
    assert pc.plan(nb) == 'stateless'
    got, _, _ = no_fallback(
        lambda: pc.render_core(nb)(pc.params(), {}, start * F))
    want, _, _ = per_block(pc, nb, start * F)
    assert torch.equal(got, want)
    jroot, _ = positional(JAX, src)
    jwant, _ = jax_compile(jroot, 1).render(position=start * F, n_blocks=nb)
    assert np.abs(got.reshape(-1, 1).numpy()
                  - np.asarray(jwant)).max() <= TOL


def test_stateless_gradient_matches_per_block_and_jax(tmp_path):
    import jax
    from signals_tpu.learn import make_loss_fn as jmake
    nb = 12
    src = track(tmp_path / 'in.wav', (nb + 4) * F, 1, 4)
    target = (0.2 * np.random.default_rng(5).standard_normal(
        (nb * F, 1))).astype(np.float32)
    jroot, jnamed = positional(JAX, src)
    jc = jax_compile(jroot, 1)
    jg = jax.jit(jax.grad(jmake(jc, target), allow_int=True))(jc.params())
    root, named = positional(PORT, src)
    pc = port_compile(root, 1)
    grads = []
    for mega in (True, False):
        pc.enable_mega = mega
        pc._render_cache.clear()
        assert pc.plan(nb) == ('stateless' if mega else 'blocks')
        params, leaves = pc.params(), []
        for n, p in named.values():
            uid = pc.index.info(n).uid
            params[uid][p] = t = params[uid][p].clone().requires_grad_()
            leaves.append(t)
        grads.append(torch.autograd.grad(
            learn.make_loss_fn(pc, target)(params), leaves))
    for k, a, b in zip(named, *grads):
        n, p = jnamed[k]
        want = np.asarray(jg[jc.index.info(n).uid][p])
        assert np.abs(want).max() > 0
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
        assert (np.abs(a.numpy() - want).max()
                <= 1e-3 * np.abs(want).max()), k


GAINS = np.array([0.2, 0.5, 0.9], np.float32)


def gain_voice(pkg, src):
    mod = mods(pkg)
    lp = mod['nodes.fx'].LowPass()
    lp.input = reader(mod, src)
    lp.cutoff = fixed(mod, 1200.0)
    lp.get_state().context = 128
    vol = fixed(mod, 1.0)
    out = mod['nodes.fx'].Gain()
    out.left = lp
    out.right = vol
    return out, vol


def test_stateless_under_polypatch(tmp_path):
    nb, V = 12, len(GAINS)
    src = track(tmp_path / 'in.wav', (nb + 4) * F, 1, 6)
    mixes = {}
    for layout in ('channels', 'vmap'):
        root, vol = gain_voice(PORT, src)
        poly = mods(PORT)['parallel'].PolyPatch(
            root, n_voices=V, overrides={(vol, 'value'): GAINS},
            block_frames=F, rate=RATE, channels=1, layout=layout,
            device='cpu')
        assert poly.compiled.plan(nb) == 'stateless'
        mixes[layout], _ = no_fallback(lambda: poly.render(n_blocks=nb))
    root, vol = gain_voice(JAX, src)
    want, _ = mods(JAX)['parallel'].PolyPatch(
        root, n_voices=V, overrides={(vol, 'value'): GAINS}, block_frames=F,
        rate=RATE, channels=1, layout='vmap').render(n_blocks=nb)
    assert float((mixes['vmap'] - mixes['channels']).abs().max()) <= V * TOL
    assert np.abs(mixes['vmap'].numpy() - np.asarray(want)).max() <= V * TOL
    assert np.abs(np.asarray(want)).max() > 0.1
