"""Visualization taps of the port against the JAX package.

* ``Wave.tap_summary`` / ``Spec.tap_summary`` under torch against numpy on
  the same seeded windows (``Wave`` exactly, ``Spec`` within 1e-5 of its
  largest band), at window lengths that pad, divide and undercut the 750
  buckets;
* ``render(..., deliver_taps=True)``: per-block arrays with their positions
  to enabled taps only; a disabled tap forwards its audio and queues
  nothing;
* every plan returns its taps (``mega``, ``delay_mega`` with a tap that the
  solver's memo injection cuts off the root walk, ``segment_scan`` with a
  tail window, ``blocks``), equal to the JAX package's tap feeds;
* ``render_vis``: summaries equal to ``tap_summary(np, ...)`` of the same
  audio and to the JAX package's ``render_vis``;
* the mix-epilogue plan refuses a patch that holds a tap, and the plain
  plan renders it.
"""

import importlib

import numpy as np
import pytest
import torch

from signals_tpu_torch.compiler import compile_node
from signals_tpu_torch.core.xp import TorchXP

RATE, F = 44100, 256
TOL = 1e-5
JAX, PORT = 'signals_tpu', 'signals_tpu_torch'


def mods(pkg):
    return {m: importlib.import_module(f'{pkg}.nodes.{m}')
            for m in ('delay', 'fixed', 'fx', 'osc', 'vis')}


def fixed(mod, value):
    f = mod['fixed'].Fixed()
    f.get_state().value = np.atleast_2d(np.asarray(value, np.float32))
    return f


def osc(mod, kind, hz, phase=None):
    o = getattr(mod['osc'], kind)()
    o.hertz = fixed(mod, hz)
    if phase is not None:
        o.phase = phase
    return o


def gain(mod, left, amount):
    g = mod['fx'].Gain()
    g.left = left
    g.right = fixed(mod, amount)
    return g


def tap(mod, kind, inp):
    t = getattr(mod['vis'], kind)()
    t.input = inp
    return t


def jax_patch(root, channels):
    import signals_tpu.compiler as C
    C._compile_cache.clear()
    return C.compile_node(root, block_frames=F, rate=RATE,
                          channels=channels)


def port_patch(root, channels):
    return compile_node(root, block_frames=F, rate=RATE, channels=channels,
                        device='cpu')


def drained(node):
    """The queued tap blocks of ``node``, joined."""
    blocks = []
    while not node.q.empty():
        blocks.append(node.q.get_nowait())
    return blocks


# --- tap_summary ------------------------------------------------------------------


@pytest.mark.parametrize('T,ch', [(8 * F, 1), (1750, 2), (750, 1), (300, 3)])
def test_wave_summary_torch_equals_numpy(T, ch):
    from signals_tpu.nodes.vis import Wave as JaxWave
    from signals_tpu_torch.nodes.vis import Wave
    x = np.random.default_rng(T).standard_normal((T, ch)).astype(np.float32)
    want = JaxWave().tap_summary(np, x, RATE)
    got_np = Wave().tap_summary(np, x, RATE)
    got = Wave().tap_summary(TorchXP('cpu'), torch.as_tensor(x), RATE)
    assert got.shape == (min(T, 750), 2, ch)
    assert np.array_equal(got_np, want)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize('T,ch,bands', [(8 * F, 1, 80), (5000, 2, 32),
                                        (64, 1, 80)])
def test_spec_summary_torch_matches_numpy(T, ch, bands):
    import jax.numpy as jnp
    from signals_tpu.nodes.vis import Spec as JaxSpec
    from signals_tpu_torch.nodes.vis import Spec
    rng = np.random.default_rng(T)
    t = np.arange(T, dtype=np.float32)[:, None]
    x = (np.sin(2 * np.pi * 440.0 * t / RATE)
         + 0.3 * rng.standard_normal((T, ch))).astype(np.float32)
    jnode, node = JaxSpec(), Spec()
    jnode.get_state().bands = node.get_state().bands = bands
    want = jnode.tap_summary(np, x, RATE)
    jax_out = np.asarray(jnode.tap_summary(jnp, jnp.asarray(x), RATE))
    got_np = node.tap_summary(np, x, RATE)
    got = node.tap_summary(TorchXP('cpu'), torch.as_tensor(x), RATE)
    assert got.dtype == torch.float32 and got.shape == (bands,)
    assert np.array_equal(got_np, want)
    scale = want.max()
    assert np.abs(got.numpy() - want).max() <= TOL * scale
    assert np.abs(got.numpy() - jax_out).max() <= TOL * scale
    assert scale > 0.1


# --- delivery ---------------------------------------------------------------------


def tapped_voice(pkg, kind='Wave'):
    """Two sines -> tap -> Gain 0.5 (the tap under the root)."""
    mod = mods(pkg)
    t = tap(mod, kind, osc(mod, 'Sine', [[440.0, 661.0]]))
    return gain(mod, t, 0.5), t


def test_render_delivers_blocks_to_enabled_taps_only():
    root, t = tapped_voice(PORT)
    patch = port_patch(root, 2)
    assert list(patch.tap_nodes.values()) == [t]
    audio, _ = patch.render(position=3 * F, n_blocks=4)
    blocks = drained(t)
    assert [b.shape for b in blocks] == [(F, 2)] * 4
    assert np.array_equal(np.concatenate(blocks) * np.float32(0.5),
                          audio.numpy())
    # the same feed as the JAX package's
    jroot, jt = tapped_voice(JAX)
    jax_patch(jroot, 2).render(position=3 * F, n_blocks=4)
    assert np.array_equal(np.concatenate(blocks),
                          np.concatenate(drained(jt)))
    # not delivered when not asked for; a disabled tap forwards its audio
    # and is handed nothing
    patch.render(n_blocks=2, deliver_taps=False)
    assert drained(t) == []
    t.get_state().enabled = False
    off, _ = patch.render(position=3 * F, n_blocks=4)
    assert drained(t) == []
    assert torch.equal(off, audio)


def test_tap_positions_reach_consume_tap():
    root, t = tapped_voice(PORT)
    seen = []
    t.consume_tap = lambda block, position, rate: seen.append(
        (block.shape, position, rate))
    port_patch(root, 2).render(position=5 * F, n_blocks=3)
    assert seen == [((F, 2), (5 + i) * F, RATE) for i in range(3)]


# --- every plan returns its taps ----------------------------------------------------


def fm_loop(pkg, tap_inside):
    """The FM voice with a feedback delay under a ``Spec`` (bench c5); with
    ``tap_inside`` a ``Wave`` sits between the operator stack and the loop's
    ``Mix``, where the delay solver's memo injection cuts it off the root
    walk."""
    mod = mods(pkg)
    i3 = gain(mod, osc(mod, 'Sine', 660.0), 1.5)
    i2 = gain(mod, osc(mod, 'Sine', 220.0, i3), 2.0)
    op1 = osc(mod, 'Sine', 110.0, i2)
    if tap_inside:
        op1 = tap(mod, 'Wave', op1)
    d = mod['delay'].Delay()
    d.get_state().frames = 4 * F
    m = mod['fx'].Mix()
    m.left = op1
    m.right = gain(mod, d, 0.45)
    m.mix = fixed(mod, 0.6)
    d.input = m
    return tap(mod, 'Spec', m)


def echo(pkg):
    """A saturated loop (no closed form: the segmented scan) under a
    ``Wave``."""
    mod = mods(pkg)
    d = mod['delay'].Delay()
    d.get_state().frames = 4 * F + 5
    shaper = mod['fx'].Drive()
    shaper.input = gain(mod, d, 0.55)
    shaper.drive = fixed(mod, 3.0)
    m = mod['fx'].Mix()
    m.left = osc(mod, 'Sawtooth', 110.0)
    m.right = shaper
    m.mix = fixed(mod, 0.6)
    d.input = m
    return tap(mod, 'Wave', m)


PLANS = {
    'mega': (lambda pkg: tapped_voice(pkg)[0], 2, 8, 'mega', True),
    'delay_mega': (lambda pkg: fm_loop(pkg, False), 1, 12, 'delay_mega',
                   True),
    'delay_mega_cut_off': (lambda pkg: fm_loop(pkg, True), 1, 12,
                           'delay_mega', True),
    'segment_scan': (echo, 1, 11, 'segment_scan', True),
    'blocks': (echo, 1, 5, 'blocks', False),
}


@pytest.mark.parametrize('name', list(PLANS))
def test_every_plan_returns_its_taps(name):
    build, channels, n_blocks, plan, mega = PLANS[name]
    patch = port_patch(build(PORT), channels)
    patch.enable_mega = mega
    assert patch.plan(n_blocks) == plan
    blocks, _, taps = patch.render_core(n_blocks)(
        patch.params(), patch.carry0, 0)
    assert set(taps) == set(patch.tap_nodes) and taps
    jp = jax_patch(build(JAX), channels)
    jp.render(n_blocks=n_blocks)
    for uid, node in patch.tap_nodes.items():
        assert taps[uid].shape == (n_blocks, F, node.channels)
        want = np.concatenate(drained(jp.tap_nodes[uid]))
        got = taps[uid].reshape(n_blocks * F, -1).numpy()
        assert np.abs(got - want).max() <= TOL
        assert np.abs(want).max() > 0.1
    # the tap at the root is the render itself
    root_uid = patch.index.info(patch.root).uid
    if root_uid in taps:
        assert torch.equal(taps[root_uid], blocks)


# --- render_vis -----------------------------------------------------------------------


def test_render_vis_sine_wave_summary_is_exact():
    """bench c1 (``bench.py:57-65``): a 440 Hz sine under a ``Wave``."""
    def build(pkg):
        mod = mods(pkg)
        return tap(mod, 'Wave', osc(mod, 'Sine', 440.0))

    root = build(PORT)
    patch = port_patch(root, 1)
    audio, _ = patch.render(n_blocks=12, deliver_taps=False)
    summaries, carry = patch.render_vis(n_blocks=12)
    assert carry == {}
    (uid,) = patch.tap_nodes
    want = root.tap_summary(np, audio.numpy(), RATE)
    assert summaries[uid].shape == (750, 2, 1)
    assert np.array_equal(summaries[uid], want)
    got, frames, position, rate = root.latest_summary()
    assert np.array_equal(got, want)
    assert (frames, position, rate) == (12 * F, 0, RATE)
    jroot = build(JAX)
    jsum, _ = jax_patch(jroot, 1).render_vis(n_blocks=12)
    assert np.array_equal(summaries[uid], np.asarray(jsum[uid]))
    # a disabled tap computes and copies nothing
    root.get_state().enabled = False
    assert patch.render_vis(n_blocks=12)[0] == {}
    assert root.latest_summary() is None


def test_render_vis_fm_delay_spec_summary():
    """bench c5 at its ``Spec`` root: the 80 band magnitudes within 1e-5
    of the largest band of the numpy summary of the same audio."""
    root = fm_loop(PORT, False)
    patch = port_patch(root, 1)
    audio, _ = patch.render(n_blocks=16, deliver_taps=False)
    summaries, _ = patch.render_vis(n_blocks=16)
    (got,) = summaries.values()
    want = root.tap_summary(np, audio.numpy(), RATE)
    assert got.shape == (80,) and want.max() > 0.05
    assert np.abs(got - want).max() <= TOL * want.max()
    jsum, _ = jax_patch(fm_loop(JAX, False), 1).render_vis(n_blocks=16)
    (jgot,) = jsum.values()
    assert np.abs(got - np.asarray(jgot)).max() <= TOL * want.max()


# --- the mix-epilogue plan ---------------------------------------------------------


def test_mix_plan_refuses_a_patch_with_a_tap():
    from signals_tpu_torch.parallel import PolyPatch

    def build(with_tap):
        mod = mods(PORT)
        hz = fixed(mod, 110.0)
        saw = mod['osc'].Sawtooth()
        saw.hertz = hz
        lp = mod['fx'].LowPass()
        lp.input = saw
        lp.cutoff = fixed(mod, 2000.0)
        lp.get_state().context = 128
        out = gain(mod, lp, 0.25)
        return (tap(mod, 'Wave', out) if with_tap else out), hz

    hz_values = np.float32([110.0, 165.0, 220.0, 275.0])
    renders = {}
    for with_tap in (False, True):
        root, hz = build(with_tap)
        poly = PolyPatch(root, n_voices=4, overrides={(hz, 'value'):
                                                      hz_values},
                         block_frames=F, rate=RATE, mix_epilogue=True,
                         device='cpu')
        assert (poly.compiled.mega_mix(8) is None) == with_tap
        renders[with_tap] = poly.render(n_blocks=8)[0]
    assert float((renders[True] - renders[False]).abs().max()) <= 4 * TOL
