"""The nine parity checks of the JAX package's record, in the port.

``BENCH_full.json`` holds the JAX package to nine renders against its numpy
pull oracle (``parity_max_abs_err``).  Here each of them is built twice from
the same numbers — once from ``signals_tpu``'s nodes, once from the port's —
and rendered on the CPU at a small size (block 1024, so that swept carry
segments engage; 8-16 blocks; the polyphonic mixes at 32 voices, the width
at which the segment kernels' geometry gate opens).  The port's render is
held to the JAX render and to the port's own pull oracle under the bench's
budgets (``bench.py:32-46``): 1e-5 max-abs, V x 1e-5 for a V-voice sum, and
0.0 exactly for ``sine`` and ``additive``.
"""

import importlib

import numpy as np
import pytest

RATE, F = 44100, 1024
TOL = 1e-5
V = 32                      # voices of the polyphonic mixes
JAX, PORT = 'signals_tpu', 'signals_tpu_torch'
NOISE_CUTS = np.linspace(1000.0, 4000.0, V).astype(np.float32)


def poly_freqs(n):
    return (110.0 * 2 ** (np.arange(n) % 12 / 12.0)
            * (1 + 0.001 * np.arange(n))).astype(np.float32)


class Kit:
    """One package's node modules and the small helpers the patches
    share."""

    def __init__(self, pkg):
        self.pkg = pkg
        for m in ('delay', 'dyn', 'env', 'fx', 'noise', 'osc', 'reverb',
                  'vis'):
            setattr(self, m, importlib.import_module(f'{pkg}.nodes.{m}'))
        self._fixed = importlib.import_module(f'{pkg}.nodes.fixed').Fixed

    def fixed(self, value):
        f = self._fixed()
        f.get_state().value = np.atleast_2d(np.asarray(value, np.float32))
        return f

    def osc_at(self, kind, hz, phase=None):
        o = getattr(self.osc, kind)()
        o.hertz = hz if hasattr(hz, 'get_state') else self.fixed(hz)
        if phase is not None:
            o.phase = phase
        return o

    def gain(self, left, amount):
        g = self.fx.Gain()
        g.left = left
        g.right = self.fixed(amount)
        return g

    def mix(self, left, right, amount):
        m = self.fx.Mix()
        m.left = left
        m.right = right
        m.mix = self.fixed(amount)
        return m

    def envelope(self, filtered, amount):
        env = self.env.ADSR()
        env.gate = self.osc_at('Square', 2.0)
        st = env.get_state()
        st.attack, st.decay, st.sustain, st.release = 0.01, 0.08, 0.6, 0.1
        voiced = self.fx.RingMod()
        voiced.left = filtered
        voiced.right = env
        return self.gain(voiced, amount)


# --- the nine patches (bench.py:57-278), each -> (root, overridden node) -----


def sine_plot(k):
    tap = k.vis.Wave()
    tap.input = k.osc_at('Sine', 440.0)
    return tap, None


def additive_voice(k):
    hz = k.fixed(220.0)
    m = k.mix(k.osc_at('Sine', hz), k.osc_at('Sawtooth', hz), 0.5)
    return k.gain(m, 1.0 / 16), hz


def subtractive_voice(k):
    hz = k.fixed(110.0)
    cutoff = k.mix(k.gain(k.osc_at('Sine', 0.5), 900.0), k.fixed(2000.0),
                   0.5)
    lp = k.fx.LowPass()
    lp.input = k.osc_at('Sawtooth', hz)
    lp.cutoff = cutoff
    lp.get_state().context = k.fx.LowPass.context_for(550.0, RATE)
    return k.envelope(lp, 1.0 / 64), hz


def static_voice(k):
    hz = k.fixed(110.0)
    lp = k.fx.LowPass()
    lp.input = k.osc_at('Sawtooth', hz)
    lp.cutoff = k.fixed(2000.0)
    lp.get_state().context = k.fx.LowPass.context_for(2000.0, RATE)
    return k.envelope(lp, 1.0 / 64), hz


def noise_voice(k):
    lp = k.fx.LowPass()
    lp.input = k.noise.White()
    cut = k.fixed(2000.0)
    lp.cutoff = cut
    lp.get_state().context = k.fx.CritFilter.context_for(1000.0, RATE)
    return k.gain(lp, 1.0 / 64), cut


def fm_delay(k):
    i3 = k.gain(k.osc_at('Sine', 660.0), 1.5)
    i2 = k.gain(k.osc_at('Sine', 220.0, i3), 2.0)
    op1 = k.osc_at('Sine', 110.0, i2)
    d = k.delay.Delay()
    d.get_state().frames = 4 * F
    m = k.mix(op1, k.gain(d, 0.45), 0.6)
    d.input = m
    tap = k.vis.Spec()
    tap.input = m
    return tap, None


def saturated_echo(k):
    d = k.delay.Delay()
    d.get_state().frames = 4 * F + 5          # bench: 16 blocks + 5
    lp = k.fx.LowPass()
    lp.input = d
    lp.cutoff = k.fixed(2500.0)
    lp.get_state().streaming = True
    shaper = k.fx.Drive()
    shaper.input = k.gain(lp, 0.55)
    shaper.drive = k.fixed(3.0)
    m = k.mix(k.osc_at('Sawtooth', 110.0), shaper, 0.6)
    d.input = m
    return m, None


def master_bus(k):
    voice, _ = subtractive_voice(k)
    rv = k.reverb.Reverb()
    rv.input = voice
    comp = k.dyn.Compressor()
    st = comp.get_state()
    st.window, st.threshold, st.ratio = 2 * F, 0.25, 4.0
    comp.input = rv
    return k.gain(comp, 0.9), None


#: name -> (build function, voices (0: a single patch), per-voice override
#: values, blocks, budget, the plan the port must pick)
CASES = {
    'sine': (sine_plot, 0, None, 8, 0.0, 'mega'),
    'additive': (additive_voice, 16, poly_freqs(16), 8, 0.0, 'mega'),
    'subtractive': (subtractive_voice, 0, None, 16, TOL, 'mega'),
    'poly64_mix': (subtractive_voice, V, poly_freqs(V), 16, V * TOL, 'mix'),
    'poly64_static_mix': (static_voice, V, poly_freqs(V), 16, V * TOL,
                          'mix'),
    'poly64_noise_mix': (noise_voice, V, NOISE_CUTS, 16, V * TOL, 'mix'),
    'fm_delay': (fm_delay, 0, None, 16, TOL, 'delay_mega'),
    'saturated_echo': (saturated_echo, 0, None, 11, TOL, 'segment_scan'),
    'master_bus': (master_bus, 0, None, 16, TOL, 'mega'),
}


def pull_oracle(pkg, root, n_blocks, channels):
    core = importlib.import_module(f'{pkg}.core')
    return np.concatenate([np.broadcast_to(root.respond(core.Request(
        requestor=None, port='test',
        loc=core.BlockLoc(position=i * F, rate=RATE,
                          shape=core.Shape(F, channels)))), (F, channels))
        for i in range(n_blocks)])


def render_case(name):
    """``(port render, JAX render, port oracle, what the port ran)`` of one
    case, all numpy ``(n*F, channels)``; a mix is ``(n*F, 1)``."""
    build, voices, values, n_blocks, _tol, _plan = CASES[name]
    jk, pk = Kit(JAX), Kit(PORT)
    if voices and name != 'additive':
        from signals_tpu.parallel import PolyPatch as JaxPoly
        from signals_tpu_torch.parallel import PolyPatch
        jroot, jnode = build(jk)
        jmix, _ = JaxPoly(jroot, n_voices=voices,
                          overrides={(jnode, 'value'): values},
                          block_frames=F, rate=RATE,
                          layout='channels').render(n_blocks=n_blocks)
        root, node = build(pk)
        poly = PolyPatch(root, n_voices=voices,
                         overrides={(node, 'value'): values},
                         block_frames=F, rate=RATE, mix_epilogue=True,
                         device='cpu')
        ran = ('mix' if poly.compiled.mega_mix(n_blocks) is not None
               else poly.compiled.plan(n_blocks))
        got = poly.render(n_blocks=n_blocks)[0].numpy()
        oroot, onode = build(pk)
        onode.get_state().value = values.reshape(1, voices)
        want = pull_oracle(PORT, oroot, n_blocks, voices).sum(
            axis=1, keepdims=True)
        return got, np.asarray(jmix).reshape(got.shape), want, ran
    import signals_tpu.compiler as jax_compiler
    from signals_tpu_torch.compiler import compile_node
    channels = voices or 1

    def built(kit):
        root, node = build(kit)
        if voices:
            node.get_state().value = values.reshape(1, voices)
        return root

    jax_compiler._compile_cache.clear()
    jaudio, _ = jax_compiler.compile_node(
        built(jk), block_frames=F, rate=RATE, channels=channels).render(
        n_blocks=n_blocks, deliver_taps=False)
    patch = compile_node(built(pk), block_frames=F, rate=RATE,
                         channels=channels, device='cpu')
    got = patch.render(n_blocks=n_blocks, deliver_taps=False)[0].numpy()
    want = pull_oracle(PORT, built(pk), n_blocks, channels)
    return got, np.asarray(jaudio), want, patch.plan(n_blocks)


@pytest.mark.parametrize('name', list(CASES))
def test_nine_check_set(name):
    _build, _voices, _values, n_blocks, tol, plan = CASES[name]
    got, jax_audio, oracle, ran = render_case(name)
    assert ran == plan
    assert got.shape == oracle.shape == jax_audio.shape
    assert np.isfinite(got).all()
    # the comparison is not against silence (the master bus peaks at
    # 0.0095: its voice carries the flagship's 1/64 gain)
    assert np.abs(oracle).max() > 500 * TOL
    err_oracle = float(np.abs(got - oracle).max())
    err_jax = float(np.abs(got - jax_audio).max())
    assert err_oracle <= tol, (name, err_oracle)
    assert err_jax <= tol, (name, err_jax)
