"""The port's flagship slice against the JAX package.

The swept-subtractive voice (saw -> LowPass swept by a 0.5 Hz LFO ->
RingMod with an ADSR -> Gain), built in both packages at 8 voices, block
1024 (so the 8-block swept carry engages) and 16 blocks (2 carry
segments).  The port's CPU render, with its params taken from the JAX
``PolyPatch.params()`` through :func:`signals_tpu_torch.interop.
params_from_jax`, must match the JAX render and the JAX numpy oracle summed
over voices within V x 1e-5 raw max-abs (the bench's per-voice budget,
``bench.py:40-46``).
"""

import importlib

import numpy as np
import pytest
import torch

import signals_tpu_torch.compiler.filters as port_filters
from signals_tpu.core import BlockLoc, Request, Shape
from signals_tpu_torch.interop import params_from_jax

RATE, F, V, NB = 44100, 1024, 8, 16
TOL = V * 1e-5


def freqs(n=V, base=110.0):
    return (base * 2 ** (np.arange(n) % 12 / 12.0)
            * (1 + 0.001 * np.arange(n))).astype(np.float32)


def build_voice(pkg: str):
    """The flagship voice (``bench.py:87-128``) from ``pkg``'s nodes."""
    mod = {m: importlib.import_module(f'{pkg}.nodes.{m}')
           for m in ('env', 'fixed', 'fx', 'osc')}

    def fixed(value):
        f = mod['fixed'].Fixed()
        f.get_state().value = np.atleast_2d(np.float32(value))
        return f

    fx, osc = mod['fx'], mod['osc']
    hz = fixed(110.0)
    saw = osc.Sawtooth()
    saw.hertz = hz
    lfo = osc.Sine()
    lfo.hertz = fixed(0.5)
    depth = fx.Gain()
    depth.left = lfo
    depth.right = fixed(900.0)
    cutoff = fx.Mix()
    cutoff.left = depth
    cutoff.right = fixed(2000.0)
    cutoff.mix = fixed(0.5)
    lp = fx.LowPass()
    lp.input = saw
    lp.cutoff = cutoff
    lp.get_state().context = fx.LowPass.context_for(550.0, RATE)
    gate = osc.Square()
    gate.hertz = fixed(2.0)
    env = mod['env'].ADSR()
    env.gate = gate
    st = env.get_state()
    st.attack, st.decay, st.sustain, st.release = 0.01, 0.08, 0.6, 0.1
    voiced = fx.RingMod()
    voiced.left = lp
    voiced.right = env
    out = fx.Gain()
    out.left = voiced
    out.right = fixed(1.0 / V)
    return out, hz


def port_poly(**kw):
    from signals_tpu_torch.parallel import PolyPatch
    root, hz = build_voice('signals_tpu_torch')
    return PolyPatch(root, n_voices=V, overrides={(hz, 'value'): freqs()},
                     block_frames=F, rate=RATE, device='cpu', **kw), hz


@pytest.fixture(scope='module')
def jax_ref():
    """JAX PolyPatch render + params, and the numpy pull oracle's voice
    sum (as ``bench.py:333-343``)."""
    from signals_tpu.parallel import PolyPatch
    root, hz = build_voice('signals_tpu')
    poly = PolyPatch(root, n_voices=V, overrides={(hz, 'value'): freqs()},
                     block_frames=F, rate=RATE, layout='channels')
    mix, _ = poly.render(n_blocks=NB)
    params = poly.params()[0]
    oracle_root, ohz = build_voice('signals_tpu')
    ohz.get_state().value = freqs().reshape(1, V)
    blocks = [np.broadcast_to(oracle_root.respond(Request(
        requestor=None, port='test',
        loc=BlockLoc(position=i * F, rate=RATE, shape=Shape(F, V)))), (F, V))
        for i in range(NB)]
    oracle = np.concatenate(blocks).sum(axis=1, keepdims=True)
    return np.asarray(mix), params, oracle


@pytest.mark.parametrize('gen', [False, True], ids=['timeline', 'generator'])
@pytest.mark.parametrize('mix_epilogue', [False, True],
                         ids=['plain_plan', 'mix_plan'])
def test_port_slice_matches_jax_render_and_oracle(jax_ref, gen,
                                                  mix_epilogue, monkeypatch):
    jmix, jparams, oracle = jax_ref
    monkeypatch.setattr(port_filters, 'SEG_SOURCE_GEN', gen)
    poly, _ = port_poly(mix_epilogue=mix_epilogue)
    params = params_from_jax(jparams, 'cpu')
    assert params.keys() == poly.params()[0].keys()   # same uid scheme
    got, carry = poly.render(n_blocks=NB, params=params)
    assert carry == {}                 # the flagship carries no state
    got = got.numpy()
    assert got.shape == (NB * F, 1) and np.isfinite(got).all()
    assert np.abs(got - jmix).max() <= TOL
    assert np.abs(got - oracle).max() <= TOL
    # the oracle's scale: the comparison is not against silence
    assert np.abs(oracle).max() > 0.1


def test_unaligned_start_raises():
    """Only a start inside a block raises now: a start off the 8-block
    carry-segment grid renders (each swept filter widens its window back
    to the segment start) and equals the same blocks of an aligned render
    (within 1e-6: the ADSR's grid scan runs at another length)."""
    poly, _ = port_poly()
    with pytest.raises(ValueError, match='block size'):
        poly.render(position=F // 2, n_blocks=8)
    aligned, _ = poly.render(position=0, n_blocks=8)
    unaligned, _ = poly.render(position=3 * F, n_blocks=2)
    assert unaligned.shape == (2 * F, 1)
    assert float((unaligned - aligned[3 * F:5 * F]).abs().max()) <= 1e-6
    a, _ = poly.render(position=8 * F, n_blocks=8)
    assert a.shape == (8 * F, 1)


def test_set_override_edits_without_recompile():
    poly, hz = port_poly()
    compiled = poly.compiled
    before, _ = poly.render(n_blocks=8)
    poly.set_override(hz, 'value', freqs(base=220.0))
    after, _ = poly.render(n_blocks=8)
    assert poly.compiled is compiled
    fresh, fhz = port_poly()
    fresh.set_override(fhz, 'value', freqs(base=220.0))
    assert torch.equal(after, fresh.render(n_blocks=8)[0])
    assert not torch.equal(before, after)


def test_filter_outside_block_windows_raises():
    """A LowPass sampled at block rate (the gain side of a Gain) needs
    zero-state filtering outside block windows, which is ported now: each
    block's sample is the last frame of its own context window — the
    batched replay with tail 1 under a multi-block window, the timeline
    kernel in a per-block step.  Both match the JAX render (its per-block
    plan) within 1e-5."""
    from signals_tpu.compiler import compile_node as jax_compile
    from signals_tpu_torch.compiler import CompiledPatch

    def patch(pkg):
        fx = importlib.import_module(f'{pkg}.nodes.fx')
        osc = importlib.import_module(f'{pkg}.nodes.osc')
        fixed = importlib.import_module(f'{pkg}.nodes.fixed')
        root, _ = build_voice(pkg)
        lp = root._ports['left'].sig._ports['left'].sig
        assert isinstance(lp, fx.LowPass)
        tone = osc.Sine()
        tone.hertz = fixed.Fixed()
        tone.hertz.sig.get_state().value = np.float32([[440.0]])
        gain = fx.Gain()
        gain.left = tone
        gain.right = lp
        return gain

    want, _ = jax_compile(patch('signals_tpu'), block_frames=F, rate=RATE,
                          channels=1).render(position=8 * F, n_blocks=8)
    compiled = CompiledPatch(patch('signals_tpu_torch'), block_frames=F,
                             rate=RATE, channels=1, device='cpu')
    got = compiled.render(position=8 * F, n_blocks=8)[0].numpy()
    params = compiled.params()
    steps = torch.cat([compiled.step(params, {}, (8 + i) * F)[0]
                       for i in range(8)]).numpy()
    want = np.asarray(want)
    assert np.abs(want).max() > 0.01
    assert np.abs(got - want).max() <= 1e-5
    assert np.abs(steps - want).max() <= 1e-5


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the no-GPU refusal cannot be shown')
    root, hz = build_voice('signals_tpu_torch')
    from signals_tpu_torch.parallel import PolyPatch
    with pytest.raises(RuntimeError, match='CUDA'):
        PolyPatch(root, n_voices=V, overrides={(hz, 'value'): freqs()},
                  device='cuda')


def test_entry_points_default_to_the_card():
    """Without ``device``, ``compile_node``, ``CompiledPatch`` and
    ``PolyPatch`` ask for the GPU: where torch sees none they raise instead
    of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the no-GPU refusal cannot be shown')
    from signals_tpu_torch.compiler import CompiledPatch, compile_node
    from signals_tpu_torch.parallel import PolyPatch
    root, hz = build_voice('signals_tpu_torch')
    with pytest.raises(RuntimeError, match='CUDA'):
        compile_node(root, block_frames=F, rate=RATE)
    with pytest.raises(RuntimeError, match='CUDA'):
        CompiledPatch(root, block_frames=F, rate=RATE, channels=1)
    with pytest.raises(RuntimeError, match='CUDA'):
        PolyPatch(root, n_voices=V, overrides={(hz, 'value'): freqs()})
