"""The port's per-block, unaligned and render-ahead paths against the JAX
package.

* The mono subtractive voice (``bench.py:87-128``: saw -> LowPass swept by
  a 0.5 Hz LFO, 8-block carry segments -> RingMod with an ADSR -> gain
  1/64), compiled at one channel: rendered from 0 for 24 blocks, block by
  block through ``step``, and from block 3 for 13 blocks (a start off the
  carry-segment grid), each against the JAX render and the JAX numpy
  oracle within 1e-5.
* The ``Transport`` re-aligns after a seek off the segment grid: the
  delivered blocks equal one render from the seek position (within 1e-6:
  the batches lower the ADSR's grid scan at other lengths), and the second
  batch starts on a segment boundary.
* The static-cutoff voice (``bench.py:131-162``, context 128) at 16
  channels in 8-block ``Transport`` batches — the batched per-block
  replay, one ``sosfilt_batch`` call per batch — against the JAX render
  with the Pallas mega filter in interpret mode, within 1e-5 per lane.
* A LowPass feeding a BandPass whose context (300 frames) is not a whole
  block, through ``step``, against the JAX step within 1e-5.
"""

import importlib

import numpy as np
import pytest
import torch

from signals_tpu_torch.compiler import compile_node
from signals_tpu_torch.compiler import kernels as K
from signals_tpu_torch.runtime import Transport

RATE, F = 44100, 1024
TOL = 1e-5


def nodes(pkg):
    return {m: importlib.import_module(f'{pkg}.nodes.{m}')
            for m in ('env', 'fixed', 'fx', 'osc')}


def fixed(mod, value):
    f = mod['fixed'].Fixed()
    f.get_state().value = np.atleast_2d(np.asarray(value, np.float32))
    return f


def envelope(mod, voiced_left, gain):
    """``voiced_left`` -> RingMod with an ADSR gated by a 2 Hz square ->
    Gain ``gain``."""
    gate = mod['osc'].Square()
    gate.hertz = fixed(mod, 2.0)
    env = mod['env'].ADSR()
    env.gate = gate
    st = env.get_state()
    st.attack, st.decay, st.sustain, st.release = 0.01, 0.08, 0.6, 0.1
    voiced = mod['fx'].RingMod()
    voiced.left = voiced_left
    voiced.right = env
    out = mod['fx'].Gain()
    out.left = voiced
    out.right = fixed(mod, gain)
    return out


def mono_voice(pkg):
    """The swept subtractive voice (``bench.py:87-128``)."""
    mod = nodes(pkg)
    fx, osc = mod['fx'], mod['osc']
    saw = osc.Sawtooth()
    saw.hertz = fixed(mod, 110.0)
    lfo = osc.Sine()
    lfo.hertz = fixed(mod, 0.5)
    depth = fx.Gain()
    depth.left = lfo
    depth.right = fixed(mod, 900.0)
    cutoff = fx.Mix()
    cutoff.left = depth
    cutoff.right = fixed(mod, 2000.0)
    cutoff.mix = fixed(mod, 0.5)
    lp = fx.LowPass()
    lp.input = saw
    lp.cutoff = cutoff
    lp.get_state().context = fx.LowPass.context_for(550.0, RATE)
    return envelope(mod, lp, 1.0 / 64)


def static_voice(pkg, hz):
    """The static-cutoff voice (``bench.py:131-162``) at ``hz`` pitches."""
    mod = nodes(pkg)
    saw = mod['osc'].Sawtooth()
    saw.hertz = fixed(mod, hz)
    lp = mod['fx'].LowPass()
    lp.input = saw
    lp.cutoff = fixed(mod, 2000.0)
    lp.get_state().context = mod['fx'].LowPass.context_for(2000.0, RATE)
    return envelope(mod, lp, 1.0 / 64)


def nested_pair(pkg):
    """Two detuned saws -> LowPass 1200 Hz -> BandPass 300-3000 Hz with a
    300-frame context (not a whole block)."""
    mod = nodes(pkg)
    saw = mod['osc'].Sawtooth()
    saw.hertz = fixed(mod, [[110.0, 185.0]])
    lp = mod['fx'].LowPass()
    lp.input = saw
    lp.cutoff = fixed(mod, 1200.0)
    bp = mod['fx'].BandPass()
    bp.input = lp
    bp.low = fixed(mod, 300.0)
    bp.high = fixed(mod, 3000.0)
    bp.get_state().context = 300
    return bp


def pull_oracle(root, start, n, channels):
    from signals_tpu.core import BlockLoc, Request, Shape
    return np.concatenate([np.broadcast_to(root.respond(Request(
        requestor=None, port='test',
        loc=BlockLoc(position=i * F, rate=RATE, shape=Shape(F, channels)))),
        (F, channels)) for i in range(start, start + n)])


def jax_steps(compiled, positions):
    import jax
    params = compiled.params()
    carry = jax.tree.map(lambda x: x, compiled.carry0)
    out = []
    for pos in positions:
        block, carry, _ = compiled.step(params, carry, pos, {})
        out.append(np.asarray(block))
    return np.concatenate(out)


@pytest.fixture(scope='module')
def mono_ref():
    """JAX renders of the mono voice (from 0, block by block, from block
    3) and the JAX numpy oracle over 24 blocks."""
    from signals_tpu.compiler import compile_node as jax_compile
    jc = jax_compile(mono_voice('signals_tpu'), block_frames=F, rate=RATE,
                     channels=1)
    assert jc.carry_seg_align == 8
    full, _ = jc.render(position=0, n_blocks=24, deliver_taps=False)
    unaligned, _ = jc.render(position=3 * F, n_blocks=13, deliver_taps=False)
    return {'render': np.asarray(full),
            'step': jax_steps(jc, [i * F for i in range(24)]),
            'unaligned': np.asarray(unaligned),
            'oracle': pull_oracle(mono_voice('signals_tpu'), 0, 24, 1)}


@pytest.mark.parametrize('path', ['render', 'step', 'unaligned'])
def test_mono_voice_matches_jax_and_oracle(mono_ref, path):
    compiled = compile_node(mono_voice('signals_tpu_torch'), block_frames=F,
                            rate=RATE, channels=1, device='cpu')
    assert compiled.carry_seg_align == 8
    if path == 'render':
        got, carry = compiled.render(position=0, n_blocks=24)
        assert carry == {}
        want = mono_ref['oracle']
    elif path == 'step':
        params = compiled.params()
        got = torch.cat([compiled.step(params, {}, i * F)[0]
                         for i in range(24)])
        want = mono_ref['oracle']
    else:
        # a start off the 8-block segment grid: the window widens back to
        # the segment start instead of raising
        got, _ = compiled.render(position=3 * F, n_blocks=13)
        want = mono_ref['oracle'][3 * F:16 * F]
    got = got.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - mono_ref[path]).max() <= TOL
    assert np.abs(got - want).max() <= TOL
    assert np.abs(want).max() > 0.005        # not silence (gain 1/64)


def collect(transport, n_blocks):
    """Drive ``render_ahead`` until ``n_blocks`` blocks were delivered;
    returns (audio, block positions, batch start positions)."""
    got, positions, starts = [], [], []

    def consumer(block, position):
        got.append(block)
        positions.append(position)

    transport.consumer = consumer
    while len(got) < n_blocks:
        starts.append(transport.position)
        transport.render_ahead()
    return np.concatenate(got[:n_blocks]), positions, starts


def test_transport_realigns_after_unaligned_seek():
    compiled = compile_node(mono_voice('signals_tpu_torch'), block_frames=F,
                            rate=RATE, channels=1, device='cpu')
    tr = Transport(compiled, consumer=None)
    tr.seek(3 * F)
    audio, positions, starts = collect(tr, 24)
    assert starts == [3 * F, 8 * F, 16 * F, 24 * F]
    assert starts[1] % (8 * F) == 0
    assert positions[:24] == [(3 + i) * F for i in range(24)]
    want = compiled.render(position=3 * F, n_blocks=24)[0].numpy()
    assert np.abs(audio - want).max() <= 1e-6
    assert tr.stats.total_blocks == 29


def test_transport_thread_streams_in_order():
    compiled = compile_node(mono_voice('signals_tpu_torch'), block_frames=F,
                            rate=RATE, channels=1, device='cpu')
    positions = []
    done = __import__('threading').Event()

    def consumer(block, position):
        assert block.shape == (F, 1) and block.dtype == np.float32
        positions.append(position)
        if len(positions) >= 16:
            done.set()

    tr = Transport(compiled, consumer)
    tr.start()
    assert done.wait(120)
    tr.stop()
    assert tr.error is None and not tr.is_active
    assert positions == [i * F for i in range(len(positions))]


def test_static_voice_render_ahead_matches_jax_pallas(monkeypatch):
    import signals_tpu.compiler as jax_compiler
    from signals_tpu.compiler import filters as jax_filters
    hz = (110.0 * 2 ** (np.arange(16) % 12 / 12.0)
          * (1 + 0.001 * np.arange(16))).astype(np.float32).reshape(1, 16)
    monkeypatch.setattr(jax_filters, 'MEGA_FILTER_IMPL', 'pallas')
    jax_compiler._compile_cache.clear()
    try:
        jc = jax_compiler.compile_node(static_voice('signals_tpu', hz),
                                       block_frames=F, rate=RATE,
                                       channels=16)
        want = np.concatenate([np.asarray(jc.render(
            position=b * F, n_blocks=8, deliver_taps=False)[0])
            for b in (3, 11, 19)])
    finally:
        jax_compiler._compile_cache.clear()
    calls = []
    batch = K.sosfilt_batch

    def spy(*args, **kw):
        calls.append(kw.get('tail'))
        return batch(*args, **kw)

    monkeypatch.setattr(K, 'sosfilt_batch', spy)
    compiled = compile_node(static_voice('signals_tpu_torch', hz),
                            block_frames=F, rate=RATE, channels=16,
                            device='cpu')
    assert compiled.carry_seg_align == 1
    tr = Transport(compiled, consumer=None)
    tr.seek(3 * F)
    got = np.concatenate([tr.render(8) for _ in range(3)])
    assert calls == [F, F, F]           # one batched replay per batch
    assert got.shape == want.shape == (24 * F, 16)
    assert np.abs(got - want).max() <= TOL
    assert np.abs(want).max() > 0.005


def test_nested_pair_step_matches_jax():
    from signals_tpu.compiler import compile_node as jax_compile
    positions = [0, F, 5 * F]
    want = jax_steps(jax_compile(nested_pair('signals_tpu'), block_frames=F,
                                 rate=RATE, channels=2), positions)
    compiled = compile_node(nested_pair('signals_tpu_torch'), block_frames=F,
                            rate=RATE, channels=2, device='cpu')
    params = compiled.params()
    got = torch.cat([compiled.step(params, {}, p)[0]
                     for p in positions]).numpy()
    assert got.shape == want.shape == (3 * F, 2)
    assert np.abs(got - want).max() <= TOL
    assert np.abs(want).max() > 0.05
