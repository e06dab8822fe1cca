"""The port's nodes and design math against the JAX package.

* Oscillators: bit-exact (``==``) against the JAX package's numpy pull
  engine, in the port's pull engine and in its compiled CPU render —
  including a start far from 0, where the phase chain's ulps are large.
* ``design_coupled``: the port's numpy design equals the JAX package's bit
  for bit for all four Butterworth types, out-of-band cutoffs included;
  the torch (f64) design agrees to f64 round-off: low/high-pass within one
  f32 ulp (rtol 2**-23), band edges below 20 kHz bit for bit.  (Band edges
  clipped at Nyquist make the coupled taps cancel catastrophically; there
  the torch design is not held to the numpy one.)
* HighPass, BandPass and BandStop in the port's pull engine against the
  JAX pull engine (both scipy f64 replay, or the f64 carry recurrence for a
  swept band edge), within 1e-6; and the port's compiled CPU render of
  each against the JAX compiled render within 1e-5 (both f32 cascades; the
  f64 pull engine is ~1.3e-5 from either on the static band voices).
* ADSR: the port's carry-free grid lowering agrees with the JAX lowering
  within 1e-6 on gate patterns with retriggers (the two scans associate the
  affine-update products in different orders).
"""

import importlib

import numpy as np
import pytest
import torch

from signals_tpu_torch.compiler import CompiledPatch
from signals_tpu_torch.core.xp import NP, TorchXP

RATE = 44100


def fixed(pkg, value):
    f = importlib.import_module(f'{pkg}.nodes.fixed').Fixed()
    f.get_state().value = np.atleast_2d(np.asarray(value, np.float32))
    return f


def pull(root, pkg, position, n_blocks, frames, channels):
    core = importlib.import_module(f'{pkg}.core')
    out = []
    for i in range(n_blocks):
        loc = core.BlockLoc(position=position + i * frames, rate=RATE,
                            shape=core.Shape(frames, channels))
        b = root.respond(core.Request(requestor=None, port='t', loc=loc))
        out.append(np.broadcast_to(b, (frames, channels)))
    return np.concatenate(out)


@pytest.mark.parametrize('name', ['Sine', 'Square', 'Sawtooth', 'Triangle'])
def test_oscillators_bit_exact_vs_jax_pull(name):
    rng = np.random.default_rng(7)
    hz = rng.uniform(20.0, 5000.0, (1, 5)).astype(np.float32)
    ph = rng.uniform(0.0, 1.0, (1, 5)).astype(np.float32)
    F, nb = 512, 4
    pos = 5859 * F                      # ~68 s into the timeline

    def build(pkg):
        osc = getattr(importlib.import_module(f'{pkg}.nodes.osc'), name)()
        osc.hertz = fixed(pkg, hz)
        osc.phase = fixed(pkg, ph)
        return osc

    want = pull(build('signals_tpu'), 'signals_tpu', pos, nb, F, 5)
    got_pull = pull(build('signals_tpu_torch'), 'signals_tpu_torch', pos,
                    nb, F, 5)
    compiled = CompiledPatch(build('signals_tpu_torch'), block_frames=F,
                             rate=RATE, channels=5, device='cpu')
    got = compiled.render(position=pos, n_blocks=nb)[0].numpy()
    assert np.array_equal(got_pull, want)
    assert np.array_equal(got, want)


def test_design_coupled_matches_jax():
    for btype in ('lp', 'hp'):
        check_design_matches_jax(btype)


@pytest.mark.parametrize('btype', ['bp', 'bs'])
def test_band_design_coupled_matches_jax(btype):
    check_design_matches_jax(btype)


def check_design_matches_jax(btype):
    from signals_tpu.compiler.filters import design_coupled as jax_design
    from signals_tpu_torch.compiler.filters import design_coupled
    rng = np.random.default_rng(3)
    cuts = np.concatenate([rng.uniform(20.0, 21000.0, 4000),
                           [0.0, -5.0, 22050.0, 30000.0]]).astype(np.float32)
    crits = (cuts.reshape(1, -1),)
    nyq = np.float32(RATE / 2)
    torch_crits = crits
    if btype in ('bp', 'bs'):
        ratio = rng.uniform(1.1, 4.0, cuts.shape)
        crits += ((cuts * ratio).astype(np.float32).reshape(1, -1),)
        torch_crits += (np.minimum(cuts * ratio, 20000.0).astype(
            np.float32).reshape(1, -1),)
    want = jax_design(np, btype, crits, nyq)
    assert np.array_equal(design_coupled(NP, btype, crits, nyq), want)
    want = jax_design(np, btype, torch_crits, nyq)
    got = design_coupled(TorchXP('cpu'), btype,
                         tuple(torch.as_tensor(c) for c in torch_crits),
                         nyq).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    if btype in ('lp', 'hp'):
        np.testing.assert_allclose(got, want, rtol=2.0 ** -23, atol=0)
    else:
        assert np.array_equal(got, want)


def build_filtered_saw(pkg, name, swept=False):
    """Three detuned saws through ``name`` (context 512): static crits, or
    a band whose low edge a 0.5 Hz LFO sweeps (8-block carry segments)."""
    osc = importlib.import_module(f'{pkg}.nodes.osc')
    fx = importlib.import_module(f'{pkg}.nodes.fx')
    saw = osc.Sawtooth()
    saw.hertz = fixed(pkg, [[110.0, 163.0, 271.0]])
    filt = getattr(fx, name)()
    filt.input = saw
    filt.get_state().context = 512
    if name == 'HighPass':
        filt.cutoff = fixed(pkg, [[400.0, 900.0, 1500.0]])
        return filt
    if swept:
        lfo = osc.Sine()
        lfo.hertz = fixed(pkg, 0.5)
        depth = fx.Gain()
        depth.left = lfo
        depth.right = fixed(pkg, 150.0)
        low = fx.Mix()
        low.left = depth
        low.right = fixed(pkg, 400.0)
        low.mix = fixed(pkg, 0.5)
        filt.low = low
    else:
        filt.low = fixed(pkg, [[300.0, 250.0, 500.0]])
    filt.high = fixed(pkg, 3000.0)
    return filt


@pytest.mark.parametrize('name,swept', [('HighPass', False),
                                        ('BandPass', False),
                                        ('BandStop', False),
                                        ('BandPass', True)])
def test_butterworth_family_pull_matches_jax_pull(name, swept):
    F, nb, start = 1024, 3, 6
    want = pull(build_filtered_saw('signals_tpu', name, swept),
                'signals_tpu', start * F, nb, F, 3)
    got = pull(build_filtered_saw('signals_tpu_torch', name, swept),
               'signals_tpu_torch', start * F, nb, F, 3)
    assert np.abs(got - want).max() <= 1e-6
    assert np.abs(want).max() > 0.1
    from signals_tpu.compiler import compile_node as jax_compile
    jax_out, _ = jax_compile(build_filtered_saw('signals_tpu', name, swept),
                             block_frames=F, rate=RATE, channels=3).render(
        position=start * F, n_blocks=nb)
    compiled = CompiledPatch(build_filtered_saw('signals_tpu_torch', name,
                                                swept),
                             block_frames=F, rate=RATE, channels=3,
                             device='cpu')
    rendered = compiled.render(position=start * F, n_blocks=nb)[0].numpy()
    assert np.abs(rendered - np.asarray(jax_out)).max() <= 1e-5


@pytest.mark.parametrize('gate_hz,channels', [(5.0, 1), (3.3, 2)])
def test_adsr_grid_lowering_matches_jax(gate_hz, channels):
    """Gate edges every ~0.1-0.15 s with attack+decay 0.13 s and release
    0.15 s: every on-edge retriggers during a release, every off-edge
    during an attack or decay."""
    from signals_tpu.compiler import CompiledPatch as JaxCompiled
    F, nb = 512, 48
    hz = np.float32(gate_hz) * (1 + np.arange(channels, dtype=np.float32)
                                / 7)

    def build(pkg):
        gate = importlib.import_module(f'{pkg}.nodes.osc').Square()
        gate.hertz = fixed(pkg, hz.reshape(1, -1))
        env = importlib.import_module(f'{pkg}.nodes.env').ADSR()
        env.gate = gate
        st = env.get_state()
        st.attack, st.decay, st.sustain, st.release = 0.05, 0.08, 0.5, 0.15
        return env

    jc = JaxCompiled(build('signals_tpu'), block_frames=F, rate=RATE,
                     channels=channels)
    want, _ = jc.render(position=8 * F, n_blocks=nb)
    got = CompiledPatch(build('signals_tpu_torch'), block_frames=F,
                        rate=RATE, channels=channels, device='cpu').render(
        position=8 * F, n_blocks=nb)[0].numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6
    # the edges were exercised: attacks reach the peak, releases fall well
    # below the sustain level before the next retrigger
    assert want.max() > 0.9 and want.min() < 0.3
