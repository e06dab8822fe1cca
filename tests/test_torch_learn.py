"""Differentiable fitting in the port (``signals_tpu_torch.learn``,
``PolyPatch.fit``) against the JAX package's ``signals_tpu.learn``.

On the CPU, at small sizes (F 256-1024, 1-4 channels, a few blocks), the
same numbers through both packages:

* the Hann window, the half-hop framing and the two spectral losses: values
  within 1e-5 relative, gradients within 1e-4 of the largest;
* ``fused_descent`` (Adam written out on tensors) against the JAX one over
  21 steps in chunks of 8, with and without per-leaf step scales: losses
  within 1e-5 relative;
* ``make_loss_fn`` gradients against ``jax.grad`` of the JAX
  ``make_loss_fn``, within 1e-3 of each leaf's largest |gradient|: a sine
  with a gain (no kernel), a saw through a fixed LowPass at 4 lanes (the
  batched entry), the swept flagship voice at 4 lanes and F 1024 (carry
  segments, through the timeline and the generator-fed entries), the echo
  feedback gain through the segmented feedback scan, and a streaming
  LowPass in that loop (the carried-state entry with its start and end
  states);
* fits that mirror ``tests/test_learn.py`` (a gain, fused against per-step
  chunks, ``relative_lr``) and ``PolyPatch.fit`` of a per-voice gain;
* the ``Wavetable``'s render and table gradient;
* a trainable upstream of a ``Reverb``: the same gradient from the
  whole-window and the per-block plans, and a fit that lowers the loss.

The plain cascade is a loop over frames, so every case keeps its rows few;
the fits at full size run on the card (``chip_smoke.py`` phase 7,
``scripts/torch_fit_full.py``).
"""

import functools
import importlib

import numpy as np
import pytest
import torch

from signals_tpu_torch import learn
from signals_tpu_torch.compiler import compile_node
from signals_tpu_torch.compiler import filters as FI
from signals_tpu_torch.parallel import PolyPatch

RATE = 44100
JAX, PORT = 'signals_tpu', 'signals_tpu_torch'
GRAD_TOL = 1e-3      # the port's gradients vs jax.grad of the JAX package's


def nodes(pkg):
    return {m: importlib.import_module(f'{pkg}.nodes.{m}')
            for m in ('delay', 'env', 'fixed', 'fx', 'osc', 'reverb',
                      'wavetable')}


def fixed(mod, value):
    f = mod['fixed'].Fixed()
    f.get_state().value = np.atleast_2d(np.asarray(value, np.float32))
    return f


def gain(mod, left, g):
    out = mod['fx'].Gain()
    out.left = left
    out.right = g
    return out


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def to_np(t):
    return t.detach().cpu().numpy()


# --- the window, the framing and the losses ----------------------------------

def test_hann_window_is_numpys_symmetric_window():
    import jax.numpy as jnp
    for n in (256, 1024, 4096):
        got = to_np(learn._hanning(n, 'cpu'))
        assert np.array_equal(got, np.hanning(n).astype(np.float32))
        assert got[0] == 0.0 and got[-1] == 0.0       # symmetric, not periodic
        np.testing.assert_allclose(got, np.asarray(jnp.hanning(n)),
                                   rtol=0, atol=1e-6)


def test_frames_half_hop_matches_jax():
    from signals_tpu.learn import _frames_half_hop as jframes
    x = np.random.default_rng(0).standard_normal(3000).astype(np.float32)
    for n in (256, 1024, 2048):
        np.testing.assert_array_equal(
            to_np(learn._frames_half_hop(torch.tensor(x), n)),
            np.asarray(jframes(x, n)))


def loss_value_and_grad_jax(name, pred, target, kw):
    import jax
    from signals_tpu import learn as jlearn
    fn = functools.partial(getattr(jlearn, name), **kw)
    value, grad = jax.jit(jax.value_and_grad(fn))(pred, target)
    return float(value), np.asarray(grad)


@pytest.mark.parametrize('name,kw', [
    ('spectral_loss', {}),
    ('spectral_loss', {'waveform': 0.0, 'fft_sizes': (128, 512)}),
    ('per_channel_spectral_loss', {}),
    ('per_channel_spectral_loss', {'waveform': 0.5, 'fft_sizes': (256,)})])
def test_losses_match_jax(name, kw):
    rng = np.random.default_rng(1)
    pred = rng.standard_normal((8192, 3)).astype(np.float32)
    target = rng.standard_normal((8192, 3)).astype(np.float32)
    want_v, want_g = loss_value_and_grad_jax(name, pred, target, kw)
    p = torch.tensor(pred, requires_grad=True)
    value = getattr(learn, name)(p, torch.tensor(target), **kw)
    (g,) = torch.autograd.grad(value, p)
    assert abs(value.item() - want_v) <= 1e-5 * abs(want_v)
    assert rel_err(to_np(g), want_g) <= 1e-4


# --- Adam ---------------------------------------------------------------------

QUAD = np.random.default_rng(2).standard_normal((4, 3)).astype(np.float32)
QUAD_B = np.random.default_rng(3).standard_normal(4).astype(np.float32)


def quad_loss(asarray, train):
    r = (asarray(QUAD) @ train['a']['w'] - asarray(QUAD_B)
         + train['b']['v'] ** 2)
    return (r * r).sum()


@pytest.mark.parametrize('scaled', [False, True])
def test_fused_descent_matches_jax(scaled):
    """21 Adam steps in chunks of 8 (the tail of 5 included) on a small
    quadratic in both packages."""
    import jax.numpy as jnp
    from signals_tpu.learn import fused_descent as jdescent
    w0 = np.array([0.5, -1.0, 2.0], np.float32)
    v0 = np.array([0.3], np.float32)
    sw, sv = np.array([1.0, 0.01, 2.0], np.float32), np.array([0.5],
                                                              np.float32)
    kw = dict(steps=21, learning_rate=0.05, steps_per_dispatch=8)
    jtrain = {'a': {'w': jnp.asarray(w0)}, 'b': {'v': jnp.asarray(v0)}}
    jscale = ({'a': {'w': jnp.asarray(sw)}, 'b': {'v': jnp.asarray(sv)}}
              if scaled else None)
    jout, jlosses = jdescent(lambda t: quad_loss(jnp.asarray, t), jtrain,
                             lr_scale=jscale, **kw)
    ptrain = {'a': {'w': torch.tensor(w0, requires_grad=True)},
              'b': {'v': torch.tensor(v0, requires_grad=True)}}
    pscale = ({'a': {'w': torch.tensor(sw)}, 'b': {'v': torch.tensor(sv)}}
              if scaled else None)
    pout, plosses = learn.fused_descent(
        lambda t: quad_loss(torch.tensor, t), ptrain,
        lr_scale=pscale, **kw)
    assert len(plosses) == len(jlosses) == 21
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-5, atol=0)
    for uid, p in (('a', 'w'), ('b', 'v')):
        np.testing.assert_allclose(to_np(pout[uid][p]),
                                   np.asarray(jout[uid][p]), rtol=1e-5,
                                   atol=1e-6)


# --- make_loss_fn gradients against jax.grad ----------------------------------

def build_sine_gain(pkg):
    mod = nodes(pkg)
    hz, vol = fixed(mod, 300.0), fixed(mod, 0.5)
    o = mod['osc'].Sine()
    o.hertz = hz
    return gain(mod, o, vol), {'hz': (hz, 'value'), 'vol': (vol, 'value')}


def build_saw_lowpass(pkg):
    mod = nodes(pkg)
    hz = fixed(mod, np.array([[110.0, 165.0, 220.0, 330.0]]))
    cut = fixed(mod, 900.0)
    saw = mod['osc'].Sawtooth()
    saw.hertz = hz
    lp = mod['fx'].LowPass()
    lp.input = saw
    lp.cutoff = cut
    lp.get_state().context = 128
    vol = fixed(mod, 0.5)
    return gain(mod, lp, vol), {'cut': (cut, 'value'), 'vol': (vol, 'value')}


def build_flagship(pkg):
    """chip_smoke.build_subtractive_voice at 4 pitches: saw -> LowPass swept
    by 2000 + 450 Sine(0.5 Hz) (context 512) -> RingMod(ADSR) -> gain."""
    mod = nodes(pkg)
    hz = fixed(mod, (110.0 * 2 ** (np.arange(4) / 12.0)).reshape(1, 4))
    saw = mod['osc'].Sawtooth()
    saw.hertz = hz
    lfo = mod['osc'].Sine()
    lfo.hertz = fixed(mod, 0.5)
    depth, centre = fixed(mod, 900.0), fixed(mod, 2000.0)
    cutoff = mod['fx'].Mix()
    cutoff.left = gain(mod, lfo, depth)
    cutoff.right = centre
    cutoff.mix = fixed(mod, 0.5)
    lp = mod['fx'].LowPass()
    lp.input = saw
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
    vol = fixed(mod, 0.25)
    return gain(mod, voiced, vol), {
        'hz': (hz, 'value'), 'centre': (centre, 'value'),
        'depth': (depth, 'value'), 'sustain': (env, 'sustain'),
        'vol': (vol, 'value')}


def build_echo(pkg, streaming=False):
    """``tests/test_learn.py:91-134``'s saturated echo (a Drive and a gain
    on the return of a 4-block delay), optionally with a streaming LowPass
    after the Drive."""
    mod = nodes(pkg)
    o = mod['osc'].Sine()
    o.hertz = fixed(mod, 220.0)
    d = mod['delay'].Delay()
    d.get_state().frames = 4 * 256
    sh = mod['fx'].Drive()
    sh.input = d
    sh.drive = fixed(mod, 1.2)
    ret, named = sh, {}
    if streaming:
        cut = fixed(mod, 1500.0)
        lp = mod['fx'].LowPass()
        lp.input = sh
        lp.cutoff = cut
        lp.get_state().streaming = True
        ret, named = lp, {'cut': (cut, 'value')}
    vol = fixed(mod, 0.3)
    m = mod['fx'].Mix()
    m.left = o
    m.right = gain(mod, ret, vol)
    m.mix = fixed(mod, 0.5)
    d.input = m
    return m, dict(named, vol=(vol, 'value'))


CASES = {
    # name: (build function, block frames, blocks, channels)
    'sine_gain': (build_sine_gain, 512, 4, 1),
    'saw_lowpass': (build_saw_lowpass, 256, 4, 4),
    'flagship': (build_flagship, 1024, 8, 4),
    'echo': (build_echo, 256, 12, 1),
    'echo_streaming': (functools.partial(build_echo, streaming=True), 256,
                       12, 1),
}


def case_target(name):
    _, F, nb, ch = CASES[name]
    rng = np.random.default_rng(len(name))
    return (0.3 * rng.standard_normal((nb * F, ch))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_grads(name):
    """``jax.grad`` of the JAX ``make_loss_fn`` at the case's named leaves
    (jitted: one program)."""
    import jax
    from signals_tpu.compiler import compile_node as jcompile
    from signals_tpu.learn import make_loss_fn as jmake
    build, F, nb, ch = CASES[name]
    root, named = build(JAX)
    c = jcompile(root, block_frames=F, rate=RATE, channels=ch)
    grads = jax.jit(jax.grad(jmake(c, case_target(name)), allow_int=True))(
        c.params())
    return {k: np.asarray(grads[c.index.info(n).uid][p])
            for k, (n, p) in named.items()}, c.segment_scan_core(nb)


def port_grads(name, seg_gen=False):
    build, F, nb, ch = CASES[name]
    root, named = build(PORT)
    old = FI.SEG_SOURCE_GEN
    FI.SEG_SOURCE_GEN = seg_gen
    try:
        c = compile_node(root, block_frames=F, rate=RATE, channels=ch,
                         device='cpu')
    finally:
        FI.SEG_SOURCE_GEN = old
    params = c.params()
    leaves = {}
    for k, (n, p) in named.items():
        uid = c.index.info(n).uid
        params[uid][p] = leaves[k] = params[uid][p].clone().requires_grad_()
    value = learn.make_loss_fn(c, case_target(name))(params)
    grads = torch.autograd.grad(value, list(leaves.values()))
    return dict(zip(leaves, map(to_np, grads))), c


@pytest.mark.parametrize('name,seg_gen', [
    ('sine_gain', False), ('saw_lowpass', False), ('flagship', False),
    ('flagship', True), ('echo', False), ('echo_streaming', False)])
def test_make_loss_fn_grads_match_jax(name, seg_gen):
    from signals_tpu_torch.compiler import kernels as K
    want, jax_segments = jax_grads(name)
    K.reset_launch_counts()
    got, c = port_grads(name, seg_gen)
    nb = CASES[name][2]
    if name.startswith('echo'):
        assert c.plan(nb) == 'segment_scan' and jax_segments is not None
    for k in want:
        assert np.isfinite(got[k]).all() and np.abs(got[k]).max() > 0, k
        assert rel_err(got[k], want[k]) <= GRAD_TOL, (k, got[k], want[k])


# --- fits ---------------------------------------------------------------------

def sine_gain_target(n_blocks, F, value):
    root, named = build_sine_gain(PORT)
    named['vol'][0].get_state().value = np.full((1, 1), value, np.float32)
    named['hz'][0].get_state().value = np.full((1, 1), 440.0, np.float32)
    c = compile_node(root, block_frames=F, rate=RATE, device='cpu')
    return c.render(n_blocks=n_blocks)[0].numpy()


def sine_gain_model(g0):
    root, named = build_sine_gain(PORT)
    named['hz'][0].get_state().value = np.full((1, 1), 440.0, np.float32)
    vol = named['vol'][0]
    vol.get_state().value = np.full((1, 1), g0, np.float32)
    return root, vol


def test_fit_recovers_gain():
    """``tests/test_learn.py:44``: the gain constant converges, and
    ``apply`` writes it back into the live node."""
    target = sine_gain_target(4, 512, 0.8)
    root, vol = sine_gain_model(0.1)
    res = learn.fit(root, target, [(vol, 'value')], rate=RATE,
                    block_frames=512, steps=150, learning_rate=0.05,
                    device='cpu')
    c = compile_node(root, block_frames=512, rate=RATE, device='cpu')
    fitted = float(res.value_of(c, vol, 'value').ravel()[0])
    assert abs(fitted - 0.8) < 0.05, fitted
    assert res.losses[-1] < res.losses[0] * 0.1
    assert abs(float(vol.get_state().value[0, 0]) - 0.8) < 0.05


def test_fit_fused_dispatch_matches_per_step():
    """``tests/test_learn.py:239``: chunks of 8 steps (8 + 8 + a tail of 5)
    are the same steps as chunks of 1: the same losses and fitted value."""
    target = sine_gain_target(4, 512, 0.8)
    results = []
    for k in (1, 8):
        root, vol = sine_gain_model(0.1)
        res = learn.fit(root, target, [(vol, 'value')], rate=RATE,
                        block_frames=512, steps=21, learning_rate=0.05,
                        steps_per_dispatch=k, device='cpu')
        results.append((res.losses, float(vol.get_state().value[0, 0])))
    assert len(results[0][0]) == len(results[1][0]) == 21
    np.testing.assert_array_equal(results[0][0], results[1][0])
    assert results[0][1] == results[1][1]


def test_fit_relative_lr_multiscale():
    """``tests/test_learn.py:470``: ONE relative learning rate fits a
    kHz-scale cutoff and a unit-scale gain together."""
    def build(cut_v, vol_v):
        root, named = build_saw_lowpass(PORT)
        cut, vol = named['cut'][0], named['vol'][0]
        cut.get_state().value = np.full((1, 1), cut_v, np.float32)
        vol.get_state().value = np.full((1, 1), vol_v, np.float32)
        return root, cut, vol

    troot, _, _ = build(2000.0, 0.8)
    target = compile_node(troot, block_frames=256, rate=RATE,
                          device='cpu').render(n_blocks=4)[0].numpy()
    root, cut, vol = build(600.0, 0.2)
    res = learn.fit(root, target, [(cut, 'value'), (vol, 'value')],
                    block_frames=256, steps=50, learning_rate=0.1,
                    relative_lr=True, device='cpu')
    assert res.losses[-1] < res.losses[0] * 0.1
    fitted_cut = float(cut.get_state().value[0, 0])
    fitted_vol = float(vol.get_state().value[0, 0])
    assert 1500 < fitted_cut < 2800, fitted_cut
    assert abs(fitted_vol - 0.8) < 0.08, fitted_vol


def poly_voice():
    mod = nodes(PORT)
    hz = fixed(mod, 220.0)
    o = mod['osc'].Sine()
    o.hertz = hz
    vol = fixed(mod, 0.5)
    return gain(mod, o, vol), hz, vol


def test_polypatch_fit_per_voice_gain():
    """``PolyPatch.fit`` of a per-voice gain override at 4 voices against
    the target MIX: the four sines lie at distinct pitches, so the mix
    separates their gains; all four are recovered together and written
    back through ``set_override``."""
    hz = np.array([220.0, 277.0, 330.0, 415.0], np.float32)
    want = np.array([0.2, 0.5, 0.7, 0.9], np.float32)

    def poly(gains):
        root, hz_node, vol = poly_voice()
        return PolyPatch(root, n_voices=4,
                         overrides={(hz_node, 'value'): hz,
                                    (vol, 'value'): gains},
                         block_frames=512, rate=RATE, device='cpu'), vol

    target = poly(want)[0].render(n_blocks=4)[0].numpy()      # (2048, 1)
    p, vol = poly(np.full(4, 0.1, np.float32))
    res = p.fit(target, [(vol, 'value')], steps=120, learning_rate=0.05)
    assert res.losses[-1] < res.losses[0] * 0.1
    fitted = vol.get_state().value
    assert fitted.shape == (1, 4)
    np.testing.assert_allclose(fitted.reshape(-1), want, atol=0.05)
    np.testing.assert_array_equal(p._channel_overrides[1][3], fitted)


# --- Wavetable ----------------------------------------------------------------

def test_wavetable_render_and_table_grad_match_jax():
    import jax
    from signals_tpu.compiler import compile_node as jcompile
    from signals_tpu.learn import make_loss_fn as jmake
    rng = np.random.default_rng(5)
    table = rng.standard_normal((64, 1)).astype(np.float32)
    target = (0.3 * rng.standard_normal((4 * 256, 1))).astype(np.float32)

    def build(pkg):
        mod = nodes(pkg)
        w = mod['wavetable'].Wavetable()
        w.hertz = fixed(mod, 330.0)
        w.get_state().table = table
        return w

    jw = build(JAX)
    jc = jcompile(jw, block_frames=256, rate=RATE, channels=1)
    pw = build(PORT)
    pc = compile_node(pw, block_frames=256, rate=RATE, device='cpu')
    # XLA may contract the interpolation's multiply-add: one ulp
    np.testing.assert_allclose(pc.render(n_blocks=4)[0].numpy(),
                               np.asarray(jc.render(n_blocks=4)[0]),
                               rtol=0, atol=1e-6)
    uid = jc.index.info(jw).uid
    want = np.asarray(jax.jit(jax.grad(jmake(jc, target), allow_int=True))(
        jc.params())[uid]['table'])
    params = pc.params()
    params[uid]['table'] = t = params[uid]['table'].requires_grad_()
    (got,) = torch.autograd.grad(
        learn.make_loss_fn(pc, target)(params), t)
    assert np.abs(want).max() > 0
    assert rel_err(to_np(got), want) <= GRAD_TOL


# --- through a reverb ---------------------------------------------------------

def test_trainable_upstream_of_reverb_raises():
    """Fitting through a ``Reverb`` runs (no refusal remains): a trainable
    upstream of it gets the same gradient from the whole-window plan
    (``mega_step``: the FDN entry's adjoint) and from the per-block plan
    (``step``, autograd of its slices) within 1e-5 relative, and
    ``learn.fit`` lowers the loss against a target rendered at another
    gain."""
    F, nb = 256, 8
    mod = nodes(PORT)
    vol = fixed(mod, 0.5)
    o = mod['osc'].Sine()
    o.hertz = fixed(mod, 220.0)
    rev = mod['reverb'].Reverb()
    rev.input = gain(mod, o, vol)
    rev.get_state().t60 = 0.5
    c = compile_node(rev, block_frames=F, rate=RATE, device='cpu')
    vol.get_state().value = np.full((1, 1), 0.3, np.float32)
    target = c.render(n_blocks=nb)[0].numpy()
    vol.get_state().value = np.full((1, 1), 0.5, np.float32)
    uid = c.index.info(vol).uid
    grads = []
    for mega in (True, False):
        c.enable_mega = mega
        c._render_cache.clear()
        assert c.plan(nb) == ('mega' if mega else 'blocks')
        params = c.params()
        params[uid]['value'] = v = params[uid]['value'].requires_grad_()
        (g,) = torch.autograd.grad(learn.make_loss_fn(c, target)(params), v)
        grads.append(to_np(g))
    c.enable_mega = True
    c._render_cache.clear()
    assert np.abs(grads[0]).max() > 0
    assert rel_err(grads[1], grads[0]) <= 1e-5
    res = learn.fit(rev, target, [(vol, 'value')], block_frames=F,
                    steps=8, learning_rate=0.05, device='cpu', apply=False)
    assert res.losses[-1] < res.losses[0]
