"""The modulation effects and the shape nodes against the JAX package.

Every test of ``tests/test_phaser.py``, ``tests/test_moddelay.py`` and
``tests/test_conv.py`` has a counterpart here that builds the same patch in
both packages from the same numbers and holds the port's CPU render to the
port's numpy pull oracle and to the JAX package's render (its compiled CPU
render), at the reference test's own tolerance: 1e-6 for the ``Phaser``
(the Hillis-Steele scan against the per-frame recurrence) and ``FracDelay``,
``TOL = 1e-5`` for ``Convolve``.  The shape nodes (``Flatten``,
``FlattenUnit``, ``Select``, ``Merge``) are held to the JAX package bit for
bit (``FlattenUnit``'s mean to one ulp).  A narrow carry-free patch takes
the port's whole-window plan where the JAX package renders it per block
(fault C1, closed): the audio agrees within 1e-5 (the mono static voice and
a 4096-tap ``Convolve``).
"""

import importlib
import os

import numpy as np
import pytest
import torch

import signals_tpu_torch.compiler as TC
from signals_tpu_torch.compiler import compile_node

F, RATE = 512, 44100
TOL = 1e-5
PKGS = ('signals_tpu', 'signals_tpu_torch')


def mod(pkg, name):
    return importlib.import_module(f'{pkg}.{name}')


def fixed(pkg, value):
    f = mod(pkg, 'nodes.fixed').Fixed()
    f.get_state().value = np.atleast_2d(np.asarray(value, np.float32))
    return f


def pull(root, n_blocks, channels=1, start_block=0, pkg='signals_tpu_torch',
         frames=F):
    core = mod(pkg, 'core')
    out = []
    for i in range(start_block, start_block + n_blocks):
        loc = core.BlockLoc(position=i * frames, rate=RATE,
                            shape=core.Shape(frames, channels))
        b = root.respond(core.Request(requestor=None, port='t', loc=loc))
        out.append(np.broadcast_to(b, (frames, channels)))
    return np.concatenate(out)


def render(root, n_blocks, channels=1, *, mega=True, position=0,
           carry=None, frames=F):
    """The port's compiled CPU render ``(audio numpy, carry, patch)``."""
    c = compile_node(root, block_frames=frames, rate=RATE, channels=channels,
                     device='cpu')
    if not mega:
        c.enable_mega = False
        c._render_cache.clear()
    audio, carry2 = c.render(position=position, n_blocks=n_blocks,
                             carry=carry, deliver_taps=False)
    TC._compile_cache.clear()
    return audio.numpy(), carry2, c


def jax_render(root, n_blocks, channels=1, position=0, frames=F):
    from signals_tpu.compiler import compile_node as jc
    c = jc(root, block_frames=frames, rate=RATE, channels=channels)
    audio, carry = c.render(position=position, n_blocks=n_blocks)
    import signals_tpu.compiler as JC
    JC._compile_cache.clear()
    return np.asarray(audio), carry, c


def saw(pkg, hz=220.0):
    s = mod(pkg, 'nodes.osc').Sawtooth()
    s.hertz = fixed(pkg, hz)
    return s


# --- Phaser -------------------------------------------------------------------


def saw_phaser(pkg, mix=0.5, f0=800.0):
    ph = mod(pkg, 'nodes.phaser').Phaser()
    ph.get_state().mix = mix
    ph.input = saw(pkg, 110.0)
    ph.sweep = fixed(pkg, f0)
    return ph


def noise_phaser(pkg, mix, f0=800.0, sweep_node=None):
    src = mod(pkg, 'nodes.noise').White()
    src.get_state().seed = 7
    ph = mod(pkg, 'nodes.phaser').Phaser()
    ph.get_state().mix = mix
    ph.input = src
    ph.sweep = sweep_node if sweep_node is not None else fixed(pkg, f0)
    return ph


def swept_sweep(pkg, hz=0.7, depth=600.0, center=900.0):
    """``center ± depth`` Hz at ``hz`` (Mix at 0.5 halves both legs)."""
    fx = mod(pkg, 'nodes.fx')
    lfo = mod(pkg, 'nodes.osc').Sine()
    lfo.hertz = fixed(pkg, hz)
    dep = fx.Gain()
    dep.left = lfo
    dep.right = fixed(pkg, depth)
    off = fx.Mix()
    off.left = dep
    off.right = fixed(pkg, center)
    off.mix = fixed(pkg, 0.5)
    return off


def test_phaser_parity_all_paths():
    fast, _, c = render(saw_phaser(PKGS[1]), 24)
    assert c.plan(24) == 'mega'
    slow, _, c2 = render(saw_phaser(PKGS[1]), 24, mega=False)
    assert c2.plan(24) == 'blocks'
    assert np.abs(fast - slow).max() < 1e-6
    oracle = pull(saw_phaser(PKGS[1]), 24)
    assert np.abs(fast - oracle).max() < 1e-6
    want, _, _ = jax_render(saw_phaser(PKGS[0]), 24)
    assert np.abs(fast - want).max() < 1e-6


def test_phaser_carry_continuation_and_jax_carry():
    from signals_tpu_torch.interop import carry_from_jax
    a, carry, _ = render(saw_phaser(PKGS[1]), 12)
    assert set(next(iter(carry.values()))) == {'x1', 'y1'}
    b, _, _ = render(saw_phaser(PKGS[1]), 12, position=12 * F, carry=carry)
    oracle = pull(saw_phaser(PKGS[1]), 24)
    assert np.abs(np.concatenate([a, b]) - oracle).max() < 1e-6
    # a render begun in the JAX package continues on the port
    ja, jcarry, _ = jax_render(saw_phaser(PKGS[0]), 12)
    assert np.asarray(jcarry[next(iter(jcarry))]['x1']).shape == (4, 1)
    b2, _, _ = render(saw_phaser(PKGS[1]), 12, position=12 * F,
                      carry=carry_from_jax(jcarry, 'cpu'))
    assert np.abs(np.concatenate([ja, b2]) - oracle).max() < 1e-6


def _band_power(x, bands=8):
    sp = np.abs(np.fft.rfft(x[2 * F:])) ** 2
    n = len(sp) // bands
    return np.array([sp[i * n:(i + 1) * n].sum() for i in range(bands)])


def test_phaser_pure_allpass_is_unit_gain():
    wet, _, _ = render(noise_phaser(PKGS[1], 1.0), 64)
    dry, _, _ = render(noise_phaser(PKGS[1], 0.0), 64)
    r = _band_power(wet.ravel()) / _band_power(dry.ravel())
    assert np.all(np.abs(r - 1.0) < 0.05), r
    want, _, _ = jax_render(noise_phaser(PKGS[0], 1.0), 64)
    assert np.abs(wet - want).max() < 1e-6


def test_phaser_half_mix_carves_deep_notches():
    half, _, _ = render(noise_phaser(PKGS[1], 0.5), 64)
    dry, _, _ = render(noise_phaser(PKGS[1], 0.0), 64)
    sp_h = np.abs(np.fft.rfft(half.ravel()[2 * F:])) ** 2
    sp_d = np.abs(np.fft.rfft(dry.ravel()[2 * F:])) ** 2
    k = 64
    ratio = (np.convolve(sp_h, np.ones(k) / k, 'same')
             / np.convolve(sp_d, np.ones(k) / k, 'same'))[k:-k]
    assert ratio.min() < 0.01, ratio.min()
    assert ratio.max() < 1.10, ratio.max()
    oracle = pull(noise_phaser(PKGS[1], 0.5), 64)
    assert np.abs(half - oracle).max() < 1e-6


def test_phaser_sweep_moves_the_notches():
    def swept(pkg):
        return noise_phaser(pkg, 0.5, sweep_node=swept_sweep(pkg))

    audio, _, _ = render(swept(PKGS[1]), 128)
    audio = audio.ravel()
    w = 16 * F
    specs = [np.abs(np.fft.rfft(audio[i * w:(i + 1) * w]))
             for i in range(3)]
    k = 32
    sm = [np.convolve(s ** 2, np.ones(k) / k, 'same') for s in specs]
    drift = max(np.abs(np.log10(sm[i] + 1e-12)
                       - np.log10(sm[0] + 1e-12)).max() for i in (1, 2))
    assert drift > 0.5, drift
    want, _, _ = jax_render(swept(PKGS[0]), 128)
    assert np.abs(audio - want.ravel()).max() < 1e-6
    oracle = pull(swept(PKGS[1]), 128).ravel()
    assert np.abs(audio - oracle).max() < 1e-6


def test_phaser_window_scan_matches_steps():
    """The whole-window scan (``mega_step``) against one ``step`` per
    block (the recurrence over one block each), stereo, from a carried
    state: the scan's association order costs no more than 1e-6."""
    def stereo(pkg):
        sh = mod(pkg, 'nodes.shape')
        m = sh.Merge()
        m.left = saw(pkg, 110.0)
        m.right = saw(pkg, 165.0)
        ph = mod(pkg, 'nodes.phaser').Phaser()
        ph.input = m
        ph.sweep = swept_sweep(pkg, 0.4, 700.0, 1000.0)
        return ph

    c = compile_node(stereo(PKGS[1]), block_frames=F, rate=RATE,
                     channels=2, device='cpu')
    a, carry = c.render(n_blocks=3)
    whole, carry_w = c.render(position=3 * F, n_blocks=16, carry=carry)
    params, parts, cs = c.params(), [], carry
    for i in range(16):
        blk, cs = c.step(params, cs, (3 + i) * F)
        parts.append(blk)
    steps = torch.cat(parts)
    assert float((whole - steps).abs().max()) < 1e-6
    for k in ('x1', 'y1'):
        uid = next(iter(carry_w))
        assert float((carry_w[uid][k] - cs[uid][k]).abs().max()) < 1e-6
    TC._compile_cache.clear()


# --- FracDelay ----------------------------------------------------------------


def flanger(pkg, d_sec):
    fx = mod(pkg, 'nodes.fx')
    s = saw(pkg, 110.0)
    fd = mod(pkg, 'nodes.moddelay').FracDelay()
    fd.get_state().max_delay = 0.01
    fd.input = s
    fd.delay = fixed(pkg, d_sec)
    mx = fx.Mix()
    mx.left = s
    mx.right = fd
    mx.mix = fixed(pkg, 0.5)
    return mx


def vibrato(pkg):
    osc = mod(pkg, 'nodes.osc').Sine()
    osc.hertz = fixed(pkg, 440.0)
    fd = mod(pkg, 'nodes.moddelay').FracDelay()
    fd.get_state().max_delay = 0.01
    fd.input = osc
    fd.delay = swept_sweep(pkg, 6.0, 0.0015, 0.002)
    return fd


def test_fracdelay_parity_all_paths():
    d = 0.0023
    fast, _, _ = render(flanger(PKGS[1], d), 24)
    slow, _, _ = render(flanger(PKGS[1], d), 24, mega=False)
    assert np.abs(fast - slow).max() < 1e-6
    oracle = pull(flanger(PKGS[1], d), 24)
    assert np.abs(fast - oracle).max() < 1e-6
    want, _, _ = jax_render(flanger(PKGS[0], d), 24)
    assert np.abs(fast - want).max() < 1e-6


def test_fracdelay_comb_notch_physics():
    audio, _, _ = render(flanger(PKGS[1], 1.0 / 440.0), 48)
    x = audio[4 * F:, 0]
    sp = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    freqs = np.fft.rfftfreq(len(x), 1 / RATE)

    def band(f0, bw=25.0):
        m = (freqs > f0 - bw) & (freqs < f0 + bw)
        return sp[m].max()

    assert band(440.0) > 10 * band(220.0), (band(440.0), band(220.0))


def test_fracdelay_vibrato_sidebands():
    audio, _, _ = render(vibrato(PKGS[1]), 64)
    oracle = pull(vibrato(PKGS[1]), 64)
    assert np.abs(audio - oracle).max() < 1e-6
    want, _, _ = jax_render(vibrato(PKGS[0]), 64)
    assert np.abs(audio - want).max() < 1e-6
    x = audio[2 * F:, 0]
    sp = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    freqs = np.fft.rfftfreq(len(x), 1 / RATE)
    center = sp[(freqs > 435) & (freqs < 445)].max()
    side = sp[((freqs > 445) & (freqs < 465))
              | ((freqs > 415) & (freqs < 435))].max()
    assert side > 0.5 * center, (side, center)


def test_fracdelay_far_into_the_timeline():
    """A mega window at a start ~6 minutes in (t up to n*F inside the
    window, frame indices past 2^24): the integer part is split off
    before the frame index is added, so the fraction is not quantized."""
    start = 32768
    audio, _, _ = render(vibrato(PKGS[1]), 16, position=start * F)
    oracle = pull(vibrato(PKGS[1]), 16, start_block=start)
    assert np.abs(audio - oracle).max() < 1e-6
    want, _, _ = jax_render(vibrato(PKGS[0]), 16, position=start * F)
    assert np.abs(audio - want).max() < 1e-6


def test_fracdelay_clamps_to_max():
    def over(pkg):
        osc = mod(pkg, 'nodes.osc').Sine()
        osc.hertz = fixed(pkg, 330.0)
        fd = mod(pkg, 'nodes.moddelay').FracDelay()
        fd.get_state().max_delay = 0.001
        fd.input = osc
        fd.delay = fixed(pkg, 0.5)
        return fd

    audio, _, _ = render(over(PKGS[1]), 8, mega=False)
    assert np.isfinite(audio).all()
    oracle = pull(over(PKGS[1]), 8)
    assert np.abs(audio - oracle).max() < 1e-6
    want, _, _ = jax_render(over(PKGS[0]), 8)
    assert np.abs(audio - want).max() < 1e-6


def test_fracdelay_stereo_spread():
    lag = 110

    def spread(pkg):
        dl = mod(pkg, 'nodes.shape').Merge()
        dl.left = fixed(pkg, 88.0 / RATE)
        dl.right = fixed(pkg, (88.0 + lag) / RATE)
        fd = mod(pkg, 'nodes.moddelay').FracDelay()
        fd.get_state().max_delay = 0.01
        fd.input = saw(pkg, 110.0)
        fd.delay = dl
        return fd

    audio, _, _ = render(spread(PKGS[1]), 24, channels=2)
    oracle = pull(spread(PKGS[1]), 24, channels=2)
    assert np.abs(audio - oracle).max() < 1e-6
    want, _, _ = jax_render(spread(PKGS[0]), 24, channels=2)
    assert np.abs(audio - want).max() < 1e-6
    lch, rch = audio[4 * F:, 0], audio[4 * F:, 1]
    assert np.abs(lch - rch).max() > 0.05
    assert np.abs(lch[:-lag] - rch[lag:]).max() < 1e-4


# --- Convolve -----------------------------------------------------------------


def convolve(pkg, input_node, **state):
    cv = mod(pkg, 'nodes.conv').Convolve()
    cv.input = input_node
    st = cv.get_state()
    for k, v in state.items():
        setattr(st, k, v)
    return cv


def both_engines(build, *, n_blocks=12, channels=1, start_block=0):
    """The port's compiled render and pull oracle of ``build('...torch')``
    and the JAX package's render of ``build('signals_tpu')``."""
    audio, _, _ = render(build(PKGS[1]), n_blocks, channels,
                         position=start_block * F)
    oracle = pull(build(PKGS[1]), n_blocks, channels, start_block)
    want, _, _ = jax_render(build(PKGS[0]), n_blocks, channels,
                            position=start_block * F)
    assert np.abs(audio - want).max() <= TOL
    return audio, oracle


def test_conv_parity_generated_ir():
    audio, oracle = both_engines(
        lambda p: convolve(p, saw(p), ir_frames=2000, mix=0.7))
    assert np.abs(audio - oracle).max() <= TOL


def test_conv_ground_truth_np_convolve():
    audio, oracle = both_engines(
        lambda p: convolve(p, saw(p), ir_frames=1500, mix=0.6, gain=1.25),
        n_blocks=10)
    dry = pull(saw(PKGS[1]), 10)[:, 0]
    ir = convolve(PKGS[1], saw(PKGS[1]), ir_frames=1500)._ir_for_channels(1)
    full = np.convolve(dry.astype(np.float64),
                       ir[:, 0].astype(np.float64))[:10 * F]
    want = 0.6 * 1.25 * full + 0.4 * dry
    assert np.abs(want - audio[:, 0]).max() <= TOL
    assert np.abs(want - oracle[:, 0]).max() <= TOL


def test_conv_ir_matches_jax_bit_for_bit():
    for kw in (dict(ir_frames=3000), dict(ir_frames=777, seed=5,
                                           decay_db=30.0, normalize=False)):
        irs = [convolve(p, saw(p), **kw)._ir() for p in PKGS]
        assert irs[0].dtype == irs[1].dtype == np.float32
        assert np.array_equal(irs[0], irs[1])


def test_conv_echo_ir_is_exact_delay():
    d = 700
    ir = np.zeros((d + 1, 1), dtype=np.float32)
    ir[0, 0] = 1.0
    ir[d, 0] = 0.5

    def build(p):
        cv = convolve(p, saw(p, 110.0), normalize=False)
        cv._ir_cache = (cv._ir_key(), ir)       # inject a known IR
        return cv

    audio, oracle = both_engines(build, n_blocks=8)
    dry = pull(saw(PKGS[1], 110.0), 8)[:, 0]
    want = dry.copy()
    want[d:] += 0.5 * dry[:-d]
    assert np.abs(audio[:, 0] - want).max() <= TOL
    assert np.abs(oracle[:, 0] - want).max() <= TOL


def test_conv_seek_matches_contiguous_render():
    full, _ = both_engines(lambda p: convolve(p, saw(p), ir_frames=1024),
                           n_blocks=16)
    tail, oracle = both_engines(
        lambda p: convolve(p, saw(p), ir_frames=1024), n_blocks=6,
        start_block=10)
    assert np.abs(full[10 * F:] - tail).max() <= TOL
    assert np.abs(tail - oracle).max() <= TOL


def _write_ir(path, data, channels):
    from signals_tpu_torch.runtime import sndfile
    w = sndfile.open_writer(str(path), rate=RATE, channels=channels)
    w.write(np.asarray(data, np.float32))
    w.close()


def test_conv_file_ir_wav(tmp_path):
    path = str(tmp_path / 'ir.wav')
    rng = np.random.default_rng(3)
    ir = (rng.standard_normal((900, 1)) *
          np.exp(-np.arange(900) / 200.0)[:, None]).astype(np.float32)
    _write_ir(path, ir, 1)
    cv = convolve(PKGS[1], saw(PKGS[1]), path=path, normalize=False)
    assert cv.context_frames() == 899
    audio, oracle = both_engines(
        lambda p: convolve(p, saw(p), path=path, normalize=False),
        n_blocks=8)
    assert np.abs(audio - oracle).max() <= TOL
    dry = pull(saw(PKGS[1]), 8)[:, 0]
    want = np.convolve(dry.astype(np.float64),
                       ir[:, 0].astype(np.float64))[:8 * F]
    assert np.abs(audio[:, 0] - want).max() <= TOL


def test_conv_stereo_bus_mono_ir_broadcasts():
    def stereo(p):
        right = mod(p, 'nodes.osc').Sine()
        right.hertz = fixed(p, 330.0)
        m = mod(p, 'nodes.shape').Merge()
        m.left = saw(p, 220.0)
        m.right = right
        return convolve(p, m, ir_frames=800)

    audio, oracle = both_engines(stereo, n_blocks=8, channels=2)
    assert audio.shape[1] == 2
    assert np.abs(audio - oracle).max() <= TOL
    mono, _ = both_engines(lambda p: convolve(p, saw(p, 220.0),
                                              ir_frames=800), n_blocks=8)
    assert np.abs(audio[:, :1] - mono).max() <= TOL


def test_conv_stereo_ir_downmixes_on_mono_bus(tmp_path):
    path = str(tmp_path / 'ir2.wav')
    rng = np.random.default_rng(5)
    ir = rng.standard_normal((400, 2)).astype(np.float32) * 0.1
    _write_ir(path, ir, 2)
    audio, oracle = both_engines(
        lambda p: convolve(p, saw(p), path=path, normalize=False),
        n_blocks=6)
    assert np.abs(audio - oracle).max() <= TOL
    dry = pull(saw(PKGS[1]), 6)[:, 0]
    mono_ir = ir.astype(np.float64).mean(axis=1)
    want = np.convolve(dry.astype(np.float64), mono_ir)[:6 * F]
    assert np.abs(audio[:, 0] - want).max() <= TOL


def test_conv_single_tap_ir_scales():
    cv = convolve(PKGS[1], saw(PKGS[1]), ir_frames=1, normalize=False)
    ir = cv._ir_for_channels(1)
    assert cv.context_frames() == 0
    audio, oracle = both_engines(
        lambda p: convolve(p, saw(p), ir_frames=1, normalize=False,
                           mix=1.0), n_blocks=4)
    dry = pull(saw(PKGS[1]), 4)
    assert np.abs(audio - dry * ir[0, 0]).max() <= TOL
    assert np.abs(oracle - dry * ir[0, 0]).max() <= TOL


def test_conv_normalize_unit_energy():
    ir = convolve(PKGS[1], saw(PKGS[1]), ir_frames=3000)._ir()
    assert abs(float(np.sum(ir.astype(np.float64) ** 2)) - 1.0) < 1e-5


def test_conv_traced_mix_edit_no_recompile():
    cv = convolve(PKGS[1], saw(PKGS[1]), ir_frames=600, mix=1.0)
    compiled = compile_node(cv, block_frames=F, rate=RATE, channels=1,
                            device='cpu')
    h = compiled.graph_hash
    wet, _ = compiled.render(position=0, n_blocks=4)
    cv.get_state().mix = 0.0
    assert compile_node(cv, block_frames=F, rate=RATE, channels=1,
                        device='cpu') is compiled
    assert compiled.graph_hash == h
    dry, _ = compiled.render(position=0, n_blocks=4)
    truth = pull(saw(PKGS[1]), 4)
    assert np.abs(dry.numpy() - truth).max() <= TOL
    assert np.abs(wet.numpy() - truth).max() > 1e-2
    TC._compile_cache.clear()


def test_conv_long_ir_whole_window():
    audio, oracle = both_engines(
        lambda p: convolve(p, saw(p), ir_frames=8192), n_blocks=48)
    assert np.abs(audio - oracle).max() <= TOL
    _, _, c = render(convolve(PKGS[1], saw(PKGS[1]), ir_frames=8192), 2)
    assert c.plan(48) == 'mega'


@pytest.mark.parametrize('patch', ['mono_static_voice', 'short_ir'])
def test_narrow_carry_free_patch_matches_jax(patch):
    """Fault C1, closed as matching the reference: the JAX package sends a
    narrow carry-free patch down its per-block vmap (its ``_use_mega``
    width gate; it has no ``plan()``), the port down its whole-window plan.
    The audio agrees within 1e-5 (F = 1024, the product block size)."""
    frames = 1024

    def build(p):
        if patch == 'short_ir':                  # context 4095 < 4 * F
            return convolve(p, saw(p), ir_frames=4096)
        fx = mod(p, 'nodes.fx')
        lp = fx.LowPass()
        lp.input = saw(p, 110.0)
        lp.cutoff = fixed(p, 2000.0)
        lp.get_state().context = 128
        g = fx.Gain()
        g.left = lp
        g.right = fixed(p, 0.5)
        return g

    audio, _, c = render(build(PKGS[1]), 12, frames=frames)
    assert c.plan(12) == 'mega'
    want, _, jc = jax_render(build(PKGS[0]), 12, frames=frames)
    assert not jc._use_mega
    assert np.abs(audio - want).max() <= TOL
    assert np.abs(audio - pull(build(PKGS[1]), 12, frames=frames)).max() \
        <= TOL


def test_conv_empty_ir_file_raises(tmp_path):
    from signals_tpu_torch.runtime import sndfile
    path = str(tmp_path / 'empty.wav')
    sndfile.open_writer(path, rate=RATE, channels=1).close()
    cv = convolve(PKGS[1], saw(PKGS[1]), path=path)
    with pytest.raises(ValueError):
        cv.context_frames()


def test_conv_ir_file_edit_recompiles(tmp_path):
    path = tmp_path / 'ir.wav'
    _write_ir(path, [[1.0], [0.5]], 1)
    cv = convolve(PKGS[1], saw(PKGS[1]), path=str(path))
    c1 = compile_node(cv, block_frames=F, rate=RATE, channels=1,
                      device='cpu')
    a1, _ = c1.render(n_blocks=2)
    _write_ir(path, [[1.0], [0.0], [0.0], [0.25]], 1)
    os.utime(path, ns=(1, int(os.stat(path).st_mtime_ns) + 10**9))
    c2 = compile_node(cv, block_frames=F, rate=RATE, channels=1,
                      device='cpu')
    assert c2.graph_hash != c1.graph_hash
    assert c2 is not c1
    a2, _ = c2.render(n_blocks=2)
    assert np.abs(a2.numpy() - pull(cv, 2)).max() <= TOL
    assert float((a1 - a2).abs().max()) > 1e-3
    TC._compile_cache.clear()


def test_conv_mix_rejects_over_wet():
    from signals_tpu_torch.core.state import BadStateValue
    cv = convolve(PKGS[1], saw(PKGS[1]))
    with pytest.raises(BadStateValue):
        cv.get_state().mix = 1.5


# --- shape ----------------------------------------------------------------------


def _three(pkg):
    m = mod(pkg, 'nodes.shape').Merge()
    m.left = saw(pkg, 110.0)
    inner = mod(pkg, 'nodes.shape').Merge()
    inner.left = saw(pkg, 220.0)
    inner.right = fixed(pkg, 0.25)            # a constant merges too
    m.right = inner
    return m


@pytest.mark.parametrize('name', ['Flatten', 'FlattenUnit', 'Select',
                                  'Select_out_of_range', 'Merge',
                                  'Merge_one_side'])
def test_shape_nodes_match_jax(name):
    def build(p):
        sh = mod(p, 'nodes.shape')
        if name == 'Merge':
            return _three(p)
        if name == 'Merge_one_side':
            m = sh.Merge()
            m.right = saw(p, 330.0)
            return m
        node = getattr(sh, name.split('_')[0])()
        if name.startswith('Select'):
            node.get_state().index = 1 if name == 'Select' else 5
        node.input = _three(p)
        return node

    ch = build(PKGS[1]).channels
    assert ch == build(PKGS[0]).channels
    audio, _, _ = render(build(PKGS[1]), 6, ch)
    want, _, _ = jax_render(build(PKGS[0]), 6, ch)
    # a mean divides a sum whose order the libraries choose: one ulp
    tol = 1e-7 if name == 'FlattenUnit' else 0.0
    assert np.abs(audio - want).max() <= tol
    assert np.array_equal(pull(build(PKGS[1]), 6, ch),
                          pull(build(PKGS[0]), 6, ch, pkg=PKGS[0]))


def test_shape_qualnames_resolve():
    from signals_tpu_torch.nodes import shape
    from signals_tpu_torch.registry import load_signal
    for name in ('Flatten', 'FlattenUnit', 'Select', 'Merge'):
        cls = getattr(shape, name)
        assert load_signal(f'signals.chain.shape.{name}') is cls
        assert load_signal(f'signals_tpu.nodes.shape.{name}') is cls


def test_modfx_qualnames_resolve():
    from signals_tpu_torch.registry import load_signal
    for modname, name in (('moddelay', 'FracDelay'), ('phaser', 'Phaser'),
                          ('conv', 'Convolve'), ('seq', 'GateSeq'),
                          ('seq', 'PitchSeq')):
        cls = getattr(mod(PKGS[1], f'nodes.{modname}'), name)
        assert load_signal(f'signals_tpu.nodes.{modname}.{name}') is cls
        assert load_signal(f'signals_tpu_torch.nodes.{modname}.{name}') is cls
