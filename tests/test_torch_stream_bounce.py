"""The port's encoded entry points (``CompiledPatch.render_encoded`` /
``render_encoded_stream``) against its own ``render`` and the JAX package.

Mirrors the first three tests of ``tests/test_stream_bounce.py`` (the
fourth drives ``map.control``'s ``bounce`` command, which the port has not
got yet) on the CPU, and adds:

* every subtype's payload byte-identical to the numpy encoder of the
  port's ``render`` from the same position — from block 0, and from block
  3 and 13, off the swept filter's 8-block carry-segment grid (fault C3:
  the JAX entry points never check ``position``);
* a start inside a block refused by both entry points, the stream at the
  call;
* the stream's batches rounded up to the carry-segment grid, each batch
  byte-identical to the numpy encoding of its own audio;
* the port's ``'pcm16'`` payload within 1 LSB of the JAX package's on the
  same patch, the port rendering the JAX package's parameters.
"""

import importlib

import numpy as np
import pytest

from signals_tpu_torch.runtime import codecs

BLOCK, RATE = 1024, 44100
JAX, PORT = 'signals_tpu', 'signals_tpu_torch'


def mod(pkg, name):
    return importlib.import_module(f'{pkg}.{name}')


def fixed(pkg, value):
    f = mod(pkg, 'nodes.fixed').Fixed()
    f.get_state().value = np.array([[value]], dtype=np.float32)
    return f


def saw_patch(pkg):
    """``tests/test_stream_bounce.py``'s patch: a 220 Hz saw at gain 0.7."""
    fx, osc = mod(pkg, 'nodes.fx'), mod(pkg, 'nodes.osc')
    saw = osc.Sawtooth()
    saw.hertz = fixed(pkg, 220.0)
    g = fx.Gain()
    g.left = saw
    g.right = fixed(pkg, 0.7)
    return g


def swept_patch(pkg):
    """A saw through a LowPass swept by a 0.5 Hz LFO (8-block carry
    segments) at gain 0.5."""
    fx, osc = mod(pkg, 'nodes.fx'), mod(pkg, 'nodes.osc')
    saw = osc.Sawtooth()
    saw.hertz = fixed(pkg, 110.0)
    lfo = osc.Sine()
    lfo.hertz = fixed(pkg, 0.5)
    depth = fx.Gain()
    depth.left = lfo
    depth.right = fixed(pkg, 600.0)
    cut = fx.Mix()
    cut.left = depth
    cut.right = fixed(pkg, 2 * 1500.0)
    cut.mix = fixed(pkg, 0.5)
    lp = fx.LowPass()
    lp.input = saw
    lp.cutoff = cut
    g = fx.Gain()
    g.left = lp
    g.right = fixed(pkg, 0.5)
    return g


def compile_(pkg, root, channels=1):
    kw = {'device': 'cpu'} if pkg == PORT else {}
    return mod(pkg, 'compiler').compile_node(
        root, block_frames=BLOCK, rate=RATE, channels=channels, **kw)


def encode_np(audio, subtype):
    a = np.asarray(audio, dtype=np.float32)
    if subtype == 'pcm16':
        return np.clip(np.round(a * np.float32(32767.0)), -32768,
                       32767).astype(np.int16)
    if subtype == 'mulaw':
        return codecs.mulaw_encode(np, a)
    if subtype == 'alaw':
        return codecs.alaw_encode(np, a)
    if subtype == 'adpcm':
        return codecs.ima_encode_np(a)[0]
    return codecs.slac2_encode_np(a)[0]


def test_stream_slac_bit_exact_and_v3_container(tmp_path):
    from signals_tpu_torch.runtime.sndfile import SlacReader, SlacWriter
    c = compile_(PORT, saw_patch(PORT))
    n_blocks, batch = 10, 4
    path = tmp_path / 'stream.slac'
    w = SlacWriter(path, rate=RATE, channels=1)
    total = n_segs = 0
    for payload, frames in c.render_encoded_stream(
            n_blocks=n_blocks, batch_blocks=batch, subtype='slac'):
        w.write_encoded(payload, frames)
        total += frames
        n_segs += 1
    w.close()
    assert total == n_blocks * BLOCK
    assert n_segs == 3                     # 4 + 4 + 2 blocks
    audio, _ = c.render(n_blocks=n_blocks, deliver_taps=False)
    pcm = np.clip(np.round(audio[:, 0].numpy() * 32767.0), -32768, 32767)
    r = SlacReader(path)
    got = np.round(r.read(0, total)[:, 0] * 32767.0)
    assert r.frames == total
    assert np.array_equal(got, pcm)


def test_stream_matches_single_shot_mulaw():
    c = compile_(PORT, saw_patch(PORT))
    one, frames, _ = c.render_encoded(n_blocks=9, subtype='mulaw')
    stream = np.concatenate(
        [p for p, _ in c.render_encoded_stream(
            n_blocks=9, batch_blocks=4, subtype='mulaw')])
    assert frames == 9 * BLOCK
    assert stream.shape == one.shape
    assert np.array_equal(stream, one)


def test_stream_cap_overshoot_path(monkeypatch):
    """A cap below the live payload length: the remainder copy still
    returns the exact bytes."""
    from signals_tpu_torch.compiler import CompiledPatch
    c = compile_(PORT, saw_patch(PORT))
    one, _, _ = c.render_encoded(n_blocks=4, subtype='slac')
    monkeypatch.setattr(CompiledPatch, 'STREAM_CAP_GUESS', 0.05)
    monkeypatch.setattr(CompiledPatch, 'STREAM_CAP_STEP', 256)
    (p0, f0), = list(c.render_encoded_stream(n_blocks=4, batch_blocks=4,
                                             subtype='slac'))
    assert p0.shape[0] > 0.05 * 4 * BLOCK      # the cap really was short
    assert f0 == 4 * BLOCK
    assert np.array_equal(p0, one)


@pytest.mark.parametrize('start', [0, 3, 13])
@pytest.mark.parametrize('subtype', list(codecs.DEVICE_SUBTYPES))
def test_render_encoded_from_any_block(subtype, start):
    """Fault C3: the payload from any block equals the numpy encoding of
    ``render`` from that block, on and off the carry-segment grid."""
    c = compile_(PORT, swept_patch(PORT), channels=2)
    assert c.carry_seg_align == 8
    audio, _ = c.render(position=start * BLOCK, n_blocks=6)
    payload, frames, _ = c.render_encoded(position=start * BLOCK,
                                          n_blocks=6, subtype=subtype)
    want = encode_np(audio.numpy(), subtype)
    assert frames == 6 * BLOCK
    assert payload.dtype == want.dtype
    assert np.array_equal(payload, want)


def test_encoded_entry_points_check_position():
    c = compile_(PORT, swept_patch(PORT))
    with pytest.raises(ValueError, match='multiple of the block'):
        c.render_encoded(position=100, n_blocks=2)
    with pytest.raises(ValueError, match='multiple of the block'):
        c.render_encoded_stream(position=100, n_blocks=2, batch_blocks=1)
    with pytest.raises(ValueError, match='unsupported'):
        c.render_encoded(n_blocks=1, subtype='flac')


@pytest.mark.parametrize('subtype', ['pcm16', 'adpcm', 'slac'])
def test_stream_batches_round_to_the_grid(subtype):
    """Batches of 3 blocks round up to the 8-block grid; from block 5 the
    stream renders 8 + 8 + 4 blocks, each payload the numpy encoding of
    its own audio (fresh codec state a batch)."""
    c = compile_(PORT, swept_patch(PORT))
    audio, _ = c.render(position=5 * BLOCK, n_blocks=20)
    a = audio.numpy()
    at = 0
    sizes = []
    for payload, frames in c.render_encoded_stream(
            position=5 * BLOCK, n_blocks=20, batch_blocks=3,
            subtype=subtype):
        assert np.array_equal(payload, encode_np(a[at:at + frames],
                                                 subtype))
        at += frames
        sizes.append(frames // BLOCK)
    assert sizes == [8, 8, 4]


def test_pcm16_payload_matches_jax_render_encoded():
    """The port's ``'pcm16'`` payload within 1 LSB of the JAX package's
    ``render_encoded('pcm16')`` on the same patch, the port rendering the
    JAX package's parameters (the renders agree within 1e-5)."""
    from signals_tpu_torch.interop import params_from_jax
    jc = compile_(JAX, swept_patch(JAX))
    pc = compile_(PORT, swept_patch(PORT))
    want, _, _ = jc.render_encoded(n_blocks=16, subtype='pcm16')
    params = params_from_jax(jc.params(), 'cpu')
    payload, carry, taps = pc._encoded_fn(16, 'pcm16')(params, pc.carry0, 0)
    got = payload.numpy()
    assert got.dtype == np.int16 and got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1
    assert np.array_equal(pc.render_encoded(n_blocks=16,
                                            subtype='pcm16')[0], got)
