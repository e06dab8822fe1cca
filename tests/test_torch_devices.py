"""The port's output path on the CPU: the device rack and sinks
(``nodes/dev.py``), the native ring and paced consumer (``runtime/ring.py``
over the port's own copy of ``ring.cc``), PortAudio through a fake
``sounddevice`` (``runtime/portaudio.py``), and live edits through the
``Transport``'s background swap.

Mirrors ``tests/test_devices.py`` (the sink's offline render within 1e-5 of
the JAX package's ``SinkDevice`` on the same patch built in both packages;
``pull_block`` against the reference callback), ``tests/test_runtime.py``
(ring round trip, backpressure, wraparound; the paced consumer; the
``pcm16`` fd stream; a streaming sink), ``tests/test_hardware_audio.py``
(through its fake) and ``tests/test_live_edit.py``, each on the port's
sink with ``device='cpu'``.  The realtime run through the ring at full
width is ``chip_smoke.py`` phase 10 (c).
"""

import importlib
import os
import sys
import threading
import time

import numpy as np
import pytest

from signals_tpu_torch.compiler import compile_node
from signals_tpu_torch.nodes.dev import (
    BadDeviceName,
    BadPlaybackState,
    DeviceInfo,
    NotASink,
    NotASource,
    Rack,
    SinkDevice,
    SourceDevice,
)
from signals_tpu_torch.nodes.fx import Gain
from signals_tpu_torch.nodes.osc import Sine, Square
from signals_tpu_torch.runtime import ring as ring_mod
from signals_tpu_torch.runtime.portaudio import HardwareCapture, HardwareOutput
from signals_tpu_torch.runtime.ring import (PacedConsumer, RingBuffer,
                                            native_available)

import torch_refs
from test_hardware_audio import make_fake_sd

RATE = 44100
JAX, PORT = 'signals_tpu', 'signals_tpu_torch'


def fixed(value, pkg=PORT):
    f = importlib.import_module(f'{pkg}.nodes.fixed').Fixed()
    f.get_state().value = np.array([[value]], dtype=np.float32)
    return f


def sine(hz=440.0, pkg=PORT):
    osc = importlib.import_module(f'{pkg}.nodes.osc').Sine()
    osc.hertz = fixed(hz, pkg)
    return osc


def port_sink(name='default', **kw):
    rack = Rack()
    rack.scan()
    kw.setdefault('device', 'cpu')
    return SinkDevice(rack.get_sink(name), **kw)


@pytest.fixture
def rack():
    r = Rack()
    r.scan()
    return r


# --- the rack and the sink (tests/test_devices.py) --------------------------


def test_rack_virtual_devices(rack):
    names = [d.name for d in rack.devices]
    assert names == ['default', 'null', 'capture']
    assert rack.get_sink('default').is_sink
    assert rack.get_sink('null').max_output_channels == 64
    assert rack.get_source('capture').is_source
    with pytest.raises(BadDeviceName):
        rack.get_device('nope')
    with pytest.raises(NotASource):
        rack.get_source('default')
    with pytest.raises(NotASink):
        rack.get_sink('capture')
    assert [d.name for d in rack.sinks()] == ['default', 'null']
    assert [d.name for d in rack.sources()] == ['capture']


def test_sink_offline_render_matches_jax():
    """The port's ``SinkDevice.render_offline`` within 1e-5 of the JAX
    package's on the same patch, the mono source on both channels."""
    jdev = importlib.import_module('signals_tpu.nodes.dev')
    jrack = jdev.Rack()
    jrack.scan()
    jsink = jdev.SinkDevice(jrack.get_sink('default'), block_frames=256,
                            realtime=False)
    jsink.get_state().channels = 2
    jsink.input = sine(pkg=JAX)
    want = np.asarray(jsink.render_offline(n_blocks=4))
    sink = port_sink(block_frames=256, realtime=False)
    sink.get_state().channels = 2
    sink.input = sine()
    audio = sink.render_offline(n_blocks=4)
    assert audio.shape == (1024, 2) and audio.device.type == 'cpu'
    got = audio.numpy()
    np.testing.assert_array_equal(got[:, 0], got[:, 1])
    assert np.abs(got - want).max() <= 1e-5
    seconds = sink.render_offline(seconds=256 * 3 / RATE)
    assert seconds.shape == (768, 2)


def test_sink_offline_render_from_a_block():
    sink = port_sink(block_frames=256, realtime=False)
    sink.get_state().channels = 1
    sink.input = sine()
    whole = sink.render_offline(n_blocks=6).numpy()
    tail = sink.render_offline(n_blocks=3, position=3 * 256).numpy()
    assert np.abs(tail - whole[768:]).max() <= 1e-6


def test_sink_pull_block_matches_reference_callback():
    sink = port_sink(block_frames=256, realtime=False)
    sink.get_state().channels = 1
    sink.input = sine()
    compiled_audio = sink.render_offline(n_blocks=2).numpy()
    sink.frame_position = 0
    pulled = np.concatenate([sink.pull_block(), sink.pull_block()])
    assert sink.frame_position == 512
    assert np.abs(compiled_audio - pulled).max() <= 1e-5


def test_sink_states_and_channel_limit():
    sink = port_sink(block_frames=256, realtime=False)
    with pytest.raises(BadPlaybackState, match='no input'):
        sink.render_offline(n_blocks=1)
    with pytest.raises(BadPlaybackState):
        sink.stop()
    with pytest.raises(BadPlaybackState):
        sink.close()
    from signals_tpu_torch.core.state import BadStateValue
    st = sink.get_state()
    st.channels = 3                     # 'default' is stereo
    with pytest.raises(BadStateValue):
        sink.set_state(st)
    sink.seek(5)
    assert sink.tell() == 5 and sink.frame_position == 5 * 256


def test_source_device_feeds_compiled_patch(rack):
    src = SourceDevice(rack.get_source('capture'), device='cpu')
    g = Gain()
    g.left = src
    g.right = fixed(2.0)
    compiled = compile_node(g, block_frames=64, rate=RATE, channels=2,
                            device='cpu')
    audio, _ = compiled.render(n_blocks=2)
    assert compiled.plan(2) == 'stateless'       # carry-free, host-fed
    np.testing.assert_array_equal(audio.numpy(), 0)   # virtual: silence
    np.testing.assert_array_equal(src.render_offline(n_blocks=2).numpy(), 0)


def test_sink_encoded_offline_entry_points():
    """``render_offline_encoded`` and ``render_offline_encoded_stream``
    give the numpy encodings of ``render_offline``'s audio."""
    from signals_tpu_torch.runtime import codecs
    sink = port_sink(block_frames=256, realtime=False)
    sink.get_state().channels = 2
    sink.input = sine(330.0)
    audio = sink.render_offline(n_blocks=6, position=256).numpy()
    payload, frames = sink.render_offline_encoded(n_blocks=6, position=256,
                                                  subtype='mulaw')
    assert frames == 6 * 256
    assert np.array_equal(payload, codecs.mulaw_encode(np, audio))
    parts = list(sink.render_offline_encoded_stream(
        n_blocks=6, position=256, subtype='pcm16',
        batch_seconds=4 * 256 / RATE))
    assert [f for _, f in parts] == [1024, 512]
    pcm = np.clip(np.round(audio * np.float32(32767.0)), -32768,
                  32767).astype(np.int16)
    assert np.array_equal(np.concatenate([p for p, _ in parts]), pcm)


# --- the ring (tests/test_runtime.py) ---------------------------------------


def test_native_library_builds_from_the_ports_copy():
    assert native_available()
    path = ring_mod.build()
    assert path.parent == ring_mod.BUILD_DIR
    assert path.name.startswith('libsigring_')
    assert 'signals_tpu/runtime/native' not in str(path)


def test_failed_build_raises_with_the_compilers_output(tmp_path,
                                                       monkeypatch):
    script = tmp_path / 'cxx'
    script.write_text('#!/bin/sh\necho "no compiler here" >&2\nexit 3\n')
    script.chmod(0o755)
    monkeypatch.setenv('CXX', str(script))
    monkeypatch.setattr(ring_mod, 'BUILD_DIR', tmp_path / 'build')
    with pytest.raises(ring_mod.RingCompileError, match='no compiler here'):
        ring_mod.build()


def test_ring_roundtrip():
    ring = RingBuffer(capacity_frames=16, channels=2)
    data = np.arange(12, dtype=np.float32).reshape(6, 2)
    assert ring.write(data) == 6
    assert ring.readable == 6
    np.testing.assert_array_equal(ring.read(4), data[:4])
    assert ring.readable == 2
    np.testing.assert_array_equal(ring.read(10), data[4:])   # short read
    with pytest.raises(ValueError):
        ring.write(np.zeros((4, 3), np.float32))
    ring.close()


def test_ring_backpressure():
    ring = RingBuffer(capacity_frames=8, channels=1)
    data = np.ones((6, 1), dtype=np.float32)
    assert ring.write(data) == 6
    assert ring.write(data) == 2          # only 2 slots left
    assert ring.writable == 0
    _ = ring.read(5)
    assert ring.writable == 5
    ring.close()


def test_ring_wraparound_preserves_order():
    ring = RingBuffer(capacity_frames=8, channels=1)
    assert ring.capacity == 8
    out = []
    seq = np.arange(100, dtype=np.float32).reshape(-1, 1)
    i = 0
    while i < len(seq) or sum(len(b) for b in out) < len(seq):
        if i < len(seq):
            i += ring.write(seq[i:i + 5])
        got = ring.read(3)
        if len(got):
            out.append(got)
    np.testing.assert_array_equal(np.concatenate(out), seq)
    ring.close()


def test_paced_consumer_rate():
    rate, block = 48000, 256
    ring = RingBuffer(capacity_frames=block * 64, channels=1)
    consumer = PacedConsumer(ring, rate=rate, block_frames=block)
    ring.write(np.ones((rate // 2, 1), dtype=np.float32))
    time.sleep(0.5)
    frames = consumer.frames
    consumer.stop()
    assert rate * 0.3 < frames < rate * 0.8, frames
    assert consumer.underruns <= frames // block
    assert consumer.frames >= frames        # counters survive stop
    ring.close()


def test_paced_consumer_underruns_when_starved():
    ring = RingBuffer(capacity_frames=1024, channels=1)
    consumer = PacedConsumer(ring, rate=RATE, block_frames=256)
    time.sleep(0.1)
    consumer.stop()
    assert consumer.underruns > 0
    ring.close()


def test_native_consumer_pcm16_fd_stream(tmp_path):
    path = tmp_path / 'stream.raw'
    fd = os.open(path, os.O_WRONLY | os.O_CREAT, 0o644)
    ring = RingBuffer(capacity_frames=4096, channels=1)
    block = np.linspace(-1.2, 1.2, 256, dtype=np.float32).reshape(-1, 1)
    ring.write(block)
    consumer = PacedConsumer(ring, rate=RATE, block_frames=256, fd=fd,
                             fmt='pcm16')
    deadline = time.time() + 5
    while consumer.frames < 256 and time.time() < deadline:
        time.sleep(0.01)
    consumer.stop()
    os.close(fd)
    ring.close()
    raw = np.fromfile(path, dtype='<i2')
    assert raw.shape[0] >= 256
    expect = np.clip(np.rint(block[:, 0] * 32767.0), -32768, 32767)
    np.testing.assert_array_equal(raw[:256], expect.astype(np.int16))


def test_streaming_sink_with_ring(tmp_path):
    """compiled render -> ring -> clocked consumer -> raw f32 file."""
    out_path = tmp_path / 'stream.f32'
    with open(out_path, 'wb') as fd_file:
        sink = port_sink(block_frames=512, realtime=True,
                         output_fd=fd_file.fileno())
        sink.get_state().channels = 1
        sink.input = sine()
        sink.start()
        assert isinstance(sink._consumer, PacedConsumer)
        time.sleep(0.6)
        sink.stop()
        sink.close()
    raw = np.frombuffer(out_path.read_bytes(), dtype='<f4')
    assert len(raw) >= RATE // 4
    mid = raw[1024:1024 + 8192]
    spec = np.abs(np.fft.rfft(mid))
    freq = np.fft.rfftfreq(len(mid), 1 / RATE)[spec.argmax()]
    assert abs(freq - 440.0) < 15.0, freq


def test_realtime_sink_pcm16_pipe_equals_the_captured_blocks():
    """Through a pipe: the consumer's PCM16 stream is the sink's captured
    blocks at 32767 full scale, with any underrun zero-filled; the
    captured audio is the offline render."""
    r, w = os.pipe()
    chunks = []
    reader = threading.Thread(
        target=lambda: chunks.extend(iter(lambda: os.read(r, 1 << 16), b'')))
    reader.start()
    sink = port_sink(block_frames=512, realtime=True, output_fd=w,
                     output_format='pcm16')
    sink.get_state().channels = 2
    sink.input = sine(550.0)
    sink.capture(True)
    sink.start()
    time.sleep(0.5)
    sink.stop()
    sink.close()
    os.close(w)
    reader.join(timeout=10)
    os.close(r)
    assert not reader.is_alive()
    raw = np.frombuffer(b''.join(chunks), dtype='<i2').reshape(-1, 2)
    cap = sink.captured()
    want = np.clip(np.rint(cap * np.float32(32767.0)), -32768,
                   32767).astype(np.int16)
    assert raw.shape[0] % 512 == 0 and raw.shape[0] > 0
    at, _ = torch_refs.match_stream(raw, want, 512)
    assert at > 0
    offline = sink.render_offline(n_blocks=cap.shape[0] // 512).numpy()
    assert np.abs(offline - cap).max() <= 1e-5


# --- PortAudio through a fake (tests/test_hardware_audio.py) -----------------


@pytest.fixture
def fake_sd(monkeypatch):
    sd = make_fake_sd(paced=False)
    monkeypatch.setitem(sys.modules, 'sounddevice', sd)
    return sd


@pytest.fixture
def fake_sd_paced(monkeypatch):
    sd = make_fake_sd(paced=True)
    monkeypatch.setitem(sys.modules, 'sounddevice', sd)
    return sd


def test_rack_lists_hardware_devices(fake_sd):
    rack = Rack()
    rack.scan()
    spk = rack.get_sink('Fake Speakers')
    assert spk.backend == 'portaudio' and spk.sd_index == 0
    assert spk.max_output_channels == 2
    mic = rack.get_source('Fake Mic')
    assert mic.backend == 'portaudio' and mic.sd_index == 1


def test_output_callback_drains_ring(fake_sd):
    ring = RingBuffer(capacity_frames=1024, channels=1)
    out = HardwareOutput(ring, rate=RATE, channels=1, block_frames=256,
                         sd_module=fake_sd)
    stream = fake_sd._streams[0]
    data = np.arange(256, dtype=np.float32).reshape(-1, 1)
    ring.write(data)
    assert stream.step()
    np.testing.assert_array_equal(stream.received[0], data)
    assert out.underruns == 0
    assert stream.step()                 # empty ring: zero-filled, counted
    assert float(np.abs(stream.received[1]).max()) == 0.0
    assert out.underruns == 1
    assert out.frames == 512
    out.stop()
    ring.close()


def test_output_callback_stops_cleanly_after_stop(fake_sd):
    ring = RingBuffer(capacity_frames=1024, channels=2)
    out = HardwareOutput(ring, rate=RATE, channels=2, block_frames=128,
                         sd_module=fake_sd)
    stream = fake_sd._streams[0]
    out.stop()
    assert not stream.step()             # a late callback stops the stream
    ring.close()


def test_capture_read_positions(fake_sd):
    cap = HardwareCapture(rate=RATE, channels=1, block_frames=256,
                          sd_module=fake_sd, timeout=0.1)
    stream = fake_sd._streams[0]
    for _ in range(4):
        stream.step()                    # frames [0, 1024) as a ramp
    np.testing.assert_array_equal(cap.read(100, 50)[:, 0],
                                  np.arange(100, 150, dtype=np.float32))
    got = cap.read(-30, 40)
    assert float(np.abs(got[:30]).max()) == 0.0
    np.testing.assert_array_equal(got[30:, 0],
                                  np.arange(0, 10, dtype=np.float32))
    got = cap.read(1000, 100)
    np.testing.assert_array_equal(got[:24, 0],
                                  np.arange(1000, 1024, dtype=np.float32))
    assert float(np.abs(got[24:]).max()) == 0.0
    cap.stop()


def test_capture_read_blocks_until_captured(fake_sd):
    cap = HardwareCapture(rate=RATE, channels=1, block_frames=256,
                          sd_module=fake_sd, timeout=2.0)
    stream = fake_sd._streams[0]

    def feed():
        time.sleep(0.05)
        for _ in range(2):
            stream.step()

    t = threading.Thread(target=feed)
    t.start()
    got = cap.read(0, 512)
    t.join(timeout=5)
    assert not t.is_alive()
    np.testing.assert_array_equal(got[:, 0], np.arange(512, dtype=np.float32))
    cap.stop()


def test_source_device_serves_captured_audio(fake_sd):
    info = DeviceInfo(name='Fake Mic', index=3, max_input_channels=1,
                      backend='portaudio', sd_index=1)
    src = SourceDevice(info, device='cpu')
    assert not src.is_capturing
    assert float(np.abs(src.host_read(0, 64, RATE)).max()) == 0.0
    src.start_capture(block_frames=256, sd_module=fake_sd)
    assert src.is_capturing
    fake_sd._streams[0].step()
    np.testing.assert_array_equal(src.host_read(10, 20, RATE)[:, 0],
                                  np.arange(10, 30, dtype=np.float32))
    with pytest.raises(BadPlaybackState, match='already open'):
        src.start_capture(sd_module=fake_sd)
    src.stop_capture()
    assert not src.is_capturing


def test_captured_audio_flows_through_compiled_patch(fake_sd):
    info = DeviceInfo(name='Fake Mic', index=3, max_input_channels=1,
                      backend='portaudio', sd_index=1)
    src = SourceDevice(info, device='cpu')
    g = Gain()
    g.left = src
    g.right = fixed(2.0)
    src.start_capture(block_frames=128, sd_module=fake_sd)
    stream = fake_sd._streams[0]
    for _ in range(8):
        stream.step()                    # frames [0, 1024)
    compiled = compile_node(g, block_frames=128, rate=RATE, channels=1,
                            device='cpu')
    audio, _ = compiled.render(position=0, n_blocks=4)
    np.testing.assert_allclose(audio[:, 0].numpy(),
                               2.0 * np.arange(512, dtype=np.float32),
                               rtol=1e-6)
    np.testing.assert_array_equal(
        src.render_offline(n_blocks=2, position=128, block_frames=128)
        .numpy()[:, 0], np.arange(128, 384, dtype=np.float32))
    src.stop_capture()


def test_sink_plays_through_hardware_output(fake_sd_paced):
    rack = Rack()
    rack.scan()
    sink = SinkDevice(rack.get_sink('Fake Speakers'), block_frames=256,
                      ring_blocks=8, device='cpu')
    sink.get_state().channels = 2
    sink.input = sine()
    sink.start()
    try:
        assert isinstance(sink._consumer, HardwareOutput)
        deadline = time.monotonic() + 10.0
        stream = fake_sd_paced._streams[0]
        while time.monotonic() < deadline:
            if any(float(np.abs(b).max()) > 0.1 for b in stream.received):
                break
            time.sleep(0.05)
        else:
            pytest.fail('no audible output reached the hardware callback')
    finally:
        sink.stop()
        sink.close()
    assert sink.underruns == 0           # the consumer is gone after stop


def test_sink_uses_paced_consumer_for_virtual(fake_sd_paced):
    sink = port_sink(block_frames=256)
    sink.get_state().channels = 1
    sink.input = sine()
    sink.start()
    try:
        assert isinstance(sink._consumer, PacedConsumer)
    finally:
        sink.stop()
        sink.close()


def test_capture_rate_mismatch_raises(fake_sd):
    info = DeviceInfo(name='Fake Mic', index=3, max_input_channels=1,
                      default_samplerate=48000.0, backend='portaudio',
                      sd_index=1)
    src = SourceDevice(info, device='cpu')
    src.start_capture(block_frames=256, sd_module=fake_sd)
    with pytest.raises(BadPlaybackState, match='48000'):
        src.host_read(0, 64, RATE)
    src.stop_capture()


# --- live edits (tests/test_live_edit.py) -----------------------------------


def _dominant_freq(x, rate=RATE):
    spec = np.abs(np.fft.rfft(x))
    return np.fft.rfftfreq(len(x), 1 / rate)[spec.argmax()]


def _wait(cond, seconds):
    deadline = time.time() + seconds
    while time.time() < deadline and not cond():
        time.sleep(0.02)
    return cond()


def test_traced_edit_applies_during_playback():
    hz = fixed(440.0)
    osc = Sine()
    osc.hertz = hz
    sink = port_sink('null', block_frames=512, realtime=False)
    sink.get_state().channels = 1
    sink.input = osc
    sink.capture(True)
    sink.start()
    assert _wait(lambda: sink.captured().shape[0] >= 8192, 30)
    hz.get_state().value = np.array([[1760.0]], dtype=np.float32)
    n0 = sink.captured().shape[0]
    assert _wait(lambda: sink.captured().shape[0] >= n0 + 16384, 30)
    sink.stop()
    sink.close()
    audio = sink.captured()[:, 0]
    assert abs(_dominant_freq(audio[:4096]) - 440.0) < 30
    assert abs(_dominant_freq(audio[-4096:]) - 1760.0) < 60


def test_structural_edit_recompiles_during_playback():
    hz = fixed(440.0)
    g = Gain()
    g.left = sine_node = Sine()
    sine_node.hertz = hz
    g.right = fixed(1.0)
    sink = port_sink('null', block_frames=512, realtime=False)
    sink.get_state().channels = 1
    sink.input = g
    sink.capture(True)
    sink.start()
    assert _wait(lambda: sink.captured().shape[0] >= 4096, 30)
    first = sink._transport.compiled
    sq = Square()
    sq.hertz = hz
    g.left = sq                          # structural: a new program

    def squared():
        tail = sink.captured()[-2048:, 0]
        return len(tail) and (np.abs(tail) > 0.9).mean() > 0.95

    assert _wait(squared, 30)
    tr = sink._transport
    sink.stop()
    sink.close()
    audio = sink.captured()[:, 0]
    assert float((np.abs(audio[:2048]) > 0.9).mean()) < 0.5
    assert float((np.abs(audio[-2048:]) > 0.9).mean()) > 0.95
    assert tr.error is None and tr.compiled is not first
    assert tr.compiled.graph_hash != first.graph_hash


def test_structural_edit_keeps_audio_continuous():
    """The background swap: while the new program warms up, the old one
    keeps rendering — no silent gap — and the edit lands one batch after
    its warmup (``Transport._swap_async``)."""
    hz = fixed(440.0)
    osc = Sine()
    osc.hertz = hz
    g = Gain()
    g.left = osc
    g.right = fixed(1.0)
    sink = port_sink('null', block_frames=512, realtime=False)
    sink.get_state().channels = 1
    sink.input = g
    sink.capture(True)
    sink.start()
    tr = sink._transport
    assert _wait(lambda: tr.position >= 16 * 512, 30)
    pos0 = tr.position
    sq = Square()
    sq.hertz = hz
    t0 = time.monotonic()
    g.left = sq
    assert _wait(lambda: (tr.last_swap_time or 0) >= t0, 60)
    blocks_during = (tr.position - pos0) // 512
    time.sleep(0.1)
    sink.stop()
    sink.close()
    assert tr.error is None
    assert blocks_during >= 1, blocks_during
    audio = sink.captured()[:, 0]
    w = audio[512:len(audio) // 512 * 512].reshape(-1, 512)
    assert w.shape[0] > 4
    assert np.sqrt((w ** 2).mean(axis=1)).min() > 0.05
    assert float((np.abs(audio[-2048:]) > 0.9).mean()) > 0.95


def test_echo_tail_survives_traced_mute():
    """Carry continuity across a traced edit: muting an echo's source
    between renders leaves the delay line ringing at the loop gain."""
    from signals_tpu_torch.nodes.delay import Delay
    from signals_tpu_torch.nodes.fx import Mix
    F = 512
    osc = Sine()
    osc.hertz = fixed(330.0)
    mix = Mix()
    d = Delay()
    d.get_state().frames = 4 * F
    fb = Gain()
    fb.left = d
    fb.right = fixed(0.9)
    mix.left = osc
    mix.right = fb
    mix.mix = fixed(0.5)
    d.input = mix
    c = compile_node(mix, block_frames=F, rate=RATE, channels=1,
                     device='cpu')
    _, carry = c.render(position=0, n_blocks=16, deliver_taps=False)
    osc.get_state().enabled = False       # traced edit: no recompile
    b, _ = c.render(position=16 * F, n_blocks=16, carry=carry,
                    deliver_taps=False)
    b = b.numpy().ravel()
    assert np.isfinite(b).all()
    early = np.abs(b[:4 * F]).max()
    late = np.abs(b[-4 * F:]).max()
    assert early > 0.1
    assert late < early * 0.2


def test_compiled_patch_keeps_its_wiring_after_an_edit():
    """A compiled patch renders the connections it was compiled from after
    the live graph is rewired (what lets the old program play while the
    new one warms up); a new compile renders the new ones."""
    hz = fixed(440.0)
    osc = Sine()
    osc.hertz = hz
    g = Gain()
    g.left = osc
    g.right = fixed(0.5)
    old = compile_node(g, block_frames=256, rate=RATE, channels=1,
                       device='cpu')
    before, _ = old.render(n_blocks=3)
    sq = Square()
    sq.hertz = hz
    g.left = sq
    after, _ = old.render(n_blocks=3)
    assert np.array_equal(after.numpy(), before.numpy())
    assert np.array_equal(old.step(old.params(), {}, 0)[0].numpy(),
                          before[:256].numpy())
    new = compile_node(g, block_frames=256, rate=RATE, channels=1,
                       device='cpu')
    assert new.graph_hash != old.graph_hash
    audio, _ = new.render(n_blocks=3)
    assert float((np.abs(audio.numpy()) > 0.49).mean()) > 0.95
    hz.get_state().value = np.array([[880.0]], np.float32)   # traced edits
    moved, _ = old.render(n_blocks=3)                       # still apply
    assert not np.array_equal(moved.numpy(), before.numpy())


# --- the downstream walk at a sink (compiler._downstream) --------------------


def feedback_echo(pkg=PORT):
    """``examples/feedback_echo.py``'s patch from ``pkg``'s nodes: a plucked
    saw (LowPass 1800 Hz, ADSR gated at 1.25 Hz) into ``Mix`` <- 0.45 x
    ``Delay`` (3/8 s) of the mix.  Returns the ``Mix``."""
    mod = {m: importlib.import_module(f'{pkg}.nodes.{m}')
           for m in ('delay', 'env', 'fx', 'osc')}
    fx, osc = mod['fx'], mod['osc']
    saw = osc.Sawtooth()
    saw.hertz = fixed(220.0, pkg)
    lp = fx.LowPass()
    lp.input = saw
    lp.cutoff = fixed(1800.0, pkg)
    gate = osc.Square()
    gate.hertz = fixed(1.25, pkg)
    env = mod['env'].ADSR()
    env.gate = gate
    st = env.get_state()
    st.attack, st.decay, st.sustain, st.release = 0.005, 0.12, 0.25, 0.08
    pluck = fx.RingMod()
    pluck.left = lp
    pluck.right = env
    mix = fx.Mix()
    echo = mod['delay'].Delay()
    echo.get_state().frames = int(0.375 * RATE)
    fb = fx.Gain()
    fb.left = echo
    fb.right = fixed(0.45, pkg)
    mix.left = pluck
    mix.right = fb
    mix.mix = fixed(0.55, pkg)
    echo.input = mix
    return mix


def jax_sink_render(root, channels, **kw):
    jdev = importlib.import_module('signals_tpu.nodes.dev')
    jrack = jdev.Rack()
    jrack.scan()
    jsink = jdev.SinkDevice(jrack.get_sink('default'), realtime=False)
    jsink.get_state().channels = channels
    jsink.input = root
    return np.asarray(jsink.render_offline(**kw))


def test_feedback_echo_through_a_sink_matches_jax():
    """The delay solver's cyclic branch walks the nodes downstream of the
    delay; the sink that reads the loop has no outputs and ends the walk
    (it raised ``AttributeError`` there).  2 s through
    ``SinkDevice.render_offline`` within 1e-5 of the JAX package's."""
    want = jax_sink_render(feedback_echo(JAX), 2, seconds=2.0)
    sink = port_sink(realtime=False)
    sink.get_state().channels = 2
    sink.input = feedback_echo()
    got = sink.render_offline(seconds=2.0).numpy()
    assert got.shape == want.shape == (86 * 1024, 2)
    assert np.isfinite(got).all() and np.abs(want).max() > 0.1
    assert np.abs(got - want).max() <= 1e-5


def test_feedback_echo_through_the_realtime_null_sink():
    """The same patch played through the realtime ``null`` sink (the ring
    and the paced consumer) for about a second: the captured frames are
    the offline render's first frames within 1e-5."""
    sink = port_sink('null', realtime=True)
    sink.get_state().channels = 1
    sink.input = feedback_echo()
    sink.capture(True)
    sink.start()
    assert _wait(lambda: sink.captured().shape[0] >= RATE, 60)
    tr = sink._transport
    sink.stop()
    sink.close()
    assert tr.error is None
    got = sink.captured()
    n = got.shape[0]
    assert n >= RATE and n % 1024 == 0
    want = sink.render_offline(n_blocks=n // 1024).numpy()
    assert np.isfinite(got).all() and np.abs(want).max() > 0.1
    assert np.abs(got - want).max() <= 1e-5


def test_mix_epilogue_poly_feeding_a_sink_matches_jax():
    """A swept ``PolyPatch(mix_epilogue=True)`` whose root also feeds a
    sink: the epilogue's soundness walk meets the sink, which is not
    ``Mix`` / ``Gain`` / ``RingMod``, and rejects the epilogue, as the
    reference's rule does; the patch takes the per-voice plan and its mix
    is within V x 1e-5 of the JAX package's ``PolyPatch`` render (default
    plan: the JAX package's own walk raises at a sink when asked for the
    epilogue)."""
    from test_torch_slice import build_voice, freqs
    from signals_tpu.parallel import PolyPatch as JaxPolyPatch
    from signals_tpu_torch.parallel import PolyPatch
    V, NB = 4, 16
    jroot, jhz = build_voice(JAX)
    jdev = importlib.import_module('signals_tpu.nodes.dev')
    jrack = jdev.Rack()
    jrack.scan()
    jsink = jdev.SinkDevice(jrack.get_sink('default'), realtime=False)
    jsink.input = jroot
    want, _ = JaxPolyPatch(jroot, n_voices=V,
                           overrides={(jhz, 'value'): freqs(V)},
                           block_frames=1024, rate=RATE).render(n_blocks=NB)
    want = np.asarray(want)
    root, hz = build_voice(PORT)
    sink = port_sink(realtime=False)
    sink.input = root
    poly = PolyPatch(root, n_voices=V, overrides={(hz, 'value'): freqs(V)},
                     block_frames=1024, rate=RATE, mix_epilogue=True,
                     device='cpu')
    assert poly.compiled.mega_mix(NB) is None      # the per-voice plan
    got, carry = poly.render(n_blocks=NB)
    got = got.numpy()
    assert carry == {} and got.shape == want.shape == (NB * 1024, 1)
    assert np.abs(want).max() > 0.1
    assert np.abs(got - want).max() <= V * 1e-5
    # the same voice without a sink takes the mix plan
    root, hz = build_voice(PORT)
    fresh = PolyPatch(root, n_voices=V, overrides={(hz, 'value'): freqs(V)},
                      block_frames=1024, rate=RATE, mix_epilogue=True,
                      device='cpu')
    assert fresh.compiled.mega_mix(NB) is not None
