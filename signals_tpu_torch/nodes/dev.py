"""Audio devices (``signals_tpu.nodes.dev``; reference
``src/signals/chain/dev.py``).

The reference binds directly to live PortAudio devices, which makes every
layer above it untestable without hardware.  Here the device layer is an
abstraction:

* :class:`SinkDevice` — owns the transport (open/start/stop/seek/tell,
  reference ``dev.py:128-165``) and drives the **compiled** patch on its
  ``device`` (default ``'cuda'``) through a
  :class:`signals_tpu_torch.runtime.Transport` render loop, instead of
  pulling the Python graph on the audio callback.  A realtime sink carries
  the blocks through the native ring (:mod:`signals_tpu_torch.runtime.ring`)
  to a clocked consumer: the paced virtual device, or a PortAudio output
  callback (:mod:`signals_tpu_torch.runtime.portaudio`) for a hardware
  sink.  Offline, :meth:`SinkDevice.render_offline` renders synchronously
  and :meth:`SinkDevice.render_offline_encoded` /
  :meth:`SinkDevice.render_offline_encoded_stream` encode on the device and
  copy only the payload off it (the production bounce).
* :class:`SourceDevice` — a host source: capture blocks enter the compiled
  program as staged inputs.  The virtual source yields silence (position-
  addressed), so patches with sources compile and run deterministically in
  tests.
* :class:`Rack` — the catalogue: the virtual ``default`` (stereo),
  ``null`` (64 channels) and ``capture`` devices are always present;
  hardware devices are appended when ``sounddevice`` imports.
"""

from __future__ import annotations

import time
import typing

import numpy as np

from signals_tpu_torch import SignalFlags
from signals_tpu_torch.core import BlockLoc, ChainLayerError, Shape
from signals_tpu_torch.graph import (
    Emitter,
    ExplicitChannels,
    KernelCtx,
    Receiver,
    port,
)
from signals_tpu_torch.registry import register

F32 = np.float32


class BadPlaybackState(ChainLayerError):
    pass


class DeviceInfo(typing.NamedTuple):
    """One entry of the device rack (reference ``dev.py:33-77``)."""

    name: str
    index: int
    hostapi: int = 0
    max_input_channels: int = 0
    max_output_channels: int = 0
    default_low_input_latency: float = 0.01
    default_low_output_latency: float = 0.01
    default_high_input_latency: float = 0.1
    default_high_output_latency: float = 0.1
    default_samplerate: float = 44100.0
    #: 'virtual' (always available, no hardware) or 'portaudio'
    backend: str = 'virtual'
    #: the sounddevice device index for backend='portaudio'
    sd_index: int = -1

    @property
    def is_source(self) -> bool:
        return self.max_input_channels > 0

    @property
    def is_sink(self) -> bool:
        return self.max_output_channels > 0

    def describe(self) -> str:
        return '\n'.join((
            f'{self.index:<3} {self.name} ({self.hostapi})',
            f'\tMaximum supported channels (I/O): '
            f'{self.max_input_channels}/{self.max_output_channels}',
            f'\tDefault samplerate: {self.default_samplerate}',
        ))

    def __str__(self) -> str:
        return self.describe()


class Device:
    """Mixin carrying the rack record and the compile device."""

    def __init__(self, info: DeviceInfo, device='cuda'):
        from signals_tpu_torch.compiler import check_device
        self.info = info
        #: where the patch this device drives is compiled and rendered
        self.device = check_device(device)
        super().__init__()

    def _n_blocks(self, seconds, n_blocks, block_frames: int) -> int:
        if n_blocks is None:
            n_blocks = max(1, int(round(seconds * self.info.default_samplerate
                                        / block_frames)))
        return n_blocks


@register('signals.chain.dev.SinkDevice')
class SinkDevice(Device, Receiver, ExplicitChannels):
    """Playback endpoint and transport owner.

    ``start()`` compiles the patch feeding ``input`` on ``device`` and
    spawns the render loop; blocks land in :meth:`consume_block`
    (overridable) and, for a realtime sink, in the ring.
    ``render_offline`` renders synchronously — the deterministic path of
    tests and bounces.  A structural edit of the patch during playback
    recompiles on a background thread while the old program keeps playing
    (the ``Transport``'s ``refresh``).
    """

    input: Receiver.BoundPort = port('input')

    class State(ExplicitChannels.State):
        pass

    def __init__(self, info: DeviceInfo, *,
                 block_frames: int = 1024,
                 realtime: bool = True,
                 ring_blocks: int = 8,
                 output_fd: int = -1,
                 output_format: str = 'f32',
                 device='cuda'):
        super().__init__(info, device)
        self.block_frames = block_frames
        self.realtime = realtime
        #: render-ahead depth of the native ring buffer (blocks)
        self.ring_blocks = ring_blocks
        #: output target for the paced consumer (-1 = discard)
        self.output_fd = output_fd
        #: fd stream format: 'f32' (raw) or 'pcm16' (the production format)
        self.output_format = output_format
        self.frame_position = 0
        self._transport = None
        self._ring = None
        self._consumer = None
        self._capture: typing.Optional[list[np.ndarray]] = None

    @classmethod
    def flags(cls) -> SignalFlags:
        return super().flags() | SignalFlags.SINK_DEVICE

    def set_state(self, new_state) -> None:
        if new_state.channels > self.info.max_output_channels:
            from signals_tpu_torch.core.state import BadStateValue
            raise BadStateValue(
                new_state, 'channels', new_state.channels,
                f'device supports at most {self.info.max_output_channels}')
        was_active = self.is_active
        changed = new_state.channels != self._state.channels
        super().set_state(new_state)
        if changed and self.is_open:
            self.close()
            if was_active:
                self.start()

    @property
    def rate(self) -> int:
        return int(self.info.default_samplerate)

    # --- transport (reference dev.py:128-165) ------------------------------

    @property
    def is_open(self) -> bool:
        return self._transport is not None

    @property
    def is_active(self) -> bool:
        return self.is_open and self._transport.is_active

    def _compile(self):
        from signals_tpu_torch.compiler import compile_node
        if not self.input:
            raise BadPlaybackState('The sink has no input connected')
        return compile_node(self.input.sig, block_frames=self.block_frames,
                            rate=self.rate, channels=self._state.channels,
                            device=self.device)

    def open(self) -> None:
        if self.is_open:
            raise BadPlaybackState('The output stream is already open')
        from signals_tpu_torch.runtime import Transport
        consume = self._consume
        if self.realtime:
            # the native ring carries blocks from the render thread to the
            # clocked consumer; its backpressure paces the renderer
            # (render-ahead depth = ring capacity), so the Transport runs
            # unthrottled.  The consumer starts in start(), after the
            # warmup, so the stream does not open on underrun silence.
            from signals_tpu_torch.runtime.ring import RingBuffer
            self._ring = RingBuffer(
                capacity_frames=self.ring_blocks * self.block_frames,
                channels=self._state.channels)
            consume = self._consume_ring
        self._transport = Transport(self._compile(), consume, realtime=False,
                                    refresh=self._compile)
        self._transport.seek(self.frame_position)

    def close(self) -> None:
        if not self.is_open:
            raise BadPlaybackState('The output stream is not open')
        self._transport.stop()
        self._transport = None
        if self._consumer is not None:
            self._consumer.stop()
            self._consumer = None
        if self._ring is not None:
            self._ring.close()
            self._ring = None

    @property
    def underruns(self) -> int:
        """Blocks the clocked consumer had to zero-fill."""
        return 0 if self._consumer is None else self._consumer.underruns

    def start(self) -> None:
        if not self.is_open:
            self.open()
        self._transport.start()
        if self._ring is not None and self._consumer is None:
            self._consumer = self._make_consumer()

    def _make_consumer(self):
        """The ring drain: a PortAudio output callback for a hardware sink
        (reference contract ``dev.py:139-179``), the paced virtual device
        otherwise."""
        from signals_tpu_torch.runtime import portaudio
        if self.info.backend == 'portaudio' and portaudio.available():
            return portaudio.HardwareOutput(
                self._ring, rate=self.rate, channels=self._state.channels,
                block_frames=self.block_frames, device=self.info.sd_index)
        from signals_tpu_torch.runtime.ring import PacedConsumer
        return PacedConsumer(self._ring, rate=self.rate,
                             block_frames=self.block_frames,
                             fd=self.output_fd, fmt=self.output_format)

    def stop(self) -> None:
        if not self.is_active:
            raise BadPlaybackState('The output stream is not active')
        self.frame_position = self._transport.tell()
        self._transport.stop()
        if self._consumer is not None:
            self._consumer.stop()
            self._consumer = None

    def seek(self, position_blocks: int) -> None:
        self.frame_position = position_blocks * self.block_frames
        if self.is_open:
            self._transport.seek(self.frame_position)

    def tell(self) -> int:
        pos = self._transport.tell() if self.is_open else self.frame_position
        return pos // self.block_frames

    def destroy(self) -> None:
        if self.is_open:
            self.close()
        super().destroy()

    # --- block consumption --------------------------------------------------

    def _consume(self, block: np.ndarray, position: int) -> None:
        self.frame_position = position + block.shape[0]
        if self._capture is not None:
            self._capture.append(block)
        self.consume_block(block, position)

    def _consume_ring(self, block: np.ndarray, position: int) -> None:
        """Push into the ring with backpressure (this is what paces the
        render-ahead loop at the sample rate)."""
        self._consume(block, position)
        written = 0
        while written < block.shape[0]:
            transport = self._transport
            if transport is None or not transport._running.is_set():
                break          # stopping: drop the remainder
            written += self._ring.write(block[written:])
            if written < block.shape[0]:
                time.sleep(self.block_frames / self.rate / 4)

    def consume_block(self, block: np.ndarray, position: int) -> None:
        """Override point: hand a rendered block to actual output."""

    def capture(self, enable: bool = True) -> None:
        self._capture = [] if enable else None

    def captured(self) -> np.ndarray:
        blocks = self._capture or []
        ch = self._state.channels
        return (np.concatenate(blocks, axis=0) if blocks
                else np.zeros((0, ch), dtype=F32))

    def render_offline(self, *, seconds: float = None, n_blocks: int = None,
                       position: int = 0):
        """Deterministic synchronous render from ``position`` (any block
        multiple): ``(n*F, channels)`` tensor on ``device``."""
        n_blocks = self._n_blocks(seconds, n_blocks, self.block_frames)
        audio, _ = self._compile().render(position=position,
                                          n_blocks=n_blocks)
        return audio

    def render_offline_encoded(self, *, seconds: float = None,
                               n_blocks: int = None, position: int = 0,
                               subtype: str = 'mulaw'):
        """Offline render with the sample encoding applied on the device —
        the payload (the WAV ``data``-chunk bytes of the subtype) is what
        crosses the host link.  Returns ``(payload numpy, frames)``."""
        n_blocks = self._n_blocks(seconds, n_blocks, self.block_frames)
        payload, frames, _ = self._compile().render_encoded(
            position=position, n_blocks=n_blocks, subtype=subtype)
        return payload, frames

    #: streaming-bounce batch length (seconds of audio a batch)
    bounce_batch_seconds = 60.0

    def render_offline_encoded_stream(self, *, seconds: float = None,
                                      n_blocks: int = None,
                                      position: int = 0,
                                      subtype: str = 'mulaw',
                                      batch_seconds: float = None):
        """Iterator of ``(payload, frames)`` batches with the next batch
        queued on the device before the current payload is waited for
        (:meth:`CompiledPatch.render_encoded_stream`) — the production
        long-bounce path."""
        n_blocks = self._n_blocks(seconds, n_blocks, self.block_frames)
        if batch_seconds is None:
            batch_seconds = self.bounce_batch_seconds
        batch_blocks = self._n_blocks(batch_seconds, None, self.block_frames)
        return self._compile().render_encoded_stream(
            position=position, n_blocks=n_blocks,
            batch_blocks=min(batch_blocks, n_blocks), subtype=subtype)

    # --- pull-engine compatibility (reference dev.py:167-179) --------------

    def pull_block(self, frames: int = None) -> np.ndarray:
        """Pull one block through the numpy interpreter (the reference's
        audio-callback body), advancing the device position."""
        frames = frames or self.block_frames
        loc = BlockLoc(position=self.frame_position, rate=self.rate,
                       shape=Shape(frames=frames,
                                   channels=self._state.channels))
        block = self.input.request(loc)
        self.frame_position += frames
        return np.broadcast_to(block, tuple(loc.shape)).astype(F32)


@register('signals.chain.dev.SourceDevice')
class SourceDevice(Device, Emitter):
    """Capture endpoint.  A host source for the compiler: captured blocks
    enter the compiled program as staged inputs (reference
    ``dev.py:182-244`` blocks on a live queue inside the graph walk
    instead).

    The virtual device is deterministic silence, so patches with sources
    compile and run without hardware; ``start_capture()`` attaches a live
    PortAudio input stream (for a ``'portaudio'``-backend rack entry),
    after which ``host_read`` serves real captured audio, position-
    addressed.  :meth:`render_offline` renders the captured audio through
    the compiled path on ``device``.
    """

    is_host_source = True

    def __init__(self, info: DeviceInfo, *, device='cuda'):
        super().__init__(info, device)
        self.position = 0
        self._capture = None

    @classmethod
    def flags(cls) -> SignalFlags:
        return super().flags() | SignalFlags.SOURCE_DEVICE

    @property
    def channels(self) -> int:
        return max(self.info.max_input_channels, 1)

    @property
    def is_capturing(self) -> bool:
        return self._capture is not None

    def start_capture(self, *, block_frames: int = 1024,
                      sd_module=None) -> None:
        """Open the live input stream (reference ``dev.py:198-217``)."""
        if self._capture is not None:
            raise BadPlaybackState('The input stream is already open')
        from signals_tpu_torch.runtime import portaudio
        device = self.info.sd_index if self.info.backend == 'portaudio' \
            else None
        self._capture = portaudio.HardwareCapture(
            rate=self.info.default_samplerate, channels=self.channels,
            block_frames=block_frames, device=device, sd_module=sd_module)

    def stop_capture(self) -> None:
        if self._capture is not None:
            self._capture.stop()
            self._capture = None

    def destroy(self) -> None:
        self.stop_capture()
        super().destroy()

    def host_read(self, position: int, frames: int, rate: int) -> np.ndarray:
        if self._capture is not None:
            if float(rate) != self._capture.rate:
                # silent resampling would time-scale the audio and stall
                # every read near the live head — fail loudly instead
                raise BadPlaybackState(
                    f'patch renders at {rate} Hz but {self.info.name!r} '
                    f'captures at {self._capture.rate:g} Hz')
            return self._capture.read(position, frames)
        return np.zeros((frames, self.channels), dtype=F32)

    def kernel(self, ctx: KernelCtx):
        # only the pull oracle lands here; the compiler stages this node
        loc = ctx.request.loc
        return self.host_read(loc.position, loc.shape.frames, loc.rate)

    def render_offline(self, *, seconds: float = None, n_blocks: int = None,
                       position: int = 0, block_frames: int = 1024):
        """The captured audio of ``n_blocks`` blocks from ``position``,
        staged and rendered by the compiled path on ``device``:
        ``(n*F, channels)`` tensor."""
        from signals_tpu_torch.compiler import compile_node
        n_blocks = self._n_blocks(seconds, n_blocks, block_frames)
        patch = compile_node(self, block_frames=block_frames,
                             rate=int(self.info.default_samplerate),
                             device=self.device)
        return patch.render(position=position, n_blocks=n_blocks)[0]


# --- the rack (reference ``chain/discovery.py:96-126``) ---------------------


class BadDevice(ChainLayerError):
    pass


class BadDeviceName(BadDevice):

    def __init__(self, name):
        super().__init__(f'There is no device named {name!r}')


class NotASource(BadDevice):

    def __init__(self, name):
        super().__init__(f'Device {name!r} does not support input')


class NotASink(BadDevice):

    def __init__(self, name):
        super().__init__(f'Device {name!r} does not support output')


_VIRTUAL_DEVICES = (
    DeviceInfo(name='default', index=0, max_output_channels=2),
    DeviceInfo(name='null', index=1, max_output_channels=64),
    DeviceInfo(name='capture', index=2, max_input_channels=2),
)


class Rack:
    """Device catalogue.  Virtual devices are always present (so every layer
    is testable without hardware); real devices are appended when the
    optional ``sounddevice`` package imports."""

    def __init__(self):
        self.devices: list[DeviceInfo] = []

    def scan(self) -> None:
        devices = list(_VIRTUAL_DEVICES)
        try:
            import sounddevice as sd
        except ImportError:
            pass
        else:
            base = len(devices)
            for i, info in enumerate(sd.query_devices()):
                devices.append(DeviceInfo(
                    name=info['name'], index=base + i,
                    hostapi=info.get('hostapi', 0),
                    max_input_channels=info['max_input_channels'],
                    max_output_channels=info['max_output_channels'],
                    default_samplerate=info['default_samplerate'],
                    backend='portaudio', sd_index=i))
        self.devices = devices

    def get_device(self, name: str) -> DeviceInfo:
        for device in self.devices:
            if device.name == name:
                return device
        raise BadDeviceName(name)

    def get_source(self, name: str) -> DeviceInfo:
        device = self.get_device(name)
        if not device.is_source:
            raise NotASource(name)
        return device

    def get_sink(self, name: str) -> DeviceInfo:
        device = self.get_device(name)
        if not device.is_sink:
            raise NotASink(name)
        return device

    def sources(self) -> list[DeviceInfo]:
        return sorted((d for d in self.devices if d.is_source),
                      key=lambda d: d.index)

    def sinks(self) -> list[DeviceInfo]:
        return sorted((d for d in self.devices if d.is_sink),
                      key=lambda d: d.index)
