"""PortAudio playback and capture (``signals_tpu.runtime.portaudio``),
through the optional ``sounddevice`` package.

The reference's sink opens a live ``sd.OutputStream`` and pulls the Python
graph inside the audio callback (``src/signals/chain/dev.py:139-179``); its
source runs an ``sd.InputStream`` whose callback enqueues captured blocks
(``dev.py:198-217``).  Here the GPU renders ahead into the lock-free ring
(:mod:`signals_tpu_torch.runtime.ring`), and the PortAudio callback only
*drains* the ring — no torch, no Python graph walk, nothing blocking on the
audio thread.  Underruns zero-fill and are counted (the reference instead
raises and kills the stream).

Everything is gated on the optional ``sounddevice`` package: the module
imports fine without it and :func:`available` reports the truth.  The
stream classes take the module as a constructor argument so tests can
inject a fake (no hardware needed).
"""

from __future__ import annotations

import threading
import typing

import numpy as np

F32 = np.float32


def _sounddevice():
    try:
        import sounddevice
    except ImportError:
        return None
    return sounddevice


def available() -> bool:
    """True when the PortAudio backend can be used."""
    return _sounddevice() is not None


class HardwareOutput:
    """Drains a ring buffer from a real PortAudio output callback.

    Same consumer interface as
    :class:`signals_tpu_torch.runtime.ring.PacedConsumer`
    (``frames``/``underruns``/``stop``), so :class:`SinkDevice` treats
    virtual and hardware outputs identically.  The callback contract
    mirrors the reference's ``SinkDevice._callback``
    (``dev.py:167-179``): fill ``outdata`` for ``frames`` frames — but
    from the pre-rendered ring rather than by recursing into the graph.
    """

    def __init__(self, ring, *, rate: float, channels: int,
                 block_frames: int, device=None, sd_module=None):
        sd = sd_module if sd_module is not None else _sounddevice()
        if sd is None:
            raise RuntimeError(
                'PortAudio output requires the sounddevice package')
        self._sd = sd
        self.ring = ring
        self.channels = channels
        self._frames = 0
        self._underruns = 0
        self._closed = threading.Event()
        self._stream = sd.OutputStream(
            samplerate=rate, channels=channels, blocksize=block_frames,
            device=device, dtype='float32', callback=self._callback)
        self._stream.start()

    def _callback(self, outdata, frames, time_info, status) -> None:
        # real-time thread: ring reads only; zero-fill shortfalls
        if self._closed.is_set():
            outdata[:] = 0.0
            raise self._sd.CallbackStop()
        buf = np.zeros((frames, self.channels), dtype=F32)
        got = self.ring.read_into(buf)
        if got < frames:
            self._underruns += 1
        outdata[:, :self.channels] = buf
        self._frames += frames

    @property
    def frames(self) -> int:
        return self._frames

    @property
    def underruns(self) -> int:
        return self._underruns

    def stop(self) -> None:
        self._closed.set()
        try:
            self._stream.stop()
            self._stream.close()
        except Exception:
            pass


class HardwareCapture:
    """Runs a PortAudio input stream whose callback appends captured blocks
    to a position-addressed buffer (reference ``dev.py:198-217``).

    ``read(position, frames)`` serves the compiled program's staged-input
    reads: zeros before the capture start, blocks (up to ``timeout``) while
    the requested range is still being captured, and zero-fills whatever
    the wait did not produce — the reference instead raises on overshoot
    (``dev.py:242-244``), which would kill a render mid-stream.
    """

    def __init__(self, *, rate: float, channels: int, block_frames: int,
                 device=None, sd_module=None, max_buffer_seconds: float = 60.0,
                 timeout: float = 2.0):
        sd = sd_module if sd_module is not None else _sounddevice()
        if sd is None:
            raise RuntimeError(
                'PortAudio capture requires the sounddevice package')
        self._sd = sd
        self.rate = float(rate)
        self.channels = channels
        self.timeout = timeout
        self._capacity = max(1, int(max_buffer_seconds * rate))
        self._buf = np.zeros((self._capacity, channels), dtype=F32)
        self._head = 0          # absolute frames captured so far
        self._lock = threading.Lock()
        self._grew = threading.Condition(self._lock)
        self.overruns = 0
        self._stream = sd.InputStream(
            samplerate=rate, channels=channels, blocksize=block_frames,
            device=device, dtype='float32', callback=self._callback)
        self._stream.start()

    def _callback(self, indata, frames, time_info, status) -> None:
        block = np.asarray(indata, dtype=F32)[:, :self.channels]
        with self._grew:
            pos = self._head % self._capacity
            n = block.shape[0]
            first = min(n, self._capacity - pos)
            self._buf[pos:pos + first] = block[:first]
            if first < n:
                self._buf[:n - first] = block[first:]
            self._head += n
            self._grew.notify_all()

    @property
    def head(self) -> int:
        with self._lock:
            return self._head

    def read(self, position: int, frames: int) -> np.ndarray:
        """Captured audio for absolute frame range [position, position+frames).

        Blocks until captured (or timeout); out-of-window ranges (already
        overwritten in the ring, or negative positions) read as zeros and
        count as overruns when data was lost.
        """
        out = np.zeros((frames, self.channels), dtype=F32)
        end = position + frames
        with self._grew:
            self._grew.wait_for(lambda: self._head >= end,
                                timeout=self.timeout)
            lo = max(position, 0, self._head - self._capacity)
            hi = min(end, self._head)
            if position >= 0 and lo > position and self._head > 0:
                self.overruns += 1
            if hi > lo:
                # at most two slice copies (ring wrap) — the capture
                # callback contends on this lock, so stay vectorized
                p0 = lo % self._capacity
                first = min(hi - lo, self._capacity - p0)
                out[lo - position:lo - position + first] = \
                    self._buf[p0:p0 + first]
                if first < hi - lo:
                    out[lo - position + first:hi - position] = \
                        self._buf[:hi - lo - first]
        return out

    def stop(self) -> None:
        try:
            self._stream.stop()
            self._stream.close()
        except Exception:
            pass
