"""Sound-file IO nodes (``signals_tpu.nodes.files``; reference
``src/signals/chain/files.py``).

These are **host nodes**: they cross the device boundary.  The compiler
turns a :class:`FileReader` into a staged render *input* — every window it
is read at, for every block of a render, read on the host as numpy
(position-addressed like the reference's seek, ``files.py:56-58``) and
copied to the device once per render — and a :class:`FileWriter` into a
tap: the render hands its blocks to :meth:`FileWriter.consume_tap`, which
writes them to disk.  Formats dispatch through
:mod:`signals_tpu_torch.runtime.sndfile`: WAV/AIFF/AU natively, anything
else via libsndfile when the ``soundfile`` package is importable (the
reference's only backend, ``files.py:8``).
"""

from __future__ import annotations

import abc

import numpy as np

from signals_tpu_torch import SignalFlags
from signals_tpu_torch.core import Request
from signals_tpu_torch.core.state import Param, instance_of
from signals_tpu_torch.graph import Emitter, KernelCtx, PassThroughResult
from signals_tpu_torch.registry import register
from signals_tpu_torch.runtime import sndfile


class SoundFileBase(Emitter, abc.ABC):

    class State(Emitter.State):
        #: structural: changing the path changes the patch's host bindings
        path: str = Param('/dev/null', validate=instance_of(str))

    def __init__(self):
        super().__init__()
        self._buffer = None

    def _close(self) -> None:
        if self._buffer is not None:
            self._buffer.close()
            self._buffer = None

    def set_state(self, new_state) -> None:
        old_path = getattr(self._state, 'path', None)
        super().set_state(new_state)
        if new_state.path != old_path:
            self._close()

    def destroy(self) -> None:
        self._close()
        super().destroy()


@register('signals.chain.files.FileReader')
class FileReader(SoundFileBase):
    """Reads blocks at the requested absolute position (reference
    ``files.py:70-86``).  Out-of-range frames, before frame 0 or past the
    file's end, are zero.

    ``conform_rate=True`` resamples the file to the ENGINE rate
    (windowed-sinc, :mod:`signals_tpu_torch.core.resample`) so any-rate
    files play pitch-correct; the default ``False`` keeps the reference's
    raw-frame semantics.  Resampling is a pure function of the absolute
    position, so block renders and seeks stay sample-exact; the pull oracle
    and the compiler share :meth:`host_read`.  ``resample_taps`` picks the
    conversion quality tier: 32 (default) or 64."""

    #: compiler: lower as a staged host input
    is_host_source = True

    class State(SoundFileBase.State):
        conform_rate: bool = Param(False, validate=instance_of(bool))
        #: structural: windowed-sinc kernel taps (quality tier)
        resample_taps: int = Param(32, validate=instance_of(int))

    @classmethod
    def flags(cls) -> SignalFlags:
        return super().flags() | SignalFlags.GENERATOR

    def _open(self):
        if self._buffer is None:
            self._buffer = sndfile.open_reader(self._state.path)
        return self._buffer

    @property
    def channels(self) -> int:
        return self._open().channels

    def host_read(self, position: int, frames: int, rate: int) -> np.ndarray:
        """``frames`` frames from the absolute engine frame ``position`` (a
        host integer; negative reads zeros), ``(frames, ch)`` float32."""
        buf = self._open()
        file_rate = int(getattr(buf, 'rate', rate) or rate)
        if not self._state.conform_rate or file_rate == rate:
            return buf.read(position, frames)
        from signals_tpu_torch.core.resample import sinc_interpolate
        taps = max(8, int(self._state.resample_taps))
        half = taps // 2
        ratio = file_rate / rate
        # the engine frames [position, position+frames) live at file
        # times k * ratio; read the covering file segment plus the
        # kernel's reach on both sides (readers zero-fill out-of-range)
        start = int(np.floor(position * ratio)) - half
        stop = int(np.ceil((position + frames) * ratio)) + half + 1
        seg = buf.read(start, stop - start)
        pos = ((position + np.arange(frames, dtype=np.float64)) * ratio
               - start)
        out = sinc_interpolate(seg, pos, cutoff=min(1.0, rate / file_rate),
                               taps=taps)
        return out.astype(np.float32)

    def kernel(self, ctx: KernelCtx):
        # only the pull oracle lands here; the compiler stages this node
        # as a host input
        loc = ctx.request.loc
        return self.host_read(loc.position, loc.shape.frames, loc.rate)


@register('signals.chain.files.FileWriter')
class FileWriter(SoundFileBase, PassThroughResult):
    """Writes the forwarded block to disk, then passes it through
    (reference ``files.py:89-102``).  A RECORDER tap: a render hands it
    its blocks on the host; a disabled writer forwards its audio and is
    handed nothing.

    ``subtype`` picks the sample encoding for containers that offer a
    choice (WAV: float32/pcm16/mulaw/alaw/adpcm; AU: all but adpcm)."""

    class State(SoundFileBase.State):
        subtype: str = Param('float32', validate=instance_of(str))

    @classmethod
    def flags(cls) -> SignalFlags:
        return super().flags() | SignalFlags.RECORDER

    def set_state(self, new_state) -> None:
        old = getattr(self._state, 'subtype', None)
        super().set_state(new_state)
        if new_state.subtype != old:
            self._close()

    def _open_writer(self, rate: int, channels: int):
        if self._buffer is not None and not hasattr(self._buffer, 'write'):
            self._close()
        if self._buffer is None:
            self._buffer = sndfile.open_writer(
                self._state.path, rate=rate, channels=channels,
                subtype=self._state.subtype)
        return self._buffer

    def kernel(self, ctx: KernelCtx):
        return ctx.in_('input')

    def consume_tap(self, block: np.ndarray, position: int,
                    rate: int) -> None:
        self._open_writer(rate, block.shape[1]).write(block)

    # pull oracle: write inline, exactly like the reference
    def _eval(self, request: Request) -> np.ndarray:
        result = super()._eval(request)
        full = np.broadcast_to(
            result, (request.loc.shape.frames, result.shape[1]))
        self.consume_tap(full, request.loc.position, request.loc.rate)
        return result
