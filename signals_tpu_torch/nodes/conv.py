"""Convolution with an impulse response (``signals_tpu.nodes.conv``) —
convolution reverb, cabinet and room simulation.

A K-tap FIR is exactly a function of the last ``K - 1`` input frames, the
stateless context window every render plan serves, so :class:`Convolve`
carries no state: it is seekable and rides every plan.

One real FFT of the padded context window, a product with the IR spectrum,
one inverse FFT: overlap-save with the engine's own window as the segment.
Under a mega window the whole batch convolves as ONE transform pair (a 60 s
window at 44.1 kHz with a 2 s IR: 2^22 points).  The IR spectrum is
computed once on the host in numpy and moved to the device once per
transform size.  Both engines run f32 FFTs: numpy's pocketfft on the host,
``torch.fft`` (cuFFT on a GPU) in the compiler — a library call, as the JAX
package leaves its FFT to XLA.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from signals_tpu_torch import SignalFlags
from signals_tpu_torch.core.state import Param, all_of, ge, in_range, \
    instance_of
from signals_tpu_torch.core.xp import to_device
from signals_tpu_torch.graph import KernelCtx, Receiver, port
from signals_tpu_torch.nodes.fx import Effect
from signals_tpu_torch.registry import register

F32 = np.float32

#: hard cap on IR taps (~12 s at 44.1 kHz): bounds the context window the
#: compiler retains and the FFT working set
MAX_IR_FRAMES = 1 << 19


def _next_pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 0)


@register()
class Convolve(Effect):
    """Convolve the input with an impulse response.

    The IR comes from a sound file (``path``) or, when ``path`` is empty,
    is synthesized as exponentially decaying noise (``ir_frames`` taps
    falling to ``-decay_db`` dB at the tail, seeded by ``seed``).  File
    IRs: mono broadcasts to every bus channel, a matching channel count
    convolves per channel, anything else downmixes to mono by mean.

    ``mix`` (dry/wet) and ``gain`` (wet gain) are traced.  Everything that
    defines the IR is structural: editing it recompiles via the graph hash
    (:meth:`structural_extra`).
    """

    input: Receiver.BoundPort = port('input')

    class State(Effect.State):
        #: structural: IR sound file; '' synthesizes a noise IR
        path: str = Param('', validate=instance_of(str))
        #: structural: synthesized-IR length in frames (file IRs use the
        #: file's length, capped at MAX_IR_FRAMES)
        ir_frames: int = Param(4096, validate=all_of(instance_of(int),
                                                     ge(1)))
        #: structural: synthesized-IR tail attenuation (dB below the head)
        decay_db: float = Param(60.0, validate=ge(0.0))
        #: structural: synthesized-IR noise seed
        seed: int = Param(0, validate=instance_of(int))
        #: structural: scale the IR to unit energy per channel
        normalize: bool = Param(True, validate=instance_of(bool))
        #: wet/dry balance in [0, 1]: 0 = dry, 1 = wet
        mix: float = Param(1.0, validate=in_range(0.0, 1.0), traced=True)
        #: linear gain on the wet (convolved) signal
        gain: float = Param(1.0, validate=ge(0.0), traced=True)

    def __init__(self):
        super().__init__()
        self._ir_cache: tuple | None = None   # (key, np.ndarray (K, irch))
        #: (ir key, M, ch, device) -> the IR spectrum on the device
        self._spectra: dict = {}

    # --- impulse response (host side) ---------------------------------------

    def _ir_key(self) -> tuple:
        st = self._state
        if st.path:
            try:
                mtime = os.stat(st.path).st_mtime_ns
            except OSError:
                mtime = None
            return ('file', st.path, mtime, st.normalize)
        return ('gen', st.ir_frames, st.decay_db, st.seed, st.normalize)

    def _ir(self) -> np.ndarray:
        """The impulse response as a float32 ``(K, irch)`` array, cached
        until a structural param (or the file on disk) changes."""
        key = self._ir_key()
        if self._ir_cache is not None and self._ir_cache[0] == key:
            return self._ir_cache[1]
        st = self._state
        if st.path:
            from signals_tpu_torch.runtime import sndfile
            reader = sndfile.open_reader(st.path)
            try:
                k = min(int(reader.frames), MAX_IR_FRAMES)
                ir = np.asarray(reader.read(0, k), dtype=F32)
            finally:
                reader.close()
            if k < 1:
                raise ValueError(f'{st.path}: empty impulse response')
        else:
            from signals_tpu_torch.core import rng
            from signals_tpu_torch.core.xp import NP
            k = min(int(st.ir_frames), MAX_IR_FRAMES)
            idx = np.arange(k, dtype=np.int32).reshape(-1, 1)
            u = rng.uniform01(NP, np.uint32(st.seed), idx, 1, salt=7)
            noise = F32(2.0) * u - F32(1.0)
            # head -> -decay_db dB at the last tap (a decaying tail only:
            # a unit head tap would make mix=1 sound dry)
            t = idx.astype(F32) / F32(max(k - 1, 1))
            env = np.power(F32(10.0), t * F32(-st.decay_db / 20.0))
            ir = (noise * env).astype(F32)
        if st.normalize:
            energy = np.sqrt(np.sum(np.square(ir, dtype=np.float64),
                                    axis=0, keepdims=True))
            ir = (ir / np.maximum(energy, 1e-30)).astype(F32)
        self._ir_cache = (key, ir)
        self._spectra.clear()
        return ir

    def _ir_len(self) -> int:
        return self._ir().shape[0]

    def _ir_for_channels(self, ch: int) -> np.ndarray:
        """The IR resolved against the bus width: ``(K, ch)``."""
        ir = self._ir()
        irch = ir.shape[1]
        if irch == ch:
            return ir
        if irch == 1:
            return np.broadcast_to(ir, (ir.shape[0], ch))
        return np.broadcast_to(ir.mean(axis=1, keepdims=True,
                                       dtype=np.float64).astype(F32),
                               (ir.shape[0], ch))

    def _spectrum(self, xp, M: int, ch: int):
        """The IR's ``M``-point spectrum ``(M // 2 + 1, ch)`` complex64:
        numpy's on the host; on a device, that array copied there once and
        kept for the next render."""
        def host():
            return np.fft.rfft(self._ir_for_channels(ch), n=M,
                               axis=0).astype(np.complex64)

        if not xp.is_torch:
            return host()
        key = (self._ir_key(), M, ch, xp.device)
        spec = self._spectra.get(key)
        if spec is None:
            spec = self._spectra[key] = to_device(host(), xp.device)
        return spec

    # --- node protocol ------------------------------------------------------

    @classmethod
    def flags(cls) -> SignalFlags:
        return super().flags() | SignalFlags.EFFECT

    def structural_extra(self) -> str:
        """The resolved IR's identity (the file's mtime and tap count, or
        the synthesis params) for the graph hash: an IR file edited on disk
        gives another hash, so a compiled patch never keeps a stale
        spectrum or a context window of the old length."""
        return f'{self._ir_key()!r};K={self._ir_len()}'

    def context_frames(self) -> int:
        return self._ir_len() - 1

    def kernel(self, ctx: KernelCtx):
        xp = ctx.xp
        N = ctx.nframes
        ch = self.channels
        K = self._ir_len()

        x = ctx.in_('input')
        dry = xp.broadcast_to(x, (N, ch))
        if K == 1:
            wet = dry * xp.reshape(
                xp.asarray(np.ascontiguousarray(self._ir_for_channels(ch)[0])),
                (1, ch))
        else:
            xc = ctx.in_context('input', K - 1)
            xc = xp.broadcast_to(xc, (xc.shape[0], ch))
            # overlap-save with the engine window as the segment: the last
            # N samples of the M-point circular convolution are exact (M >=
            # N + K - 1 keeps the wrap in the discarded head); the frames
            # the pull engine omits before the stream start and the head
            # of the transform are zeros
            M = _next_pow2(N + K - 1)
            xc = xp.pad(xc, ((M - xc.shape[0], 0), (0, 0)))
            X = xp.fft.rfft(xc, n=M, axis=0)
            y = xp.fft.irfft(X * self._spectrum(xp, M, ch), n=M, axis=0)
            wet = xp.astype(y[-N:], xp.float32)

        mix = xp.reshape(xp.astype(ctx.param('mix'), xp.float32), ())
        gain = xp.reshape(xp.astype(ctx.param('gain'), xp.float32), ())
        return (mix * gain) * wet + (F32(1.0) - mix) * dry
