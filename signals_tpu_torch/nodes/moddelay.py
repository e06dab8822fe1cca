"""Modulated fractional delay (``signals_tpu.nodes.moddelay``) — the
chorus / flanger / vibrato primitive.

A moving sub-block read needs no carried state: it is a function of a
bounded input lookback, the stateless context-window shape every engine
serves (the context filters, the compressor).  So :class:`FracDelay` is
seekable, independent of the blocking, and rides every render plan with one
linear-interpolated gather a frame.

Classic patches: vibrato (a slow Sine on ``delay``), chorus
(``Mix(dry, FracDelay(src, lfo))``), flanger (a chorus swept under ~10 ms),
stereo spread (a 2-channel ``delay`` reads each channel at its own moving
offset).
"""

from __future__ import annotations

import numpy as np

from signals_tpu_torch import SignalFlags
from signals_tpu_torch.core.state import Param, all_of, ge, instance_of
from signals_tpu_torch.graph import (
    BlockCachingEmitter,
    ImplicitChannels,
    KernelCtx,
    Receiver,
    port,
)
from signals_tpu_torch.registry import register

F32 = np.float32


@register('signals_tpu.nodes.moddelay.FracDelay')
class FracDelay(BlockCachingEmitter, ImplicitChannels, Receiver):
    """Linearly interpolated moving delay read.

    ``input`` is delayed by the ``delay`` signal (seconds, audio rate,
    broadcastable: a constant is a static fractional delay, an LFO a chorus
    sweep, a multi-channel signal a per-channel spread), clamped to ``[0,
    max_delay]``.  ``max_delay`` (seconds) is structural: it sizes the
    context lookback.  A ramping delay shifts the pitch (rate ``1 -
    d'(t)``): vibrato.  Frames before the stream start read as silence in
    both engines.
    """

    input: Receiver.BoundPort = port('input')
    delay: Receiver.BoundPort = port('delay')

    class State(BlockCachingEmitter.State):
        #: structural: maximum delay in seconds (sizes the lookback)
        max_delay: float = Param(
            0.05, validate=all_of(instance_of(float), ge(1e-4)))

    @classmethod
    def flags(cls) -> SignalFlags:
        return super().flags() | SignalFlags.EFFECT

    def lookback_frames(self, rate: int) -> int:
        # +1: the linear interpolation reads one frame past the clamp
        return int(np.ceil(self._state.max_delay * rate)) + 1

    def kernel(self, ctx: KernelCtx):
        xp = ctx.xp
        M = self.lookback_frames(ctx.rate)
        F = ctx.nframes
        ch = self.channels
        x = ctx.in_context('input', M)
        if x.shape[0] < M + F:          # the pull engine clamps at 0
            x = xp.pad(x, ((M + F - x.shape[0], 0), (0, 0)))
        x = xp.broadcast_to(x, (M + F, ch))

        d = xp.broadcast_to(ctx.in_('delay'), (F, ch))
        df = xp.clip(d * F32(ctx.rate), F32(0.0), F32(M - 1))
        # split the integer part off BEFORE adding the frame index: ``t + M
        # - df`` in f32 quantizes the fraction at large t (a mega window
        # lowers the whole batch, t up to n*F); with the integer part
        # removed first the indices are exact int32 arithmetic at any
        # window size and the fraction's precision does not depend on t
        df_int = xp.floor(df)
        frac = df - df_int              # in [0, 1)
        # frame t of this block sits at x[M + t]; read M + t - df, between
        # a - 1 and a with a = M + t - int(df)
        t = xp.reshape(xp.arange(F, dtype=xp.int32), (F, 1))
        a = t + (M - xp.astype(df_int, xp.int32))   # in [1, M + F - 1]
        lo = xp.take_along_axis(x, a - 1, axis=0)
        hi = xp.take_along_axis(x, a, axis=0)
        return lo * frac + hi * (F32(1.0) - frac)
