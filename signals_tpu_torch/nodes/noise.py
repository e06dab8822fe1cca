"""Noise generators (``signals_tpu.nodes.noise``; reference
``src/signals/chain/noise.py``).

Noise is counter-based (:mod:`signals_tpu_torch.core.rng`): a pure function
of ``(seed, frame, channel)``, so every engine produces identical samples
and seeking/replay is exact.  Parity with the reference is
distribution-level (uniform [0, 1)), the only property the reference
guarantees.  A source hashes at its own ``channels`` width: a mono source
under a wide consumer is one timeline that the consumer broadcasts.
"""

from __future__ import annotations

import abc

import numpy as np

from signals_tpu_torch import SignalFlags
from signals_tpu_torch.core.rng import uniform01
from signals_tpu_torch.core.state import Param, instance_of
from signals_tpu_torch.graph import (
    BlockCachingEmitter,
    ExplicitChannelsEmitter,
    KernelCtx,
    Receiver,
    port,
)
from signals_tpu_torch.registry import register

F32 = np.float32


class Noise(ExplicitChannelsEmitter, BlockCachingEmitter, abc.ABC):

    class State(ExplicitChannelsEmitter.State):
        seed: int = Param(0, validate=instance_of(int), traced=True)

    @classmethod
    def flags(cls) -> SignalFlags:
        return super().flags() | SignalFlags.GENERATOR


@register('signals.chain.noise.White')
class White(Noise):

    def kernel(self, ctx: KernelCtx):
        return uniform01(ctx.xp, ctx.param('seed'), ctx.frame_range_int,
                         self._state.channels)


@register()
class Pink(Noise):
    """~1/f noise in [0, 1) via Voss-McCartney: the sum of 16 octave-rate
    sample-and-hold white sources, each a pure counter hash of
    ``frame >> k`` (an arithmetic shift of the signed frame index) —
    stateless, seek-stable, and identical across engines like
    :class:`White`."""

    OCTAVES = 16

    def kernel(self, ctx: KernelCtx):
        xp = ctx.xp
        n = ctx.frame_range_int
        seed = ctx.param('seed')
        ch = self._state.channels
        total = uniform01(xp, seed, n, ch)
        for k in range(1, self.OCTAVES):
            total = total + uniform01(xp, seed, n >> k, ch, salt=k)
        return total * F32(1.0 / self.OCTAVES)


@register()
class SampleHold(Noise, Receiver):
    """Random sample-and-hold LFO: a fresh uniform [0, 1) value held for
    ``1/rate`` seconds (``rate`` in Hz at block rate) — the classic
    "random" modulation source.  The hold index is an absolute-time pure
    function (like oscillator phase), so it is seekable and engine-exact."""

    rate: Receiver.BoundPort = port('rate')

    def kernel(self, ctx: KernelCtx):
        xp = ctx.xp
        hold_hz = ctx.in_block_rate('rate')           # (1, c)
        # same discipline as Osc phase: multiply by the host-exact 1/rate
        idx_f = xp.floor(ctx.frame_range * ctx.inv_rate_f32 * hold_hz)
        idx = xp.astype(idx_f, xp.int32)              # (F, c)
        seed = ctx.param('seed')
        ch = max(self._state.channels, idx.shape[1])
        idx = xp.broadcast_to(idx, (idx.shape[0], ch))
        cols = [uniform01(xp, seed, idx[:, c:c + 1], 1, salt=c + 1)
                for c in range(ch)]
        return xp.concatenate(cols, axis=1) if ch > 1 else cols[0]
