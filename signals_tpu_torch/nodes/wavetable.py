"""Wavetable synthesis (``signals_tpu.nodes.wavetable``).

A single-cycle table read with linear interpolation.  The table is a
*traced* parameter, so it is a synthesis surface: any single-cycle waveform
becomes an oscillator, editable per render without recompiling and
differentiable (:func:`signals_tpu_torch.learn.fit` can fit the waveform
itself to target audio: the read is an index into the table, whose
backward adds each output's cotangent into the two entries it read).

The phase path follows :mod:`signals_tpu_torch.nodes.osc`'s bit-parity
discipline (primitive frac, multiply by the host-precomputed reciprocal
rate).
"""

from __future__ import annotations

import numpy as np

from signals_tpu_torch import SignalFlags
from signals_tpu_torch.core.state import Param, array_2d
from signals_tpu_torch.graph import (
    BlockCachingEmitter,
    ImplicitChannels,
    KernelCtx,
    Receiver,
    port,
)
from signals_tpu_torch.nodes.osc import _frac
from signals_tpu_torch.registry import register

F32 = np.float32


def _default_table() -> np.ndarray:
    # one sine cycle, 1024 samples: replace with any single-cycle waveform
    t = np.arange(1024, dtype=np.float32) / 1024.0
    return np.sin(2 * np.pi * t).astype(np.float32).reshape(-1, 1)


@register('signals_tpu.nodes.wavetable.Wavetable')
class Wavetable(BlockCachingEmitter, ImplicitChannels):
    """Single-cycle wavetable oscillator with linear interpolation.

    ``table`` is a traced ``(length, 1)`` array param: editable (and
    trainable) without recompiling, as long as its length is unchanged.
    ``hertz``/``phase`` behave exactly like the analytic oscillators'.
    """

    hertz: Receiver.BoundPort = port('hertz')
    phase: Receiver.BoundPort = port('phase')

    class State(BlockCachingEmitter.State):
        table: np.ndarray = Param(
            _default_table,
            validate=array_2d,
            convert=lambda v: np.asarray(v, dtype=np.float32)
            if isinstance(v, (np.ndarray, list, tuple)) else v,
            traced=True)

    @classmethod
    def flags(cls) -> SignalFlags:
        return super().flags() | SignalFlags.GENERATOR

    def kernel(self, ctx: KernelCtx):
        xp = ctx.xp
        table = ctx.param('table')
        n = table.shape[0]
        hertz = ctx.in_block_rate('hertz')
        phase = ctx.in_block_rate('phase')
        turns = _frac(xp, ctx.frame_range * ctx.inv_rate_f32 * hertz)
        t = _frac(xp, turns + phase)
        # linear interpolation with wraparound
        x = t * F32(n)
        i0 = xp.floor(x)
        frac = x - i0
        i0 = xp.astype(i0, xp.int32)
        i1 = xp.where(i0 + 1 >= n, 0, i0 + 1)
        i0 = xp.where(i0 >= n, 0, i0)      # guard the t == 1.0 edge
        wave = table[:, 0]
        y0 = wave[i0]
        y1 = wave[i1]
        return y0 + (y1 - y0) * frac
