"""Oscillators (``signals_tpu.nodes.osc``).

Phase model is stateless absolute time: ``cycles = frame_index / rate *
hertz + phase`` with ``hertz`` and ``phase`` sampled once per block.  The op
sequence is the JAX package's, chosen for cross-engine bit-parity: IEEE
remainder as ``x - floor(x)`` (two exactly rounded ops), the frame count
multiplied by the host constant ``1/rate``, no multiply-add pair an engine
could contract.  The CUDA generator kernel
(:func:`~signals_tpu_torch.compiler.kernels.sosfilt_segments_gen`) repeats
this sequence with round-to-nearest intrinsics.
"""

from __future__ import annotations

import abc

import numpy as np

from signals_tpu_torch import SignalFlags
from signals_tpu_torch.graph import (
    BlockCachingEmitter,
    ImplicitChannels,
    KernelCtx,
    Receiver,
    port,
)
from signals_tpu_torch.registry import register

F32 = np.float32


def _frac(xp, x):
    """``x mod 1`` as primitive IEEE ops (``xp.mod`` is a composite whose
    sequence differs between backends)."""
    return x - xp.floor(x)


def _frac_half(xp, x):
    """``x mod 0.5`` via the same primitive-op trick (scaling by powers of
    two is exact)."""
    return F32(0.5) * _frac(xp, x * F32(2.0))


class Osc(BlockCachingEmitter, ImplicitChannels, abc.ABC):
    hertz: Receiver.BoundPort = port('hertz')
    phase: Receiver.BoundPort = port('phase')

    @classmethod
    def flags(cls) -> SignalFlags:
        return super().flags() | SignalFlags.GENERATOR

    def kernel(self, ctx: KernelCtx):
        # phase: cycles ; hertz: cycles/second — both at block rate
        phase = ctx.in_block_rate('phase')
        hertz = ctx.in_block_rate('hertz')
        xp = ctx.xp
        # frames * (seconds/frame) * (cycles/second), reduced to one cycle
        # before the phase offset and the periodic function
        turns = _frac(xp, ctx.frame_range * ctx.inv_rate_f32 * hertz)
        t = _frac(xp, turns + phase)
        return self._osc(ctx, t)

    @abc.abstractmethod
    def _osc(self, ctx, t):
        raise NotImplementedError


@register('signals.chain.osc.Sine')
class Sine(Osc):
    """Sine via the shared cross-engine polynomial
    (:func:`signals_tpu_torch.core.mathx.sin2pi`)."""

    def _osc(self, ctx, t):
        from signals_tpu_torch.core.mathx import sin2pi
        return sin2pi(ctx.xp, t)   # t already reduced to [0, 1)


@register('signals.chain.osc.Square')
class Square(Osc):

    def _osc(self, ctx, t):
        xp = ctx.xp
        return xp.sign(F32(0.5) - _frac(xp, t))


@register('signals.chain.osc.Sawtooth')
class Sawtooth(Osc):

    def _osc(self, ctx, t):
        xp = ctx.xp
        return F32(2.0) * _frac(xp, t - F32(0.5)) - F32(1.0)


@register('signals.chain.osc.Triangle')
class Triangle(Osc):

    def _osc(self, ctx, t):
        xp = ctx.xp
        t = t - F32(0.25)
        return ((F32(4.0) * _frac_half(xp, t) - F32(1.0))
                * xp.sign(_frac(xp, t) - F32(0.5)))
