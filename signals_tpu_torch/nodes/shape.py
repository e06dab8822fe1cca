"""Channel-shape manipulation (``signals_tpu.nodes.shape``; reference
``src/signals/chain/shape.py``).

The kernels are written against ``ctx.xp`` and serve both engines.  The
reference's axes are kept fixed as the JAX package fixes them:
``Flatten``/``Select`` reduce and index the CHANNEL axis and stay 2-D
(the reference's ``shape.py:35,57`` use the frame axis), and ``Merge``
broadcasts each side to its full ``(frames, channels)`` extent before the
concatenation, so constant (1×1) and unplugged inputs merge
(``shape.py:69-74`` crashes there).
"""

from __future__ import annotations

import abc

import numpy as np

from signals_tpu_torch import SignalFlags
from signals_tpu_torch.core.state import Param, all_of, ge, instance_of
from signals_tpu_torch.graph import (
    BlockCachingEmitter,
    KernelCtx,
    Receiver,
    port,
)
from signals_tpu_torch.registry import register


class Shaper(BlockCachingEmitter, Receiver, abc.ABC):

    @classmethod
    def flags(cls) -> SignalFlags:
        return super().flags() | SignalFlags.EFFECT


class Scalar(Shaper, abc.ABC):
    input: Receiver.BoundPort = port('input')

    @property
    def channels(self) -> int:
        return 1


@register('signals.chain.shape.Flatten')
class Flatten(Scalar):
    """Sum all channels into one."""

    def kernel(self, ctx: KernelCtx):
        return ctx.xp.sum(ctx.in_full('input'), axis=1, keepdims=True)


@register('signals.chain.shape.FlattenUnit')
class FlattenUnit(Scalar):
    """Mean of all channels."""

    def kernel(self, ctx: KernelCtx):
        return ctx.xp.mean(ctx.in_full('input'), axis=1, keepdims=True)


@register('signals.chain.shape.Select')
class Select(Scalar):
    """Pick one channel by index; silence when the index is out of range
    (reference ``shape.py:44-57``, kept 2-D)."""

    class State(Scalar.State):
        index: int = Param(0, validate=all_of(instance_of(int), ge(0)))

    def kernel(self, ctx: KernelCtx):
        ch = ctx.in_channels('input')
        idx = self._state.index
        if ch is None or idx >= ch:
            return np.zeros((1, 1), dtype=np.float32)
        return ctx.in_full('input')[:, idx:idx + 1]


@register('signals.chain.shape.Merge')
class Merge(Shaper):
    """Concatenate the channels of both inputs (reference
    ``shape.py:60-74``), each side broadcast to its full ``(frames,
    channels)`` extent first."""

    left: Receiver.BoundPort = port('left')
    right: Receiver.BoundPort = port('right')

    @property
    def channels(self) -> int:
        return sum(inp.channels for inp in self.inputs_by_port.values()) or 1

    def kernel(self, ctx: KernelCtx):
        xp = ctx.xp
        parts = []
        for name in ('left', 'right'):
            ch = ctx.in_channels(name)
            if ch is None:
                continue
            block = ctx.in_full(name)
            parts.append(xp.broadcast_to(block, (ctx.nframes, ch)))
        if not parts:
            return np.zeros((1, 1), dtype=np.float32)
        return xp.concatenate(parts, axis=1)
