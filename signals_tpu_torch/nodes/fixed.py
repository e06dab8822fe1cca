"""Constant signals (reference ``src/signals/chain/fixed.py``)."""

from __future__ import annotations

import numpy as np

from signals_tpu_torch import SignalFlags
from signals_tpu_torch.core import Shape
from signals_tpu_torch.core.state import Param, array_2d
from signals_tpu_torch.graph import Emitter, KernelCtx
from signals_tpu_torch.registry import register


def _empty_value() -> np.ndarray:
    return np.zeros((1, 1), dtype=np.float32)


@register('signals.chain.fixed.Fixed')
class Fixed(Emitter):
    """Emits a stored 2-D array regardless of the requested loc, relying on
    broadcast shape semantics (1×1 constants; reference ``fixed.py:38-39``).

    ``value`` is a traced parameter: editing it feeds a new array into the
    compiled program without recompiling — unless its *shape* changes, which
    is structural (channel inference depends on it).
    """

    class State(Emitter.State):
        value: np.ndarray = Param(
            _empty_value,
            validate=array_2d,
            convert=lambda v: np.asarray(v, dtype=np.float32)
            if isinstance(v, (np.ndarray, list, tuple)) else v,
            traced=True)

    @classmethod
    def flags(cls) -> SignalFlags:
        return super().flags()

    @property
    def channels(self) -> int:
        return Shape.of_array(self._state.value).channels

    def kernel(self, ctx: KernelCtx):
        return ctx.param('value')
