"""Auxiliary subsystems (``signals_tpu.utils``): so far
:class:`LatencyStats`, the per-block render-time metrics (p50/p95/max,
realtime headroom) the :class:`~signals_tpu_torch.runtime.Transport` loop
feeds."""

from __future__ import annotations

import numpy as np


class LatencyStats:
    """Rolling per-block latency collector."""

    def __init__(self, *, window: int = 512):
        self.window = window
        self._times: list[float] = []
        self.total_blocks = 0

    def record(self, seconds: float) -> None:
        self.total_blocks += 1
        self._times.append(seconds)
        if len(self._times) > self.window:
            del self._times[:len(self._times) - self.window]

    def percentile(self, q: float) -> float:
        if not self._times:
            return 0.0
        return float(np.percentile(self._times, q))

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p95(self) -> float:
        return self.percentile(95)

    @property
    def worst(self) -> float:
        return max(self._times, default=0.0)

    def headroom(self, block_frames: int, rate: int) -> float:
        """How many times realtime the p50 block render is."""
        budget = block_frames / rate
        p50 = self.p50
        return budget / p50 if p50 > 0 else float('inf')

    def summary(self, block_frames: int, rate: int) -> dict:
        return {
            'blocks': self.total_blocks,
            'p50_ms': self.p50 * 1e3,
            'p95_ms': self.p95 * 1e3,
            'worst_ms': self.worst * 1e3,
            'x_realtime_p50': self.headroom(block_frames, rate),
        }
