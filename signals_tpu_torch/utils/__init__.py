"""Auxiliary subsystems (``signals_tpu.utils``): profiling, metrics,
checkpointing.

* :class:`LatencyStats` — per-block render-time metrics (p50/p95/max,
  realtime headroom), fed by the :class:`~signals_tpu_torch.runtime.
  Transport` loop; :func:`timed` records one timed region into it;
* :func:`trace` — a ``torch.profiler`` trace of a region (the host and, on
  a GPU, the card), written as a Chrome trace;
* :mod:`signals_tpu_torch.utils.checkpoint` — carried-state snapshots, so
  a long render (or a live performance) resumes exactly: patch text +
  position + carry, in the JAX package's ``.npz`` format.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import tempfile
import time

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


@contextlib.contextmanager
def timed(stats: LatencyStats):
    """Record the region's host time (seconds) into ``stats``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        stats.record(time.perf_counter() - t0)


@contextlib.contextmanager
def trace(log_dir=None):
    """Trace the region with ``torch.profiler`` — host ops and, where torch
    sees a GPU, the card's kernels and copies — and write it as a Chrome
    trace (``chrome://tracing``, Perfetto) into ``log_dir`` (default
    ``signals_tpu_torch_trace`` under the temporary directory).  Yields
    the directory."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    log_dir = pathlib.Path(log_dir if log_dir is not None else
                           pathlib.Path(tempfile.gettempdir())
                           / 'signals_tpu_torch_trace')
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(
        str(log_dir / f'trace_{os.getpid()}_{time.time_ns()}.json'))
