"""Auxiliary subsystems (``signals_tpu.utils``): profiling, metrics,
checkpointing.

* :class:`LatencyStats` — per-block render-time metrics (p50/p95/max,
  realtime headroom), fed by the :class:`~signals_tpu_torch.runtime.
  Transport` loop; :func:`timed` records one timed region into it;
* :func:`span` — the program's own spans: named ranges at the boundaries
  of the render and fit paths, kept in memory from :func:`enable` to
  :func:`disable` and handed over by :func:`drain`; off by default, when
  a span costs one flag test;
* :func:`trace` — a ``torch.profiler`` trace of a region (the host and, on
  a GPU, the card), written as a Chrome trace with the program's spans on
  its timeline;
* :mod:`signals_tpu_torch.utils.checkpoint` — carried-state snapshots, so
  a long render (or a live performance) resumes exactly: patch text +
  position + carry, in the JAX package's ``.npz`` format.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import tempfile
import threading
import time
import typing

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


# -- spans ------------------------------------------------------------------

_spans_on = False
#: spans also open a ``torch.profiler.record_function`` range (in
#: :func:`trace`)
_spans_to_profiler = False
_records: list = []
_records_lock = threading.Lock()
_thread = threading.local()


class SpanRecord(typing.NamedTuple):
    """One span as :func:`drain` hands it over.  Times are
    ``time.perf_counter_ns()``; ``end_ns`` is None for a span still open.
    ``parent`` and ``root`` index the same drain's list: the enclosing span
    on the same thread (-1 for none) and the outermost one (the record
    itself for an outermost span), so every span of one call shares its
    ``root``."""
    name: str
    start_ns: int
    end_ns: typing.Optional[int]
    parent: int
    root: int
    thread: int


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ('name', 'record', 'range')

    def __init__(self, name: str):
        self.name = name
        self.range = None

    def __enter__(self):
        stack = getattr(_thread, 'stack', None)
        if stack is None:
            stack = _thread.stack = []
        with _records_lock:
            index = len(_records)
            self.record = [self.name, 0, None,
                           stack[-1] if stack else -1,
                           stack[0] if stack else index,
                           threading.get_ident()]
            _records.append(self.record)
        stack.append(index)
        if _spans_to_profiler:
            import torch
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.record[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.record[2] = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _thread.stack.pop()
        return False


def span(name: str, detail: typing.Optional[str] = None):
    """A context manager that records the region as the span ``name``
    (``name + detail`` where ``detail`` is given, so a caller builds no
    string while spans are off) while spans are enabled; otherwise one
    shared no-op context."""
    if not _spans_on:
        return _NO_SPAN
    return _Span(name if detail is None else name + detail)


def enable() -> None:
    """Record spans from now on (in memory, until :func:`drain`)."""
    global _spans_on
    _spans_on = True


def disable() -> None:
    """Stop recording spans; what was recorded stays for :func:`drain`."""
    global _spans_on
    _spans_on = False


def drain() -> list[SpanRecord]:
    """The spans recorded since the last drain, in the order they opened,
    and forget them.  Drain between calls: a span open across a drain
    keeps its place in the old list."""
    global _records
    with _records_lock:
        out, _records = _records, []
    return [SpanRecord(*r) for r in out]


def self_ns(records: typing.Sequence[SpanRecord]) -> list[int]:
    """Each closed span's self time: its duration less the time its direct
    children cover (children on one thread run one after another)."""
    out = [r.end_ns - r.start_ns for r in records]
    for r in records:
        if r.parent >= 0:
            out[r.parent] -= r.end_ns - r.start_ns
    return out


@contextlib.contextmanager
def trace(log_dir=None):
    """Trace the region with ``torch.profiler`` — host ops and, where torch
    sees a GPU, the card's kernels and copies — and write it as a Chrome
    trace (``chrome://tracing``, Perfetto) into ``log_dir`` (default
    ``signals_tpu_torch_trace`` under the temporary directory).  Spans are
    on in the region, each a ``record_function`` range on the trace's
    timeline; the spans that it recorded stay for :func:`drain` only where
    they were on before.  Yields the directory."""
    global _spans_to_profiler
    import torch
    from torch.profiler import ProfilerActivity, profile
    log_dir = pathlib.Path(log_dir if log_dir is not None else
                           pathlib.Path(tempfile.gettempdir())
                           / 'signals_tpu_torch_trace')
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    was_on, kept = _spans_on, len(_records)
    with profile(activities=activities) as prof:
        enable()
        _spans_to_profiler = True
        try:
            yield log_dir
        finally:
            _spans_to_profiler = False
            if not was_on:
                disable()
                with _records_lock:
                    del _records[kept:]
    prof.export_chrome_trace(
        str(log_dir / f'trace_{os.getpid()}_{time.time_ns()}.json'))
