"""Reading the traced slice of a run: the device's operations from
``torch.profiler`` and the union of the device's busy intervals.

Events are plain tuples ``(name, start_us, duration_us)``, so the metric
readers run on a canned trace in the CPU tests."""

from __future__ import annotations

import collections
import time


def profile(fn):
    """Run ``fn()`` (which ends by synchronising) under ``torch.profiler``
    with the device's activity alone (CUPTI: the kernels and copies, and
    the host's CUDA runtime calls; no operator recording, which would slow
    the host): ``(wall seconds, device events)``.  Ranges marked in code
    (user annotations) are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    acts = [a for a in torch.profiler.supported_activities()
            if a == ProfilerActivity.CUDA] or [ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    device = [(e.name, float(e.time_range.start),
               float(e.time_range.elapsed_us()))
              for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, 'is_user_annotation', False)]
    return wall, device


def union_us(events) -> float:
    """Microseconds covered by at least one of ``events``."""
    total, end = 0.0, float('-inf')
    for _, start, dur in sorted(events, key=lambda e: e[1]):
        stop = start + dur
        if stop <= end:
            continue
        total += stop - max(start, end)
        end = stop
    return total


def by_name(events, top: int = 10) -> list:
    """``[[name, seconds], ...]``: the ``top`` names with the most total
    duration."""
    acc = collections.Counter()
    for name, _, dur in events:
        acc[name] += dur * 1e-6
    return [[n, s] for n, s in acc.most_common(top)]


def matching(events, include, exclude=()) -> list:
    """The events whose name holds one of ``include`` and none of
    ``exclude``."""
    return [e for e in events if any(k in e[0] for k in include)
            and not any(k in e[0] for k in exclude)]
