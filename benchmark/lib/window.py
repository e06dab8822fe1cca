"""Statistics of a run's window and traced slice that several metric
readers share."""

from __future__ import annotations

import numpy as np

from benchmark.lib import roofline, trace


def call_ms(rec: dict) -> np.ndarray:
    """Each call's host time, start to end (the mix in host memory, or the
    fit call's return), in ms."""
    return np.array([(c[2] - c[0]) * 1e3 for c in rec['window']['calls']])


def wall_per(rec: dict, per: str) -> float:
    """The untraced window's wall seconds per call (``per 'calls'``) or per
    optimizer step (``'steps'``)."""
    calls = rec['window']['calls']
    units = len(calls) if per == 'calls' else sum(c[4] for c in calls)
    return rec['window']['seconds'] / units


def busy_per(rec: dict, kind: str, per: str):
    """The traced slice's device-busy seconds (the union of its kernels and
    copies) per call or per step; None outside ``kind`` or without a
    trace."""
    t = rec.get('trace')
    if rec['kind'] != kind or not t or not t['device']:
        return None
    return trace.union_us(t['device']) * 1e-6 / t[per]


def idle_ms(rec: dict, kind: str, per: str):
    """Milliseconds per call or step in which the device waits: the
    untraced window's wall per unit less the traced slice's device-busy
    time per unit (the profiler's cost on the host stays out)."""
    busy = busy_per(rec, kind, per)
    if busy is None:
        return None
    return (wall_per(rec, per) - busy) * 1e3


def idle_share(rec: dict, kind: str, per: str):
    """The share (%) of the untraced window in which the device waits:
    ``100 (1 - busy / wall)``, a unit's traced device-busy time over its
    untraced wall."""
    busy = busy_per(rec, kind, per)
    if busy is None:
        return None
    return 100.0 * (1.0 - busy / wall_per(rec, per))


def launches(rec: dict, kind: str, per: str):
    """Device kernels and copies in the traced slice, per call (``per
    'calls'``) or per optimizer step (``'steps'``)."""
    t = rec.get('trace')
    if rec['kind'] != kind or not t or not t['device']:
        return None
    return len(t['device']) / t[per]


def kernel_share(rec: dict, kind: str, include, exclude, work, per: str):
    """A kernel's share (%) of its roofline: the least time its work needs
    (``work(shapes) -> (flops, bytes)``, one call's) over its measured
    device time a call (the events whose name holds one of ``include`` and
    none of ``exclude``, summed over the slice, divided by its calls or
    steps); None where the slice holds none of its events."""
    t = rec.get('trace')
    if rec['kind'] != kind or not t:
        return None
    events = trace.matching(t['device'], include, exclude)
    if not events:
        return None
    per_call_s = sum(e[2] for e in events) * 1e-6 / t[per]
    bound, _ = roofline.bound_s(*work(rec['shapes']))
    return 100.0 * bound / per_call_s
