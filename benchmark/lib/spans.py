"""The program's own spans and copy counters in a traced run, and the
device's idle gaps named by them.

The program (``signals_tpu_torch``) records spans at the boundaries of its
render and fit paths while ``utils.enable()`` is on (``poly.render``,
``poly.params``, ``poly.plan``, ``lower.<Node>``, ``fit.forward``, ...)
and counts its host-to-device copies in ``kernels.COPIES``.  In a run with
``--trace 1`` the first reader of a span metric calls :func:`collect`,
which builds the cell's system again from the run's configuration and
traffic (the harness has freed its own by then; the seed is :data:`SEED`,
as the slices time the calls and compare nothing), warms it, and runs two
slices of the traffic's ``trace_calls`` calls with spans on:

* a slice without the profiler, whose spans and counters the readers take
  (CUPTI slows the host's side of a call);
* a profiled slice (the device's activity, as ``lib/trace.py`` records it,
  with correlation ids): its device operations are moved onto the spans'
  clock (``time.perf_counter_ns``) by anchors, synchronisations that the
  host brackets at its start and end, and each idle gap of the device is
  named by the innermost span that covers most of it; each operation's
  device time is put down to the innermost span open at its launch.

Both go to ``rec['spans']`` and to the log.  Where the program has no
spans (an older checkout) or the traced slice saw no device (no card),
:func:`collect` builds nothing and the readers read nothing.

Spans are ``SpanRecord``-like tuples ``(name, start_ns, end_ns, parent,
root, thread)``; device operations ``(name, start_ns, dur_ns, launch_ns)``
on the spans' clock, so the functions below run on canned numbers in the
CPU tests.  Named gaps and device time by span come out as events in
``lib/trace.py``'s form, ``(name, start_us, dur_us)``, which its
``by_name`` sums.
"""

from __future__ import annotations

import bisect
import collections
import gc
import sys
import time

from benchmark.lib import trace as tr

NONE = '(none)'
#: the seed the spans' slices build the system from
SEED = 0
#: synchronisations bracketed by the host's clock at each end of the
#: profiled slice, and the pause before each (no other runtime call lies
#: near one)
ANCHORS = 8
ANCHOR_PAUSE_S = 1e-3


def _stderr(msg):
    print(msg, file=sys.stderr, flush=True)


def program():
    """``(utils, kernels)`` of the program where it records spans and
    counts its copies; None otherwise."""
    from signals_tpu_torch import utils
    from signals_tpu_torch.compiler import kernels
    if not (all(hasattr(utils, n) for n in ('span', 'enable', 'disable',
                                            'drain'))
            and hasattr(kernels, 'COPIES')):
        return None
    return utils, kernels


# -- the clock -------------------------------------------------------------


def anchor(brackets, calls, offset_ns: int):
    """``(offset, uncertainty, at)`` in ns: the spans' clock less the
    profiler's, from runtime calls the host bracketed.  ``brackets``: the
    host's reads ``(before, after)`` around each call (the spans' clock);
    ``calls``: ``(start, dur)`` of the profiler's events of that kind (its
    clock), each bracket's own found as the one nearest it under the
    offset known so far (``offset_ns`` at first).  A call lies inside its
    bracket, so each bounds the offset to ``[before - start, after - start
    - dur]``; the offset is the middle of all the bounds' intersection and
    the uncertainty half its width (negative where they do not meet);
    ``at`` is the middle of the brackets on the spans' clock."""
    lo, hi = -float('inf'), float('inf')
    for before, after in brackets:
        start, dur = nearest(calls, before, offset_ns)
        lo = max(lo, before - start)
        hi = min(hi, after - start - dur)
        offset_ns = int(lo + hi) // 2
    at = (brackets[0][0] + brackets[-1][1]) // 2
    return offset_ns, (hi - lo) / 2, at


def nearest(calls, at_ns: int, offset_ns: int):
    """The ``(start_ns, dur_ns)`` of ``calls`` whose start, moved by
    ``offset_ns``, lies nearest ``at_ns``."""
    return min(calls, key=lambda c: abs(c[0] + offset_ns - at_ns))


# -- gaps and spans --------------------------------------------------------


def idle_gaps(ops) -> list:
    """``[(start_ns, end_ns), ...]``: the intervals between the first and
    the last of ``ops`` (``(name, start_ns, dur_ns, ...)``) that no
    operation covers."""
    gaps, end = [], None
    for op in sorted(ops, key=lambda o: o[1]):
        if end is not None and op[1] > end:
            gaps.append((end, op[1]))
        end = op[1] + op[2] if end is None else max(end, op[1] + op[2])
    return gaps


def innermost(spans) -> list:
    """``[(start_ns, end_ns, name), ...]`` in order: where each closed
    span is the innermost one open (its interval less its children's),
    over every span of ``spans``; times no span covers are left out."""
    children = collections.defaultdict(list)
    for i, s in enumerate(spans):
        if s[3] >= 0:
            children[s[3]].append(i)
    out = []
    for i, s in enumerate(spans):
        if s[2] is None:
            continue
        at = s[1]
        for c in sorted(children[i], key=lambda c: spans[c][1]):
            if spans[c][1] > at:
                out.append((at, spans[c][1], s[0]))
            if spans[c][2] is not None:
                at = max(at, spans[c][2])
        if s[2] > at:
            out.append((at, s[2], s[0]))
    out.sort()
    return out


def name_gaps(gaps, segments) -> list:
    """``[(name, start_us, dur_us), ...]`` a gap each: its name is the span
    that is innermost over most of it (:func:`innermost`'s ``segments``),
    :data:`NONE` where no span covers most of it."""
    starts = [s[0] for s in segments]
    out = []
    for g0, g1 in gaps:
        cover = collections.Counter()
        i = max(bisect.bisect_right(starts, g0) - 1, 0)
        while i < len(segments) and segments[i][0] < g1:
            s0, s1, name = segments[i]
            overlap = min(s1, g1) - max(s0, g0)
            if overlap > 0:
                cover[name] += overlap
            i += 1
        cover[NONE] += (g1 - g0) - sum(cover.values())
        out.append((cover.most_common(1)[0][0], g0 * 1e-3, (g1 - g0) * 1e-3))
    return out


def by_launch(ops, segments) -> list:
    """``[(name, launch_us, dur_us), ...]`` an operation each: the
    innermost span open at its launch (:data:`NONE` outside every span,
    ``(not matched)`` where its launch was not found)."""
    starts = [s[0] for s in segments]
    out = []
    for op in ops:
        launch = op[3]
        name = '(not matched)'
        if launch is not None:
            i = bisect.bisect_right(starts, launch) - 1
            name = (segments[i][2] if i >= 0 and segments[i][1] > launch
                    else NONE)
        out.append((name, None if launch is None else launch * 1e-3,
                    op[2] * 1e-3))
    return out


# -- the readers' side -----------------------------------------------------


def total_ms(records, name: str) -> float:
    return sum(r[2] - r[1] for r in records if r[0] == name) * 1e-6


def count(records, name: str) -> int:
    return sum(1 for r in records if r[0] == name)


def _units(rec: dict, kind: str, unit: str):
    """``(rec['spans'], how many spans named unit)``; ``(None, 0)`` outside
    ``kind``, without spans or without such a span."""
    got = collect(rec) if rec['kind'] == kind else None
    n = count(got['records'], unit) if got else 0
    return (got, n) if n else (None, 0)


def per(rec: dict, kind: str, name: str, unit: str):
    """Milliseconds of span ``name`` per ``unit`` span (``poly.render``: a
    call; ``fit.forward``: a step) in the slice without the profiler;
    None outside ``kind`` or without spans."""
    got, n = _units(rec, kind, unit)
    return total_ms(got['records'], name) / n if n else None


def copies_per_call(rec: dict, key: str = 'h2d_copies'):
    """The program's host-to-device copies (``key='h2d_bytes'``: their
    bytes) per ``poly.render`` span in the slice without the profiler."""
    got, n = _units(rec, 'render', 'poly.render')
    return got['copies'][key] / n if n else None


# -- the slices ------------------------------------------------------------


def collect(rec: dict, log=_stderr):
    """``rec['spans']``, measured on the first call (see the module's
    text); None where the program has no spans or the traced slice saw no
    device."""
    if 'spans' in rec:
        return rec['spans']
    rec['spans'] = None
    t = rec.get('trace')
    if not t or not t['device'] or program() is None:
        return None
    import torch
    device = torch.device('cuda', torch.cuda.current_device())
    got = measure(rec['config'], rec['traffic'], SEED, device, log)
    calls = rec['window']['calls']
    log(f'spans: the spans slice took {got["slice_s"] / got["calls"]!r} s '
        f'a call, the window {rec["window"]["seconds"] / len(calls)!r}')
    rec['spans'] = got
    return got


def measure(cfg: dict, traffic: dict, seed: int, device, log=_stderr) -> dict:
    """Build the configuration's system for ``traffic`` from ``seed`` on
    ``device``, warm it, and run the slice of spans alone, then (on a
    card) the profiled slice; free the system."""
    import torch
    from benchmark.lib import harness
    utils, kernels = program()
    t0 = time.perf_counter()
    system = harness.load_file(
        harness.BENCH / 'configs' / f'{cfg["name"]}.py').build(
            cfg, seed, device, traffic)
    driver = harness.load_file(
        harness.BENCH / 'drivers' / f'{traffic["kind"]}.py',
        f'bench_driver_{traffic["kind"]}').Driver(traffic, system, seed)
    driver.warm()
    n = traffic['trace_calls']
    kernels.reset_copy_counts()
    utils.drain()
    t1 = time.perf_counter()
    utils.enable()
    try:
        for _ in range(n):
            driver.call()
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
    finally:
        utils.disable()
    t2 = time.perf_counter()
    out = {'calls': n, 'slice_s': t2 - t1, 'records': utils.drain(),
           'copies': dict(kernels.COPIES)}
    if device.type == 'cuda':
        out.update(profiled(driver, n, device, utils, log))
    log(f'spans: system rebuilt and warm in {t1 - t0:.3f} s, spans slice of '
        f'{n} calls {t2 - t1:.3f} s, profiled slice '
        f'{time.perf_counter() - t2:.3f} s; {len(out["records"])} spans, '
        f'copies {out["copies"]}')
    log(f'spans: self seconds by name over the {n} calls, top 10: '
        + repr(tr.by_name((r[0], r[1] * 1e-3, s * 1e-3) for r, s in zip(
            out['records'], utils.self_ns(out['records'])))))
    del system, driver
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    return out


def profiled(driver, n: int, device, utils, log=_stderr) -> dict:
    """``n`` calls under ``torch.profiler`` (the device's activity) with
    spans on, between two groups of anchors (:func:`analyse`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    def brackets():
        out = []
        for _ in range(ANCHORS):
            time.sleep(ANCHOR_PAUSE_S)
            before = time.perf_counter_ns()
            torch.cuda.synchronize()
            out.append((before, time.perf_counter_ns()))
        time.sleep(ANCHOR_PAUSE_S)
        return out

    torch.cuda.synchronize(device)
    utils.drain()
    with torch.profiler.profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        rough = time.time_ns() - time.perf_counter_ns()
        first = brackets()
        utils.enable()
        try:
            for _ in range(n):
                driver.call()
            torch.cuda.synchronize(device)
        finally:
            utils.disable()
        last = brackets()
    ops, runtime = [], []
    for e in prof.profiler.kineto_results.events():
        if not e.is_user_annotation():
            (ops if e.device_type() == DeviceType.CUDA else runtime).append(
                (e.name(), e.start_ns(), e.duration_ns(), e.correlation_id()))
    out = analyse(utils.drain(), ops, runtime, first, last, -rough)
    a = out['anchors']
    log(f'spans: anchors {a} (the two ends apart by '
        f'{a["apart_ns"] / 1e3:.3f} us)')
    log(f'spans: {out["ops"]} device ops, {out["matched"]} matched to their '
        f'launch; {out["gaps"]} idle gaps, {out["idle_s"]!r} s idle, '
        f'named by a span: share {out["named_share"]!r}')
    log(f'breakdown.idle_gaps (profiled slice, {n} calls): '
        f'{out["idle_gaps"]!r}')
    for key, what in (('device_by_span', 'device seconds'),
                      ('launches_by_span', 'device ops'),
                      ('device_by_span_op', 'device seconds by operation')):
        log(f'spans: {what} by launching span, top 10: {out[key]!r}')
    log(f'spans: host seconds in runtime calls by span, top 10: '
        f'{out["runtime_by_span"]!r}')
    return out


def analyse(records, ops, runtime, first, last, rough_ns) -> dict:
    """The profiled slice on the spans' clock.  ``ops``: the device's
    operations and ``runtime``: the host's runtime calls, each ``(name,
    start_ns, dur_ns, correlation id)`` on the profiler's clock (an
    operation's launch is the call of its correlation id); ``first`` and
    ``last``: the host's brackets ``(before_ns, after_ns)`` around the
    ``cudaDeviceSynchronize`` calls that anchor each end (:func:`anchor`); ``rough_ns``: the spans' clock less
    the profiler's to well under the anchors' spacing, which finds the
    first anchor's call.  Each time is moved by the offset interpolated
    between the two ends; the idle gaps are named (:func:`name_gaps`) and
    the operations' device time and count, and the runtime calls' host
    time, put down to the span open at their launch or start
    (:func:`by_launch`)."""
    syncs = [(start, dur) for name, start, dur, _ in runtime
             if name == 'cudaDeviceSynchronize']
    off_a, unc_a, at_a = anchor(first, syncs, rough_ns)
    off_b, unc_b, at_b = anchor(last, syncs, off_a)

    def moved(t):
        return t + off_a + (off_b - off_a) * (t + off_a - at_a) // max(
            at_b - at_a, 1)

    launches = {c: start for _, start, _, c in runtime if c}
    ops = [(name, moved(start), dur,
            moved(launches[c]) if c in launches else None)
           for name, start, dur, c in ops]
    calls = [(name, moved(start), dur, moved(start))
             for name, start, dur, _ in runtime]
    segments = innermost(records)
    gaps = name_gaps(idle_gaps(ops), segments)
    idle_s = sum(g[2] for g in gaps) * 1e-6
    named_s = sum(g[2] for g in gaps if g[0] != NONE) * 1e-6
    launched = by_launch(ops, segments)
    return {'anchors': {'first_ns': off_a, 'first_unc_ns': unc_a,
                        'last_ns': off_b, 'last_unc_ns': unc_b,
                        'apart_ns': off_b - off_a},
            'ops': len(ops), 'matched': sum(o[3] is not None for o in ops),
            'gaps': len(gaps), 'idle_s': idle_s,
            'named_share': named_s / idle_s if idle_s else None,
            'idle_gaps': tr.by_name(gaps),
            'device_by_span': tr.by_name(launched),
            'launches_by_span': [list(c) for c in collections.Counter(
                e[0] for e in launched).most_common(10)],
            'device_by_span_op': tr.by_name(
                (f'{e[0]} | {op[0][:160]}', e[1], e[2])
                for e, op in zip(launched, ops)),
            'runtime_by_span': tr.by_name(
                (f'{e[0]} | {call[0]}', e[1], e[2]) for e, call in zip(
                    by_launch(calls, segments), calls))}
