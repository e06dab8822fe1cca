"""The program's spans in the benchmark (``lib/spans.py``): the readers
over canned spans, the idle gaps named over canned device operations, the
anchors that move the profiler's events onto the spans' clock, and the
slices at ``test_bench_harness``'s tiny sizes on the CPU."""

import pytest
import torch

from benchmark.lib import harness, spans, trace
from benchmark.tests import test_bench_harness as shared

BENCH = harness.BENCH
SPEC = shared.SPEC
CPU = torch.device('cpu')
NEW = {'params_ms.render', 'plan_ms.render', 'h2d_copies.render',
       'h2d_bytes.render', 'forward_ms.fit', 'backward_ms.fit',
       'update_ms.fit', 'sync_ms.fit'}
reader = shared.reader


def span(name, start, end, parent=-1, root=0):
    return (name, start, end, parent, root, 1)


# -- the readers -----------------------------------------------------------


def render_spans():
    """Two render calls: 1 ms of ``poly.params`` and 4 ms of ``poly.plan``
    each, the first with a lowering inside the plan."""
    recs = []
    for k, t in enumerate((0, 10_000_000)):
        r = len(recs)
        recs += [span('poly.render', t, t + 6_000_000, -1, r),
                 span('poly.params', t + 100_000, t + 1_100_000, r, r),
                 span('poly.plan', t + 1_500_000, t + 5_500_000, r, r)]
        if k == 0:
            recs.append(span('lower.LowPass', t + 2_000_000, t + 3_000_000,
                             r + 2, r))
    return recs


def fit_spans():
    """One fit call of two steps and one sync."""
    recs = [span('poly.fit', 0, 50_000_000)]
    t = 1_000_000
    for _ in range(2):
        for name, ms in (('fit.forward', 5), ('fit.backward', 8),
                         ('fit.update', 1)):
            recs.append(span(name, t, t + ms * 1_000_000, 0, 0))
            t += ms * 1_000_000
    recs.append(span('fit.sync', t, t + 3_000_000, 0, 0))
    return recs


def canned(kind, records, copies=0, nbytes=0):
    return {'kind': kind, 'trace': None,
            'spans': {'calls': 2, 'records': records,
                      'copies': {'h2d_copies': copies, 'h2d_bytes': nbytes}}}


def test_render_readers_over_canned_spans():
    rec = canned('render', render_spans(), copies=70, nbytes=4280)
    assert reader('params_ms.render').read(rec) == pytest.approx(1.0)
    assert reader('plan_ms.render').read(rec) == pytest.approx(4.0)
    assert reader('h2d_copies.render').read(rec) == 35.0
    assert reader('h2d_bytes.render').read(rec) == 2140.0
    for name in ('forward_ms.fit', 'backward_ms.fit', 'update_ms.fit',
                 'sync_ms.fit'):
        assert reader(name).read(rec) is None, name


def test_fit_readers_over_canned_spans():
    rec = canned('fit', fit_spans())
    assert reader('forward_ms.fit').read(rec) == pytest.approx(5.0)
    assert reader('backward_ms.fit').read(rec) == pytest.approx(8.0)
    assert reader('update_ms.fit').read(rec) == pytest.approx(1.0)
    assert reader('sync_ms.fit').read(rec) == pytest.approx(1.5)
    for name in ('params_ms.render', 'plan_ms.render', 'h2d_copies.render',
                 'h2d_bytes.render'):
        assert reader(name).read(rec) is None, name


def test_readers_read_nothing_without_spans(monkeypatch):
    """An older program (no spans) and a slice with no device: nothing is
    built and nothing read."""
    rec = {'kind': 'render', 'trace': {'device': [('k', 0.0, 1.0)]},
           'config': {}, 'traffic': {}}
    monkeypatch.setattr(spans, 'program', lambda: None)
    assert reader('params_ms.render').read(rec) is None
    assert rec['spans'] is None
    rec = {'kind': 'fit', 'trace': {'device': []}}
    assert reader('forward_ms.fit').read(rec) is None


# -- gaps named by spans ---------------------------------------------------


def test_idle_gaps_are_the_complement_of_the_operations():
    ops = [('a', 0, 10, None), ('b', 5, 10, None), ('c', 30, 5, None),
           ('d', 50, 10, None)]
    assert spans.idle_gaps(ops) == [(15, 30), (35, 50)]


def test_innermost_span_segments():
    segs = spans.innermost(render_spans())
    assert segs[:5] == [(0, 100_000, 'poly.render'),
                        (100_000, 1_100_000, 'poly.params'),
                        (1_100_000, 1_500_000, 'poly.render'),
                        (1_500_000, 2_000_000, 'poly.plan'),
                        (2_000_000, 3_000_000, 'lower.LowPass')]
    assert sum(e - s for s, e, _ in segs) == 12_000_000


def test_gaps_named_by_the_span_that_covers_most_of_them():
    segs = spans.innermost(render_spans())
    gaps = [(2_200_000, 2_800_000),      # inside lower.LowPass
            (2_900_000, 3_300_000),      # mostly in the plan after it
            (6_500_000, 9_500_000),      # between the calls
            (9_900_000, 10_300_000)]     # mostly in the second params
    named = spans.name_gaps(gaps, segs)
    assert [n for n, _, _ in named] == ['lower.LowPass', 'poly.plan',
                                        spans.NONE, 'poly.params']
    assert named[0][1:] == pytest.approx((2200.0, 600.0))
    by = dict(trace.by_name(named))
    assert sum(by.values()) == pytest.approx(
        sum(b - a for a, b in gaps) * 1e-9)
    assert by[spans.NONE] == pytest.approx(3e-3)


def test_device_time_by_launching_span():
    segs = spans.innermost(render_spans())
    ops = [('k1', 9_000_000, 1000, 2_500_000),
           ('copy', 9_100_000, 500, 5_200_000),
           ('late', 9_200_000, 300, 8_000_000),
           ('lost', 9_300_000, 200, None)]
    got = spans.by_launch(ops, segs)
    assert [n for n, _, _ in got] == ['lower.LowPass', 'poly.plan',
                                      spans.NONE, '(not matched)']
    assert got[0][1:] == pytest.approx((2500.0, 1.0))
    assert got[3][1] is None


# -- the clock -------------------------------------------------------------


def test_anchors_bound_the_offset_by_their_brackets():
    """The profiler's clock runs 5e12 ns ahead; three brackets, 1 ms
    apart, of calls that took 6 us: each bounds the offset, and their
    intersection is narrower than any one of them."""
    ahead = 5_000_000_000_000
    calls = [(1_003_000 + ahead, 6_000), (2_001_000 + ahead, 6_000),
             (3_002_000 + ahead, 6_000), (9_000_000 + ahead, 6_000)]
    brackets = [(1_000_000, 1_010_000), (2_000_000, 2_008_000),
                (3_000_000, 3_009_000)]
    # each bracket alone: [before - start, after - start - dur]
    assert [(b - c[0], a - c[0] - c[1]) for (b, a), c in zip(
        brackets, calls)] == [(-3_000 - ahead, 1_000 - ahead),
                              (-1_000 - ahead, 1_000 - ahead),
                              (-2_000 - ahead, 1_000 - ahead)]
    off, unc, at = spans.anchor(brackets, calls, -ahead + 200_000)
    assert off == -ahead and unc == 1_000
    assert at == (1_000_000 + 3_009_000) // 2
    # brackets that cannot all hold: a negative uncertainty
    _, unc, _ = spans.anchor([(1_000_000, 1_010_000), (2_003_000, 2_008_000)],
                             calls, -ahead)
    assert unc < 0


def test_analyse_moves_the_profilers_events_onto_the_spans_clock():
    """The profiler's clock runs 5e12 ns ahead of the spans' and drifts by
    2 us over the slice; two groups of syncs anchor it (the profiler's own
    last sync lies after them), a kernel launched inside ``lower.LowPass``
    lands in it, and the gaps around add up to the idle time."""
    ahead = 5_000_000_000_000
    recs = render_spans()
    first = [(-3_000_000, -2_990_000), (-2_000_000, -1_990_000)]
    last = [(20_000_000, 20_010_000), (21_000_000, 21_010_000)]
    ops = [('k1', 2_600_000 + ahead, 100_000, 7),
           ('copy', 5_000_000 + ahead, 400_000, 8),
           ('k2', 12_000_000 + ahead, 1_000_000, 9)]
    syncs = [('cudaDeviceSynchronize', t + ahead, 4_000, 0)
             for t in (-2_997_000, -1_997_000, 20_001_000, 21_001_000,
                       22_000_000)]
    runtime = syncs + [('cudaLaunchKernel', 2_500_000 + ahead, 20_000, 7),
                       ('cudaMemcpyAsync', 5_100_000 + ahead, 300_000, 8),
                       ('cudaLaunchKernel', 11_600_000 + ahead, 10_000, 9)]
    # the rough offset is off by 300 us: the nearest sync is still right
    got = spans.analyse(recs, ops, runtime, first, last, -ahead + 300_000)
    a = got['anchors']
    assert a['first_ns'] == -ahead and a['first_unc_ns'] == 3_000
    assert a['last_ns'] == -ahead + 2_000 and a['apart_ns'] == 2_000
    assert got['matched'] == got['ops'] == 3
    assert dict(got['launches_by_span']) == {'lower.LowPass': 1,
                                             'poly.plan': 2}
    assert dict(got['device_by_span_op'])['lower.LowPass | k1'] == \
        pytest.approx(1e-4)
    assert dict(got['runtime_by_span']) == pytest.approx({
        'poly.plan | cudaMemcpyAsync': 3e-4,
        'lower.LowPass | cudaLaunchKernel': 2e-5,
        'poly.plan | cudaLaunchKernel': 1e-5,
        spans.NONE + ' | cudaDeviceSynchronize': 2e-5})
    gaps = dict(got['idle_gaps'])
    assert gaps == pytest.approx({'poly.plan': 2.3e-3,
                                  spans.NONE: 6.6e-3}, rel=1e-3)
    assert got['idle_s'] == pytest.approx(8.9e-3, rel=1e-3)
    assert got['named_share'] == pytest.approx(2.3 / 8.9, rel=1e-3)


# -- runs at a tiny size ---------------------------------------------------


def test_an_untraced_run_records_no_span():
    from signals_tpu_torch import utils
    utils.drain()
    out = shared.run_tiny('flagship-512v-bounce')
    assert utils.drain() == []
    assert not set(out['metrics']) & NEW


@pytest.mark.parametrize('workload', sorted(shared.TINY))
def test_a_traced_run_on_the_cpu_reads_no_span_metric(workload):
    """No device trace on the CPU: the span readers build nothing."""
    out = shared.run_tiny(workload, trace=True)
    assert not set(out['metrics']) & NEW


@pytest.mark.parametrize('workload', sorted(shared.TINY))
def test_the_spans_slice_at_a_tiny_size(workload):
    parts = shared.tiny_parts(workload)
    got = spans.measure(parts['config'], parts['traffic'], 2 ** 31 + 5, CPU,
                        log=lambda m: None)
    names = {r[0] for r in got['records']}
    rec = {'kind': parts['traffic']['kind'], 'spans': got}
    if rec['kind'] == 'render':
        assert {'poly.render', 'poly.params', 'poly.plan',
                'lower.LowPass'} <= names
        assert spans.count(got['records'], 'poly.render') == 2
        assert reader('plan_ms.render').read(rec) > 0
        # on the CPU nothing is copied off the host
        assert reader('h2d_copies.render').read(rec) == 0
        assert reader('h2d_bytes.render').read(rec) == 0
    else:
        assert {'poly.fit', 'fit.prepare', 'fit.forward', 'fit.backward',
                'fit.update', 'fit.sync', 'fit.apply'} <= names
        assert spans.count(got['records'], 'fit.forward') == 2
        assert reader('backward_ms.fit').read(rec) > 0


# -- the metrics' entries ---------------------------------------------------


def test_the_span_metrics_are_entered_for_their_cells():
    per_layer = {m['name']: m for m in SPEC['per_layer']}
    for name in NEW:
        m = per_layer[name]
        kind = name.rsplit('.', 1)[1]
        assert (BENCH / 'metrics' / f'{name}.py').is_file()
        assert m['workloads'] == (['score-64v-fit'] if kind == 'fit' else
                                  ['flagship-512v-bounce',
                                   'score-64v-bounce'])
        assert m['source'] == ('program_counter' if name.startswith('h2d')
                               else 'program_span')
