"""The harness on the CPU: each cell's loop at a tiny size and its result's
keys, the metric readers over a canned trace, the refusal to run without a
card, and the check coming out false when the timed path is broken
underneath.  The ``cuda`` test runs a cell on the card."""

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import faults
from benchmark.lib import harness, roofline, trace
from benchmark.reference import plain

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CPU = torch.device('cpu')
SPEC = harness.read_json(ROOT / 'BENCHMARK.json')
SMALL_SCORE = dict(voices=8, score_seconds=4.0, melody_notes=20, chords=5)
TINY = {
    'flagship-512v-bounce': (dict(voices=4), dict(blocks=16, trace_calls=2)),
    'score-64v-bounce': (SMALL_SCORE, dict(blocks=32, trace_calls=2)),
    'score-64v-fit': (SMALL_SCORE, dict(blocks=32, steps_per_call=2,
                                        trace_calls=1)),
}


def tiny_parts(workload):
    parts = harness.cell_spec(SPEC, workload)
    cfg_over, traffic_over = TINY[workload]
    parts['config'] = dict(parts['config'], **cfg_over)
    parts['traffic'] = dict(parts['traffic'], **traffic_over)
    return parts


def run_tiny(workload, trace=False, seconds=0.2):
    return harness.run_cell(tiny_parts(workload), seed=2 ** 31 + 99,
                            seconds=seconds, trace=trace, device=CPU,
                            t_start=time.perf_counter(), log=lambda m: None)


def test_every_cell_has_its_files():
    for w in SPEC['workloads']:
        assert (BENCH / 'configs' / f'{w["config"]}.json').is_file()
        assert (BENCH / 'configs' / f'{w["config"]}.py').is_file()
        traffic = harness.read_json(BENCH / 'traffic'
                                    / f'{w["traffic"]}.json')
        assert (BENCH / 'drivers' / f'{traffic["kind"]}.py').is_file()
        assert (BENCH / 'limits' / f'{w["name"]}.json').is_file()
    for m in SPEC['end_to_end'] + SPEC['per_layer']:
        assert (BENCH / 'metrics' / f'{m["name"]}.py').is_file()
    assert set(TINY) == {w['name'] for w in SPEC['workloads']}


@pytest.mark.parametrize('workload', sorted(TINY))
def test_loop_and_result_keys(workload):
    out = run_tiny(workload)
    assert list(out) == ['correct', 'attempted', 'failed', 'metrics',
                         'device', 'checks']
    assert out['correct'] is True and out['failed'] == 0
    assert out['attempted'] >= 1
    parts = harness.cell_spec(SPEC, workload)
    assert set(out['metrics']) == {m['name'] for m in parts['end_to_end']}
    for m in parts['end_to_end']:
        assert out['metrics'][m['name']]['unit'] == m['unit']
        assert out['metrics'][m['name']]['value'] > 0
    assert out['device']['platform'] == 'cpu'
    for c in out['checks'].values():
        assert c['value'] <= c['limit']
    json.dumps(out)


def test_traced_run_reads_nothing_from_an_empty_device_trace():
    out = run_tiny('score-64v-bounce', trace=True)
    assert list(out)[-1] == 'checks'
    assert 'breakdown' in out and out['device']['window_s'] > 0
    # no device events on the CPU: only the benchmark's own spans read
    assert set(out['metrics']) == {'dispatch_ms.render'}


def canned(kind):
    """A traced slice of two calls (four steps): K1 (its two kernels) or
    K3 / B3, an elementwise kernel and a copy each, with idle gaps
    between."""
    if kind == 'render':
        names = ['void seg_cascade<true, 1>(float const*)', 'sum_partials',
                 'elementwise_kernel', 'Memcpy DtoH (Device -> Pinned)']
    else:
        names = ['void rows_cascade<1>(float const*)',
                 'void rows_cascade_vjp<1>(float const*)',
                 'elementwise_kernel', 'Memcpy HtoD (Pageable -> Device)']
    device, t = [], 0.0
    for _ in range(2):
        for name, dur in zip(names, (400.0, 100.0, 50.0, 450.0)):
            device.append((name, t, dur))
            t += dur
        t += 1000.0                     # idle between calls
    return {'window_s': 4000e-6, 'calls': 2, 'steps': 4, 'device': device}


def reader(name):
    return harness.load_file(BENCH / 'metrics' / f'{name}.py')


def record(kind, shapes):
    calls = [(0.0, 0.001, 0.01, 60.0, 4), (0.01, 0.012, 0.03, 60.0, 4)]
    return {'kind': kind, 'shapes': shapes, 'setup_s': 12.5,
            'window': {'seconds': 0.03, 'calls': calls},
            'trace': canned(kind)}


FLAG = {'voices': 512, 'blocks': 2584, 'context': 512, 'blocks_per_seg': 8,
        'block_frames': 1024, 'nsec': 1}
SCORE = {'voices': 64, 'blocks': 2584, 'context': 1024, 'block_frames': 1024,
         'nsec': 1}


def test_readers_over_a_canned_render_trace():
    rec = record('render', FLAG)
    assert reader('x_realtime').read(rec) == pytest.approx(120.0 / 0.03)
    assert reader('render_p95_ms').read(rec) == pytest.approx(
        np.percentile([10.0, 20.0], 95))
    assert reader('dispatch_ms.render').read(rec) == pytest.approx(1.5)
    assert reader('launches.render').read(rec) == 4.0
    # a call's traced busy time (1 ms) over its untraced wall (15 ms)
    assert reader('idle_share.render').read(rec) == pytest.approx(
        100 * (1 - 1e-3 / 15e-3))
    bound, _ = roofline.bound_s(*roofline.k1_work(
        blocks=2584, voices=512, context=512, blocks_per_seg=8,
        block_frames=1024))
    assert reader('K1_roofline').read(rec) == pytest.approx(
        100 * bound / 500e-6)
    # what the cell does not have, the readers leave out
    for name in ('fit_step_ms', 'dispatch_ms.fit', 'launches.fit',
                 'idle_share.fit', 'B3_roofline', 'K3_roofline'):
        assert reader(name).read(rec) is None, name
    assert reader('setup_s').read(rec) == 12.5


def test_readers_over_a_canned_fit_trace():
    shapes = dict(SCORE, blocks=517)
    rec = record('fit', shapes)
    assert reader('fit_step_ms').read(rec) == pytest.approx(30.0 / 8)
    # a step's untraced wall (3.75 ms) less its traced busy time (0.5 ms)
    assert reader('dispatch_ms.fit').read(rec) == pytest.approx(3.25)
    assert reader('idle_share.fit').read(rec) == pytest.approx(
        100 * 3.25 / 3.75)
    assert reader('launches.fit').read(rec) == 2.0
    bound, _ = roofline.bound_s(*roofline.b3_work(
        windows=517, lanes=64, rows=2048, tail=1024,
        timeline_rows=1024 + 517 * 1024))
    assert reader('B3_roofline').read(rec) == pytest.approx(
        100 * bound / (200e-6 / 4))
    for name in ('x_realtime', 'render_p95_ms', 'K1_roofline',
                 'idle_share.render'):
        assert reader(name).read(rec) is None, name


def test_busy_union_and_top_operations():
    t = canned('render')
    assert trace.union_us(t['device']) == 2000.0
    assert trace.union_us(t['device'] + [('overlap', 100.0, 600.0)]) == 2000.0
    top = trace.by_name(t['device'])
    assert top[0][0].startswith('Memcpy') and top[0][1] == pytest.approx(
        900e-6)


def test_refuses_without_a_card(tmp_path):
    """Here torch sees no CUDA device: no result line, a non-zero exit."""
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    p = subprocess.run(
        [sys.executable, str(BENCH / 'run.py'), '--workload',
         'flagship-512v-bounce', '--seed', '1', '--seconds', '1',
         '--trace', '0'], capture_output=True, text=True, cwd=ROOT,
        timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ''
    assert 'CUDA' in p.stderr


# --- the check sees a broken timed path ---------------------------------


FAULTS = [(w, f) for w in sorted(TINY)
          for f in ('half_voices', 'altered_answer')] + [
    ('score-64v-fit', 'unchanged_state')]


@pytest.mark.parametrize('workload, fault', FAULTS)
def test_a_broken_timed_path_is_not_correct(workload, fault):
    with faults.FAULTS[fault](tiny_parts(workload)['traffic']['kind']):
        out = run_tiny(workload)
    assert out['correct'] is False, out['checks']
    assert any(c['value'] > c['limit'] for c in out['checks'].values())


def test_faults_are_undone():
    with faults.FAULTS['altered_answer']('render'):
        pass
    assert run_tiny('score-64v-bounce')['correct'] is True


# --- the loops are found by the traffic's kind, whatever the system -------


class TwoChannels:
    """A system whose mix has two channels: a ramp by position."""
    block_frames, rate, device = 4, 8, CPU

    def render(self, position, n_blocks):
        frames = torch.arange(position, position + n_blocks * 4,
                              dtype=torch.float32)
        return torch.stack([frames, -frames], dim=1)


class TwoChannelReference:
    @staticmethod
    def mix(cfg, inputs, position, n_blocks, device, dtype):
        frames = torch.arange(position, position + n_blocks * 4,
                              dtype=dtype)
        return torch.stack([frames, -frames], dim=1)


def driver(kind, traffic, system, seed=5):
    mod = harness.load_file(BENCH / 'drivers' / f'{kind}.py')
    return mod.Driver(traffic, system, seed)


def test_render_loop_keeps_its_samples_in_buffers_of_their_own():
    d = driver('render', {'blocks': 3, 'positions': 'advance',
                          'wrap_batches': 2, 'samples': 3}, TwoChannels())
    d.warm()
    calls = d.window(0.05)
    assert len(calls) >= 3 and len(d.samples) == 3
    bufs = [id(b) for _, _, b in d.samples] + [id(d.host)]
    assert len(set(bufs)) == 4
    out = d.outputs()
    for i, pos, mix in out['samples']:
        assert mix.shape == (12, 2) and mix[0, 0] == pos
    assert d.check(TwoChannelReference, {}, {}, out, CPU,
                   torch.float64) == {'mix_gap': 0.0}
    out['samples'][1][2][5, 1] += 1.0
    assert d.check(TwoChannelReference, {}, {}, out, CPU,
                   torch.float64)['mix_gap'] > 0


class Quadratic:
    """A fit of two leaves, ``a`` (3 elements) and ``b`` (1), to the loss
    ``sum w (p - 1)^2``; ``fit`` runs the plain Adam, as a program would."""

    block_frames, rate, device = 4, 8, CPU
    W = {'a': np.array([1.0, 2.0, 3.0]), 'b': np.array([0.5])}

    def __init__(self, bias=0.0):
        self.p = {'a': np.array([0.2, 0.3, 0.4]), 'b': np.array([3.0])}
        self.bias = bias

    @classmethod
    def loss_and_grad(cls, p, bias=0.0):
        loss = sum(float(np.sum(cls.W[k] * (v - 1.0) ** 2))
                   for k, v in p.items())
        return loss + bias, {k: 2 * cls.W[k] * (v - 1.0)
                             for k, v in p.items()}

    def param(self):
        return dict(self.p)

    def loss_grad(self):
        return self.loss_and_grad(self.p, self.bias)

    def fit(self, steps, learning_rate, relative_lr):
        losses = []

        def grad(p):
            loss, g = self.loss_and_grad(p, self.bias)
            losses.append(loss)
            return g
        ps, _ = plain.adam(self.p, grad, steps, learning_rate, relative_lr)
        self.p = ps[-1]
        return losses


class QuadraticReference:
    @staticmethod
    def fit_reference(cfg, inputs, traffic, p0, at, device, dtype):
        ps, gs = plain.adam(p0, lambda p: Quadratic.loss_and_grad(p)[1],
                            traffic['first_steps'],
                            traffic['learning_rate'], traffic['relative_lr'])
        return {'params': ps, 'grads': gs,
                'losses': [Quadratic.loss_and_grad(p)[0] for p in ps[:-1]],
                'at': [Quadratic.loss_and_grad(p) for p in at]}


FIT = {'first_steps': 3, 'steps_per_call': 2, 'learning_rate': 0.05,
       'relative_lr': True}


@pytest.mark.parametrize('bias, sound', [(0.0, True), (1e-3, False)])
def test_fit_loop_compares_leaves(bias, sound):
    d = driver('fit', FIT, Quadratic(bias))
    d.warm()
    d.window(0.01)
    got = d.check(QuadraticReference, {}, {}, d.outputs(), CPU,
                  torch.float64)
    assert set(got) == {'loss_gap', 'grad_gap', 'step_gap'}
    if sound:
        assert max(got.values()) < 1e-12
    else:
        assert got['loss_gap'] > 1e-5 and got['grad_gap'] == 0.0


def test_worst_leaf_by_norms_and_the_median_floor():
    mod = harness.load_file(BENCH / 'drivers' / 'fit.py')
    want = {'a': np.array([3.0, 4.0]), 'b': np.array([1e-9]),
            'c': np.array([2.0])}
    by = mod.scale(want)
    assert by == {'a': 5.0, 'b': 2.0, 'c': 2.0}
    # a sign flips the elements but not the norm; a tiny leaf's gap is
    # measured against the median leaf
    got = {'a': np.array([-4.0, 3.0]), 'b': np.array([1e-3]),
           'c': np.array([2.0])}
    assert mod.worst_leaf(got, want, by) == pytest.approx(1e-3 / 2.0)
    assert mod.worst_leaf(got, want, by, ['a', 'c']) == 0.0


# --- on the card ----------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


@pytest.mark.cuda
@pytest.mark.parametrize('trace_on', [0, 1])
def test_a_cell_on_the_card(card, trace_on):
    p = subprocess.run(
        [sys.executable, str(BENCH / 'run.py'), '--workload',
         'score-64v-fit', '--seed', '4000000001', '--seconds', '2',
         '--trace', str(trace_on)], capture_output=True, text=True,
        cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out['correct'] is True
    assert out['device']['platform'] == 'gpu'
    assert p.stderr.strip().splitlines()[-1].startswith('check ')
