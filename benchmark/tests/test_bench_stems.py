"""The ``stems`` configuration at a tiny size on the CPU (4 voices, 8
blocks of 256 frames, a context of 256, FFT sizes 256 and 512; seeded
targets and starts): the program's loss and gradient against the plain
reference's, the reference's autograd against its own central difference,
three Adam steps against ``plain.adam``, the cell's check on a sound run
and on each planted fault (at 4 voices, and at 32, where the filter takes
the segment kernels' path as the cell's 64 voices do), the inputs, the
roofline counts of K2 and B2 at the cell's shape, and the new readers over
canned traces.
``conftest.py`` enters :data:`TINY` in ``test_bench_harness.TINY``, so the
shared tests of every cell run this one too."""

import json
import pathlib
import time

import numpy as np
import pytest
import torch

from benchmark import faults_stems
from benchmark.lib import harness, roofline
from benchmark.reference import plain

BENCH = pathlib.Path(__file__).resolve().parents[1]
CELL = 'stems-64v-fit'
CPU = torch.device('cpu')
_LOSS = json.loads((BENCH / 'configs' / 'stems.json').read_text())['loss']
#: the cell's sizes for the CPU runs: 4 voices, 8 blocks of 256 frames,
#: a context of 256, FFT sizes 256 and 512
TINY = {CELL: (
    dict(voices=4, block_frames=256, context=256,
         loss=dict(_LOSS, fft_sizes=[256, 512])),
    dict(blocks=8, steps_per_call=2, trace_calls=1))}
SEEDS = [2 ** 31 + 17, 14, 17]


def parts():
    out = harness.cell_spec(harness.read_json(BENCH.parent
                                              / 'BENCHMARK.json'), CELL)
    cfg_over, traffic_over = TINY[CELL]
    out['config'] = dict(out['config'], **cfg_over)
    out['traffic'] = dict(out['traffic'], **traffic_over)
    return out


def modules():
    return (harness.load_file(BENCH / 'configs' / 'stems.py'),
            harness.load_file(BENCH / 'reference' / 'stems.py',
                              'benchmark.reference.stems'))


def tiny(seed):
    """``(cfg, traffic, system, reference module)`` at the tiny size."""
    p = parts()
    prog, ref = modules()
    return (p['config'], p['traffic'],
            prog.build(p['config'], seed, CPU, p['traffic']), ref)


def row_gaps(got, want):
    """Per row, the worst element's ``|got - want|`` over the larger of
    that element's ``|want|`` and the row's median ``|want|``."""
    return {r: float(np.max(np.abs(got[r] - want[r]) / np.maximum(
        np.abs(want[r]), np.median(np.abs(want[r]))))) for r in want}


# -- the program against the reference --------------------------------------


@pytest.mark.parametrize('seed', SEEDS)
def test_loss_and_gradient_against_the_reference(seed):
    """The program's loss and gradient at the start against the
    reference's (its own target; the loss's value in float32, the gradient
    float64's).  The tolerances are float32's in this loss: the
    log-magnitude term reads bins far below the partials, where float32's
    rounding of the stems and of the FFT moves ``log(|X| + 1e-4)`` by up to
    ~1e-2, so the loss differs by up to 1.7e-4 of itself and a hertz or
    cutoff element's gradient by up to 4.1e-2 of its row's scale over 8
    seeds; no element above a tenth of its row's median changes sign."""
    cfg, traffic, s, ref = tiny(seed)
    loss, g = s.loss_grad()
    p0, target = ref.fit_problem(cfg, s.inputs, traffic, CPU)
    assert set(p0) == set(g) == {'hz', 'cutoff', 'gain'}
    for r, v in s.param().items():
        assert v.shape == (4,) and np.array_equal(v, p0[r])
        # the leaves are in units of the start's values
        assert np.array_equal(v, np.ones(4))
    want_loss, want = ref.loss_and_grad(cfg, s.inputs, p0, 8, target, CPU)
    assert loss == pytest.approx(want_loss, rel=1e-3)
    gaps = row_gaps(g, want)
    assert max(gaps.values()) < 0.1, gaps
    for r in want:
        big = np.abs(want[r]) >= 0.1 * np.median(np.abs(want[r]))
        assert np.array_equal(np.sign(g[r][big]), np.sign(want[r][big])), r


def test_the_target_is_the_reference_stems():
    cfg, traffic, s, ref = tiny(SEEDS[0])
    want = ref.mix(cfg, s.inputs, 0, 8, CPU)
    assert s.target.shape == want.shape == (8 * 256, 4)
    gap = (s.target.double() - want).abs().max() / want.abs().max()
    assert float(gap) < 2e-6


@pytest.mark.parametrize('row, rel, tol', [
    ('hz', 1e-4, 2e-3), ('cutoff', 1e-5, 1e-4), ('gain', 1e-5, 1e-4)])
def test_reference_autograd_against_a_central_difference(row, rel, tol):
    """Voice 1's element of each row, in the float64 loss, the difference
    taken in the value and put in the leaf's unit.  A hertz step is taken
    between float32 values (the phase is float32's), wide enough that the
    phase moves by many of its ulps."""
    cfg, traffic, s, ref = tiny(SEEDS[0])
    p0, target = ref.fit_problem(cfg, s.inputs, traffic, CPU)
    _, grad = ref.loss_and_grad(cfg, s.inputs, p0, 8, target, CPU)
    unit = ref.units(s.inputs)
    v0 = ref.values_of(p0, unit)

    def loss_at(v):
        p = {k: a.copy() for k, a in v0.items()}
        p[row][1] = v
        return float(ref.spectral_loss(
            cfg, ref.mix(cfg, s.inputs, 0, 8, CPU, rows=p), target))

    v = v0[row][1]
    lo, hi = v * (1 - rel), v * (1 + rel)
    if row == 'hz':
        lo, hi = float(np.float32(lo)), float(np.float32(hi))
    fd = (loss_at(hi) - loss_at(lo)) / (hi - lo)
    assert fd * unit[row][1] == pytest.approx(grad[row][1], rel=tol)


def test_three_adam_steps_against_plain_adam():
    """``learn.fit``'s three steps against ``plain.adam`` on the values,
    fed the program's own gradient at each point it visits: the same
    losses, and each element's move within 1e-2 of one relative step
    (``0.005 max(|p0|, 0.01)``; float32's Adam against float64's)."""
    cfg, traffic, s, _ = tiny(SEEDS[0])
    prog, _ = modules()
    lr = traffic['learning_rate']
    v0 = prog.values(s.param(), s.unit)
    seen = []

    def grad_at(v):
        s._set(v)
        loss, g = s.loss_grad()
        seen.append(loss)
        return {r: g[r] / s.unit[r] for r in g}

    vs, _ = plain.adam(v0, grad_at, 3, lr, True)
    s._set(v0)
    losses = s.fit(3, lr, True)
    v3 = prog.values(s.param(), s.unit)
    assert np.allclose(losses, seen, rtol=1e-4)
    for r in v0:
        step = lr * np.maximum(np.abs(v0[r]), 0.01)
        moved = v3[r] - v0[r]
        assert np.all(moved != 0.0), r
        assert np.all(np.abs(moved - (vs[-1][r] - v0[r])) < 1e-2 * step), r


# -- the check --------------------------------------------------------------


def run_tiny(seed, fault=None, voices=None):
    p = parts()
    if voices is not None:
        # 11 blocks: one block a segment, as at the cell's 517
        p['config'] = dict(p['config'], voices=voices)
        p['traffic'] = dict(p['traffic'], blocks=11)

    def run():
        return harness.run_cell(p, seed=seed, seconds=0.1, trace=False,
                                device=CPU, t_start=time.perf_counter(),
                                log=lambda m: None)
    if fault is None:
        return run()
    with faults_stems.FAULTS[fault](p['traffic']['kind']):
        return run()


def values(out):
    return {k: c['value'] for k, c in out['checks'].items()}


def test_a_sound_run_is_correct():
    out = run_tiny(SEEDS[0])
    assert out['correct'] is True, out['checks']
    assert set(out['checks']) == {'loss_gap', 'grad_gap', 'step_gap'}
    assert set(out['metrics']) == {'fit_step_ms', 'setup_s'}


SEEN = [f for f in faults_stems.FAULTS if f not in faults_stems.UNSEEN]


@pytest.mark.parametrize('fault', SEEN)
def test_a_planted_fault_is_not_correct(fault):
    out = run_tiny(SEEDS[0], fault)
    assert out['correct'] is False, out['checks']


@pytest.mark.parametrize('voices', [4, 32])
def test_a_zeroed_cutoff_gradient_leaves_the_cutoffs_still(voices):
    """With the coefficient cotangent zeroed, through the batched replay
    (4 lanes) and the segment kernels' path (32 lanes, B2's on a card), the
    cutoffs do not move: the cutoff row's ``step_gap`` is its whole move
    over the larger of that and the median row's (0.93 and 1 here), past
    the cell's limit, and the run is sound without the fault."""
    limit = json.loads((BENCH / 'limits' / f'{CELL}.json').read_text())[
        'step_gap']
    assert run_tiny(SEEDS[0], voices=voices)['correct'] is True
    out = values(run_tiny(SEEDS[0], 'cutoff_grad_zeroed', voices=voices))
    assert out['step_gap'] > 0.9 > limit


def test_a_one_percent_loss_is_under_float32s_own_error():
    """The loss raised by 1% moves ``loss_gap`` by about 1e-2, which the
    cell's limit cannot tell from a sound run at the cell's size: the
    loss at the start and at the window's end agree within ~3e-4 (the
    reference's loss is float32's too), but the second and third steps'
    losses lie on each side's own Adam path, and Adam's first steps move a
    voice by one learning rate whatever its gradient's size, so a voice
    whose near-zero gradient takes the other sign in float32 parts the
    paths: sound runs read up to 1.1e-2 (``PERF.md`` §2)."""
    sound = values(run_tiny(SEEDS[0]))
    raised = values(run_tiny(SEEDS[0], 'loss_scaled'))
    assert sound['loss_gap'] < 1e-3
    assert raised['loss_gap'] - sound['loss_gap'] == pytest.approx(
        1e-2, rel=0.2)
    limits = json.loads((BENCH / 'limits' / f'{CELL}.json').read_text())
    assert raised['loss_gap'] < limits['loss_gap']


def test_a_negated_cutoff_gradient_is_not_seen_by_norms():
    """A blind spot that ``faults_stems.UNSEEN`` names: the leaves are
    compared by their norms, and a gradient's sign moves neither the norm
    of a gradient leaf nor Adam's step size, so the cutoffs stepping the
    wrong way read as sound, each number under a quarter of its limit."""
    limits = json.loads((BENCH / 'limits' / f'{CELL}.json').read_text())
    out = run_tiny(SEEDS[1], 'cutoff_grad_negated')
    assert out['correct'] is True
    for name in ('grad_gap', 'step_gap'):
        assert out['checks'][name]['value'] < 0.25 * limits[name], name


def test_faults_are_undone():
    with faults_stems.FAULTS['odd_gains_zeroed']('fit'):
        pass
    assert run_tiny(SEEDS[0])['correct'] is True


# -- the inputs -------------------------------------------------------------


def test_inputs_follow_bench_and_the_seed():
    prog, _ = modules()
    cfg = json.loads((BENCH / 'configs' / 'stems.json').read_text())
    a, b = prog.make_inputs(cfg, 5), prog.make_inputs(cfg, 6)
    i = np.arange(64)
    hz = (110.0 * 2 ** (i % 12 / 12.0) * (1 + 0.001 * i)).astype(np.float32)
    assert np.array_equal(a['target']['hz'], hz)
    assert np.array_equal(a['target']['cutoff'],
                          np.linspace(350.0, 1200.0, 64).astype(np.float32))
    assert np.all((a['target']['gain'] >= 0.3) & (a['target']['gain'] < 0.9))
    assert np.all(np.abs(a['start']['hz'] / hz - 1) <= 0.02 + 1e-6)
    assert np.all(a['start']['cutoff'] == 800.0)
    assert np.all(a['start']['gain'] == 0.5)
    again = prog.make_inputs(cfg, 5)
    for side in ('target', 'start'):
        for r in a[side]:
            assert np.array_equal(a[side][r], again[side][r])
    assert not np.array_equal(a['target']['gain'], b['target']['gain'])
    assert not np.array_equal(a['start']['hz'], b['start']['hz'])


# -- the readers ------------------------------------------------------------


C9 = {'voices': 64, 'blocks': 517, 'context': 1024, 'block_frames': 1024,
      'nsec': 1}


def reader(name):
    return harness.load_file(BENCH / 'metrics' / f'{name}.py')


def test_b2_counts_are_the_kernel_tables():
    """``PERF.md`` §6's B2 row at c9's shape: 410 MB (x, gy, the folded
    gx, the coefficients and their gradient), 2.575 GFLOP, bound by bytes
    at 0.1224 ms."""
    flops, nbytes = reader('B2_roofline').work(C9)
    s, by = roofline.bound_s(flops, nbytes)
    assert by == 'bytes'
    assert nbytes / 1e6 == pytest.approx(410.0, abs=0.05)
    assert flops / 1e9 == pytest.approx(2.575, abs=5e-4)
    assert s * 1e3 == pytest.approx(0.1224, abs=5e-5)


def test_k2_counts_at_c9():
    """12 FLOP a section-row over 517 x 64 x (1024 + 1024) rows; the
    timeline read once, the output written, the coefficients read."""
    flops, nbytes = reader('K2_roofline').work(C9)
    assert flops == 12 * 517 * 64 * 2048
    assert nbytes == 4 * ((1024 + 517 * 1024) * 64 + 517 * 1024 * 64
                          + 517 * 64 * 11)
    s, by = roofline.bound_s(flops, nbytes)
    assert by == 'bytes' and s * 1e3 == pytest.approx(0.08143, abs=5e-5)


def canned_fit():
    """A traced slice of one call of four steps: K2 and B2 each step,
    beside K1, K3 and B1 events that neither reader may count."""
    device, t = [], 0.0
    for _ in range(4):
        for name, dur in (('void seg_cascade<false, 0, 1>(float const*)',
                           200.0),
                          ('void seg_cascade_vjp<false, 0, 1>(float const*)',
                           400.0),
                          ('void seg_cascade<true, 2, 1>(float const*)', 50.0),
                          ('void seg_cascade_vjp<true, 2, 1>(float const*)',
                           50.0),
                          ('void rows_cascade<1>(float const*)', 50.0)):
            device.append((name, t, dur))
            t += dur
    return {'kind': 'fit', 'shapes': C9, 'setup_s': 1.0,
            'window': {'seconds': 0.1, 'calls': [(0.0, 0.1, 0.1, 0.0, 4)]},
            'trace': {'window_s': 0.01, 'calls': 1, 'steps': 4,
                      'device': device}}


@pytest.mark.parametrize('name, per_step_us', [('K2_roofline', 200.0),
                                               ('B2_roofline', 400.0)])
def test_roofline_readers_over_a_canned_fit_trace(name, per_step_us):
    mod = reader(name)
    rec = canned_fit()
    bound, _ = roofline.bound_s(*mod.work(C9))
    assert mod.read(rec) == pytest.approx(100 * bound / (per_step_us * 1e-6))
    assert mod.read(dict(rec, kind='render')) is None


def span(name, start, end, parent=-1, root=0):
    return (name, start, end, parent, root, 1)


def test_loss_ms_reads_the_loss_span_and_nothing_without_it():
    """Two steps whose forwards (5 ms) hold a 2 ms ``fit.loss``; without
    that span (a program that records none) the reader gives nothing."""
    recs = [span('learn.fit', 0, 40_000_000)]
    t = 1_000_000
    for _ in range(2):
        f = len(recs)
        recs.append(span('fit.forward', t, t + 5_000_000, 0))
        recs.append(span('fit.loss', t + 3_000_000, t + 5_000_000, f))
        recs.append(span('fit.backward', t + 5_000_000, t + 9_000_000, 0))
        t += 10_000_000
    rec = {'kind': 'fit', 'trace': None,
           'spans': {'calls': 1, 'records': recs, 'copies': {}}}
    mod = reader('loss_ms.fit')
    assert mod.read(rec) == pytest.approx(2.0)
    old = [r for r in recs if r[0] != 'fit.loss']
    assert mod.read(dict(rec, spans=dict(rec['spans'], records=old))) is None
    assert mod.read(dict(rec, kind='render')) is None
