"""``signals_tpu_torch.utils``' spans and the copy counter: off by default
and then free of records, nesting, roots and threads, self time, the
counter and its reset, the documented spans of ``PolyPatch.render`` (both
layouts), of ``PolyPatch.fit`` and of ``learn.fit``, a fit bit for bit the
same with spans on, and ``trace``'s file with the spans on
its timeline.  The ``cuda`` tests run on the card: a span holds the
launch of the kernel it issued once the profiler's events are on the
spans' clock, and a flagship render's copies are the ones its parameter
leaves and its lowering's host values explain."""

import json
import threading

import numpy as np
import pytest
import torch

from signals_tpu_torch import utils
from signals_tpu_torch.compiler import compile_node, kernels
from signals_tpu_torch.core import xp
from signals_tpu_torch.nodes.fixed import Fixed
from signals_tpu_torch.nodes.fx import Gain, LowPass
from signals_tpu_torch.nodes.osc import Sawtooth, Sine
from signals_tpu_torch.parallel import PolyPatch

CPU = torch.device('cpu')
RENDER = ['poly.render', 'poly.params', 'patch.host_inputs', 'poly.plan']
FIT_STEP = ['fit.forward', 'fit.backward', 'fit.update']


@pytest.fixture(autouse=True)
def spans_off():
    utils.disable()
    utils.drain()
    yield
    utils.disable()
    utils.drain()


def recorded(fn):
    utils.enable()
    try:
        fn()
    finally:
        utils.disable()
    return utils.drain()


def fixed(value):
    f = Fixed()
    f.get_state().value = np.atleast_2d(np.float32(value))
    return f


def voice(swept=True):
    """saw -> low-pass (swept by a sine, or fixed) -> gain; ``(root, pitch
    node, gain node)``."""
    hz = fixed(220.0)
    saw = Sawtooth()
    saw.hertz = hz
    lp = LowPass()
    lp.input = saw
    if swept:
        lfo = Sine()
        lfo.hertz = fixed(0.5)
        cut = Gain()
        cut.left = lfo
        cut.right = fixed(300.0)
        sweep = Gain()
        sweep.left = cut
        sweep.right = fixed(1.0)
        lp.cutoff = sweep
        lp.get_state().context = 256
    else:
        lp.cutoff = fixed(1200.0)
    out = Gain()
    out.left = lp
    gain = fixed(0.25)
    out.right = gain
    return out, hz, gain


def poly(layout, mix_epilogue=None, swept=True):
    root, hz, gain = voice(swept)
    return PolyPatch(root, n_voices=3,
                     overrides={(hz, 'value'): np.float32([110, 220, 330])},
                     block_frames=256, layout=layout,
                     mix_epilogue=mix_epilogue, device=CPU), gain


# -- the recorder ----------------------------------------------------------


def test_off_records_nothing_and_shares_one_context():
    assert utils.span('a') is utils.span('b', 'c')
    with utils.span('a'):
        with utils.span('lower.', 'Gain'):
            pass
    assert utils.drain() == []


def test_nesting_parent_root_and_name_detail():
    def body():
        with utils.span('outer'):
            with utils.span('mid'):
                with utils.span('lower.', 'Gain'):
                    pass
            with utils.span('mid2'):
                pass
        with utils.span('next'):
            pass

    got = recorded(body)
    assert [r.name for r in got] == ['outer', 'mid', 'lower.Gain', 'mid2',
                                     'next']
    assert [r.parent for r in got] == [-1, 0, 1, 0, -1]
    assert [r.root for r in got] == [0, 0, 0, 0, 4]
    for r in got:
        assert r.start_ns <= r.end_ns
        if r.parent >= 0:
            p = got[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    assert utils.drain() == []


def test_threads_keep_their_own_stacks():
    inside = threading.Event()
    leave = threading.Event()

    def worker():
        with utils.span('worker'):
            inside.set()
            leave.wait(10)
            with utils.span('worker.child'):
                pass

    def body():
        t = threading.Thread(target=worker)
        with utils.span('main'):
            t.start()
            assert inside.wait(10)
            with utils.span('main.child'):
                leave.set()
                t.join(10)
        assert not t.is_alive()

    got = {r.name: (i, r) for i, r in enumerate(recorded(body))}
    main, worker = got['main'], got['worker']
    assert main[1].thread != worker[1].thread
    assert got['main.child'][1].parent == main[0]
    assert got['worker.child'][1].parent == worker[0]
    assert got['worker.child'][1].root == worker[0]
    assert got['main.child'][1].thread == main[1].thread


def test_self_time():
    recs = [utils.SpanRecord('a', 0, 100, -1, 0, 1),
            utils.SpanRecord('b', 10, 40, 0, 0, 1),
            utils.SpanRecord('c', 15, 25, 1, 0, 1),
            utils.SpanRecord('d', 50, 90, 0, 0, 1)]
    assert utils.self_ns(recs) == [30, 20, 10, 40]


def test_an_open_span_drains_without_an_end():
    utils.enable()
    with utils.span('open'):
        got = utils.drain()
    assert got[0].name == 'open' and got[0].end_ns is None


# -- the copy counter ------------------------------------------------------


def test_copies_off_the_host_are_counted_and_reset():
    kernels.reset_copy_counts()
    assert kernels.COPIES is xp.COPIES
    xp.to_device(np.zeros(3, np.float32), CPU)
    xp.to_device(torch.zeros(2), CPU)
    assert kernels.COPIES == {'h2d_copies': 0, 'h2d_bytes': 0}
    # the meta device stands for a card: the copy is off the host
    meta = torch.device('meta')
    assert xp.to_device(np.zeros(3, np.float64), meta,
                        torch.float32).dtype == torch.float32
    xp.to_device(0.5, meta)
    xp.to_device(torch.zeros(4, dtype=torch.float64), meta)
    xp.to_device(torch.zeros(4, device=meta), meta)      # already there
    assert kernels.COPIES == {'h2d_copies': 3, 'h2d_bytes': 12 + 4 + 32}
    kernels.reset_copy_counts()
    assert kernels.COPIES == {'h2d_copies': 0, 'h2d_bytes': 0}
    assert set(kernels.LAUNCHES) >= {'segments_gen', 'batch'}


# -- the program's spans ---------------------------------------------------


def calls(records, root_name):
    """The records grouped by their root, for the roots named
    ``root_name``."""
    roots = [i for i, r in enumerate(records)
             if r.parent == -1 and r.name == root_name]
    return [[r for r in records if r.root == i] for i in roots]


@pytest.mark.parametrize('layout, mix_epilogue', [
    ('channels', True), ('channels', False), ('vmap', None)])
def test_each_render_yields_the_documented_spans(layout, mix_epilogue):
    p, _ = poly(layout, mix_epilogue)
    want = p.render(n_blocks=8)[0]
    got = []
    recs = recorded(lambda: got.extend(
        p.render(position=256 * 8 * k, n_blocks=8)[0] for k in range(2)))
    assert torch.equal(got[0], want)
    per_call = calls(recs, 'poly.render')
    assert len(per_call) == 2 and len(recs) == sum(map(len, per_call))
    for spans in per_call:
        names = [r.name for r in spans]
        assert names[:4] == RENDER
        lowered = names[4:]
        assert lowered and all(n.startswith('lower.') for n in lowered)
        assert 'lower.LowPass' in lowered and 'lower.Sawtooth' in lowered
        plan = recs.index(spans[3])
        assert all(r.parent >= plan for r in spans[4:])


def test_a_compiled_render_is_one_span_with_its_lowering():
    root, _, _ = voice(swept=False)
    patch = compile_node(root, block_frames=256, rate=44100, channels=1,
                         device=CPU)
    patch.render(n_blocks=4)
    recs = recorded(lambda: patch.render(n_blocks=4))
    assert recs[0].name == 'patch.render' and recs[0].parent == -1
    assert all(r.root == 0 for r in recs)
    assert {r.name for r in recs[1:]} >= {'lower.LowPass', 'lower.Gain'}


@pytest.mark.parametrize('steps_per_dispatch, syncs', [(None, 1), (1, 2)])
def test_a_fit_yields_each_steps_spans(steps_per_dispatch, syncs):
    p, gain = poly('channels', swept=False)
    target = p.render(n_blocks=4)[0].detach() * 1.5
    recs = recorded(lambda: p.fit(
        target, [(gain, 'value')], steps=2, learning_rate=0.01,
        steps_per_dispatch=steps_per_dispatch))
    (spans,) = calls(recs, 'poly.fit')
    assert len(spans) == len(recs)
    names = [r.name for r in spans]
    top = [r.name for r in spans if r.parent == 0]
    assert top[0] == 'fit.prepare' and top[-1] == 'fit.apply'
    steps = [n for n in top if n in FIT_STEP]
    assert steps == FIT_STEP * 2
    assert names.count('fit.sync') == syncs
    # each step's forward renders through the plan, lowering the patch,
    # then calls the loss
    forward = [i for i, r in enumerate(recs) if r.name == 'fit.forward']
    for i in forward:
        inner = [r.name for r in recs if r.parent == i]
        assert inner == ['poly.plan', 'fit.loss']


def stems():
    """Two voices of the benchmark's stem patch (sine partials at F0 and
    3 F0 -> Mix -> LowPass -> Gain) on the CPU; ``(root, [(node, 'value')
    ...] of its hertz, cutoff and gain rows, target)``."""
    from benchmark.lib import harness
    mod = harness.load_file(harness.BENCH / 'configs' / 'stems.py')
    cfg = dict(harness.read_json(harness.BENCH / 'configs' / 'stems.json'),
               voices=2, block_frames=256, context=256)
    root, rows = mod.patch(cfg)
    values = {'hz': [220.0, 330.0], 'cutoff': [900.0, 1500.0],
              'gain': [0.25, 0.5]}
    for r, node in rows.items():
        node.get_state().value = np.float32([values[r]])
    target = compile_node(root, block_frames=256, rate=44100, device=CPU) \
        .render(n_blocks=4)[0].detach() * 1.5
    return root, [(node, 'value') for node in rows.values()], target


def learn_fit(root, trainable, target, **kw):
    from signals_tpu_torch import learn
    return learn.fit(root, target, trainable, block_frames=256, steps=2,
                     learning_rate=0.01, relative_lr=True, device=CPU,
                     loss=learn.per_channel_spectral_loss, **kw)


@pytest.mark.parametrize('steps_per_dispatch, syncs', [(None, 1), (1, 2)])
def test_learn_fit_yields_its_documented_spans(steps_per_dispatch, syncs):
    root, trainable, target = stems()
    recs = recorded(lambda: learn_fit(root, trainable, target,
                                      steps_per_dispatch=steps_per_dispatch))
    (spans,) = calls(recs, 'learn.fit')
    assert len(spans) == len(recs)
    top = [r.name for r in spans if r.parent == 0]
    assert top[0] == 'fit.prepare' and top[-1] == 'fit.apply'
    assert [n for n in top if n in FIT_STEP] == FIT_STEP * 2
    assert top.count('fit.sync') == syncs
    # each step's forward lowers the patch from its root, then calls the
    # loss
    forward = [i for i, r in enumerate(recs) if r.name == 'fit.forward']
    assert len(forward) == 2
    for i in forward:
        inner = [r.name for r in recs if r.parent == i]
        assert inner == ['lower.Gain', 'fit.loss']
    assert [recs[r.parent].name for r in recs
            if r.name == 'fit.loss'] == ['fit.forward'] * 2


@pytest.mark.parametrize('which', ['learn', 'poly'])
def test_spans_on_leave_a_fit_bit_for_bit(which):
    """The same fit with spans off and on: the same losses and the same
    fitted values, bit for bit."""
    def run(on):
        if which == 'learn':
            root, trainable, target = stems()
            fit = lambda: learn_fit(root, trainable, target)  # noqa: E731
        else:
            p, gain = poly('channels', swept=False)
            target = p.render(n_blocks=4)[0].detach() * 1.5
            fit = lambda: p.fit(target, [(gain, 'value')],  # noqa: E731
                                steps=2, learning_rate=0.01)
        if on:
            utils.enable()
        try:
            res = fit()
        finally:
            utils.disable()
        assert bool(utils.drain()) == on
        return res

    off, on = run(False), run(True)
    assert np.array_equal(off.losses, on.losses)
    assert off.params.keys() == on.params.keys()
    for uid, leaves in off.params.items():
        for name, value in leaves.items():
            assert torch.equal(value, on.params[uid][name]), (uid, name)


def test_spans_stay_off_and_cost_no_records_in_a_plain_render():
    p, _ = poly('channels')
    p.render(n_blocks=8)
    assert utils.drain() == []


def test_trace_writes_its_file_with_the_spans(tmp_path):
    p, _ = poly('channels', mix_epilogue=False)
    p.render(n_blocks=4)
    with utils.trace(tmp_path / 'tr') as log_dir:
        p.render(n_blocks=4)
    files = list(log_dir.glob('trace_*.json'))
    assert len(files) == 1
    names = {e.get('name') for e in
             json.loads(files[0].read_text())['traceEvents']}
    assert {'poly.render', 'poly.plan', 'lower.LowPass'} <= names
    # it switched the spans on for its region only and kept no records
    assert utils.drain() == []
    with utils.span('after'):
        pass
    assert utils.drain() == []


# -- on the card -----------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return torch.device('cuda', 0)


class Probe:
    """A driver of one call: an elementwise kernel inside the span
    ``probe`` after a host pause outside every span."""

    def __init__(self, device):
        self.x = torch.ones(1 << 20, device=device)

    def call(self):
        import time
        time.sleep(2e-3)
        with utils.span('probe'):
            self.y = self.x * 2.0


@pytest.mark.cuda
def test_a_span_holds_its_kernels_launch_on_the_profilers_clock(card):
    from benchmark.lib import spans
    probe = Probe(card)
    probe.call()
    torch.cuda.synchronize(card)
    got = spans.profiled(probe, 5, card, utils, log=lambda m: None)
    a = got['anchors']
    assert abs(a['apart_ns']) < 50_000, a
    assert got['matched'] == got['ops'] >= 5
    names = dict(got['launches_by_span'])
    assert names.get('probe') == 5, got['launches_by_span']
    # the pauses between the calls are idle gaps under no span
    assert dict(got['idle_gaps'])[spans.NONE] > 5 * 1.5e-3


@pytest.mark.cuda
def test_a_flagship_renders_copies_are_its_leaves_and_host_values(card):
    """The benchmark's 512-voice flagship, one 60 s render: every copy
    onto the card in the profiler's trace is one the counter counted, and
    each is a host value handed to ``to_device``.  They are the parameter
    leaves alone: there are no host inputs here, and the lowering's host
    scalars stay on the host (``TorchXP``'s weak-scalar rule)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    import signals_tpu_torch.compiler as compiler
    import signals_tpu_torch.parallel as parallel
    from benchmark.lib import harness
    cfg = harness.read_json(harness.BENCH / 'configs' / 'flagship.json')
    system = harness.load_file(harness.BENCH / 'configs' / 'flagship.py') \
        .build(cfg, 7, card, {'blocks': 2584})
    p = system.poly
    mix = p.render(n_blocks=2584)[0]
    leaves = sum(len(v) for v in p.params()[0].values())
    torch.cuda.synchronize(card)
    kernels.reset_copy_counts()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        p.render(n_blocks=2584)
        torch.cuda.synchronize(card)
    copies = dict(kernels.COPIES)
    htod = [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and 'HtoD' in e.name()]
    assert p.compiled.host_inputs(0, 2584) == {}

    host = []
    spy = xp.to_device

    def listed(data, device, dtype=None, **kw):
        if not isinstance(data, torch.Tensor):
            host.append((type(data).__name__, np.ndim(data)))
        return spy(data, device, dtype, **kw)

    mods = (xp, compiler, parallel)
    try:
        for m in mods:
            m.to_device = listed
        again = p.render(n_blocks=2584)[0]
    finally:
        for m in mods:
            m.to_device = spy
    assert torch.equal(again, mix)
    arrays = sum(1 for kind, _ in host if kind == 'ndarray')
    assert len(host) == copies['h2d_copies'] == arrays == leaves
    assert len(htod) <= copies['h2d_copies'], (len(htod), host)
