"""The port's realtime soak (``scripts/torch_soak.py``), counterpart of
``scripts/soak.py`` / ``tests/test_soak.py``.

On the CPU the port renders through the plain versions of its kernels,
slower than realtime, so these tests run the soak's machinery for about
8 s of each patch and assert what does not depend on the CPU's speed: the
report has the reference's keys, the live edits happened, both seeks
landed in the position, the render thread did not die and the sink was
closed, and the underrun counters add up.  The reference's whole contract
(zero underruns after warmup at 65 s and 35 s, p50 over 3x realtime, p95
under one block) is the card's: the ``cuda`` tests below and
``chip_smoke.py`` phase 14.
"""

import importlib.util
import pathlib

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent


def load(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / 'scripts' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


torch_soak = load('torch_soak')

#: the reference's report keys (scripts/soak.py)
KEYS = {'patch', 'seconds', 'edits', 'seeks', 'warmup_underruns',
        'final_underruns', 'seek_window_underruns', 'underruns_after_warmup',
        'position_blocks', 'latency'}
LATENCY = {'blocks', 'p50_ms', 'p95_ms', 'worst_ms', 'x_realtime_p50'}


@pytest.fixture
def sinks(monkeypatch):
    """Every ``SinkDevice`` the soak makes, with the transport it opened."""
    from signals_tpu_torch.nodes import dev
    made = []

    class Recorded(dev.SinkDevice):
        def open(self):
            super().open()
            made.append((self, self._transport))

    monkeypatch.setattr(dev, 'SinkDevice', Recorded)
    return made


def test_soak_report_keys_match_the_reference():
    """The port's report carries the reference's keys, no more."""
    import ast
    tree = ast.parse((REPO / 'scripts' / 'soak.py').read_text())
    want = next(
        {k.value for k in node.value.keys}
        for node in ast.walk(tree)
        if isinstance(node, ast.Assign)
        and getattr(node.targets[0], 'id', None) == 'report')
    assert want == KEYS


@pytest.mark.parametrize('patch', ['voice', 'echo'])
def test_soak_machinery_on_the_cpu(patch, sinks):
    seconds, block = 8.0, 1024
    report = torch_soak.soak(seconds, patch=patch, device='cpu',
                             progress=lambda msg: None)
    assert set(report) == KEYS and set(report['latency']) == LATENCY
    assert report['patch'] == patch and report['seconds'] == seconds
    # an edit every 2 s after the 2 s warmup
    assert report['edits'] >= 2
    # two seeks, each 5 s ahead of its time; the position is past the last
    seeks = report['seeks']
    assert len(seeks) == 2
    targets = [t for _, t in seeks]
    assert targets == [int((seconds * f + 5.0) * 44100) // block
                       for f in (0.33, 0.66)]
    assert report['position_blocks'] >= targets[-1]
    assert report['latency']['blocks'] > 0
    # the counters add up
    assert report['underruns_after_warmup'] == (
        report['final_underruns'] - report['warmup_underruns']
        - report['seek_window_underruns'])
    assert 0 <= report['warmup_underruns'] <= report['final_underruns']
    # the render thread never died, and the sink is closed
    assert len(sinks) == 1
    sink, transport = sinks[0]
    assert transport.error is None and not transport.is_active
    assert not sink.is_open and not sink.is_active


def test_soak_main_defaults_to_the_card():
    import inspect
    assert inspect.signature(torch_soak.soak).parameters[
        'device'].default == 'cuda'
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            torch_soak.main(['--seconds', '0.1'])


# --- the reference's whole contract, on the card ---------------------------


@pytest.mark.cuda
@pytest.mark.slow
def test_cuda_realtime_soak_65s():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    report = torch_soak.soak(65.0, progress=lambda msg: None)
    assert report['underruns_after_warmup'] == 0, report
    assert report['edits'] >= 30
    assert len(report['seeks']) == 2
    assert report['position_blocks'] > 65.0 * 44100 / 1024 * 0.95
    lat = report['latency']
    assert lat['blocks'] > 2000
    assert lat['x_realtime_p50'] > 3.0, lat
    assert lat['p95_ms'] < 1000.0 * 1024 / 44100, lat


@pytest.mark.cuda
@pytest.mark.slow
def test_cuda_realtime_soak_echo_35s():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    report = torch_soak.soak(35.0, patch='echo', progress=lambda msg: None)
    assert report['underruns_after_warmup'] == 0, report
    assert report['position_blocks'] > 0
    assert len(report['seeks']) == 2
