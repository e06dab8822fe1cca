"""``signals_tpu_torch.utils``: latency stats, ``timed``, ``trace``, and
checkpoint / resume (``utils/checkpoint.py``) against the JAX package.

Mirrors ``tests/test_utils.py:45-80`` on the port, and adds: a port round
trip resumes bit for bit; a checkpoint the JAX package writes resumes in
the port within 1e-5 of the JAX package's own continuation, and one the
port writes resumes in the JAX package (the ``.npz`` format and the carry
layout are shared; ``expect_graph_hash=None`` because the port's graph
hash includes the compile device); leaves keep their dtypes through the
device; ``trace`` writes a trace on the CPU.  The card's round trip is
``chip_smoke.py`` phase 10 (e).
"""

import importlib
import json

import numpy as np
import pytest
import torch

from signals_tpu.utils import checkpoint as jcheckpoint
from signals_tpu_torch.utils import LatencyStats, checkpoint, timed, trace

F = 256
RATE = 44100
JAX, PORT = 'signals_tpu', 'signals_tpu_torch'


def feedback_patch(pkg):
    """``tests/test_utils.py``'s patch: a sine mixed with its own 2-block
    echo at gain 0.5."""
    m = {n: importlib.import_module(f'{pkg}.nodes.{n}')
         for n in ('delay', 'fixed', 'fx', 'osc')}

    def fixed(v):
        f = m['fixed'].Fixed()
        f.get_state().value = np.array([[v]], np.float32)
        return f

    src = m['osc'].Sine()
    src.hertz = fixed(440.0)
    mix = m['fx'].Mix()
    d = m['delay'].Delay()
    d.get_state().frames = 2 * F
    fb = m['fx'].Gain()
    fb.left = d
    fb.right = fixed(0.5)
    mix.left = src
    mix.right = fb
    mix.mix = fixed(0.6)
    d.input = mix
    return mix


def compile_(pkg, root):
    kw = {'device': 'cpu'} if pkg == PORT else {}
    return importlib.import_module(f'{pkg}.compiler').compile_node(
        root, block_frames=F, rate=RATE, channels=1, **kw)


def test_latency_stats_and_timed():
    stats = LatencyStats(window=10)
    for t in (0.001, 0.002, 0.003):
        stats.record(t)
    assert stats.p50 == pytest.approx(0.002)
    assert stats.worst == pytest.approx(0.003)
    s = stats.summary(1024, 44100)
    assert s['blocks'] == 3
    assert s['x_realtime_p50'] == pytest.approx((1024 / 44100) / 0.002)
    with timed(stats):
        sum(range(1000))
    assert stats.total_blocks == 4 and 0 < stats._times[-1] < 1.0
    with pytest.raises(KeyError):
        with timed(stats):
            raise KeyError('recorded all the same')
    assert stats.total_blocks == 5


def test_checkpoint_roundtrip(tmp_path):
    c = compile_(PORT, feedback_patch(PORT))
    full, _ = c.render(position=0, n_blocks=12)
    a, carry = c.render(position=0, n_blocks=6)
    path = tmp_path / 'state.npz'
    checkpoint.save(path, position=6 * F, carry=carry,
                    graph_hash=c.graph_hash, patch_lines=['+ 1a example'])
    loaded = checkpoint.load(path, expect_graph_hash=c.graph_hash,
                             device='cpu')
    assert loaded['position'] == 6 * F
    assert loaded['patch'] == ['+ 1a example']
    assert loaded['graph_hash'] == c.graph_hash
    b, _ = c.render(position=loaded['position'], n_blocks=6,
                    carry=loaded['carry'])
    # other batch splits reassociate the delay solver's scan (~1 ulp)
    np.testing.assert_allclose(torch.cat([a, b]).numpy(), full.numpy(),
                               atol=1e-6, rtol=0)
    # resuming from the loaded carry is resuming from the carry itself
    b2, _ = c.render(position=6 * F, n_blocks=6, carry=carry)
    assert torch.equal(b, b2)


def test_checkpoint_rejects_wrong_graph(tmp_path):
    path = tmp_path / 'state.npz'
    checkpoint.save(path, position=0, carry={}, graph_hash='aaaa')
    with pytest.raises(checkpoint.CheckpointMismatch):
        checkpoint.load(path, expect_graph_hash='bbbb')
    assert checkpoint.load(path, device='cpu')['position'] == 0
    a = compile_(PORT, feedback_patch(PORT))
    b = compile_node_at(feedback_patch(PORT), 512)
    assert a.graph_hash != b.graph_hash
    checkpoint.save(path, position=F, carry=a.carry0,
                    graph_hash=a.graph_hash)
    with pytest.raises(checkpoint.CheckpointMismatch):
        checkpoint.load(path, expect_graph_hash=b.graph_hash, device='cpu')


def compile_node_at(root, block_frames):
    from signals_tpu_torch.compiler import compile_node
    return compile_node(root, block_frames=block_frames, rate=RATE,
                        channels=1, device='cpu')


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    jc = compile_(JAX, feedback_patch(JAX))
    _, jcarry = jc.render(position=0, n_blocks=6)
    path = tmp_path / 'jax.npz'
    jcheckpoint.save(path, position=6 * F, carry=jcarry,
                     graph_hash=jc.graph_hash)
    # (the JAX render donates its carry: save before continuing)
    want, _ = jc.render(position=6 * F, n_blocks=6, carry=jcarry)
    pc = compile_(PORT, feedback_patch(PORT))
    loaded = checkpoint.load(path, expect_graph_hash=None, device='cpu')
    assert set(loaded['carry']) == set(pc.carry0)
    for uid, leaves in pc.carry0.items():
        for name, v in leaves.items():
            got = loaded['carry'][uid][name]
            assert got.shape == v.shape and got.dtype == v.dtype
    got, _ = pc.render(position=loaded['position'], n_blocks=6,
                       carry=loaded['carry'])
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5


def test_port_checkpoint_resumes_in_jax(tmp_path):
    pc = compile_(PORT, feedback_patch(PORT))
    _, carry = pc.render(position=0, n_blocks=5)
    want, _ = pc.render(position=5 * F, n_blocks=7, carry=carry)
    path = tmp_path / 'port.npz'
    checkpoint.save(path, position=5 * F, carry=carry,
                    graph_hash=pc.graph_hash)
    jc = compile_(JAX, feedback_patch(JAX))
    loaded = jcheckpoint.load(path)
    got, _ = jc.render(position=loaded['position'], n_blocks=7,
                       carry=loaded['carry'])
    assert np.abs(np.asarray(got) - want.numpy()).max() <= 1e-5


def test_leaves_keep_their_dtypes(tmp_path):
    carry = {'n1': {'zi': torch.randn(2, 2, 3), 'count': torch.arange(
        5, dtype=torch.int32)}, 'n2': {'x': torch.ones(4, dtype=torch.float64),
                                      'h': torch.zeros(7, 1)}}
    path = tmp_path / 'dtypes.npz'
    checkpoint.save(path, position=0, carry=carry)
    with np.load(path) as data:
        keys = sorted(k for k in data.files if k.startswith('carry:'))
        meta = json.loads(str(data['__meta__']))
    assert keys == ['carry:n1/count', 'carry:n1/zi', 'carry:n2/h',
                    'carry:n2/x']
    assert meta['carry_keys'] == [k[len('carry:'):] for k in keys]
    back = checkpoint.load(path, device='cpu')['carry']
    for uid, leaves in carry.items():
        for name, v in leaves.items():
            assert back[uid][name].dtype == v.dtype
            assert torch.equal(back[uid][name], v)
    with np.load(path) as data:
        assert data['carry:n1/count'].dtype == np.int32


def test_load_defaults_to_the_card(tmp_path):
    import inspect
    assert inspect.signature(checkpoint.load).parameters[
        'device'].default == 'cuda'
    path = tmp_path / 'c.npz'
    checkpoint.save(path, position=0, carry={'n0': {'zi': torch.ones(2)}})
    if torch.cuda.is_available():
        assert checkpoint.load(path)['carry']['n0']['zi'].is_cuda
    else:
        with pytest.raises(RuntimeError, match='CUDA'):
            checkpoint.load(path)


def test_trace_writes_a_trace_on_the_cpu(tmp_path):
    with trace(tmp_path / 'tr') as log_dir:
        x = torch.randn(64, 64)
        (x @ x).sum()
    files = list(log_dir.glob('trace_*.json'))
    assert len(files) == 1
    events = json.loads(files[0].read_text())['traceEvents']
    assert any('mm' in e.get('name', '') for e in events)
