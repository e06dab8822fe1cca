"""The voice mesh of the port (``signals_tpu_torch.parallel.voice_mesh``,
``PolyPatch(mesh=...)``, ``entry.dryrun_multichip``) on gloo CPU processes,
against one process and against the JAX package's unsharded ``PolyPatch``.

Each rank is a process of its own (``tests/torch_mesh_worker.py``) that
joins a gloo group of 2 or 4 ranks through a ``file://`` store and writes
its results to a file; the tests bound their own wait and kill the ranks on
an overrun.  Three spawns in all: 2 ranks, 4 ranks and
``dryrun_multichip(2, device='cpu')``.

What is held (16 voices, F 64, 4 blocks):

* the summed mix of both layouts, the channels layout with and without the
  mix epilogue, from block 0 and from block 3, and after ``set_override``,
  within V x 1e-5 of one process's render and of the JAX package's.  The
  sum reduced across ranks adds the voices in another order than one
  process does, so it is not bit for bit; every rank holds the same bits;
* the sharded ``PolyPatch.fit`` (per-voice pitches and a shared cutoff
  centre, 3 steps): its losses and the gradients the update uses within
  1e-4 relative of one process's.  The per-voice gradient catches a mix
  whose backward sums the cotangents over the ranks again (W x the
  gradient), the shared one a gradient not summed over the ranks;
* the fit of one process and of each rank against the JAX package's
  unsharded ``PolyPatch.fit`` (losses, written-back params) and the
  step-0 gradients against ``jax.grad`` of its loss, within 1e-4
  relative;
* the indivisible voices' ``ValueError`` and the lane-efficiency policy.
"""

import importlib.util
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = REPO / 'tests' / 'torch_mesh_worker.py'
#: seconds a spawn may take before its processes are killed
SPAWN_TIMEOUT = 180


def _worker():
    spec = importlib.util.spec_from_file_location('torch_mesh_worker',
                                                  WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


W = _worker()


def run_bounded(cmds, timeout=SPAWN_TIMEOUT):
    """Start every command (each in a session of its own), wait for all of
    them at most ``timeout`` seconds together, and return their output;
    on an overrun kill every process group and fail."""
    procs = [subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              start_new_session=True) for cmd in cmds]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            left = max(1.0, deadline - time.monotonic())
            outs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f'{len(cmds)} processes did not finish in {timeout} s')
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


def sharded(world, tmp_path):
    """Each rank's results of ``torch_mesh_worker.checks`` on a gloo group
    of ``world`` ranks."""
    store = tmp_path / 'store'
    run_bounded([[sys.executable, str(WORKER), str(r), str(world),
                  str(store), str(tmp_path)] for r in range(world)])
    return [dict(np.load(tmp_path / f'rank{r}.npz')) for r in range(world)]


@pytest.fixture(scope='module')
def one_process():
    """The same checks in this process, without a mesh."""
    return W.checks()


@pytest.fixture(scope='module')
def jax_renders():
    """The JAX package's unsharded ``PolyPatch`` renders of the voice in
    both layouts: ``{layout: (4 blocks from 0, its frames from block 3)}``
    and the channels layout after ``set_override`` (2 blocks)."""
    from signals_tpu.parallel import PolyPatch as JaxPolyPatch
    out = {}
    for layout in ('vmap', 'channels'):
        root, hz, _ = W.voice('signals_tpu')
        kw = {'channels': 1} if layout == 'vmap' else {}
        p = JaxPolyPatch(root, n_voices=W.V,
                         overrides={(hz, 'value'): W.FREQS},
                         block_frames=W.F, rate=W.RATE, layout=layout, **kw)
        out[layout] = np.asarray(p.render(n_blocks=W.NB)[0])
    return out


@pytest.fixture(scope='module')
def jax_fits():
    """The JAX package's unsharded ``PolyPatch.fit`` of the same case as
    ``torch_mesh_worker.fit_case`` in each layout: ``{layout: {'losses',
    'hz_grad0', 'center_grad0', 'hz', 'center'}}``, the step-0 gradients
    ``jax.grad`` of the fit's loss at the initial params."""
    import jax
    import jax.numpy as jnp

    from signals_tpu.learn import _merge_train, _split_train
    from signals_tpu.parallel import PolyPatch as JaxPolyPatch
    out = {}
    for layout in ('vmap', 'channels'):
        root, hz, center = W.voice('signals_tpu')
        kw = {'channels': 1} if layout == 'vmap' else {}
        p = JaxPolyPatch(root, n_voices=W.V,
                         overrides={(hz, 'value'): W.FREQS},
                         block_frames=W.F, rate=W.RATE, layout=layout, **kw)
        index = p.compiled.index
        hz_key = (index.info(hz).uid, 'value')
        center_key = (index.info(center).uid, 'value')
        params, _ = p.params()
        raw = p._raw_render_fn(W.NB)
        host = p.compiled.stage_host(0, W.NB)
        carry0 = jax.tree.map(jnp.asarray, p.init_carry())

        def loss_fn(tp):
            mix, _ = raw(_merge_train(params, tp), carry0, jnp.int32(0),
                         host)
            return W.mse(mix.reshape(W.NB * W.F, 1), W.TARGET)

        # jitted: op by op, the grad of the channels layout takes ~40 s
        grads = jax.jit(jax.grad(loss_fn))(
            _split_train(params, {hz_key, center_key}))
        res = p.fit(W.TARGET, [(hz, 'value'), (center, 'value')],
                    steps=W.FIT_STEPS, learning_rate=0.01, loss=W.mse)
        fitted = (p._overrides[hz_key] if layout == 'vmap'
                  else p._channel_overrides[0][3])
        out[layout] = {
            'losses': np.asarray(res.losses),
            'hz_grad0': np.asarray(grads[hz_key[0]]['value']).reshape(-1),
            'center_grad0': np.asarray(
                grads[center_key[0]]['value']).reshape(-1),
            'hz': np.asarray(fitted).reshape(-1),
            'center': np.asarray(center.get_state().value).reshape(-1)}
    return out


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """``{world: [each rank's results]}`` at 2 and 4 ranks."""
    return {world: sharded(world, tmp_path_factory.mktemp(f'mesh{world}'))
            for world in (2, 4)}


def max_rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize('world', [2, 4])
@pytest.mark.parametrize('name', [n for n, _, _ in W.LAYOUTS])
def test_sharded_mix_matches_one_process_and_jax(ranks, one_process,
                                                 jax_renders, world, name):
    """The summed mix from block 0, from block 3 and after a
    ``set_override`` of every pitch, at 2 and 4 ranks, in every layout.
    Tolerance V x 1e-5 (the sum across ranks reorders the voices' sum)."""
    tol = W.V * 1e-5
    rs = ranks[world]
    jax_full = jax_renders['vmap' if name == 'vmap' else 'channels']
    for what in ('mix', 'seek', 'edit'):
        key = f'{what}/{name}'
        for r in rs[1:]:
            assert np.array_equal(r[key], rs[0][key]), (key, 'ranks differ')
        got, want = rs[0][key], one_process[key]
        assert got.shape == want.shape, key
        assert np.abs(got - want).max() <= tol, key
    assert np.abs(rs[0][f'mix/{name}'] - jax_full).max() <= tol
    assert np.abs(rs[0][f'seek/{name}']
                  - jax_full[3 * W.F:4 * W.F]).max() <= tol
    # set_override reached every rank's voices
    assert np.abs(rs[0][f'edit/{name}']
                  - rs[0][f'mix/{name}'][:2 * W.F]).max() > 1e-3


@pytest.mark.parametrize('world', [2, 4])
@pytest.mark.parametrize('layout', ['vmap', 'channels'])
def test_sharded_fit_matches_one_process(ranks, one_process, world, layout):
    """The losses of a 3-step sharded fit and the gradients its updates
    used: each rank's slice of the per-voice pitches' gradient (joined in
    rank order) and the shared centre's gradient, within 1e-4 relative of
    one process's; every rank the same losses and the same written-back
    pitches."""
    rs = ranks[world]
    ref = one_process
    for r in rs:
        assert np.array_equal(r[f'fit_losses/{layout}'],
                              rs[0][f'fit_losses/{layout}'])
        assert max_rel(r[f'fit_center_grad/{layout}'],
                       ref[f'fit_center_grad/{layout}']) <= 1e-4
        assert np.array_equal(r[f'fit_hz/{layout}'], rs[0][f'fit_hz/{layout}'])
        assert np.array_equal(r[f'fit_center/{layout}'],
                              rs[0][f'fit_center/{layout}'])
    assert max_rel(rs[0][f'fit_losses/{layout}'],
                   ref[f'fit_losses/{layout}']) <= 1e-4
    joined = np.concatenate([r[f'fit_hz_grad/{layout}'] for r in rs], axis=1)
    assert joined.shape == ref[f'fit_hz_grad/{layout}'].shape
    assert max_rel(joined, ref[f'fit_hz_grad/{layout}']) <= 1e-4
    assert max_rel(rs[0][f'fit_hz/{layout}'], ref[f'fit_hz/{layout}']) <= 1e-4
    # the fit moved the pitches (apply=True wrote every voice back)
    assert np.abs(rs[0][f'fit_hz/{layout}'] - W.FREQS).max() > 1e-3


@pytest.mark.parametrize('world', [1, 2, 4])
@pytest.mark.parametrize('layout', ['vmap', 'channels'])
def test_fit_matches_the_jax_package(ranks, one_process, jax_fits, world,
                                     layout):
    """The port's ``PolyPatch.fit`` (``world`` 1: one process without a
    mesh; 2 and 4: each rank of the sharded fit) against the JAX package's
    unsharded one, within 1e-4 relative: the 3 steps' losses, the step-0
    gradients of the per-voice pitches (joined over the ranks) and of the
    shared centre against ``jax.grad`` of the JAX loss, and the pitches
    and centre written back."""
    rs = [one_process] if world == 1 else ranks[world]
    ref = jax_fits[layout]
    joined = np.concatenate([r[f'fit_hz_grad/{layout}'][0] for r in rs])
    assert joined.shape == ref['hz_grad0'].shape
    assert max_rel(joined, ref['hz_grad0']) <= 1e-4
    for r in rs:
        assert max_rel(r[f'fit_losses/{layout}'], ref['losses']) <= 1e-4
        assert max_rel(r[f'fit_center_grad/{layout}'][0],
                       ref['center_grad0']) <= 1e-4
        assert max_rel(r[f'fit_hz/{layout}'], ref['hz']) <= 1e-4
        assert max_rel(r[f'fit_center/{layout}'], ref['center']) <= 1e-4


@pytest.mark.parametrize('world', [2, 4])
def test_mesh_refuses_indivisible_voices_and_keeps_the_policy(ranks, world):
    """``n_voices % W`` must be 0 in both layouts; a mesh pinned below the
    knee warns, an unpinned one is capped at ``efficient_device_count``."""
    from signals_tpu_torch.parallel import (MIN_EFFICIENT_VOICES_PER_DEVICE,
                                            efficient_device_count)
    for rank, r in enumerate(ranks[world]):
        assert int(r['mesh/rank']) == rank
        for layout in ('vmap', 'channels'):
            assert 'not divisible' in str(r[f'indivisible/{layout}'])
        assert 'lane-efficiency' in str(r['policy/warning'])
        assert 'another chip' in str(r['policy/warning'])
        assert int(r['policy/capped']) == efficient_device_count(
            8 * world, world) == 1
        assert int(r['policy/full']) == world
    assert MIN_EFFICIENT_VOICES_PER_DEVICE == 64


def test_policy_matches_the_jax_package():
    """Both packages decline the same meshes."""
    from signals_tpu import parallel as jp
    from signals_tpu_torch import parallel as tp
    assert tp.MIN_EFFICIENT_VOICES_PER_DEVICE == \
        jp.MIN_EFFICIENT_VOICES_PER_DEVICE
    for v in (1, 63, 64, 65, 128, 500, 512, 4096):
        for n in (1, 2, 3, 4, 8):
            assert tp.efficient_device_count(v, n) == \
                jp.efficient_device_count(v, n)


def test_dryrun_multichip_on_two_cpu_ranks():
    """``dryrun_multichip(2, device='cpu')``: the sharded training step, the
    channels layout's render, the sharded fit, the policy and the
    weak-scaling lines, printed by rank 0."""
    out, = run_bounded([[sys.executable, '-c',
                         'from signals_tpu_torch.entry import '
                         'dryrun_multichip; '
                         "dryrun_multichip(2, device='cpu')"]])
    for line in ('dryrun_multichip(2): one sharded training step OK',
                 'dryrun_multichip(2): channels-layout sharded render OK',
                 'dryrun_multichip(2): sharded PolyPatch.fit OK',
                 'dryrun_multichip weak scaling (fixed 8 voices/rank',
                 'dryrun_multichip policy: voice_mesh(n_voices=16) picks 1',
                 'dryrun_multichip weak scaling at the policy width'):
        assert line in out, out


def test_mesh_entry_points_default_to_the_card():
    """``voice_mesh``, ``PolyPatch`` and ``dryrun_multichip`` ask for the
    GPU unless told otherwise; ``dryrun_multichip(n, 'cuda')`` raises where
    torch sees fewer than n GPUs and never falls back to gloo or the CPU,
    and ``voice_mesh`` needs an initialised process group."""
    import inspect

    import torch

    from signals_tpu_torch.entry import dryrun_multichip
    from signals_tpu_torch.parallel import PolyPatch, voice_mesh
    assert inspect.signature(voice_mesh).parameters['device'].default is None
    assert 'default' in voice_mesh.__doc__ and "'cuda'" in voice_mesh.__doc__
    assert inspect.signature(PolyPatch).parameters['device'].default == \
        'cuda'
    assert inspect.signature(dryrun_multichip).parameters[
        'device'].default == 'cuda'
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match='GPUs'):
        dryrun_multichip(have + 1)
    with pytest.raises(RuntimeError, match='process group'):
        voice_mesh(1, device='cpu')
