"""One rank of the voice-mesh checks of ``tests/test_torch_mesh.py``.

Run as ``python tests/torch_mesh_worker.py RANK WORLD STORE OUT``: the rank
joins a gloo process group of ``WORLD`` ranks through the ``file://`` store
``STORE``, shards the voices over ``voice_mesh(WORLD, device='cpu')``, runs
:func:`checks` and writes its results to ``OUT/rank{RANK}.npz``.  The test
runs :func:`checks` without a mesh in its own process for the reference.
Nothing here imports JAX.
"""

from __future__ import annotations

import importlib
import pathlib
import sys
import warnings

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

F = 64            # frames a block
RATE = 44100
V = 16            # voices
NB = 4            # blocks a render
FIT_STEPS = 3
#: (name, layout, mix_epilogue) of every render checked
LAYOUTS = (('vmap', 'vmap', None), ('channels', 'channels', False),
           ('channels_epilogue', 'channels', True))
FREQS = np.linspace(110.0, 880.0, V).astype(np.float32)
TARGET = (0.01 * np.random.default_rng(16).standard_normal((NB * F, 1))
          ).astype(np.float32)


def voice(pkg: str = 'signals_tpu_torch'):
    """``(root, hz, center)``: the flagship's voice built from ``pkg``'s
    nodes (saw -> LowPass swept by an LFO around ``center`` -> RingMod by
    an ADSR gated at 8 Hz -> gain 1 / V); ``hz`` takes the per-voice
    pitches, ``center`` (the cutoff's centre, 2000 Hz) stays shared."""
    def node(mod, cls):
        return getattr(importlib.import_module(f'{pkg}.nodes.{mod}'), cls)()

    def fixed(value):
        f = node('fixed', 'Fixed')
        f.get_state().value = np.array([[value]], dtype=np.float32)
        return f

    hz, center = fixed(110.0), fixed(2000.0)
    saw = node('osc', 'Sawtooth')
    saw.hertz = hz
    lfo = node('osc', 'Sine')
    lfo.hertz = fixed(3.0)
    depth = node('fx', 'Gain')
    depth.left = lfo
    depth.right = fixed(900.0)
    cutoff = node('fx', 'Mix')
    cutoff.left = depth
    cutoff.right = center
    cutoff.mix = fixed(0.5)
    lp = node('fx', 'LowPass')
    lp.input = saw
    lp.cutoff = cutoff
    gate = node('osc', 'Square')
    gate.hertz = fixed(8.0)
    env = node('env', 'ADSR')
    env.gate = gate
    ring = node('fx', 'RingMod')
    ring.left = lp
    ring.right = env
    out = node('fx', 'Gain')
    out.left = ring
    out.right = fixed(1.0 / V)
    return out, hz, center


def mse(pred, target):
    return ((pred - target) ** 2).mean()


def poly(layout, mix_epilogue, mesh, n_voices=V):
    from signals_tpu_torch.parallel import PolyPatch
    root, hz, center = voice()
    kw = {'channels': 1} if layout == 'vmap' else {}
    p = PolyPatch(root, n_voices=n_voices,
                  overrides={(hz, 'value'): FREQS[:n_voices]},
                  block_frames=F, rate=RATE, layout=layout,
                  mix_epilogue=mix_epilogue, mesh=mesh, device='cpu', **kw)
    return p, hz, center


def fit_case(layout, mesh) -> dict:
    """A 3-step ``PolyPatch.fit`` of the per-voice pitches and the shared
    centre against ``TARGET`` (L2), ``apply=True``: each step's loss, the
    gradients the update used (seen by a hook on each trained leaf, the
    shared one after the mesh's sum over the ranks), and the pitches
    written back."""
    from signals_tpu_torch import learn
    p, hz, center = poly(layout, False, mesh)
    index = p.compiled.index
    role = {(index.info(hz).uid, 'value'): 'hz',
            (index.info(center).uid, 'value'): 'center'}
    seen = {'hz': [], 'center': []}
    descent = learn.fused_descent

    def spy(loss_fn, train, **kw):
        # a hook on each trained leaf sees the gradient the update uses
        # (the shared one after the mesh's sum over the ranks)
        hooks = [train[uid][k].register_hook(
            lambda g, who=role[(uid, k)]:
                seen[who].append(g.detach().reshape(-1).numpy().copy()))
            for uid in train for k in train[uid]]
        try:
            return descent(loss_fn, train, **kw)
        finally:
            for h in hooks:
                h.remove()

    learn.fused_descent = spy
    try:
        res = p.fit(TARGET, [(hz, 'value'), (center, 'value')],
                    steps=FIT_STEPS, learning_rate=0.01, loss=mse)
    finally:
        learn.fused_descent = descent
    if layout == 'vmap':
        fitted = p._overrides[(index.info(hz).uid, 'value')]
    else:
        fitted = p._channel_overrides[0][3]
    return {f'fit_losses/{layout}': np.asarray(res.losses),
            f'fit_hz_grad/{layout}': np.stack(seen['hz']),
            f'fit_center_grad/{layout}': np.stack(seen['center']),
            f'fit_hz/{layout}': np.asarray(fitted).reshape(-1),
            f'fit_center/{layout}': np.asarray(
                center.get_state().value).reshape(-1)}


def checks(mesh=None) -> dict:
    """Every render of the checks (``mix/``, ``seek/`` from block 3,
    ``edit/`` after ``set_override``) in each of ``LAYOUTS``, and the fits
    of :func:`fit_case`; under a mesh also its refusal of indivisible
    voices and its policy."""
    r = {}
    with warnings.catch_warnings():
        # 16 voices over a few ranks is far below the policy's knee
        warnings.simplefilter('ignore', RuntimeWarning)
        for name, layout, epilogue in LAYOUTS:
            p, hz, _ = poly(layout, epilogue, mesh)
            r[f'mix/{name}'] = p.render(n_blocks=NB)[0].numpy()
            r[f'seek/{name}'] = p.render(position=3 * F,
                                         n_blocks=1)[0].numpy()
            p.set_override(hz, 'value', FREQS * 1.5)
            r[f'edit/{name}'] = p.render(n_blocks=2)[0].numpy()
        for layout in ('vmap', 'channels'):
            r.update(fit_case(layout, mesh))
        if mesh is None:
            return r
        for layout in ('vmap', 'channels'):
            try:
                poly(layout, False, mesh, n_voices=V + 1)
                r[f'indivisible/{layout}'] = np.array('accepted')
            except ValueError as e:
                r[f'indivisible/{layout}'] = np.array(str(e))
    from signals_tpu_torch.parallel import voice_mesh
    world = mesh.size()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        voice_mesh(world, device='cpu', n_voices=8 * world)
    r['policy/warning'] = np.array(' | '.join(str(w.message)
                                              for w in caught))
    r['policy/capped'] = np.array(voice_mesh(device='cpu',
                                             n_voices=8 * world).size())
    r['policy/full'] = np.array(voice_mesh(device='cpu',
                                           n_voices=64 * world).size())
    r['mesh/rank'] = np.array(mesh.get_local_rank(0))
    return r


def main(rank: int, world: int, store: str, out: str) -> None:
    import torch.distributed as dist

    from signals_tpu_torch.parallel import voice_mesh
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'file://{store}',
                            world_size=world, rank=rank)
    try:
        r = checks(voice_mesh(world, device='cpu'))
        np.savez(pathlib.Path(out) / f'rank{rank}.npz', **r)
    finally:
        dist.destroy_process_group()


if __name__ == '__main__':
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
