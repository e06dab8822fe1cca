"""The flagship forward step as one callable.

``entry(device='cuda')`` builds the 64-voice subtractive patch (saw ->
LFO-swept LowPass -> RingMod(ADSR gated by a 2 Hz Square) -> Gain 1/64) as
a ``PolyPatch(layout='vmap')`` and returns ``(forward, (params, carry,
0))``: ``forward(params, carry, position)`` renders one block of every
voice — ``torch.func.vmap`` of one voice's ``step`` over the stacked
per-voice params and carry — and sums the voices into the master mix,
returning ``(mix (F, 1), carry')`` on the device.  The patch and its
per-voice pitches are those of the JAX package's ``__graft_entry__.entry``.

``dryrun_multichip(n_devices, device='cuda')`` is the JAX package's
multi-device dry run on ``torch.distributed``: it starts one process a
device (NCCL on GPUs, gloo on the CPU), shards the voice axis over a
:func:`~signals_tpu_torch.parallel.voice_mesh` of them, and runs one
training step of the vmap layout (the mix and the loss summed over the
ranks), the channels layout's sharded render, a sharded ``PolyPatch.fit``
and the weak-scaling timings, printed by rank 0.

    >>> # forward, (params, carry, position) = entry(device='cpu')
    >>> # mix, carry = forward(params, carry, position)
    >>> # dryrun_multichip(2, device='cpu')
"""

from __future__ import annotations

import os
import tempfile
import time
import warnings

import numpy as np
import torch

RATE = 44100
N_VOICES = 64
BLOCK_FRAMES = 1024


def _fixed(value):
    from signals_tpu_torch.nodes.fixed import Fixed
    f = Fixed()
    f.get_state().value = np.atleast_2d(np.asarray(value, dtype=np.float32))
    return f


def subtractive_voice():
    """``(root, hz)``: one voice of the flagship, its pitch at ``hz``."""
    from signals_tpu_torch.nodes.env import ADSR
    from signals_tpu_torch.nodes.fx import Gain, LowPass, Mix, RingMod
    from signals_tpu_torch.nodes.osc import Sawtooth, Sine, Square
    hz = _fixed(110.0)
    saw = Sawtooth()
    saw.hertz = hz
    lfo = Sine()
    lfo.hertz = _fixed(0.5)
    depth = Gain()
    depth.left = lfo
    depth.right = _fixed(900.0)
    cutoff = Mix()
    cutoff.left = depth
    cutoff.right = _fixed(2000.0)
    cutoff.mix = _fixed(0.5)
    lp = LowPass()
    lp.input = saw
    lp.cutoff = cutoff
    gate = Square()
    gate.hertz = _fixed(2.0)
    env = ADSR()
    env.gate = gate
    voiced = RingMod()
    voiced.left = lp
    voiced.right = env
    out = Gain()
    out.left = voiced
    out.right = _fixed(1.0 / N_VOICES)
    return out, hz


def _poly(n_voices: int, block_frames: int, device, mesh=None,
          layout='vmap'):
    """``(PolyPatch, its pitch node)`` of the flagship at ``n_voices``, one
    pitch a voice (110 Hz up the chromatic scale, an octave every 12
    voices)."""
    from signals_tpu_torch.parallel import PolyPatch
    root, hz = subtractive_voice()
    freqs = (110.0 * 2 ** (np.arange(n_voices) % 12 / 12.0)).astype(
        np.float32)
    kw = {'channels': 1} if layout == 'vmap' else {}
    return PolyPatch(root, n_voices=n_voices,
                     overrides={(hz, 'value'): freqs},
                     block_frames=block_frames, rate=RATE, layout=layout,
                     mesh=mesh, device=device, **kw), hz


def poly(n_voices: int = N_VOICES, block_frames: int = BLOCK_FRAMES,
         device='cuda'):
    """The flagship's ``PolyPatch`` in the vmap layout."""
    return _poly(n_voices, block_frames, device)[0]


def entry(device='cuda'):
    """``(forward, (params, carry, 0))``: one vmapped and mixed block of the
    64-voice patch on ``device``."""
    p = poly(device=device)
    compiled = p.compiled
    F, ch = compiled.block_frames, compiled.channels
    params, axes = p.params()
    #: a (V, 0) tensor vmapped on dim 0 gives every vmap the voice count
    voices = torch.empty((p.n_voices, 0), device=p.device)

    def voice_step(params, carry, position, _voice):
        block, carry2 = compiled.step(params, carry, position)
        return torch.broadcast_to(block, (F, ch)), carry2

    vstep = torch.func.vmap(voice_step, in_dims=(axes, 0, None, 0))

    def forward(params, carry, position):
        blocks, carry2 = vstep(params, carry, position, voices)
        return blocks.sum(dim=0), carry2

    return forward, (params, p.init_carry(), 0)


def dryrun_multichip(n_devices: int, device='cuda') -> None:
    """Run the sharded training step and its checks on ``n_devices``
    processes, one a device: ``'cuda'`` needs ``n_devices`` GPUs (NCCL; it
    raises where torch sees fewer, and never falls back to the CPU),
    ``'cpu'`` runs gloo processes.  The process group meets through a
    ``file://`` store in a temporary directory (no TCP port).  A failure on
    any rank raises here."""
    import torch.multiprocessing as mp
    device_type = torch.device(device).type
    if device_type == 'cuda':
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(f'dryrun_multichip({n_devices}, "cuda") needs '
                               f'{n_devices} GPUs; torch sees {have}')
    elif device_type != 'cpu':
        raise ValueError(f'unsupported device {device!r}')
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_dryrun_rank, nprocs=n_devices,
                 args=(n_devices, device_type, os.path.join(tmp, 'store')))


def _dryrun_rank(rank: int, world: int, device: str, store: str) -> None:
    import torch.distributed as dist
    if device == 'cuda':
        torch.cuda.set_device(rank)
    dist.init_process_group('nccl' if device == 'cuda' else 'gloo',
                            init_method=f'file://{store}',
                            world_size=world, rank=rank)
    try:
        _dryrun_multichip_impl(world, device)
    finally:
        dist.destroy_process_group()


def _dryrun_multichip_impl(n_devices: int, device: str) -> None:
    """One rank of :func:`dryrun_multichip`; rank 0 prints."""
    import torch.distributed as dist

    from signals_tpu_torch import learn
    from signals_tpu_torch.parallel import (MIN_EFFICIENT_VOICES_PER_DEVICE,
                                            efficient_device_count,
                                            voice_mesh)
    rank = dist.get_rank()

    def say(text):
        if rank == 0:
            print(text, flush=True)

    def sync():
        if device == 'cuda':
            torch.cuda.synchronize()

    # the validation shards tiny patches on purpose: the lane-efficiency
    # policy's warning is checked once, below
    warnings.simplefilter('ignore', RuntimeWarning)
    mesh = voice_mesh(n_devices, device=device)
    n_voices, F, n_blocks = 2 * n_devices, 64, 2

    # one training step of the vmap layout: the voices' pitches trained
    # against silence (L2), the mix and the loss summed over the ranks
    p, hz = _poly(n_voices, F, device, mesh)
    params, _ = p.params()
    key = (p.compiled.index.info(hz).uid, 'value')
    train = learn._split_train(params, {key})
    shape = train[key[0]]['value'].shape
    render = p.render_fn(n_blocks)
    carry = p.init_carry()

    def l2(tp):
        mix, _ = render(learn._merge_train(params, tp), carry, 0)
        return torch.mean(mix ** 2)

    train, losses = learn.fused_descent(l2, train, steps=1,
                                        learning_rate=1e-2)
    assert np.isfinite(losses[0]), losses
    assert train[key[0]]['value'].shape == shape
    say(f'dryrun_multichip({n_devices}): one sharded training step OK, '
        f'loss={losses[0]:.6f}')

    # the channels layout under the mesh: the rank's voice lanes, the mix
    # summed over the ranks
    pc, hzc = _poly(n_voices, F, device, mesh, layout='channels')
    audio, _ = pc.render(n_blocks=n_blocks)
    assert audio.shape == (n_blocks * F, 1)
    assert bool(torch.isfinite(audio).all())
    say(f'dryrun_multichip({n_devices}): channels-layout sharded render '
        f'OK, peak={float(audio.abs().max()):.4f}')

    # the product training API under the mesh
    res = pc.fit(np.zeros((n_blocks * F, 1), np.float32), [(hzc, 'value')],
                 steps=3, learning_rate=0.01, apply=False)
    assert np.isfinite(res.losses).all(), res.losses
    say(f'dryrun_multichip({n_devices}): sharded PolyPatch.fit OK, loss '
        f'{res.losses[0]:.6f} -> {res.losses[-1]:.6f}')

    # weak scaling: the channels layout's sharded render at 1, 2, 4, ...
    # ranks with the voices a rank fixed (best of 5, rank 0's clock)
    def render_ms(n_voices, mesh, nb):
        ps, _ = _poly(n_voices, F, device, mesh, layout='channels')
        pp, _ = ps.params()
        fn = ps.render_fn(nb)
        fn(pp, ps.init_carry(), 0)   # warm up
        sync()
        reps = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn(pp, ps.init_carry(), 0)
            sync()
            reps.append((time.perf_counter() - t0) * 1e3)
        return round(min(reps), 3)

    def sweep(per_rank, nb):
        counts, d = [], 1
        while d < n_devices:
            counts.append(d)
            d *= 2
        counts.append(n_devices)
        ms = {}
        for d in counts:
            sub = voice_mesh(d, device=device)
            if rank < d:
                ms[d] = render_ms(per_rank * d, sub, nb)
            dist.barrier()
        return {d: {'t_ms': t, 'vs_1dev': round(t / ms[1], 2)}
                for d, t in ms.items()} if rank == 0 else None

    per, nb = 8, 16
    table = sweep(per, nb)
    one = voice_mesh(1, device=device)
    t_all = render_ms(per * n_devices, one, nb) if rank == 0 else None
    dist.barrier()
    say(f'dryrun_multichip weak scaling (fixed {per} voices/rank, {nb} '
        f'blocks of {F}, {device}, one process a rank): {table}; one rank '
        f'rendering all {per * n_devices} voices: {t_all} ms; the only '
        f'traffic between ranks is the all_reduce of the ({nb}*{F}, 1) '
        f'mix, {nb * F * 4} bytes a render')

    # the lane-efficiency policy: a narrow pinned mesh warns, an unpinned
    # one is capped
    total = per * n_devices
    if n_devices > 1:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            voice_mesh(n_devices, device=device, n_voices=total)
        assert any('lane-efficiency' in str(w.message) for w in caught), \
            'a narrow pinned mesh must warn'
    capped = voice_mesh(device=device, n_voices=total).size()
    assert capped == efficient_device_count(total, n_devices), capped
    say(f'dryrun_multichip policy: voice_mesh(n_voices={total}) picks '
        f'{capped} rank(s) (knee {MIN_EFFICIENT_VOICES_PER_DEVICE} '
        f'voices/device, {n_devices} available); narrow pinned meshes warn')

    # weak scaling at the width the policy endorses
    eff = MIN_EFFICIENT_VOICES_PER_DEVICE
    say(f'dryrun_multichip weak scaling at the policy width (fixed {eff} '
        f'voices/rank, 8 blocks of {F}, {device}): {sweep(eff, 8)}; total '
        f'at {n_devices} ranks {eff * n_devices} voices')


if __name__ == '__main__':
    fn, args = entry()
    out, _ = fn(*args)
    print('entry forward:', tuple(out.shape), float(out.abs().max()))
