#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``signals_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Three phases; any failure raises and exits non-zero:

1. **Build** the CUDA kernels from ``signals_tpu_torch/compiler/csrc`` and
   print the toolchain and the card.
2. **Each kernel against its plain PyTorch version** on the card, at the
   shapes the flagship render gives it (64 lanes, F=1024, C=512, 8-block
   carry segments, 256 blocks): the identity-cascade saw source bit-exact,
   filtered lanes within 1e-5 max-abs, group sums within 1e-5 of their max.
3. **The flagship render**: the 64-voice swept-subtractive PolyPatch built
   from the port's nodes, rendered on the card for 256 blocks through the
   product default (generator + mix epilogue), the per-voice plan and the
   timeline kernel (generator off), each with its launch counts reset just
   before it and checked just after; the first 32 blocks held to the port's
   numpy pull oracle within 64 x 1e-5 raw max-abs, every render to the
   default one.  Then the render time of a 60 s batch, kernel path and
   plain path.

Prints one JSON line describing the kernels, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  Imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

RATE = 44100
F = 1024            # block frames (the carry grid)
V = 64              # voices
C = 512             # LowPass.context_for(550 Hz)
M = 8               # blocks per carry segment
N_BLOCKS = 256      # the main-path render
ORACLE_BLOCKS = 32
TOL = 1e-5          # per-voice parity budget
SECONDS = 60.0


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def poly_freqs(n):
    return (110.0 * 2 ** (np.arange(n) % 12 / 12.0)
            * (1 + 0.001 * np.arange(n))).astype(np.float32)


def build_subtractive_voice():
    """Saw -> LowPass (cutoff 2000 + 900*Sine(0.5 Hz)/2 via Gain/Mix) ->
    RingMod with an ADSR gated by a 2 Hz Square -> Gain 1/V."""
    from signals_tpu_torch.nodes.env import ADSR
    from signals_tpu_torch.nodes.fixed import Fixed
    from signals_tpu_torch.nodes.fx import Gain, LowPass, Mix, RingMod
    from signals_tpu_torch.nodes.osc import Sawtooth, Sine, Square

    def fixed(value):
        f = Fixed()
        f.get_state().value = np.atleast_2d(np.float32(value))
        return f

    hz = fixed(110.0)
    saw = Sawtooth()
    saw.hertz = hz
    lfo = Sine()
    lfo.hertz = fixed(0.5)
    depth = Gain()
    depth.left = lfo
    depth.right = fixed(900.0)
    cutoff = Mix()
    cutoff.left = depth
    cutoff.right = fixed(2000.0)
    cutoff.mix = fixed(0.5)
    lp = LowPass()
    lp.input = saw
    lp.cutoff = cutoff
    lp.get_state().context = LowPass.context_for(550.0, RATE)
    gate = Square()
    gate.hertz = fixed(2.0)
    env = ADSR()
    env.gate = gate
    st = env.get_state()
    st.attack, st.decay, st.sustain, st.release = 0.01, 0.08, 0.6, 0.1
    voiced = RingMod()
    voiced.left = lp
    voiced.right = env
    out = Gain()
    out.left = voiced
    out.right = fixed(1.0 / V)
    return out, hz


def cuda_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events,
    after one warmup call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    import torch
    from signals_tpu_torch.compiler import _build
    t0 = time.perf_counter()
    path, out = _build.build(verbose=True)
    print(f'[build] {path.name} in {time.perf_counter() - t0:.1f} s')
    for line in out.splitlines():
        if 'registers' in line or 'spill' in line or 'Compiling' in line:
            print(f'[build] ptxas: {line.strip()}')
    release = [ln for ln in run([_build.nvcc_path(), '--version']).splitlines()
               if 'release' in ln]
    print(f'[build] torch {torch.__version__} cuda {torch.version.cuda}; '
          f'nvcc: {release[0].strip() if release else "?"}')
    print(f'[build] card: {card_line()}')


def card_line() -> str:
    return run(['nvidia-smi', '--query-gpu=name,power.limit',
                '--format=csv,noheader']).splitlines()[0]


def phase_kernels():
    """Each kernel vs its plain version on the card; returns per-kernel
    (max_abs_err, ms, plain_ms)."""
    import torch
    from signals_tpu_torch.compiler import kernels as K
    from signals_tpu_torch.compiler.filters import design_coupled
    from signals_tpu_torch.core.xp import TorchXP
    dev = torch.device('cuda')
    rng = np.random.default_rng(0)
    nb = N_BLOCKS
    geo = dict(n_segments=nb, seg_frames=F, context=C, blocks_per_seg=M)
    cuts = torch.as_tensor(rng.uniform(600.0, 5000.0, (1, nb * V))
                           .astype(np.float32), device=dev)
    co = design_coupled(TorchXP(dev), 'lp', (cuts,), np.float32(RATE / 2))
    co = co.reshape(1, nb, V, 11).permute(1, 0, 2, 3).contiguous()
    toff = torch.full((V,), -C, dtype=torch.int32, device=dev)
    lanef = torch.as_tensor(np.stack([poly_freqs(V), np.zeros(V, np.float32),
                                      np.ones(V, np.float32)]), device=dev)
    gen = dict(geo, osc_code=K.OSC_SAW, rate=RATE)

    # identity cascade (d0 = 1): the kernel's saw must be bit-exact
    co_id = torch.zeros_like(co)
    co_id[..., 8] = 1.0
    src = K.gen_source_rows(toff, lanef, n_segments=nb // M,
                            seg_frames=M * F, context=C, osc_code=K.OSC_SAW,
                            rate=RATE)[:, C:].reshape(nb, F, V)
    got_id = K.sosfilt_segments_gen(co_id, toff, lanef, **gen)
    err_id = float((got_id - src).abs().max())
    print(f'[kernels] segments_gen identity-cascade saw vs source rows: '
          f'max abs {err_id!r} (must be 0.0)')
    assert err_id == 0.0, err_id

    results = {}
    x = K.gen_source_rows(toff, lanef, n_segments=1, seg_frames=nb * F,
                          context=C, osc_code=K.OSC_SAW, rate=RATE)[0]
    cases = {
        'segments_gen': (
            lambda **kw: K.sosfilt_segments_gen(co, toff, lanef, **gen, **kw),
            lambda **kw: K.sosfilt_segments_gen_plain(co, toff, lanef, **gen,
                                                      **kw)),
        'segments': (
            lambda **kw: K.sosfilt_segments(co, x, **geo, **kw),
            lambda **kw: K.sosfilt_segments_plain(co, x, **geo, **kw)),
    }
    for name, (call, plain) in cases.items():
        got, want = call(), plain()
        err = float((got - want).abs().max())
        print(f'[kernels] {name} lanes vs plain: max abs {err!r} '
              f'(tol {TOL})')
        assert torch.isfinite(got).all() and err <= TOL, err
        gsum, wsum = call(sum_groups=V), plain(sum_groups=V)
        rel = float((gsum - wsum).abs().max() / wsum.abs().max())
        print(f'[kernels] {name} sum_groups={V} vs plain: max abs / max '
              f'{rel!r} (tol {TOL})')
        assert gsum.shape == (nb, F, 1) and rel <= TOL, rel
        ms = cuda_ms(lambda: call(sum_groups=V), 20)
        plain_ms = cuda_ms(lambda: plain(sum_groups=V), 1)
        print(f'[kernels] {name} sum_groups={V}, {nb} blocks: kernel '
              f'{ms:.4f} ms, plain {plain_ms:.1f} ms')
        results[name] = (err, ms, plain_ms)
    return results


def oracle_mix(n_blocks):
    """The numpy pull oracle: the V-wide voice patch rendered per block and
    summed over voices."""
    from signals_tpu_torch.core import BlockLoc, Request, Shape
    root, hz = build_subtractive_voice()
    hz.get_state().value = poly_freqs(V).reshape(1, V)
    blocks = []
    for i in range(n_blocks):
        loc = BlockLoc(position=i * F, rate=RATE, shape=Shape(F, V))
        b = root.respond(Request(requestor=None, port='oracle', loc=loc))
        blocks.append(np.broadcast_to(b, (F, V)))
    return np.concatenate(blocks).sum(axis=1, keepdims=True)


def make_poly(**kw):
    from signals_tpu_torch.parallel import PolyPatch
    root, hz = build_subtractive_voice()
    return PolyPatch(root, n_voices=V, overrides={(hz, 'value'): poly_freqs(V)},
                     block_frames=F, rate=RATE, layout='channels',
                     device='cuda', **kw)


@contextlib.contextmanager
def plain_kernels():
    """Within this block the kernel wrappers are swapped for their plain
    PyTorch versions (the node lowerings look them up at call time): the
    plain path on the card, for timing it beside the kernels."""
    from signals_tpu_torch.compiler import kernels as K
    saved = K.sosfilt_segments_gen, K.sosfilt_segments
    K.sosfilt_segments_gen = K.sosfilt_segments_gen_plain
    K.sosfilt_segments = K.sosfilt_segments_plain
    try:
        yield
    finally:
        K.sosfilt_segments_gen, K.sosfilt_segments = saved


def phase_render():
    """The flagship through the port's entry points.  Returns, per kernel,
    ``(launches, render)``: its launch count in the render that proves it
    (the default render for K1, the generator-off render for K2)."""
    import torch
    from signals_tpu_torch.compiler import filters, kernels as K
    default = make_poly()
    assert default._mix_epilogue, 'mix epilogue not on for cuda'
    assert default.compiled.mega_mix(N_BLOCKS) is not None, \
        'the flagship is not eligible for the mix plan'
    per_voice = make_poly(mix_epilogue=False)
    filters.SEG_SOURCE_GEN = False       # compile-time snapshot
    gen_off = make_poly()
    filters.SEG_SOURCE_GEN = 'auto'
    variants = (
        ('default (generator + mix epilogue)', default,
         {'segments_gen': 1, 'segments': 0}),
        ('mix_epilogue=False', per_voice, {'segments_gen': 1, 'segments': 0}),
        ('generator off (timeline kernel)', gen_off,
         {'segments_gen': 0, 'segments': 1}),
    )
    mixes, counts = {}, {}
    for name, poly, expect in variants:
        K.reset_launch_counts()
        mixes[name] = poly.render(n_blocks=N_BLOCKS)
        torch.cuda.synchronize()
        counts[name] = dict(K.LAUNCHES)
        print(f'[render] {name}: launches {counts[name]}')
        assert counts[name] == expect, (name, counts[name], expect)

    t0 = time.perf_counter()
    want = oracle_mix(ORACLE_BLOCKS)
    print(f'[render] numpy oracle, {ORACLE_BLOCKS} blocks: '
          f'{time.perf_counter() - t0:.1f} s')
    budget = V * TOL
    ref = None
    for name, mix in mixes.items():
        got = mix.cpu().numpy()
        assert got.shape == (N_BLOCKS * F, 1), got.shape
        assert np.isfinite(got).all(), name
        err = float(np.abs(got[:ORACLE_BLOCKS * F] - want).max())
        print(f'[render] {name}: vs oracle max abs {err!r} '
              f'(budget {budget:g}, peak {float(np.abs(want).max())!r})')
        assert err <= budget, (name, err)
        if ref is None:
            ref = got
        else:
            diff = float(np.abs(got - ref).max())
            print(f'[render] {name}: vs default over {N_BLOCKS} blocks '
                  f'max abs {diff!r}')
            assert diff <= budget, (name, diff)

    n60 = int(np.ceil(SECONDS * RATE / F / M)) * M
    audio_s = n60 * F / RATE
    card = card_line()
    for name, poly in (('kernel path (default plan)', default),
                       ('kernel path (mix_epilogue=False)', per_voice)):
        ms = cuda_ms(lambda: poly.render(n_blocks=n60), 3)
        print(f'[render] {name}: {n60} blocks ({audio_s:.3f} s audio) in '
              f'{ms:.3f} ms = {audio_s / (ms / 1e3):.1f}x realtime  [{card}]')
    with plain_kernels():
        ms = cuda_ms(lambda: default.render(n_blocks=n60), 1)
    print(f'[render] plain path (default plan, plain PyTorch cascade): '
          f'{ms:.1f} ms = {audio_s / (ms / 1e3):.1f}x realtime  [{card}]')
    return {'segments_gen': (counts[variants[0][0]]['segments_gen'],
                             variants[0][0]),
            'segments': (counts[variants[2][0]]['segments'],
                         variants[2][0])}


def main() -> int:
    try:
        import torch
        import signals_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f'chip_smoke: cannot import the port ({e}); run it from the '
              f'repository root', file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA GPU visible to torch', file=sys.stderr)
        return 2
    assert 'jax' not in sys.modules and 'signals_tpu' not in sys.modules
    phase_build()
    kern = phase_kernels()
    launches = phase_render()
    assert 'jax' not in sys.modules and 'signals_tpu' not in sys.modules
    src = 'signals_tpu_torch/compiler/csrc/segments.cu'
    replaces = {'segments_gen': 'signals_tpu/compiler/pallas_kernels.py:1228',
                'segments': 'signals_tpu/compiler/pallas_kernels.py:519'}
    print(json.dumps({'kernels': [
        {'name': f'sosfilt_{name}', 'route': 'cuda', 'source': src,
         'replaces': replaces[name], 'launches': launches[name][0],
         'launched_by': f'flagship render, {launches[name][1]}',
         'max_abs_err': kern[name][0], 'ms': kern[name][1],
         'plain_ms': kern[name][2]} for name in ('segments_gen', 'segments')]}))
    print(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
