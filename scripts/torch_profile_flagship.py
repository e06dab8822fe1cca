#!/usr/bin/env python3
"""Where the time of the port's renders goes, on one NVIDIA GPU.

Renders ``chip_smoke.py``'s patches through the port's entry points:

* the 64-voice swept-subtractive PolyPatch, a 60 s batch, through both
  plans (the mix-epilogue plan, the CUDA default, and the per-voice plan);
* the mono subtractive voice, a 60 s batch;
* the static-cutoff voice at 16 channels: one ``step`` and one 8-block
  render-ahead batch, as the ``Transport`` renders them (each copied off
  the card);
* carried state: the saturated echo (segmented feedback scan, 162
  segments of 16 blocks; and again with its streaming filter's
  ``mega_step`` taking the per-block-coefficient form), the FM voice with
  a feedback delay (the
  loop-free delay solver, 60 s), and the static voice as a streaming
  filter, one ``step`` and one 8-block batch.

For each it prints the time by CUDA events, and from one ``torch.profiler``
run the device-side events only (kernels and memory copies/sets, each
counted once, not again under the host op that issued it): device time by
name, the number of kernels, and the device busy share (device time over
the profiled wall time).  Writes the full tables to
``chiprun_out/profile.txt``.

    python3 scripts/torch_profile_flagship.py
"""

from __future__ import annotations

import collections
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402


def device_events(prof):
    """``{name: [count, microseconds]}`` of the events that ran on the
    device.  Host ops appear only with their own device type and are left
    out, so no kernel is counted twice."""
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.elapsed_us()
    return by_name


def is_kernel(name: str) -> bool:
    return not name.startswith(('Memcpy', 'Memset'))


def cells():
    """``(name, render callable, audio seconds it renders)``."""
    from signals_tpu_torch.compiler import compile_node
    n = int(np.ceil(cs.SECONDS * cs.RATE / cs.F / cs.M)) * cs.M
    audio_s = n * cs.F / cs.RATE
    for name, kw in (('flagship, mix-epilogue plan', {}),
                     ('flagship, per-voice plan', {'mix_epilogue': False})):
        poly = cs.make_poly(**kw)
        yield name, lambda poly=poly: poly.render(n_blocks=n)[0], audio_s
    mono = compile_node(cs.build_subtractive_voice(gain=1.0 / 64)[0],
                        block_frames=cs.F, rate=cs.RATE, channels=1,
                        device='cuda')
    yield 'mono voice, 60 s', lambda: mono.render(n_blocks=n)[0], audio_s
    static = compile_node(cs.build_static_voice(), block_frames=cs.F,
                          rate=cs.RATE, channels=cs.STATIC_CH, device='cuda')
    params = static.params()
    yield ('static voice, one step',
           lambda: static.step(params, {}, 5 * cs.F)[0].cpu(),
           cs.F / cs.RATE)
    yield ('static voice, one 8-block render-ahead batch',
           lambda: static.render(position=8 * cs.F,
                                 n_blocks=cs.AHEAD)[0].cpu(),
           cs.AHEAD * cs.F / cs.RATE)
    echo = compile_node(cs.build_saturated_echo(), block_frames=cs.F,
                        rate=cs.RATE, channels=1, device='cuda')
    n_echo = -(-n // cs.ECHO_BLOCKS) * cs.ECHO_BLOCKS
    yield (f'saturated echo, {n_echo} blocks ({echo.plan(n_echo)})',
           lambda: echo.render(n_blocks=n_echo)[0], n_echo * cs.F / cs.RATE)
    # the same with mega_step's fixed-cutoff shortcut off: per-block
    # coefficients, the batched launch, the scan and the f64 correction
    general = compile_node(cs.build_saturated_echo(), block_frames=cs.F,
                           rate=cs.RATE, channels=1, device='cuda')
    for node in general.index.order:
        if getattr(node, 'supports_mega_step', False):
            node.crits_static = lambda: False
    yield (f'saturated echo, {n_echo} blocks, mega_step without the '
           f'fixed-cutoff shortcut',
           lambda: general.render(n_blocks=n_echo)[0],
           n_echo * cs.F / cs.RATE)
    fm = compile_node(cs.build_fm_delay(), block_frames=cs.F, rate=cs.RATE,
                      channels=1, device='cuda')
    yield (f'FM + feedback delay, 60 s ({fm.plan(n)})',
           lambda: fm.render(n_blocks=n)[0], audio_s)
    voice = compile_node(cs.build_static_voice(streaming=True),
                         block_frames=cs.F, rate=cs.RATE,
                         channels=cs.STATIC_CH, device='cuda')
    vparams = voice.params()
    yield ('streaming static voice, one step',
           lambda: voice.step(vparams, voice.carry0, 5 * cs.F)[0].cpu(),
           cs.F / cs.RATE)
    yield ('streaming static voice, one 8-block batch',
           lambda: voice.render(position=8 * cs.F,
                                n_blocks=cs.AHEAD)[0].cpu(),
           cs.AHEAD * cs.F / cs.RATE)


def main() -> int:
    if not torch.cuda.is_available():
        print('needs an NVIDIA GPU', file=sys.stderr)
        return 2
    card = cs.card_line()
    out = ROOT / 'chiprun_out'
    out.mkdir(exist_ok=True)
    lines = []
    for name, render, audio_s in cells():
        ms = cs.cuda_ms(render, 5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            render()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        evts = device_events(prof)
        dev_us = sum(us for _, us in evts.values())
        n_kernels = sum(c for k, (c, _) in evts.items() if is_kernel(k))
        n_copies = sum(c for k, (c, _) in evts.items() if not is_kernel(k))
        head = (f'{name}: {audio_s:.3f} s of audio in {ms:.3f} ms by CUDA '
                f'events = {audio_s / (ms / 1e3):.1f}x realtime; profiled: '
                f'device {dev_us / 1e3:.3f} ms in {n_kernels} kernels + '
                f'{n_copies} copies/sets over {wall_us / 1e3:.3f} ms wall, '
                f'busy share {dev_us / wall_us:.3f}  [{card}]')
        print(head)
        lines.append(head)
        ranked = sorted(evts.items(), key=lambda kv: -kv[1][1])
        for i, (key, (count, us)) in enumerate(ranked):
            row = f'  {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}'
            if i < 8:
                print(row)
            lines.append(row)
        lines.append(prof.key_averages().table(
            sort_by='self_cpu_time_total', row_limit=40))
    (out / 'profile.txt').write_text('\n'.join(lines) + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
