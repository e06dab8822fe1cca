#!/usr/bin/env python3
"""Where the time of the port's flagship render goes, on one NVIDIA GPU.

Renders the 64-voice swept-subtractive PolyPatch (``chip_smoke.py``'s
patch) for a 60 s batch through both plans — the mix-epilogue plan (the
CUDA default) and the per-voice plan — and prints, per plan: the render
time by CUDA events, and from one ``torch.profiler`` run the device-side
events only (kernels and memory copies/sets, each counted once, not again
under the host op that issued it): device time by name, the number of
kernels, and the device busy share (device time over the profiled wall
time).  Writes the full tables to ``chiprun_out/profile_flagship.txt``.

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


def main() -> int:
    if not torch.cuda.is_available():
        print('needs an NVIDIA GPU', file=sys.stderr)
        return 2
    n = int(np.ceil(cs.SECONDS * cs.RATE / cs.F / cs.M)) * cs.M
    audio_s = n * cs.F / cs.RATE
    card = cs.card_line()
    out = ROOT / 'chiprun_out'
    out.mkdir(exist_ok=True)
    lines = []
    for name, kw in (('mix-epilogue plan', {}),
                     ('per-voice plan', {'mix_epilogue': False})):
        poly = cs.make_poly(**kw)
        ms = cs.cuda_ms(lambda: poly.render(n_blocks=n), 5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            poly.render(n_blocks=n)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        evts = device_events(prof)
        dev_us = sum(us for _, us in evts.values())
        n_kernels = sum(c for k, (c, _) in evts.items() if is_kernel(k))
        n_copies = sum(c for k, (c, _) in evts.items() if not is_kernel(k))
        head = (f'{name}: {n} blocks ({audio_s:.3f} s) in {ms:.3f} ms by '
                f'CUDA events = {audio_s / (ms / 1e3):.1f}x realtime; '
                f'profiled: device {dev_us / 1e3:.3f} ms in {n_kernels} '
                f'kernels + {n_copies} copies/sets over {wall_us / 1e3:.3f} '
                f'ms wall, busy share {dev_us / wall_us:.3f}  [{card}]')
        print(head)
        lines.append(head)
        ranked = sorted(evts.items(), key=lambda kv: -kv[1][1])
        for i, (key, (count, us)) in enumerate(ranked):
            row = f'  {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}'
            if i < 12:
                print(row)
            lines.append(row)
        lines.append(prof.key_averages().table(
            sort_by='self_cpu_time_total', row_limit=40))
    (out / 'profile_flagship.txt').write_text('\n'.join(lines) + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
