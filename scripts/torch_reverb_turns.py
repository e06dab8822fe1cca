#!/usr/bin/env python3
"""The reverb's feedback delay network on one NVIDIA GPU: the hand-written
kernels of ``signals_tpu_torch/compiler/csrc/fdn.cu`` against their plain
turn loops.

``fdn_advance`` advances the eight delay lines over a window in turns of
``min(lengths)`` frames (1310 at 44.1 kHz, ~2020 turns for 60 s), one CTA
a lane group with a block barrier a turn; the plain version is an eager
loop of ~18 small kernels a turn.  In one process, in turns (plain,
kernel, kernel, plain), this script prints:

* the forward's device time (``torch.profiler``, 3 calls) and the plain
  loop's (CUDA events) at the master bus's shape (one lane, 60 s) and at
  64 folded voices with per-lane decay times (60 s), each kernel call
  checked bit for bit against the plain loop;
* the adjoint ``fdn_advance_vjp`` against the plain adjoint at one lane,
  60 s (within 1e-5 of each output's largest value);
* the 60 s master bus (``chip_smoke.build_master_bus``, bench c7) rendered
  with the kernel and with the plain loop: wall (host clock, one
  synchronised call after a warmup), device time and the number of
  kernels and copies (``torch.profiler``), the same bits audio and carry.

    python3 scripts/torch_reverb_turns.py
"""

from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from signals_tpu_torch.compiler import compile_node  # noqa: E402
from signals_tpu_torch.compiler import kernels as K  # noqa: E402


def network(card, n60) -> None:
    lengths = cs.fdn_lengths()
    L = max(lengths)
    for lanes in (1, cs.V):
        lines, inject, g = cs.fdn_inputs(lanes, n60 * cs.F, 31 + lanes)
        want = K.fdn_advance_plain(lines, inject, g, lengths)
        times = []
        for kind in ('plain', 'kernel', 'kernel', 'plain'):
            if kind == 'kernel':
                got = K.fdn_advance(lines, inject, g, lengths)
                assert torch.equal(got, want), lanes
                del got
                ms, how = cs.kernel_device_ms(
                    lambda: K.fdn_advance(lines, inject, g, lengths), 3,
                    ('fdn_advance',))
            else:
                ms, how = cs.cuda_ms(lambda: K.fdn_advance_plain(
                    lines, inject, g, lengths), 2), 'CUDA events'
            times.append(f'{kind} {ms:.3f} ms ({how})')
        print(f'[reverb] fdn_advance, {lanes} lane(s) x {n60 * cs.F} '
              f'frames: {"; ".join(times)}; the kernel gives the plain '
              f'loop\'s bits  [{card}]')
        del lines, inject, g, want
        torch.cuda.empty_cache()
    lines, inject, g = cs.fdn_inputs(1, n60 * cs.F, 41)
    tl = K.fdn_advance(lines, inject, g, lengths)
    gtl = torch.randn(tl.shape, device='cuda',
                      generator=torch.Generator('cuda').manual_seed(41))
    want = K.fdn_advance_vjp_plain(tl, g, gtl, lengths, L)
    got = K.fdn_advance_vjp(tl, g, gtl, lengths, L)
    rel = max(cs.rel_max(a, w) for a, w in zip(got, want))
    assert rel <= 1e-5, rel
    times = []
    for kind in ('plain', 'kernel', 'kernel', 'plain'):
        if kind == 'kernel':
            ms, how = cs.kernel_device_ms(
                lambda: K.fdn_advance_vjp(tl, g, gtl, lengths, L), 3,
                ('fdn_advance_vjp',))
        else:
            ms, how = cs.cuda_ms(lambda: K.fdn_advance_vjp_plain(
                tl, g, gtl, lengths, L), 1), 'CUDA events'
        times.append(f'{kind} {ms:.3f} ms ({how})')
    print(f'[reverb] fdn_advance_vjp, 1 lane x {n60 * cs.F} frames: '
          f'{"; ".join(times)}; vs the plain adjoint {rel!r} of the largest '
          f'value  [{card}]')


def master_bus(card, n60) -> None:
    patch = compile_node(cs.build_master_bus(), block_frames=cs.F,
                         rate=cs.RATE, channels=1, device='cuda')
    outs = {}
    for kind in ('plain', 'kernel', 'kernel', 'plain'):
        if kind == 'plain':
            with cs.plain_fdn():
                outs[kind] = patch.render(n_blocks=n60)
                wall, dev, events = cs.profiled(
                    lambda: patch.render(n_blocks=n60))
        else:
            outs[kind] = patch.render(n_blocks=n60)
            wall, dev, events = cs.profiled(
                lambda: patch.render(n_blocks=n60))
        print(f'[reverb] master_bus, {n60} blocks, {kind}: wall {wall:.3f} '
              f'ms, device {dev:.3f} ms in {events} kernels and copies  '
              f'[{card}]')
    (a, ca), (b, cb) = outs['kernel'], outs['plain']
    same = torch.equal(a, b) and all(torch.equal(ca[u][k], cb[u][k])
                                     for u in ca for k in ca[u])
    print(f'[reverb] master_bus: kernel and plain loop give the same bits, '
          f'audio and carry: {same}')
    assert same


def main() -> int:
    if not torch.cuda.is_available():
        print('torch_reverb_turns: no CUDA GPU visible to torch',
              file=sys.stderr)
        return 2
    card = cs.card_line()
    n60 = cs.n_blocks_60s()
    network(card, n60)
    master_bus(card, n60)
    return 0


if __name__ == '__main__':
    sys.exit(main())
