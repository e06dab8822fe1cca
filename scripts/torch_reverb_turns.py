#!/usr/bin/env python3
"""The master bus's reverb on one NVIDIA GPU: its turn loop eager against
its turn replayed as a CUDA graph.

``Reverb.mega_step`` advances its eight delay lines 1310 frames a turn; a
60 s window is 2020 turns of 18 small kernels, which an eager loop pays the
host for one by one.  ``Reverb.graph_turns`` captures one turn (indexed
reads and writes at a frame offset kept on the device) and replays it.
This script renders the 60 s master bus (``chip_smoke.build_master_bus``,
bench c7) both ways in one process — eager, graphed, graphed, eager — and
prints for each its wall time (host clock of one synchronised call after a
warmup), the device time and the number of kernels and copies
(``torch.profiler``), then checks that both forms give the same bits, audio
and carry.

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
from signals_tpu_torch.nodes.reverb import Reverb  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print('torch_reverb_turns: no CUDA GPU visible to torch',
              file=sys.stderr)
        return 2
    card = cs.card_line()
    n60 = cs.n_blocks_60s()
    audio_s = n60 * cs.F / cs.RATE
    bus = compile_node(cs.build_master_bus(), block_frames=cs.F,
                       rate=cs.RATE, channels=1, device='cuda')
    outs = {}
    try:
        for graphed in (False, True, True, False):
            Reverb.graph_turns = graphed
            name = 'graphed' if graphed else 'eager'
            wall, dev_ms, events = cs.profiled(
                lambda: bus.render(n_blocks=n60))
            print(f'[reverb] master_bus, {n60} blocks, {name} turns: wall '
                  f'{wall:.3f} ms = {audio_s / (wall / 1e3):.1f}x realtime, '
                  f'device {dev_ms:.3f} ms in {events} kernels and copies, '
                  f'busy share {dev_ms / wall:.3f}  [{card}]')
            outs[name] = bus.render(n_blocks=n60)
    finally:
        Reverb.graph_turns = None
    (a, ca), (b, cb) = outs['eager'], outs['graphed']
    same = torch.equal(a, b) and all(
        torch.equal(ca[uid][k], cb[uid][k]) for uid in ca for k in ca[uid])
    print(f'[reverb] graphed and eager turns give the same bits, audio and '
          f'carry: {same}')
    return 0 if same else 1


if __name__ == '__main__':
    sys.exit(main())
