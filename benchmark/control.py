#!/usr/bin/env python3
"""The control of a cell: the plain reference put in the program's place,
computed in bfloat16 (the nearest precision below the float32 that the
configurations state), driven by the cell's own loop and checked as a run
is.  Its numbers set the upper reading of each limit; a sound limit makes
it come out not correct.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 \
        [--device cuda]

Prints one JSON line a seed: the numbers compared, their limits and
``correct``.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.lib import harness  # noqa: E402


class ReferenceSystem:
    """The configuration's reference in ``dtype``, with the calls of the
    program's system: ``render``, and for a fit ``param``, ``fit`` (Adam on
    the reference's gradient) and ``loss_grad``, from the reference's
    ``mix``, ``fit_problem`` and ``loss_and_grad``."""

    def __init__(self, cfg, seed, device, traffic, dtype):
        import torch
        inputs_of = harness.load_file(
            harness.BENCH / 'configs' / f'{cfg["name"]}.py').make_inputs
        self.ref = harness.load_file(
            harness.BENCH / 'reference' / f'{cfg["reference"]}.py',
            f'benchmark.reference.{cfg["reference"]}')
        self.cfg, self.traffic, self.dtype = cfg, traffic, dtype
        self.device = torch.device(device)
        self.block_frames, self.rate = cfg['block_frames'], cfg['rate']
        self.inputs = inputs_of(cfg, seed)
        self.shapes = {}
        if traffic['kind'] == 'fit':
            self.p, self.target = self.ref.fit_problem(
                cfg, self.inputs, traffic, self.device, dtype)

    def render(self, position, n_blocks):
        import torch
        mix = self.ref.mix(self.cfg, self.inputs, position, n_blocks,
                           self.device, self.dtype)
        return mix.to(torch.float32).reshape(n_blocks * self.block_frames,
                                             -1)

    def param(self):
        return dict(self.p)

    def loss_grad(self):
        return self.ref.loss_and_grad(self.cfg, self.inputs, self.p,
                                      self.traffic['blocks'], self.target,
                                      self.device, self.dtype)

    def fit(self, steps, learning_rate, relative_lr):
        from benchmark.reference import plain
        losses = []

        def grad(p):
            self.p = p
            loss, g = self.loss_grad()
            losses.append(loss)
            return g

        ps, _ = plain.adam(self.p, grad, steps, learning_rate, relative_lr)
        self.p = ps[-1]
        return np.asarray(losses)


def main(argv=None) -> int:
    import torch
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    parts = harness.cell_spec(harness.read_json(ROOT / 'BENCHMARK.json'),
                              args.workload)
    device = torch.device(args.device)

    def build(cfg, seed, dev, traffic):
        return ReferenceSystem(cfg, seed, dev, traffic, torch.bfloat16)

    for seed in args.seeds:
        t0 = time.perf_counter()
        out = harness.run_cell(parts, seed=seed, seconds=0.0, trace=False,
                               device=device, t_start=t0, build=build,
                               log=lambda m: None)
        print(json.dumps({'workload': args.workload, 'seed': seed,
                          'correct': out['correct'],
                          'checks': out['checks'],
                          'seconds': time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
