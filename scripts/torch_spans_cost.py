#!/usr/bin/env python3
"""What the program's spans cost the host, on one NVIDIA GPU.

Builds each benchmark cell's system at its full size (``benchmark/configs``
and the cell's loop, ``benchmark/drivers``) and runs its calls in blocks of
``--seconds`` with the spans off and on in turns (off, on, on, off, for
``--rounds`` rounds), the spans drained after each block.  Prints one JSON
line a cell: for a render cell each block's mean enqueue (the call into
``PolyPatch.render`` to its return, as ``dispatch_ms.render`` reads it)
and mean call (to the mix in host memory) in ms, for a fit cell each
block's ms an optimizer step; and each mode's median of them.  Where the
program has no spans (an older checkout) every block runs with them off.

    python3 scripts/torch_spans_cost.py [--cells flagship-512v-bounce ...] \
        [--seconds 2] [--rounds 3] [--seed 1]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.lib import harness  # noqa: E402

CELLS = ('flagship-512v-bounce', 'score-64v-bounce', 'score-64v-fit')


def block(driver, kind: str, seconds: float) -> float:
    """Calls for ``seconds``: the mean enqueue ms a call (render) or ms a
    step (fit)."""
    calls = []
    end = time.perf_counter() + seconds
    while not calls or time.perf_counter() < end:
        driver.call(calls)
    if kind == 'render':
        return 1e3 * statistics.fmean(c[1] - c[0] for c in calls), \
            1e3 * statistics.fmean(c[2] - c[0] for c in calls)
    return 1e3 * (calls[-1][2] - calls[0][0]) / sum(c[4] for c in calls), \
        None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--cells', nargs='+', default=list(CELLS))
    p.add_argument('--seconds', type=float, default=2.0)
    p.add_argument('--rounds', type=int, default=3)
    p.add_argument('--seed', type=int, default=1)
    args = p.parse_args(argv)
    from signals_tpu_torch import utils
    has_spans = hasattr(utils, 'enable')
    device = torch.device('cuda', 0)
    spec = harness.read_json(ROOT / 'BENCHMARK.json')
    for cell in args.cells:
        parts = harness.cell_spec(spec, cell)
        cfg, traffic = parts['config'], parts['traffic']
        system = harness.load_file(
            harness.BENCH / 'configs' / f'{cfg["name"]}.py').build(
                cfg, args.seed, device, traffic)
        driver = harness.load_file(
            harness.BENCH / 'drivers' / f'{traffic["kind"]}.py',
            f'bench_driver_{traffic["kind"]}').Driver(traffic, system,
                                                      args.seed)
        driver.warm()
        blocks = []
        for _ in range(args.rounds):
            for on in (False, True, True, False):
                on = on and has_spans
                if on:
                    utils.enable()
                try:
                    ms, call_ms = block(driver, traffic['kind'],
                                        args.seconds)
                finally:
                    if on:
                        utils.disable()
                        utils.drain()
                blocks.append({'spans': on, 'ms': ms, 'call_ms': call_ms})
        med = {mode: statistics.median(b['ms'] for b in blocks
                                       if b['spans'] == (mode == 'on'))
               for mode in (('off', 'on') if has_spans else ('off',))}
        print(json.dumps({'cell': cell, 'kind': traffic['kind'],
                          'card': torch.cuda.get_device_name(device),
                          'median_ms': med, 'blocks': blocks}), flush=True)
        del system, driver
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
