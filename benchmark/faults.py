#!/usr/bin/env python3
"""Faults planted under a cell's timed path, to show that the check sees
them.  Each is a context manager that breaks one thing in the program while
it is open:

* ``half_voices``: half of the voices left out, the mix scaled by two (the
  mean taken over the rest): the odd voices silenced in the params the
  render gets (a pitch of 0 Hz is a silent saw; a velocity of 0);
* ``altered_answer``: one sample of each mix raised by 1% of its peak
  where the render returns it; in a fit, the loss raised by 1%;
* ``unchanged_state``: the optimizer's steps leave the parameters where
  they were (the losses are still computed).

    python3 benchmark/faults.py --workload <name> --fault <fault> \
        --seeds 1 2 3 [--seconds 2]

runs the cell with the fault planted and prints one JSON line a seed with
the numbers compared.  Each fault takes the traffic's ``kind``.  The CPU
tests plant them at tiny sizes.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def _patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def _voice_leaves(poly):
    """``(uid, pname)`` of the per-voice leaves that silence a voice at 0:
    the vmap layout's velocity values, the channels layout's pitch."""
    if poly.layout == 'vmap':
        return [k for k in poly._overrides if k[1] == 'values']
    return [(poly.compiled.index.info(n).uid, p)
            for n, p, _, _ in poly._channel_overrides]


def half_voices(kind):
    from signals_tpu_torch.parallel import PolyPatch
    original = PolyPatch.render_fn

    def render_fn(self, n_blocks):
        inner = original(self, n_blocks)
        keys = _voice_leaves(self)

        def broken(params, carry, position0, host=None):
            params = {u: dict(v) for u, v in params.items()}
            for uid, pname in keys:
                leaf = params[uid][pname].clone()
                if self.layout == 'vmap':
                    leaf[1::2] = 0.0
                else:
                    leaf[..., 1::2] = 0.0
                params[uid][pname] = leaf
            mix, carry2 = inner(params, carry, position0, host)
            return 2.0 * mix, carry2
        return broken
    return _patched(PolyPatch, 'render_fn', render_fn)


def altered_answer(kind):
    from signals_tpu_torch import learn
    from signals_tpu_torch.parallel import PolyPatch
    if kind == 'fit':
        original = learn.spectral_loss
        return _patched(learn, 'spectral_loss',
                        lambda *a, **k: 1.01 * original(*a, **k))
    render = PolyPatch.render

    def broken(self, **kw):
        mix, carry = render(self, **kw)
        mix = mix.clone()
        mix[len(mix) // 2] += 0.01 * mix.abs().max()
        return mix, carry
    return _patched(PolyPatch, 'render', broken)


def unchanged_state(kind):
    from signals_tpu_torch import learn
    original = learn.fused_descent

    def broken(loss_fn, train, **kw):
        copy = {u: {p: v.detach().clone().requires_grad_()
                    for p, v in leaves.items()}
                for u, leaves in train.items()}
        _, losses = original(loss_fn, copy, **kw)
        return train, losses
    return _patched(learn, 'fused_descent', broken)


FAULTS = {f.__name__: f for f in (half_voices, altered_answer,
                                  unchanged_state)}


def main(argv=None) -> int:
    import torch
    from benchmark.lib import harness
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--fault', required=True, choices=sorted(FAULTS))
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--seconds', type=float, default=2.0)
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    parts = harness.cell_spec(harness.read_json(ROOT / 'BENCHMARK.json'),
                              args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        with FAULTS[args.fault](parts['traffic']['kind']):
            out = harness.run_cell(parts, seed=seed, seconds=args.seconds,
                                   trace=False,
                                   device=torch.device(args.device),
                                   t_start=t0, log=lambda m: None)
        print(json.dumps({'workload': args.workload, 'fault': args.fault,
                          'seed': seed, 'correct': out['correct'],
                          'checks': out['checks']}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
