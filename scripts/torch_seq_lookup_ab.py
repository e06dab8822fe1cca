"""The sequencer's lookups on the card: this tree's ``nodes/seq.py`` against
another checkout's, in one process.

Run from the repository root on a machine with an NVIDIA GPU::

    python scripts/torch_seq_lookup_ab.py --base path/to/other/checkout

It builds the benchmark's ``score`` configuration and times, in alternating
windows, a step of its ``fit_cutoff`` traffic and a call of its
``bounce_whole`` traffic with either module's ``gate_sorted`` /
``pitch_sorted`` in the compiled nodes (so the rest of the port is this
tree's on both sides).  Then the velocity track's pitch lookup and a gate
lookup over the same 64 voices' starts, under ``torch.func.vmap``, at the
frame counts the score's cells read: the host's enqueue time a lookup and
its wall to a synchronize.  Times in ms (windows) and us (lookups).
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: the frame counts of the score's lookups: one block-rate sample, the fit's
#: and the bounce's block grids, the ADSR's grids, the fit's and the
#: bounce's windows
FRAMES = (1, 517, 561, 2584, 2628, 529408, 2646016)


def load_seq(checkout: pathlib.Path):
    path = checkout / 'signals_tpu_torch' / 'nodes' / 'seq.py'
    spec = importlib.util.spec_from_file_location('base_seq', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lookups(mod):
    """``(gate, pitch)`` of ``mod`` with this tree's call signature:
    ``pitch(starts, values, n, ascending=...)``, ``gate(starts, ends, n)``
    (an ``ascending`` the module does not take is dropped)."""
    takes = 'ascending' in inspect.signature(mod.pitch_sorted).parameters

    def pitch(s, v, n, *, ascending=False):
        if takes:
            return mod.pitch_sorted(s, v, n, ascending=ascending)
        return mod.pitch_sorted(s, v, n)

    def gate(s, e, n, **_):
        return mod.gate_sorted(s, e, n)
    return gate, pitch


def windows(name, sides, use, once, secs, rounds):
    import torch
    res = {s: [] for s in sides}
    for s in sides:
        use(s)
        for _ in range(2):
            once()
    for r in range(rounds):
        order = sides if r % 2 == 0 else sides[::-1]
        for s in order:
            use(s)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            k = 0
            while time.perf_counter() - t0 < secs:
                k += once()
            torch.cuda.synchronize()
            res[s].append((time.perf_counter() - t0) * 1e3 / k)
    for s in sides:
        print(name, s, 'median', statistics.median(res[s]),
              [round(v, 3) for v in res[s]], flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--base', type=pathlib.Path, required=True,
                    help='the checkout whose nodes/seq.py is compared')
    ap.add_argument('--seed', type=int, default=2145000001)
    ap.add_argument('--seconds', type=float, default=4.0,
                    help='length of one timed window')
    ap.add_argument('--rounds', type=int, default=6)
    args = ap.parse_args()

    import torch
    from benchmark.lib import harness
    from signals_tpu_torch.nodes import seq
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(card, torch.__version__, flush=True)
    impl = {'base': lookups(load_seq(args.base)),
            'tree': (seq.gate_sorted, seq.pitch_sorted)}
    sides = ['base', 'tree']

    def use(side):
        seq.gate_sorted, seq.pitch_sorted = impl[side]

    bench = harness.BENCH
    score = harness.load_file(bench / 'configs' / 'score.py')
    cfg = json.loads((bench / 'configs' / 'score.json').read_text())
    fit_t = json.loads((bench / 'traffic' / 'fit_cutoff.json').read_text())
    bounce_t = json.loads((bench / 'traffic' / 'bounce_whole.json')
                          .read_text())

    fit = score.build(cfg, args.seed, 'cuda', fit_t)
    steps = fit_t['steps_per_call']

    def fit_once():
        fit.fit(steps, fit_t['learning_rate'], fit_t['relative_lr'])
        return steps
    windows('fit ms/step', sides, use, fit_once, args.seconds, args.rounds)
    del fit
    torch.cuda.empty_cache()

    b = score.build(cfg, args.seed, 'cuda', bounce_t)
    nb = bounce_t['blocks']
    host = torch.empty((nb * 1024, 1), dtype=torch.float32, pin_memory=True)

    def bounce_once():
        host.copy_(b.render(0, nb).reshape(host.shape))
        return 1
    windows('bounce ms/call', sides, use, bounce_once, args.seconds,
            max(2, args.rounds - 2))

    vel = b.poly.compiled.root.right.sig
    params, _ = b.poly.params()
    leaf = params[b.poly.compiled.index.info(vel).uid]
    starts, values = leaf['starts'], leaf['values']
    for frames in FRAMES:
        n = torch.arange(frames, dtype=torch.int32,
                         device='cuda').to(torch.float32)[:, None]
        row = [str(frames)]
        for side in sides:
            gate, pitch = impl[side]
            runs = {
                'pitch': lambda: torch.func.vmap(lambda s, v: pitch(
                    s, v, n, ascending=True))(starts, values),
                'gate': lambda: torch.func.vmap(lambda s: gate(
                    s, s + 5000.0, n))(starts)}
            for kind, f in runs.items():
                for _ in range(3):
                    f()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(20):
                    f()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                row.append(f'{side}.{kind} host {(t1 - t0) / 20 * 1e6:.0f} '
                           f'us, wall {(t2 - t0) / 20 * 1e6:.0f} us')
        print(*row, sep=' | ', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
