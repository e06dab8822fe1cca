"""One run of one cell: set-up, the measured window, the traced slice
(``--trace 1``), the check against the plain reference, the result line.

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration in ``benchmark/configs/<config>.json`` (sizes) with
``<config>.py`` (builds the program's patch from them and the seed), the
reference ``benchmark/reference/<reference>.py`` that the configuration
names, the traffic in ``benchmark/traffic/<traffic>.json``, the loop it
drives in ``benchmark/drivers/<kind>.py`` (the traffic's ``kind``), each
metric's reader in ``benchmark/metrics/<metric>.py`` and the cell's limits
in ``benchmark/limits/<cell>.json``.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / 'benchmark'
#: top-level modules that may not be loaded in a run (compared whole)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'signals_tpu')


def load_file(path: pathlib.Path, name: str = None):
    """Import a module from ``path`` (names with dots are fine)."""
    name = name or 'bench_' + path.stem.replace('.', '_')
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def cell_spec(spec: dict, workload: str) -> dict:
    """The cell's entry, configuration, traffic, limits and the metrics it
    reports with ``--trace 0`` and ``--trace 1``."""
    cells = {w['name']: w for w in spec['workloads']}
    if workload not in cells:
        raise SystemExit(f'unknown workload {workload!r}; known: '
                         f'{sorted(cells)}')
    cell = cells[workload]

    def mine(metrics):
        return [m for m in metrics
                if 'workloads' not in m or workload in m['workloads']]

    return {'cell': cell,
            'config': read_json(BENCH / 'configs' / f'{cell["config"]}.json'),
            'traffic': read_json(BENCH / 'traffic'
                                 / f'{cell["traffic"]}.json'),
            'limits': read_json(BENCH / 'limits' / f'{workload}.json'),
            'end_to_end': mine(spec['end_to_end']),
            'per_layer': mine(spec['per_layer'])}


def forbidden_modules() -> list:
    return sorted({m.split('.')[0] for m in sys.modules}
                  & set(FORBIDDEN))


def card_info(device) -> dict:
    """The card's name, and from ``nvidia-smi`` its power limit, draw and
    clocks (empty where it cannot be read)."""
    import torch
    info = {'kind': torch.cuda.get_device_name(device)}
    try:
        out = subprocess.run(
            ['nvidia-smi', f'--id={device.index or 0}',
             '--query-gpu=power.limit,power.draw,clocks.sm,clocks.mem,'
             'temperature.gpu', '--format=csv,noheader'],
            capture_output=True, text=True, timeout=20).stdout.strip()
        info['smi'] = out
    except (OSError, subprocess.SubprocessError) as exc:
        info['smi'] = f'not read: {exc}'
    return info


def run_cell(parts: dict, *, seed: int, seconds: float, trace: bool,
             device, t_start: float, log=print, build=None) -> dict:
    """Set-up, window, traced slice and check of one cell on ``device``;
    returns the result line's object (without the forbidden-module test,
    which belongs to the process).  ``build`` (default: the
    configuration's) makes the system under test."""
    import torch
    from benchmark.lib import program
    cfg, traffic = parts['config'], parts['traffic']
    own = build is None
    if own:
        build = load_file(BENCH / 'configs' / f'{cfg["name"]}.py').build
    t_build = time.perf_counter()
    system = build(cfg, seed, device, traffic)
    log(f'set-up: {t_build - t_start:.3f} s to the build, the patch built '
        f'in {time.perf_counter() - t_build:.3f} s')
    driver = load_file(BENCH / 'drivers' / f'{traffic["kind"]}.py',
                       f'bench_driver_{traffic["kind"]}').Driver(
                           traffic, system, seed)
    if own:
        program.reset_launches()
    driver.warm()
    if own:
        program.check_launches(cfg, traffic['kind'], driver.warm_units,
                               device)
    setup_s = time.perf_counter() - t_start
    log(f'set-up: the warm-up ended at {setup_s:.3f} s')

    calls = driver.window(seconds)
    window_s = calls[-1][2] - calls[0][0]
    ms = [(c[2] - c[0]) * 1e3 for c in calls]
    q = np.percentile(ms, [5, 50, 95]) if len(ms) > 1 else ms * 3
    fifths = [round(float(np.median(p)), 3)
              for p in np.array_split(ms, 5) if len(p)]
    log(f'window calls, ms: first {[round(v, 3) for v in ms[:3]]}, p5 '
        f'{q[0]:.3f}, p50 {q[1]:.3f}, p95 {q[2]:.3f}, max {max(ms):.3f}; '
        f'by fifths of the window, median {fifths}')
    rec = {'kind': traffic['kind'], 'config': cfg, 'traffic': traffic,
           'shapes': system.shapes, 'setup_s': setup_s,
           'window': {'seconds': window_s, 'calls': calls}, 'trace': None}
    breakdown = None
    if trace:
        from benchmark.lib import trace as tr
        n = traffic['trace_calls']

        def traced():
            for _ in range(n):
                driver.call()
            if device.type == 'cuda':
                torch.cuda.synchronize(device)

        wall, dev_ev = tr.profile(traced)
        rec['trace'] = {'window_s': wall, 'calls': n,
                        'steps': n * traffic.get('steps_per_call', 1),
                        'device': dev_ev}
        # kernel names cut to 200 characters: the template arguments past
        # that repeat the functor
        breakdown = {'device_ops': [[k[:200], v]
                                    for k, v in tr.by_name(dev_ev)]}
        log(f'traced slice: {n} calls in {wall!r} s, {len(dev_ev)} device '
            f'events')

    dev_info = {'platform': 'gpu' if device.type == 'cuda' else 'cpu',
                'count': 1}
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
        dev_info['memory_peak_bytes'] = int(
            torch.cuda.max_memory_allocated(device))
        card = card_info(device)
        dev_info['kind'] = card['kind']
        log(f'card: {card["kind"]}; power.limit, power.draw, clocks.sm, '
            f'clocks.mem, temperature: {card["smi"]}')
        log(f'peak device memory: {dev_info["memory_peak_bytes"]} bytes')
    else:
        dev_info['kind'] = 'cpu'
        dev_info['memory_peak_bytes'] = 0
    if rec['trace'] is not None:
        from benchmark.lib import trace as tr
        busy = tr.union_us(rec['trace']['device']) * 1e-6
        dev_info['busy_s'] = busy
        dev_info['window_s'] = rec['trace']['window_s']

    outputs = driver.outputs()
    inputs = system.inputs
    del system, driver.system
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()

    metrics = {}
    wanted = parts['per_layer'] if trace else parts['end_to_end']
    for m in wanted:
        reader = load_file(BENCH / 'metrics' / f'{m["name"]}.py')
        value = reader.read(rec)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}

    log(f'window: {len(calls)} calls in {window_s!r} s; set-up '
        f'{setup_s!r} s')
    ref_mod = load_file(BENCH / 'reference' / f'{cfg["reference"]}.py',
                        f'benchmark.reference.{cfg["reference"]}')
    t0 = time.perf_counter()
    numbers = driver.check(ref_mod, cfg, inputs, outputs, device,
                           torch.float64)
    log(f'reference check: {time.perf_counter() - t0:.1f} s')
    limits = parts['limits']
    checks = {k: {'value': v, 'limit': limits[k]} for k, v in numbers.items()}
    correct = all(c['value'] <= c['limit'] for c in checks.values())
    failed = 0 if correct else 1
    attempted = len(calls)
    out = {'correct': correct, 'attempted': attempted, 'failed': failed,
           'metrics': metrics, 'device': dev_info}
    if breakdown is not None:
        out['breakdown'] = breakdown
    out['checks'] = checks
    return out


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    spec = read_json(ROOT / 'BENCHMARK.json')
    parts = cell_spec(spec, args.workload)
    chips = parts['cell']['chips']
    import torch
    print(f'set-up: torch imported at {time.perf_counter() - t_start:.3f} s',
          file=sys.stderr)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f'error: this cell needs {chips} CUDA device(s); torch sees '
              f'{seen}', file=sys.stderr)
        return 3
    device = torch.device('cuda', 0)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    out = run_cell(parts, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device=device, t_start=t_start,
                   log=log)
    bad = forbidden_modules()
    if bad:
        log(f'error: the run loaded {bad}')
        return 4
    for name, c in out['checks'].items():
        log(f'check {name}: {c["value"]!r} (limit {c["limit"]!r})')
    print(json.dumps(out), flush=True)
    return 0
