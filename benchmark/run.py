#!/usr/bin/env python3
"""Run one benchmark cell once and print its result as the last line:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the repository root on a machine with the CUDA devices the cell
asks for; without them it exits non-zero and prints no result."""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                 ('TRITON_CACHE_DIR', 'triton_cache'),
                 ('CUDA_CACHE_PATH', 'cuda_cache')):
    os.environ[var] = str(ROOT / 'build' / sub)
os.environ['USE_FLAX'] = '0'
# one process, few threads: the host path is Python dispatch, and idle
# worker threads only add noise to it
os.environ['OMP_NUM_THREADS'] = '1'
os.environ['MKL_NUM_THREADS'] = '1'
sys.path.insert(0, str(ROOT))

from benchmark.lib import harness  # noqa: E402

if __name__ == '__main__':
    sys.exit(harness.main(sys.argv[1:], T0))
