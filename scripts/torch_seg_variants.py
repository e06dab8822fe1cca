#!/usr/bin/env python3
"""The segment kernels' specialised paths, each timed against the code
without it or with another choice, on one NVIDIA GPU.

Builds ``signals_tpu_torch/compiler/csrc`` as it stands and, beside it,
each variant below: the same sources with one textual edit of
``segments.cu`` (all ``nvcc`` processes started together, into
``build/seg_variants/``).  Each variant is first held to the shipped
kernel's output (1e-5 of the output's max), then K1 (saw generator) and K2
(timeline) are timed at the flagship's geometry (``chip_smoke.py`` phase
2) over 256, 512 and 2584 blocks, where the kernel sums subgroups of
h = 8, 16 and 32 lanes (sum of 64, and K1 per lane), by the profiler's
device time, the variants taking turns within each round, and the median
of the rounds is printed beside the shipped build's.  Also prints each
build's ``ptxas`` registers, stack frame and spills per ``seg_cascade``.

    python3 scripts/torch_seg_variants.py
"""

from __future__ import annotations

import pathlib
import re
import shutil
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from signals_tpu_torch.compiler import _build  # noqa: E402

OUT = ROOT / 'build' / 'seg_variants'
ROUNDS = 5
REPS = 10

#: the line that sends one-section group sums to the zero-input pass 2
_FREE = '        if (g.h) {\n            // group sums of one section'

#: variant -> (what it changes, [(text in segments.cu, its replacement)])
VARIANTS = {
    'no_ph0': ('without the phase-0 synthesis: every lane reduces turns + ph',
               [('sl.ph0 = sl.ph == 0.f && sl.hz >= 0.f;',
                 'sl.ph0 = false;')]),
    'free_never': ('without the zero-input pass 2: one-section group sums '
                   'replay the slice from its true start, as two sections do',
                   [(_FREE, _FREE.replace('g.h', 'false', 1))]),
    'free_h16': ('the zero-input pass 2 chosen by geometry: for K1 only where '
                 'the summed subgroup h is 16 lanes or more',
                 [(_FREE, _FREE.replace('g.h', 'g.h && (!GEN || g.h >= 16)',
                                        1))]),
    'free_h32': ('the same from h = 32 on',
                 [(_FREE, _FREE.replace('g.h', 'g.h && (!GEN || g.h >= 32)',
                                        1))]),
    'lb1': ('without the 64-register cap: __launch_bounds__(kMaxThreads) '
            'without a minimum of 2 blocks per SM',
            [('__launch_bounds__(kMaxThreads, 2)',
              '__launch_bounds__(kMaxThreads)')]),
}


def build_variants() -> dict[str, pathlib.Path]:
    """``{variant: library}``, ``'shipped'`` the sources as they stand."""
    shutil.rmtree(OUT, ignore_errors=True)
    nvcc = _build.nvcc_path()
    dirs = {'shipped': _build._CSRC}
    for name, (_, edits) in VARIANTS.items():
        d = OUT / name
        shutil.copytree(_build._CSRC, d)
        seg = d / 'segments.cu'
        text = seg.read_text()
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        seg.write_text(text)
        dirs[name] = d
    rows_o = OUT / 'rows.o'
    objs = {name: OUT / f'segments_{name}.o' for name in dirs}
    cmds = [[nvcc, *_build.COMPILE_FLAGS, '-Xptxas', '-v', '-o', str(o),
             str(dirs[name] / 'segments.cu')] for name, o in objs.items()]
    cmds.append([nvcc, *_build.COMPILE_FLAGS, '-o', str(rows_o),
                 str(_build._CSRC / 'rows.cu')])
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode:
            raise _build.KernelBuildError(f'{" ".join(cmd)}\n{out}')
    libs = {name: OUT / f'lib_{name}.so' for name in dirs}
    _build._run_all([[nvcc, *_build.LINK_FLAGS, '-o', str(libs[name]),
                      str(objs[name]), str(rows_o)] for name in dirs])
    # ptxas -v: per entry function its stack frame and spills, then its
    # registers
    for name, out in zip(objs, outs):
        tmpl, frame = None, ''
        for line in out.splitlines():
            if 'Compiling entry function' in line:
                t = re.search(r'seg_cascadeILb(\d)ELi(\d)ELi(\d)E', line)
                tmpl = t and f'GEN={t[1]}, OSC={t[2]}, NSEC={t[3]}'
            elif tmpl and 'bytes stack frame' in line:
                frame = line.split(':')[-1].strip()
            elif tmpl and 'registers' in line:
                regs = re.search(r'Used (\d+) registers', line)[1]
                print(f'[ptxas] {name}: seg_cascade<{tmpl}>: {regs} '
                      f'registers; {frame}')
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print('torch_seg_variants: no CUDA GPU visible to torch',
              file=sys.stderr)
        return 2
    card = cs.card_line()
    libs = {name: _build.load(path)
            for name, path in build_variants().items()}
    for name, (what, _) in VARIANTS.items():
        print(f'[variant] {name}: {what}')
    kernels = ('seg_cascade', 'sum_partials')
    rng = np.random.default_rng(0)
    for nb in (cs.N_BLOCKS, 2 * cs.N_BLOCKS, cs.n_blocks_60s()):
        *_, cases = cs.segment_cases(rng, nb)
        for kname, g in (('segments_gen', cs.V), ('segments_gen', 0),
                         ('segments', cs.V)):
            call = cases[kname][0]
            what = (f'{kname} {"sum_groups=%d" % g if g else "per lane"}, '
                    f'{nb} blocks')
            _build._lib = libs['shipped']
            ref = call(g)
            scale = float(ref.abs().max())
            times = {name: [] for name in libs}
            for name, lib in libs.items():
                _build._lib = lib
                err = float((call(g) - ref).abs().max()) / scale
                assert err <= cs.TOL, (what, name, err)
            for _ in range(ROUNDS):
                for name, lib in libs.items():
                    _build._lib = lib
                    times[name].append(
                        cs.device_ms(lambda: call(g), REPS, kernels))
            # a round whose trace lost kernel events (None) is left out
            times = {name: [t for t in ts if t is not None]
                     for name, ts in times.items()}
            base = statistics.median(times['shipped'])
            for name, ts in times.items():
                ms = statistics.median(ts)
                print(f'[time] {what}: {name} {ms:.4f} ms device (median of '
                      f'{len(ts)} x {REPS} calls, profiler; min {min(ts):.4f} '
                      f'max {max(ts):.4f}), {ms / base:.3f} x shipped  '
                      f'[{card}]')
            del ref
        del cases
        torch.cuda.empty_cache()
    _build._lib = None
    return 0


if __name__ == '__main__':
    sys.exit(main())
