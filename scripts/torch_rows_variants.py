#!/usr/bin/env python3
"""What the zero-state kernels K3/K4 (``csrc/rows.cu``) spend their time on,
on one NVIDIA GPU: builds that differ from the shipped one in one thing.

Builds ``signals_tpu_torch/compiler/csrc`` as it stands and, beside it,
each variant below: the same sources with one textual edit of ``rows.cu``
(all ``nvcc`` processes started together, into ``build/rows_variants/``):

* ``no_loads``: every input load replaced by a value made in registers
  from the row index, so no row is read from memory;
* ``no_stores``: every output store replaced by a running sum that one
  store per lane writes at the end (so that the compiler keeps the loop);
* for the time-sliced scan also ``slice64`` (slices of 64 rows at least,
  the segment kernels' minimum, instead of one 16-row chunk), ``indexed``
  (rows addressed by index times stride, each load and store tested,
  instead of pointers stepping by the strides), ``lb_default`` (the
  launch bounds without their explicit minimum of one block per SM) and
  ``no_rows`` (no row walked: the launch, the slicing and the scans alone,
  the floor of the scan at each shape).

``rows.cu`` has had two forms, the row loop (one thread per lane walks all
of a window's rows) and the time-sliced scan; the edits are given for
both, and the script applies the set whose marker it finds, so that a copy
of it run from the root of an older checkout measures that tree's kernels.
The shipped build is first held to the plain version (1e-5 max-abs); the
variants compute other numbers and are only timed.  Each build is timed at
the step shape (1152 rows, 16 lanes), the mono step (1152, 1) and the
render-ahead batch (L 1152, 8 windows x 16 lanes, tail 1024), at 1 and 2
sections, and at 1 section the sampled filter's windows (129 rows, 8 x 16
lanes, tail 1) and windows of 64 rows, by the profiler's device time,
the builds taking turns within each round; the median of the rounds is
printed beside the shipped build's.  Also prints each build's ``ptxas``
registers, stack frame and spills per kernel.

    python3 scripts/torch_rows_variants.py
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
from signals_tpu_torch.compiler import kernels as K  # noqa: E402
from signals_tpu_torch.compiler.filters import design_coupled  # noqa: E402
from signals_tpu_torch.core.xp import TorchXP  # noqa: E402

OUT = ROOT / 'build' / 'rows_variants'
ROUNDS = 5
REPS = 10
#: kernel names of either form in a profiler trace
KERNELS = ('rows_cascade', 'batch_cascade', 'timeline_cascade')

#: form -> (a text only that form of rows.cu holds, {variant: [(text in
#: rows.cu, its replacement)]})
EDITS = {
    'row loop': ('run_rows(', {
        'no_loads': [(
            '? x[(int64_t)r * row_stride] : 0.f;',
            '? 1e-3f * (float)r : 0.f;')],
        'no_stores': [
            ('    cas.reset();\n    float v[kChunk], next[kChunk];',
             '    cas.reset();\n    float sink = 0.f;\n'
             '    float v[kChunk], next[kChunk];'),
            ('out[(int64_t)(r - skip) * row_stride] = v[i];',
             'sink += v[i];'),
            ('        }\n    }\n}\n\n// grid: lane tiles',
             '        }\n    }\n    if (active) out[0] = sink;\n}\n\n'
             '// grid: lane tiles')],
    }),
    'time-sliced scan': ('rows_cascade', {
        'no_loads': [(
            'v[i] = i < n ? *xr : 0.f;',
            'v[i] = i < n ? 1e-3f * (float)(r0 + i) : 0.f;')],
        'no_stores': [
            ('    Cplx a{1.f, 0.f};\n',
             '    Cplx a{1.f, 0.f};\n    float sink = 0.f;\n'),
            ('            *o = v[i];\n', '            sink += v[i];\n'),
            ('    return a;\n}',
             '    if (EMIT && active) out[0] = sink;\n    return a;\n}')],
        'slice64': [(
            'g.n_rows,\n                                                    '
            'kRows);', 'g.n_rows);')],
        'indexed': [
            ('            v[i] = i < n ? *xr : 0.f;\n'
             '            xr += g.x_row;\n',
             '            v[i] = (active && r0 + i < row_b)\n'
             '                       ? xl[(int64_t)(r0 + i) * g.x_row]'
             ' : 0.f;\n'),
            ('        const int lo = max(g.skip - r0, 0);'
             '          // the first output row\n', ''),
            ('        float* o = out + (int64_t)(r0 + lo - g.skip)'
             ' * g.lanes;\n', ''),
            ('            if (i < lo || i >= n) continue;\n'
             '            *o = v[i];\n            o += g.lanes;\n',
             '            const int r = r0 + i;\n'
             '            if (r >= g.skip && r < row_b)\n'
             '                out[(int64_t)(r - g.skip) * g.lanes]'
             ' = v[i];\n')],
        'lb_default': [('__launch_bounds__(kMaxThreads, 1)\n',
                        '__launch_bounds__(kMaxThreads)\n')],
        'no_rows': [('    for (int r0 = row_a; r0 < row_b; r0 += kRows) {',
                     '    for (int r0 = row_a; r0 < row_a; r0 += kRows) {')],
    }),
}

WHAT = {
    'no_loads': 'input loads replaced by a register value (1e-3 x row)',
    'no_stores': 'output stores replaced by one store of their sum per lane',
    'slice64': 'slices of 64 rows at least (the segment kernels\' minimum) '
               'instead of one 16-row chunk',
    'indexed': 'each row addressed by its index times the stride, each '
               'load and store tested against the slice, instead of '
               'pointers stepping by the strides',
    'lb_default': '__launch_bounds__ without the explicit minimum of one '
                  'block per SM',
    'no_rows': 'no row walked: the launch, the slicing and the scans alone '
               '(the scan\'s floor at each shape)',
}


def build_variants() -> dict[str, pathlib.Path]:
    """``{build: library}``, ``'shipped'`` the sources as they stand."""
    shutil.rmtree(OUT, ignore_errors=True)
    rows_src = (_build._CSRC / 'rows.cu').read_text()
    form = [f for f, (mark, _) in EDITS.items() if mark in rows_src]
    assert len(form) == 1, form
    print(f'[variant] rows.cu form: {form[0]}')
    dirs = {'shipped': _build._CSRC}
    for name, edits in EDITS[form[0]][1].items():
        d = OUT / name
        shutil.copytree(_build._CSRC, d)
        text = rows_src
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        (d / 'rows.cu').write_text(text)
        dirs[name] = d
    nvcc = _build.nvcc_path()
    seg_o = OUT / 'segments.o'
    objs = {name: OUT / f'rows_{name}.o' for name in dirs}
    cmds = [[nvcc, *_build.COMPILE_FLAGS, '-Xptxas', '-v', '-o', str(o),
             str(dirs[name] / 'rows.cu')] for name, o in objs.items()]
    cmds.append([nvcc, *_build.COMPILE_FLAGS, '-o', str(seg_o),
                 str(_build._CSRC / 'segments.cu')])
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode:
            raise _build.KernelBuildError(f'{" ".join(cmd)}\n{out}')
    libs = {name: OUT / f'lib_{name}.so' for name in dirs}
    _build._run_all([[nvcc, *_build.LINK_FLAGS, '-o', str(libs[name]),
                      str(objs[name]), str(seg_o)] for name in dirs])
    # ptxas -v: per entry function its stack frame and spills, then its
    # registers
    for name, out in zip(objs, outs):
        kern, frame = None, ''
        for line in out.splitlines():
            if 'Compiling entry function' in line:
                t = re.search(r'(\w+_cascade)ILi(\d)E', line)
                kern = t and f'{t[1]}<{t[2]}>'
            elif kern and 'bytes stack frame' in line:
                frame = line.split(':')[-1].strip()
            elif kern and 'registers' in line:
                regs = re.search(r'Used (\d+) registers', line)[1]
                print(f'[ptxas] {name}: {kern}: {regs} registers; {frame}')
    return libs


def cases(rng):
    """``{what: (kernel call, plain call)}`` at the step, mono-step and
    render-ahead shapes, 1 and 2 sections, and the sampled and 64-row
    windows, contiguous inputs."""
    dev = torch.device('cuda')
    L, ch, B = cs.STATIC_C + cs.F, cs.STATIC_CH, cs.AHEAD
    out = {}
    for nsec, btype in ((1, 'lp'), (2, 'bp')):
        lo = torch.as_tensor(rng.uniform(300.0, 3000.0, (1, B * ch))
                             .astype(np.float32), device=dev)
        crits = (lo,) if nsec == 1 else (lo, lo * 4.0)
        co = design_coupled(TorchXP(dev), btype, crits,
                            np.float32(cs.RATE / 2))
        co = co.reshape(nsec, B, ch, 11).permute(1, 0, 2, 3).contiguous()
        x = torch.as_tensor(rng.standard_normal((L, B, ch)).astype(
            np.float32), device=dev)
        co4, x4 = co[0].contiguous(), x[:, 0].contiguous()
        co1, x1 = co[0, :, :1].contiguous(), x[:, 0, :1].contiguous()
        out[f'step ({L}, {ch}), {nsec} section(s)'] = (
            lambda co4=co4, x4=x4: K.sosfilt_timeline(co4, x4),
            lambda co4=co4, x4=x4: K.sosfilt_timeline_plain(co4, x4))
        if nsec == 1:
            out[f'mono step ({L}, 1), {nsec} section(s)'] = (
                lambda: K.sosfilt_timeline(co1, x1),
                lambda: K.sosfilt_timeline_plain(co1, x1))
        out[f'render-ahead (L {L}, {B} x {ch} lanes, tail {cs.F}), '
            f'{nsec} section(s)'] = (
            lambda co=co, x=x: K.sosfilt_batch(co, x, tail=cs.F),
            lambda co=co, x=x: K.sosfilt_batch_plain(co, x, tail=cs.F))
        if nsec == 1:
            for n, tail, what in ((cs.STATIC_C + 1, 1, 'sampled windows'),
                                  (64, 64, '64-row windows')):
                xs = x[:n].contiguous()
                out[f'{what} (L {n}, {B} x {ch} lanes, tail {tail}), '
                    f'{nsec} section(s)'] = (
                    lambda xs=xs, tail=tail: K.sosfilt_batch(co, xs,
                                                             tail=tail),
                    lambda xs=xs, tail=tail: K.sosfilt_batch_plain(
                        co, xs, tail=tail))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print('torch_rows_variants: no CUDA GPU visible to torch',
              file=sys.stderr)
        return 2
    card = cs.card_line()
    libs = {name: _build.load(path)
            for name, path in build_variants().items()}
    for name, what in WHAT.items():
        print(f'[variant] {name}: {what}')
    for what, (call, plain) in cases(np.random.default_rng(0)).items():
        _build._lib = libs['shipped']
        err = float((call() - plain()).abs().max())
        assert err <= cs.TOL, (what, err)
        times = {name: [] for name in libs}
        for _ in range(ROUNDS):
            for name, lib in libs.items():
                _build._lib = lib
                times[name].append(cs.device_ms(call, REPS, KERNELS))
        # a round whose trace lost kernel events (None) is left out
        times = {name: [t for t in ts if t is not None]
                 for name, ts in times.items()}
        base = statistics.median(times['shipped'])
        for name, ts in times.items():
            ms = statistics.median(ts)
            print(f'[time] {what}: {name} {ms:.4f} ms device (median of '
                  f'{len(ts)} x {REPS} calls, profiler; min {min(ts):.4f} '
                  f'max {max(ts):.4f}), {ms / base:.3f} x shipped; shipped '
                  f'vs plain max abs {err!r}  [{card}]')
    _build._lib = None
    return 0


if __name__ == '__main__':
    sys.exit(main())
