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

``--null-state-bits`` runs another check instead: that the carried-state
entry changed nothing for callers that pass no state.  It builds the
``rows.cu`` of commit d36b6eb (the time-sliced scan before ``zi`` / ``zf``
existed) beside the current sources, into ``build/rows_d36b6eb/``, and holds
``sosfilt_timeline`` and ``sosfilt_batch`` (no ``zi``, no ``zf``) of the
current build to that build's launchers bit for bit at 20 shapes: 1-4
sections, one slice and many, ragged tails, tail 1, one lane, overlapping
``unfold`` views and broadcast channels.  The old source comes from ``git
show d36b6eb:signals_tpu_torch/compiler/csrc/rows.cu``; on a machine whose
copy of the repository has no history, write that file to
``build/rows_d36b6eb/rows.cu`` first (``build/`` is not committed).

    python3 scripts/torch_rows_variants.py --null-state-bits
"""

from __future__ import annotations

import ctypes
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


OLD_COMMIT = 'd36b6eb'
OLD_DIR = ROOT / 'build' / f'rows_{OLD_COMMIT}'


def old_rows_source() -> str:
    """``rows.cu`` of :data:`OLD_COMMIT`: from the repository's history, or
    from ``build/rows_d36b6eb/rows.cu`` where there is no history."""
    path = 'signals_tpu_torch/compiler/csrc/rows.cu'
    shown = subprocess.run(['git', 'show', f'{OLD_COMMIT}:{path}'], cwd=ROOT,
                           capture_output=True, text=True)
    if shown.returncode == 0 and 'rows_cascade' in shown.stdout:
        return shown.stdout
    kept = OLD_DIR / 'rows.cu'
    if kept.is_file():
        return kept.read_text()
    raise SystemExit(f'no git history here and no {kept}: write the output '
                     f'of `git show {OLD_COMMIT}:{path}` there first')


def build_old_rows() -> ctypes.CDLL:
    """The old ``rows.cu`` built with the current headers (they have not
    changed since) and loaded with its own C interface (no ``zi``, no
    ``zf``)."""
    text = old_rows_source()
    src_dir = OLD_DIR / 'csrc'
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(_build._CSRC, src_dir)
    (src_dir / 'rows.cu').write_text(text)
    nvcc = _build.nvcc_path()
    obj, so = OLD_DIR / 'rows.o', OLD_DIR / 'librows_old.so'
    _build._run_all([[nvcc, *_build.COMPILE_FLAGS, '-o', str(obj),
                      str(src_dir / 'rows.cu')]])
    _build._run_all([[nvcc, *_build.LINK_FLAGS, '-o', str(so), str(obj)]])
    lib = ctypes.CDLL(str(so))
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.sosfilt_timeline_launch.argtypes = [p, q, q, p, q, q, p, i, i, i, p]
    lib.sosfilt_timeline_launch.restype = i
    lib.sosfilt_batch_launch.argtypes = [p, q, q, q, p, q, q, q, p, i, i, i,
                                         i, i, p]
    lib.sosfilt_batch_launch.restype = i
    return lib


def old_timeline(lib, coeffs, x):
    nsec, ch, coeffs, x = K._timeline_args(coeffs, x)
    coeffs = K._columns_contiguous(coeffs)
    out = torch.empty((x.shape[0], ch), dtype=torch.float32, device=x.device)
    code = lib.sosfilt_timeline_launch(
        coeffs.data_ptr(), *coeffs.stride()[:2], x.data_ptr(), *x.stride(),
        out.data_ptr(), nsec, ch, x.shape[0], K._stream(x.device))
    assert code == 0, code
    return out


def old_batch(lib, coeffs, x_t, tail):
    L, B = x_t.shape[:2]
    nsec, ch = coeffs.shape[1], max(coeffs.shape[2], x_t.shape[2])
    coeffs = K._columns_contiguous(
        torch.broadcast_to(coeffs, (B, nsec, ch, 11)))
    x_t = torch.broadcast_to(x_t, (L, B, ch))
    out = torch.empty((tail, B, ch), dtype=torch.float32, device=x_t.device)
    code = lib.sosfilt_batch_launch(
        coeffs.data_ptr(), *coeffs.stride()[:3], x_t.data_ptr(),
        *x_t.stride(), out.data_ptr(), nsec, B, ch, L, tail,
        K._stream(x_t.device))
    assert code == 0, code
    return out


def null_state_bits() -> int:
    """The current kernels without a state against the old build, bit for
    bit; returns the number of shapes held."""
    lib = build_old_rows()
    dev = torch.device('cuda')
    rng = np.random.default_rng(4)

    def coeffs(nsec, lanes):
        lo = torch.as_tensor(rng.uniform(20.0, 3000.0, (1, lanes))
                             .astype(np.float32), device=dev)
        crits = [lo * (1.5 ** k) for k in range(2 if nsec > 1 else 1)]
        co = design_coupled(TorchXP(dev), 'lp' if nsec == 1 else 'bp',
                            tuple(crits), np.float32(cs.RATE / 2))
        # 3 and 4 sections: the band design's two, repeated
        return torch.cat([co] * 2)[:nsec] if nsec > 2 else co

    def rows(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=dev)

    held = 0
    for nsec in (1, 2, 3, 4):
        for n, ch in ((1152, 16), (1152, 1), (15, 3), (20000, 5)):
            co, x = coeffs(nsec, ch), rows(n, ch)
            assert torch.equal(K.sosfilt_timeline(co, x),
                               old_timeline(lib, co, x)), (nsec, n, ch)
            held += 1
    for nsec, L, B, ch, tail in ((1, 1152, 8, 16, 1024), (2, 1152, 8, 16,
                                                          1024),
                                 (1, 129, 8, 16, 1), (4, 300, 3, 5, 7)):
        co = coeffs(nsec, B * ch).reshape(nsec, B, ch, 11).permute(1, 0, 2, 3)
        xt = rows(L + (B - 1) * 1024, ch)
        for x_t in (xt.unfold(0, L, 1024).permute(2, 0, 1),
                    xt[:L, None, :1].expand(L, B, ch)):
            assert torch.equal(K.sosfilt_batch(co, x_t, tail=tail),
                               old_batch(lib, co, x_t, tail)), (nsec, L, B)
            held += 1
    return held


def main() -> int:
    if not torch.cuda.is_available():
        print('torch_rows_variants: no CUDA GPU visible to torch',
              file=sys.stderr)
        return 2
    card = cs.card_line()
    if '--null-state-bits' in sys.argv[1:]:
        n = null_state_bits()
        print(f'[null-state] sosfilt_timeline and sosfilt_batch without a '
              f'state give the bits of the {OLD_COMMIT} rows.cu at {n} '
              f'shapes  [{card}]')
        return 0
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
