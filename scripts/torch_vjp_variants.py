#!/usr/bin/env python3
"""The backward kernels (``csrc/adjoint.cu``: B1 / B2 ``seg_cascade_vjp``,
B3 ``rows_cascade_vjp``) against the serial walk they replaced, on one
NVIDIA GPU, in one process.

Builds the ``adjoint.cu`` of commit bef113c (one thread per (carry segment
or window, lane) walking its rows forward into a scratch buffer in global
memory and back) with the current headers beside the current sources, into
``build/vjp_bef113c/``.  At the fits' shapes — B1 at the flagship fit (64
blocks, m 8, C 512, sum of 64, no source cotangent) and at c8 (43 blocks, C
1024, per lane), B2 at c9 (517 blocks, C 1024, 64 lanes, with the input's
cotangent) — and at ``chip_smoke.B3_SHAPES`` (B3 at the static voice's
render-ahead, step and carried-state shapes, the streaming fit's (8192,
16), the echo's (16384, 1) and 2^20 rows at two sections) it holds the
current kernel's outputs to the old one's (``chip_smoke.TOL`` of each
output's largest |value|), times both by the profiler's device time, old
and new taking turns (old, new, new, old) in each of the rounds, and
prints the medians; then, at c9 and at B3's (8192, 16) and 2^20-row
shapes, each call's memory over its inputs
(``torch.cuda.max_memory_allocated`` after a reset: the old one's scratch
buffer is in it).

    python3 scripts/torch_vjp_variants.py

The old source comes from ``git show bef113c:signals_tpu_torch/compiler/
csrc/adjoint.cu``; on a machine whose copy of the repository has no
history, write that file to ``build/vjp_bef113c/adjoint.cu`` first
(``build/`` is not committed).
"""

from __future__ import annotations

import ctypes
import pathlib
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

OLD_COMMIT = 'bef113c'
OLD_DIR = ROOT / 'build' / f'vjp_{OLD_COMMIT}'
ROUNDS = 3
REPS = 3
KERNELS = ('seg_cascade_vjp', 'rows_cascade_vjp')
MEMORY = ('B2 at c9', 'B3 at the streaming fit', 'B3 at the past shared')


def old_source() -> str:
    """``adjoint.cu`` of :data:`OLD_COMMIT`: from the repository's history,
    or from ``build/vjp_bef113c/adjoint.cu`` where there is no history."""
    path = 'signals_tpu_torch/compiler/csrc/adjoint.cu'
    shown = subprocess.run(['git', 'show', f'{OLD_COMMIT}:{path}'], cwd=ROOT,
                           capture_output=True, text=True)
    if shown.returncode == 0 and 'seg_cascade_vjp' in shown.stdout:
        return shown.stdout
    kept = OLD_DIR / 'adjoint.cu'
    if kept.is_file():
        return kept.read_text()
    raise SystemExit(f'no git history here and no {kept}: write the output '
                     f'of `git show {OLD_COMMIT}:{path}` there first')


def build_old() -> ctypes.CDLL:
    """The old ``adjoint.cu`` built with the current headers and loaded
    with its own C interface (a scratch buffer after ``gcoeffs``)."""
    text = old_source()
    src_dir = OLD_DIR / 'csrc'
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(_build._CSRC, src_dir)
    (src_dir / 'adjoint.cu').write_text(text)
    nvcc = _build.nvcc_path()
    obj, so = OLD_DIR / 'adjoint.o', OLD_DIR / 'libadjoint_old.so'
    _build._run_all([[nvcc, *_build.COMPILE_FLAGS, '-o', str(obj),
                      str(src_dir / 'adjoint.cu')]])
    _build._run_all([[nvcc, *_build.LINK_FLAGS, '-o', str(so), str(obj)]])
    lib = ctypes.CDLL(str(so))
    p, i, f, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
    lib.sosfilt_segments_vjp_launch.argtypes = [p, p, q, q, p, p, f, i, p,
                                                i, p, p, p, p, i, i, i, i, i,
                                                i, i, p]
    lib.sosfilt_segments_vjp_launch.restype = i
    lib.sosfilt_rows_vjp_launch.argtypes = [p, q, q, q, p, q, q, q, p, p, p,
                                            p, p, p, p, i, i, i, i, i, p]
    lib.sosfilt_rows_vjp_launch.restype = i
    return lib


def old_scratch(n_lanes, n_rows, nsec, device):
    """The old kernels' scratch: per row, lane and section the lagged
    state (s1, s2), and the input of every section after the first."""
    return torch.empty(n_lanes * n_rows * (3 * nsec - 1),
                       dtype=torch.float32, device=device)


def old_gen_vjp(lib, co, toff, lanef, gy, *, n_segments, seg_frames,
                context, osc_code, rate, sum_groups, blocks_per_seg,
                source_grad):
    """bef113c's ``kernels.sosfilt_segments_gen_vjp`` on the old build."""
    m = blocks_per_seg
    nsec, lanes = co.shape[1], co.shape[2]
    n_units, n_rows = n_segments // m, context + m * seg_frames
    gco = torch.zeros_like(co)
    gsrc = (torch.empty((n_units, n_rows, lanes), dtype=torch.float32,
                        device=co.device) if source_grad else None)
    scratch = old_scratch(n_units * lanes, n_rows, nsec, co.device)
    code = lib.sosfilt_segments_vjp_launch(
        co.data_ptr(), None, 0, 0, toff.data_ptr(), lanef.data_ptr(),
        float(np.float32(1.0 / rate)), osc_code, K._SIN_C, 1, gy.data_ptr(),
        None if gsrc is None else gsrc.data_ptr(), gco.data_ptr(),
        scratch.data_ptr(), n_segments, nsec, lanes, seg_frames, context, m,
        sum_groups, K._stream(co.device))
    assert code == 0, code
    return gco, gsrc


def old_seg_vjp(lib, co, x, gy, *, n_segments, seg_frames, context,
                sum_groups=0, blocks_per_seg=1):
    """bef113c's ``kernels.sosfilt_segments_vjp`` on the old build."""
    m = blocks_per_seg
    nsec, lanes = co.shape[1], co.shape[2]
    n_units, n_rows = n_segments // m, context + m * seg_frames
    gco = torch.zeros_like(co)
    gxw = torch.empty((n_units, n_rows, lanes), dtype=torch.float32,
                      device=co.device)
    scratch = old_scratch(n_units * lanes, n_rows, nsec, co.device)
    code = lib.sosfilt_segments_vjp_launch(
        co.data_ptr(), x.data_ptr(), *x.stride(), None, None, 0.0, 0, None,
        0, gy.data_ptr(), gxw.data_ptr(), gco.data_ptr(), scratch.data_ptr(),
        n_segments, nsec, lanes, seg_frames, context, m, sum_groups,
        K._stream(co.device))
    assert code == 0, code
    return gco, K._fold_windows(gxw, x.shape[0], m * seg_frames)


def old_rows_vjp(lib, co, x_t, gy, tail, zi, gzf):
    """bef113c's ``kernels._rows_vjp`` on the old build: ``(gcoeffs, gx,
    gzi)`` of windows ``x_t`` ``(L, B, ch)``."""
    L, B, ch = x_t.shape
    nsec = co.shape[1]
    gco = torch.zeros((B, nsec, ch, 11), dtype=torch.float32,
                      device=co.device)
    gx = torch.empty((L, B, ch), dtype=torch.float32, device=co.device)
    gzi = None if zi is None else torch.empty_like(zi)
    scratch = old_scratch(B * ch, L, nsec, co.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    code = lib.sosfilt_rows_vjp_launch(
        co.data_ptr(), *co.stride()[:3], x_t.data_ptr(), *x_t.stride(),
        ptr(zi), gy.data_ptr(), ptr(gzf), gx.data_ptr(), gco.data_ptr(),
        ptr(gzi), scratch.data_ptr(), nsec, B, ch, L, tail,
        K._stream(co.device))
    assert code == 0, code
    return gco, gx, gzi


def shapes(lib, dev):
    """``{name: (new call, old call)}`` at the fits' shapes."""
    rng = np.random.default_rng(7)

    def randn(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=dev)

    def lowpass(cuts, nb):
        c = torch.as_tensor(np.asarray(cuts, np.float32).reshape(1, -1),
                            device=dev)
        co = design_coupled(TorchXP(dev), 'lp', (c,), np.float32(cs.RATE / 2))
        return co.reshape(1, nb, -1, 11).permute(1, 0, 2, 3).contiguous()

    V, F = cs.V, cs.F
    toff_fit = torch.full((V,), -cs.C, dtype=torch.int32, device=dev)
    lanef = torch.as_tensor(np.stack([cs.poly_freqs(V), np.zeros(V,
                                                                  np.float32),
                                      np.ones(V, np.float32)]), device=dev)
    nb = cs.FIT_BLOCKS
    fit_co = lowpass(rng.uniform(600.0, 5000.0, nb * V), nb)
    fit_gy = randn(nb, F, 1)
    fit = dict(n_segments=nb, seg_frames=F, context=cs.C, osc_code=K.OSC_SAW,
               rate=cs.RATE, sum_groups=V, blocks_per_seg=cs.M,
               source_grad=False)
    nb8 = cs.C8_BLOCKS
    c8_co = lowpass(np.full(nb8 * V, 800.0), nb8)
    c8_toff = torch.full((V,), -cs.C8_C, dtype=torch.int32, device=dev)
    c8_gy = randn(nb8, F, V)
    c8 = dict(n_segments=nb8, seg_frames=F, context=cs.C8_C,
              osc_code=K.OSC_SAW, rate=cs.RATE, sum_groups=0,
              blocks_per_seg=1, source_grad=False)
    nb9 = cs.c9_blocks()
    c9_co = lowpass(np.tile(np.linspace(350.0, 1200.0, V), nb9), nb9)
    c9_x = randn(cs.C9_C + nb9 * F, V)
    c9_gy = randn(nb9, F, V)
    c9 = dict(n_segments=nb9, seg_frames=F, context=cs.C9_C)
    b3 = {}
    for name, (entry, nsec, B, ch, L, tail, *rest) in cs.B3_SHAPES.items():
        co, x, gy, zi, gzf, _, _ = cs.b3_inputs(rng, dev, nsec, B, ch, L,
                                                tail, *rest)
        kw = dict(tail=tail, zi=zi, gzf=gzf)
        b3[f'B3 at the {name} shape ({L} rows, {B} x {ch} lanes, {nsec} '
           f'section{"s" if nsec > 1 else ""})'] = (
            lambda co=co, x=x, gy=gy, kw=kw: K.sosfilt_batch_vjp(co, x, gy,
                                                                 **kw),
            lambda co=co, x=x, gy=gy, kw=kw: old_rows_vjp(lib, co, x, gy,
                                                          **kw))
    return {
        f'B1 at the flagship fit ({nb} blocks, m {cs.M}, C {cs.C}, sum of '
        f'{V})': (
            lambda: K.sosfilt_segments_gen_vjp(fit_co, toff_fit, lanef,
                                               fit_gy, **fit),
            lambda: old_gen_vjp(lib, fit_co, toff_fit, lanef, fit_gy,
                                **fit)),
        f'B1 at c8 ({nb8} blocks, C {cs.C8_C}, per lane)': (
            lambda: K.sosfilt_segments_gen_vjp(c8_co, c8_toff, lanef, c8_gy,
                                               **c8),
            lambda: old_gen_vjp(lib, c8_co, c8_toff, lanef, c8_gy, **c8)),
        f'B2 at c9 ({nb9} blocks, C {cs.C9_C}, {V} lanes)': (
            lambda: K.sosfilt_segments_vjp(c9_co, c9_x, c9_gy, **c9),
            lambda: old_seg_vjp(lib, c9_co, c9_x, c9_gy, **c9)),
        **b3,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print('torch_vjp_variants: no CUDA GPU visible to torch',
              file=sys.stderr)
        return 2
    card = cs.card_line()
    dev = torch.device('cuda')
    _build.library()
    lib = build_old()
    for name, (new, old) in shapes(lib, dev).items():
        err = 0.0
        for a, b in zip(new(), old()):
            if b is None:
                continue
            err = max(err, cs.rel_max(a, b))
        assert err <= cs.TOL, (name, err)
        times = {'old': [], 'new': []}
        for _ in range(ROUNDS):
            for which in ('old', 'new', 'new', 'old'):
                ms = cs.device_ms(new if which == 'new' else old, REPS,
                                  KERNELS)
                if ms is not None:      # a trace that lost kernel events
                    times[which].append(ms)
        med = {k: statistics.median(v) for k, v in times.items()}
        print(f'[vjp] {name}: new {med["new"]:.5f} ms, old {med["old"]:.4f} '
              f'ms device (medians of {len(times["new"])} / '
              f'{len(times["old"])} x {REPS} calls, profiler; new min '
              f'{min(times["new"]):.5f} max {max(times["new"]):.5f}), '
              f'{med["old"] / med["new"]:.1f}x; new vs old max abs / max '
              f'{err!r}  [{card}]')
        if name.startswith(MEMORY):
            mem = {'new': cs.memory_over_inputs(new),
                   'old': cs.memory_over_inputs(old)}
            print(f'[vjp] {name}: memory over its inputs new '
                  f'{mem["new"] / 2**20:.1f} MiB, old '
                  f'{mem["old"] / 2**20:.1f} MiB  [{card}]')
    return 0


if __name__ == '__main__':
    sys.exit(main())
