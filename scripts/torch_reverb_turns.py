#!/usr/bin/env python3
"""The reverb's feedback delay network on one NVIDIA GPU: the hand-written
kernels of ``signals_tpu_torch/compiler/csrc/fdn.cu`` against their plain
turn loops, against the design of commit b3cf912 and against variants of
the shipped design, in one process.

The shipped kernels keep each delay line as a ring of ``d_j`` slots in
shared memory, store whole rows (at 8 lanes and more through clusters of
8 CTAs), and run the adjoint's gain sums in a parallel kernel after its
serial chain.  Beside them this script builds (all ``nvcc`` at once, into
``build/fdn_variants/``):

* ``b3cf912``: that commit's ``fdn.cu`` alone (one CTA a lane group, the
  timeline read back ``d_j`` rows behind in device memory, 4-byte row
  stores, the gain sums on the adjoint's chain).  The machine with the
  card has no git history, so first run, from the repository root,
  ``mkdir -p build/fdn_b3cf912 && git show
  b3cf912:signals_tpu_torch/compiler/csrc/fdn.cu >
  build/fdn_b3cf912/fdn.cu`` (``build/`` is copied to the card and not
  committed);
* ``no_prefetch``: the shipped sources with the forward's inject sample
  and the adjoint's cotangent row loaded where they are used instead of a
  frame (row) ahead;
* ``threads1024``: both chain kernels in CTAs of 1024 threads (a
  1310-frame turn in a full round and one 286 frames deep) instead of the
  turn split evenly over the rounds (672);
* ``relaxed``: the clusters' turn barrier without its release (no memory
  barrier before the arrive): timed, and whether it still gives the plain
  loop's bits printed (without the release a CTA may read its peers'
  staged rows before they land);
* ``noexport``: the clusters without the export of the staged rows
  (timing only: its timeline is wrong and not checked).

Then it prints, each case's builds in turns (b3cf912, shipped, variant,
shipped, b3cf912), device times by ``torch.profiler`` (3 calls):

* the forward at one lane, 60 s (the master bus), at 64 lanes with
  per-lane decay times, 60 s (shipped: clusters; also shipped with one
  CTA a lane), and at ``Reverb(size=4.0)``'s delays (rings in global
  memory), each call checked bit for bit against the plain turn loop;
* the adjoint (chain and gain kernel) at one lane, 60 s, and at 64 lanes
  over 256 blocks, within 1e-5 of the plain adjoint;
* the 60 s master bus (``chip_smoke.build_master_bus``) rendered with each
  design and with the plain loop: wall (one synchronised call after a
  warmup), device time and kernel count, the same bits audio and carry;
* its fit step (the loss and four gradients, as ``chip_smoke.py`` phase
  12 (a)): wall, device time and kernel count with each design.

    python3 scripts/torch_reverb_turns.py
"""

from __future__ import annotations

import contextlib
import ctypes
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from signals_tpu_torch import learn  # noqa: E402
from signals_tpu_torch.compiler import _build  # noqa: E402
from signals_tpu_torch.compiler import compile_node  # noqa: E402
from signals_tpu_torch.compiler import kernels as K  # noqa: E402

OUT = ROOT / 'build' / 'fdn_variants'
OLD_SRC = ROOT / 'build' / 'fdn_b3cf912' / 'fdn.cu'

#: variant -> [(text in fdn.cu, its replacement)]
VARIANTS = {
    'no_prefetch': [
        ('                const float inj = inj_next;\n',
         '                const float inj = inject[(int64_t)t * lanes + '
         'lane];\n'),
        ('                if (tn < t2) inj_next = inject[(int64_t)tn * lanes '
         '+ lane];\n', ''),
        ('            for (int j = 0; j < kLines; ++j) u[j] = gn[j];\n',
         '            for (int j = 0; j < kLines; ++j) u[j] = 0.0f;\n'
         '            load_row(u, gtl + (int64_t)p * row + lane, lanes);\n'),
        ('            if (r + nt < n)\n', '            if (false)\n'),
        ('            else if (tid < nn)\n', '            else if (false)\n'),
    ],
    'threads1024': [('    return (per + 31) / 32 * 32;\n',
                     '    return kThreads + 0 * per;\n')],
    'relaxed': [('barrier.cluster.arrive.release.aligned',
                 'barrier.cluster.arrive.relaxed.aligned')],
    'noexport': [('        if (CLUSTER && k > 0)   // the previous turn\'s rows, '
                  'staged\n', '        if (false)\n'),
                 ('    if (CLUSTER && k > 0) {\n        const int ts',
                  '    if (false) {\n        const int ts')],
}
#: variants timed whose timeline need not be the network's (whether it
#: is, is printed)
INEXACT = ('relaxed', 'noexport')


def build_all():
    """``({name: library path}, {name: ptxas output})``: the shipped build,
    each variant (every source, the edit in ``fdn.cu``) and b3cf912's
    ``fdn.cu`` alone."""
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    path, out = _build.build()
    libs, logs = {'shipped': path}, {'shipped': out}
    nvcc = _build.nvcc_path()
    cmds = {}
    for name, edits in VARIANTS.items():
        d = OUT / name
        shutil.copytree(_build._CSRC, d)
        src = d / 'fdn.cu'
        text = src.read_text()
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        src.write_text(text)
        cmds[name] = [nvcc, '-shared', *_build.COMPILE_FLAGS[:-1],
                      '-Xptxas', '-v', '-o', str(d / 'lib.so'),
                      *map(str, sorted(d.glob('*.cu')))]
    if not OLD_SRC.is_file():
        raise SystemExit(f'{OLD_SRC} is missing: run `git show b3cf912:'
                         f'signals_tpu_torch/compiler/csrc/fdn.cu > '
                         f'{OLD_SRC.relative_to(ROOT)}` in a checkout')
    cmds['b3cf912'] = [nvcc, '-shared', *_build.COMPILE_FLAGS[:-1],
                       '-Xptxas', '-v', '-o', str(OUT / 'b3cf912.so'),
                       str(OLD_SRC)]
    procs = {n: subprocess.Popen(c, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for n, c in cmds.items()}
    for name, p in procs.items():
        logs[name] = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f'{name} build failed:\n{logs[name]}')
        libs[name] = pathlib.Path(cmds[name][cmds[name].index('-o') + 1])
    return libs, logs


def ptxas_fdn(name, log):
    for kernel, (regs, smem, spills) in sorted(cs.fdn_ptxas(log).items()):
        print(f'[fdn ptxas] {name}: {kernel}: {regs} registers, {smem} '
              f'bytes static shared, {spills}')


class Old:
    """b3cf912's kernels behind the port's wrappers' signatures."""

    def __init__(self, path):
        self.lib = ctypes.CDLL(str(path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ints = ctypes.POINTER(ctypes.c_int)
        self.lib.fdn_advance_launch.argtypes = [p, p, p, p, i, i, i, i, f,
                                                ints, p]
        self.lib.fdn_advance_vjp_launch.argtypes = [p, p, p, p, p, p, p, i,
                                                    i, i, i, f, ints, p]

    @staticmethod
    def group(lanes):
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        group = 1
        while group < 8 and -(-lanes // group) > sms:
            group *= 2
        return group

    def run(self, lines, inject, g, lengths):
        L, n, lanes = lines.shape
        T = inject.shape[0]
        lines, inject, g = (t.contiguous() for t in (lines, inject, g))
        tl = torch.empty((L + T, n, lanes), device='cuda')
        code = self.lib.fdn_advance_launch(
            lines.data_ptr(), inject.data_ptr(), g.data_ptr(), tl.data_ptr(),
            L, T, lanes, self.group(lanes), float(K.H8[0, 0]),
            K._delays(lengths), K._stream(tl.device))
        assert code == 0, code
        return tl

    def vjp(self, tl, g, gtl, lengths, L):
        n, lanes = tl.shape[1], tl.shape[2]
        T = tl.shape[0] - L
        tl, g, gtl = (t.contiguous() for t in (tl, g, gtl))
        ha = torch.empty((T, n, lanes), device='cuda')
        glines = torch.empty((L, n, lanes), device='cuda')
        ginject = torch.empty((T, lanes), device='cuda')
        gg = torch.empty((n, lanes), device='cuda')
        code = self.lib.fdn_advance_vjp_launch(
            tl.data_ptr(), g.data_ptr(), gtl.data_ptr(), ha.data_ptr(),
            glines.data_ptr(), ginject.data_ptr(), gg.data_ptr(), L, T, lanes,
            self.group(lanes), float(K.H8[0, 0]), K._delays(lengths),
            K._stream(tl.device))
        assert code == 0, code
        return glines, ginject, gg


@contextlib.contextmanager
def design(name, libs, old, one_cta=False):
    """Within this block the port's FDN entry points run ``name``'s
    kernels: a shipped-API build swapped in as the kernel library, or
    b3cf912's behind ``_fdn_run`` / ``fdn_advance_vjp``; ``one_cta``
    runs the shipped forward one CTA a lane at any lane count."""
    saved = (_build._lib, K._fdn_run, K.fdn_advance_vjp, K.fdn_cluster)
    try:
        if name == 'b3cf912':
            K._fdn_run = old.run
            K.fdn_advance_vjp = old.vjp
        else:
            _build._lib = _build.load(libs[name])
            if one_cta:
                K.fdn_cluster = lambda lanes: False
        yield
    finally:
        _build._lib, K._fdn_run, K.fdn_advance_vjp, K.fdn_cluster = saved


def in_turns(names, fn):
    """``{name: [results]}`` of ``fn(name)`` over ``names``, then back."""
    out = {}
    for name in list(names) + list(reversed(names))[1:]:
        out.setdefault(name, []).append(fn(name))
    return out


def spread(values):
    return '-'.join(f'{v:.3f}' for v in (min(values), max(values)))


def network(card, n60, libs, old):
    lengths = cs.fdn_lengths()
    print(f'[fdn] clusters of 8 CTAs the card holds at once with the '
          f'44.1 kHz rings in shared memory: '
          f'{_build.library().fdn_cluster_occupancy(K._delays(lengths))}')
    cases = [('1 lane', 1, n60 * cs.F, 1.0, ['b3cf912', 'shipped',
                                            'no_prefetch', 'threads1024']),
             ('64 lanes', cs.V, n60 * cs.F, 1.0,
              ['b3cf912', 'shipped', 'one_cta', 'threads1024', 'relaxed',
               'noexport']),
             ('1 lane, size 4.0', 1, n60 * cs.F, 4.0, ['b3cf912', 'shipped'])]
    for label, lanes, T, size, names in cases:
        lengths = cs.fdn_lengths(size)
        lines, inject, g = cs.fdn_inputs(lanes, T, 31 + lanes, lengths)
        want = K.fdn_advance_plain(lines, inject, g, lengths)
        exact = {}

        def timed(name):
            lib = 'shipped' if name == 'one_cta' else name
            with design(lib, libs, old, one_cta=name == 'one_cta'):
                got = K.fdn_advance(lines, inject, g, lengths)
                exact[name] = torch.equal(got, want)
                assert name in INEXACT or exact[name], (label, name)
                del got
                ms, _ = cs.kernel_device_ms(
                    lambda: K.fdn_advance(lines, inject, g, lengths), 3,
                    ('fdn_advance',))
            return ms

        res = in_turns(names, timed)
        print(f'[fdn] fdn_advance, {label} x {T} frames, device ms: '
              + '; '.join(f'{n} {spread(v)}' for n, v in res.items())
              + f'; the plain loop\'s bits: {exact}  [{card}]')
        del lines, inject, g, want
        torch.cuda.empty_cache()
    for label, lanes, T in (('1 lane', 1, n60 * cs.F),
                            ('64 lanes', cs.V, cs.N_BLOCKS * cs.F)):
        lengths = cs.fdn_lengths()
        L = max(lengths)
        lines, inject, g = cs.fdn_inputs(lanes, T, 41 + lanes)
        tl = K.fdn_advance(lines, inject, g, lengths)
        gtl = torch.randn(tl.shape, device='cuda',
                          generator=torch.Generator('cuda').manual_seed(41))
        want = K.fdn_advance_vjp_plain(tl, g, gtl, lengths, L)

        def timed(name):
            with design(name, libs, old):
                got = K.fdn_advance_vjp(tl, g, gtl, lengths, L)
                rel = max(cs.rel_max(a, w) for a, w in zip(got, want))
                assert rel <= 1e-5, (label, name, rel)
                ms = [cs.kernel_device_ms(
                    lambda: K.fdn_advance_vjp(tl, g, gtl, lengths, L), 3,
                    (k,))[0] for k in ('fdn_advance_vjp', 'fdn_vjp_gain')]
            return ms

        res = in_turns(['b3cf912', 'shipped', 'no_prefetch', 'threads1024'],
                       timed)
        print(f'[fdn] fdn_advance_vjp + fdn_vjp_gain, {label} x {T} frames '
              f'(within 1e-5 of the plain adjoint), device ms chain; gain: '
              + '; '.join(f'{n} {spread([c for c, _ in v])}; '
                          f'{spread([q for _, q in v])}'
                          for n, v in res.items()) + f'  [{card}]')
        del lines, inject, g, tl, gtl, want
        torch.cuda.empty_cache()


def clocks(card, n60):
    """The SM clock while the one-lane forward runs back to back for about
    a second (``nvidia-smi`` sampled every 50 ms), beside its maximum."""
    lengths = cs.fdn_lengths()
    lines, inject, g = cs.fdn_inputs(1, n60 * cs.F, 7)
    K.fdn_advance(lines, inject, g, lengths)
    torch.cuda.synchronize()
    smi = subprocess.Popen(
        ['nvidia-smi', '--query-gpu=clocks.sm,clocks.max.sm,power.draw',
         '--format=csv,noheader,nounits', '-lms', '50'],
        stdout=subprocess.PIPE, text=True)
    try:
        for _ in range(250):
            K.fdn_advance(lines, inject, g, lengths)
        torch.cuda.synchronize()
    finally:
        smi.terminate()
    rows = [r.split(', ') for r in smi.communicate()[0].splitlines()
            if r.count(',') == 2]
    sm = sorted(int(r[0]) for r in rows)
    print(f'[fdn] SM clock while fdn_advance runs at one lane: '
          f'{sm[0] if sm else "?"}-{sm[-1] if sm else "?"} MHz over '
          f'{len(sm)} samples (max {rows[0][1] if rows else "?"} MHz, power '
          f'{max((float(r[2]) for r in rows), default=0):.0f} W)  [{card}]')


def bus_nodes(root):
    rv = cs.port_sig(root, 'left', 'input')
    return [(cs.port_sig(rv, 'input', 'right'), 'value'),
            (cs.port_sig(rv, 'input', 'left', 'left', 'cutoff', 'right'),
             'value'), (rv, 't60'), (rv, 'mix')]


def master_bus(card, n60, libs, old):
    root = cs.build_master_bus()
    patch = compile_node(root, block_frames=cs.F, rate=cs.RATE, channels=1,
                         device='cuda')
    named = bus_nodes(root)
    outs = {}

    def render(name):
        ctx = (cs.plain_fdn() if name == 'plain'
               else design(name, libs, old))
        with ctx:
            outs[name] = patch.render(n_blocks=n60)
            return cs.profiled(lambda: patch.render(n_blocks=n60))

    res = in_turns(['plain', 'b3cf912', 'shipped'], render)
    for name, runs in res.items():
        print(f'[fdn] master_bus, {n60} blocks, {name}: wall '
              f'{spread([r[0] for r in runs])} ms, device '
              f'{spread([r[1] for r in runs])} ms in '
              f'{"-".join(str(r[2]) for r in runs)} kernels and copies  '
              f'[{card}]')
    (a, ca) = outs['shipped']
    same = all(torch.equal(a, b) and all(torch.equal(ca[u][k], cb[u][k])
                                         for u in ca for k in ca[u])
               for b, cb in (outs['plain'], outs['b3cf912']))
    print(f'[fdn] master_bus: every design gives the plain loop\'s bits, '
          f'audio and carry: {same}')
    assert same

    tgt = (0.2 * np.random.default_rng(5).standard_normal(
        (n60 * cs.F, 1))).astype(np.float32)
    loss_fn = learn.make_loss_fn(patch, torch.tensor(tgt, device='cuda'))

    def step():
        params, leaves = patch.params(), []
        for node, pname in named:
            uid = patch.index.info(node).uid
            params[uid][pname] = t = params[uid][pname].requires_grad_()
            leaves.append(t)
        value = loss_fn(params)
        return torch.autograd.grad(value, leaves)

    grads = {}

    def fit(name):
        with design(name, libs, old):
            grads[name] = step()
            return cs.profiled(step)

    res = in_turns(['b3cf912', 'shipped'], fit)
    for name, runs in res.items():
        print(f'[fdn] master_bus fit step (loss and 4 gradients), {name}: '
              f'wall {spread([r[0] for r in runs])} ms, device '
              f'{spread([r[1] for r in runs])} ms in '
              f'{"-".join(str(r[2]) for r in runs)} kernels and copies  '
              f'[{card}]')
    rel = max(cs.rel_max(a, b) for a, b in zip(grads['shipped'],
                                               grads['b3cf912']))
    print(f'[fdn] master_bus fit step: gradients vs b3cf912\'s, relative '
          f'{rel!r}')
    assert rel <= 1e-4, rel


def main() -> int:
    if not torch.cuda.is_available():
        print('torch_reverb_turns: no CUDA GPU visible to torch',
              file=sys.stderr)
        return 2
    card = cs.card_line()
    libs, logs = build_all()
    for name, log in logs.items():
        ptxas_fdn(name, log)
    old = Old(libs['b3cf912'])
    _build._lib = _build.load(libs['shipped'])
    n60 = cs.n_blocks_60s()
    clocks(card, n60)
    network(card, n60, libs, old)
    master_bus(card, n60, libs, old)
    return 0


if __name__ == '__main__':
    sys.exit(main())
