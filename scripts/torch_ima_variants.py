#!/usr/bin/env python3
"""The IMA ADPCM encoder on one NVIDIA GPU: the hand-written kernel of
``signals_tpu_torch/compiler/csrc/codecs.cu`` against the design of commit
2d7e608 and against variants of the shipped design, in one process.

The shipped kernel gives each warp a tile of 32 chains whose samples it
stages through shared memory itself, the next chunk's loads in flight
while the chains walk this one.  Beside it this script builds (all
``nvcc`` at once, into ``build/ima_variants/``):

* ``2d7e608``: that commit's ``codecs.cu`` (one thread a chain, 128 a CTA,
  each sample a global load a step ahead, the step and index tables in
  shared memory, an 89-read search for the starting index).  The machine
  with the card has no git history, so first run, from the repository
  root, ``mkdir -p build/ima_2d7e608 && git show
  2d7e608:signals_tpu_torch/compiler/csrc/codecs.cu >
  build/ima_2d7e608/codecs.cu`` (``build/`` is copied to the card and not
  committed);
* ``chain``: the shipped source patched by :data:`CHAIN_ONLY`: each
  sample a hash in registers, nothing loaded — the chains alone, the
  kernel's serial floor (its bytes are not an encoding, and not checked;
  ``chip_smoke.py`` builds the same patch for its floor);
* ``staged_words``: each chain's nibble words kept in shared memory and
  the tile's words stored after each chunk, 16 bytes of a chain a lane
  where a block's words are contiguous (one channel), instead of each word
  stored when it is complete;
* ``warps1`` / ``warps2``: one or two tiles a CTA (shipped: four);
* ``clamp``: the quantization as a round and two clamps instead of one
  saturating conversion (``cvt.rni.sat.s16.f32``);
* ``table16`` / ``table32``: the step table as int16 (45 words) / int at
  every width (shipped: int16 for narrow tiles, int for wide ones);
* ``prefetch`` (and ``prefetch_chain``, its chains alone): the next step
  size off the chain — the five sizes the next index can take read as
  soon as the index is known, the next selected by the code's bits;
* any other ``codecs.cu`` given with ``--source NAME=PATH``.

Then, at ``chip_smoke.IMA_SHAPES`` on the flagship's 60 s mix (the frames
less 7, scaled per channel as ``chip_smoke.ima_kernel`` does), each build
in turns (the builds in order, then in reverse), the device time of one
call by ``torch.profiler`` (5 calls a turn), each payload (not the
chain's) checked byte for byte against the shipped wrapper's
(``codecs.ima_encode``), which ``chip_smoke.py`` holds to the plain loop;
beside them the byte bound and each build's ``ptxas`` registers.

    python3 scripts/torch_ima_variants.py
"""

from __future__ import annotations

import ctypes
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from signals_tpu_torch.compiler import _build  # noqa: E402
from signals_tpu_torch.runtime import codecs  # noqa: E402

OUT = ROOT / 'build' / 'ima_variants'
SRC = ROOT / 'signals_tpu_torch' / 'compiler' / 'csrc' / 'codecs.cu'
OLD_SRC = ROOT / 'build' / 'ima_2d7e608' / 'codecs.cu'

#: the chains alone, the kernel's serial floor: each sample a hash of
#: (step, lane) in registers and nothing staged (its bytes are no encoding)
CHAIN_ONLY = [
    ('    auto sample = [&](const float* col, int i) -> int {\n'
     '        return quantize(col[i * kRow]);\n',
     '    auto sample = [&](const float* col, int n, int i) -> int {\n'
     '        const uint32_t h = (uint32_t)(n * kChunk + i) * 2654435761u\n'
     '            ^ (uint32_t)lane * 40503u;\n'
     '        return (int)(h >> 16) - 32768;\n'),
    ('sample(col, ', 'sample(col, n, '),
    ('    stage(0, buf[warp][0]);\n', ''),
    ('const bool next = n + 1 < n_chunks;', 'const bool next = false;'),
]

#: variant -> ([(text in codecs.cu, its replacement)], extra nvcc flags)
VARIANTS = {
    'chain': (CHAIN_ONLY, []),
    # the tile's words kept in shared memory and stored after each chunk:
    # lane t stores word 4n - 1 + t % 4 of chains t / 4, t / 4 + 8, ...
    'staged_words': ([
        ('            if (active) words[(int64_t)(j >> 3) * ch] = word;\n',
         '            wstage[((j >> 3) & 3) * kLanes] = word;\n'),
        ('    uint32_t* words = blk + ch + c;\n',
         '    __shared__ uint32_t staged_words[kWarps][4 * kLanes];\n'
         '    uint32_t* wstage = staged_words[warp] + lane;\n'
         '    const int n_words = (spb - 1) / 8;\n'),
        ('        __syncwarp();        // every lane is done with this '
         "chunk's buffer\n",
         '        __syncwarp();\n'
         '        const int w = 4 * n - 1 + lane % 4;\n'
         '        for (int jj = lane / 4; jj < T.n; jj += kLanes / 4) {\n'
         '            if (w < 0 || w >= n_words) continue;\n'
         '            const int64_t bj = kWide ? T.b0 : T.b0 + jj / ch;\n'
         '            const int cj = kWide ? T.c0 + jj : jj % ch;\n'
         '            out[bj * ((int64_t)((spb - 1) / 8 + 1) * ch) + ch\n'
         '                + (int64_t)w * ch + cj] = '
         'staged_words[warp][(w & 3) * kLanes + jj];\n'
         '        }\n'
         '        __syncwarp();        // every lane is done with this '
         "chunk's buffer\n")],
        []),
    # one tile a CTA, or eight
    'warps1': ([('constexpr int kWarps = 4; ', 'constexpr int kWarps = 1; ')],
               []),
    'warps2': ([('constexpr int kWarps = 4; ', 'constexpr int kWarps = 2; ')],
               []),
    # the quantization as a round and two clamps (5 instructions) instead
    # of one saturating conversion
    'clamp': ([('    short q;\n'
                '    asm("cvt.rni.sat.s16.f32 %0, %1;"\n'
                '        : "=h"(q) : "f"(__fmul_rn(v, 32768.0f)));\n'
                '    return q;\n',
                '    float q = rintf(__fmul_rn(v, 32768.0f));\n'
                '    q = fminf(fmaxf(q, -32768.0f), 32767.0f);\n'
                '    return (int)q;\n')], []),
    # the step table as int16 at every width (shipped: int when wide)
    'table16': ([('    using Step = typename std::conditional<kWide, int, '
                  'int16_t>::type;\n',
                  '    using Step = int16_t;\n')], []),
    # the step table as int at every width (shipped: int16 when narrow)
    'table32': ([('    using Step = typename std::conditional<kWide, int, '
                  'int16_t>::type;\n',
                  '    using Step = int;\n')], []),
}

#: the next step size taken off the chain: the five sizes the next index
#: can have (index - 1, + 2, + 4, + 6, + 8, clamped: a table padded by one
#: entry below and nine above) read as soon as the index is known, the
#: next size selected by the code's bits
PREFETCH = [
    ('    __shared__ Step steps[89];\n',
     '    __shared__ Step steps[89];\n    __shared__ int padded[98];\n'),
    ('    for (int i = threadIdx.x; i < 89; i += blockDim.x) steps[i] = '
     'kSteps[i];\n',
     '    for (int i = threadIdx.x; i < 89; i += blockDim.x) steps[i] = '
     'kSteps[i];\n'
     '    for (int i = threadIdx.x; i < 98; i += blockDim.x)\n'
     '        padded[i] = kSteps[min(max(i - 1, 0), 88)];\n'),
    ('    int pred = 0, index = 0;\n',
     '    int pred = 0, index = 0;\n'
     '    int step = 0, cm1 = 0, c2 = 0, c4 = 0, c6 = 0, c8 = 0;\n'),
    ('        const int step = steps[index];\n', ''),
    ('                           : index - 1, 0), 88);\n',
     '                           : index - 1, 0), 88);\n'
     '        step = b4 ? (b2 ? (b1 ? c8 : c6) : (b1 ? c4 : c2)) : cm1;\n'
     '        cm1 = padded[index];\n        c2 = padded[index + 3];\n'
     '        c4 = padded[index + 5];\n        c6 = padded[index + 7];\n'
     '        c8 = padded[index + 9];\n'),
    ('                blk[c] = ((uint32_t)pred & 0xFFFFu) | ((uint32_t)index '
     '<< 16);\n',
     '                blk[c] = ((uint32_t)pred & 0xFFFFu) | ((uint32_t)index '
     '<< 16);\n'
     '            step = padded[index + 1];\n'
     '            cm1 = padded[index];\n            c2 = padded[index + 3];\n'
     '            c4 = padded[index + 5];\n'
     '            c6 = padded[index + 7];\n'
     '            c8 = padded[index + 9];\n'),
]
VARIANTS['prefetch'] = (PREFETCH, [])
VARIANTS['prefetch_chain'] = (PREFETCH + CHAIN_ONLY, [])

#: other sources of codecs.cu given with --source: name -> path
SOURCES: dict = {}

#: the builds timed by default, in turns
BUILDS = ('2d7e608', 'shipped', 'chain', 'staged_words', 'clamp', 'warps1',
          'warps2', 'table16', 'table32', 'prefetch', 'prefetch_chain')


def patched(name: str) -> pathlib.Path:
    """The shipped source with ``VARIANTS[name]``'s replacements, written
    into ``OUT``."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    for old, new in VARIANTS[name][0]:
        if old not in text:
            raise SystemExit(f'{name}: {old!r} not in {SRC.name}')
        text = text.replace(old, new)
    path = OUT / f'codecs_{name}.cu'
    path.write_text(text)
    return path


def sources(builds) -> dict:
    """``{build: (source path, extra nvcc flags)}`` of ``builds``."""
    if not OLD_SRC.is_file():
        raise SystemExit(f'{OLD_SRC} is missing: run, from the repository '
                         f'root, mkdir -p {OLD_SRC.parent.relative_to(ROOT)}'
                         f' && git show 2d7e608:signals_tpu_torch/compiler/'
                         f'csrc/codecs.cu > {OLD_SRC.relative_to(ROOT)}')
    OUT.mkdir(parents=True, exist_ok=True)
    found = {}
    for name in builds:
        if name == '2d7e608':
            found[name] = (OLD_SRC, [])
        elif name == 'shipped':
            found[name] = (SRC, [])
        elif name in SOURCES:
            found[name] = (SOURCES[name], [])
        else:
            found[name] = (patched(name), VARIANTS[name][1])
    return found


def build(builds) -> dict:
    """``{build: (ctypes library, ptxas registers line)}``, every build's
    ``nvcc`` started together."""
    nvcc = _build.nvcc_path()
    srcs = sources(builds)
    cmds = [[nvcc, '-O3', '-std=c++17', *_build.ARCH_FLAGS, '-Xcompiler',
             '-fPIC', '-shared', '-Xptxas', '-v', *flags, '-o',
             str(OUT / f'{name}.so'), str(src)]
            for name, (src, flags) in srcs.items()]
    procs = {name: _build.subprocess.Popen(
        cmd, stdout=_build.subprocess.PIPE, stderr=_build.subprocess.STDOUT,
        text=True) for name, cmd in zip(srcs, cmds)}
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f'{name}: nvcc failed\n{out}')
        regs = [ln.strip() for ln in out.splitlines()
                if 'registers' in ln or 'spill' in ln]
        lib = ctypes.CDLL(str(OUT / f'{name}.so'))
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.ima_encode_launch.argtypes = [p, q, i, i, i, p, p]
        lib.ima_encode_launch.restype = i
        libs[name] = (lib, '; '.join(regs))
    return libs


def encoder(lib):
    """``ima_encode`` of ``csrc/codecs.cu`` through ``lib``."""
    def encode(x, spb):
        nb = -(-x.shape[0] // spb)
        out = torch.empty(nb * ((spb - 1) // 2 + 4) * x.shape[1],
                          dtype=torch.uint8, device=x.device)
        code = lib.ima_encode_launch(
            x.data_ptr(), x.shape[0], x.shape[1], spb, nb, out.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if code:
            raise RuntimeError(f'ima_encode launch failed: CUDA error {code}')
        return out
    return encode


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--builds', default=','.join(BUILDS),
                    help='comma-separated builds to time in turns: 2d7e608, '
                         f'shipped, {", ".join(VARIANTS)}')
    ap.add_argument('--shapes', default='all',
                    help="'all' (chip_smoke.IMA_SHAPES) or 'quick' (1 ch x "
                         '1017, 16 ch x 505, 64 ch x 1017)')
    ap.add_argument('--source', action='append', default=[],
                    metavar='NAME=PATH',
                    help='also time codecs.cu as written at PATH (another '
                         'design, checked byte for byte like the others)')
    ap.add_argument('--sass', action='store_true',
                    help='write each build\'s cuobjdump -sass into '
                         'build/ima_variants/<build>.sass')
    args = ap.parse_args(argv)
    for spec in args.source:
        name, path = spec.split('=', 1)
        SOURCES[name] = pathlib.Path(path).resolve()
    builds = tuple(args.builds.split(',')) + tuple(
        spec.split('=', 1)[0] for spec in args.source)
    shapes = (cs.IMA_SHAPES if args.shapes == 'all'
              else ((1, 1017), (16, 505), (64, 1017)))
    if not torch.cuda.is_available():
        print('torch_ima_variants: no CUDA GPU visible to torch',
              file=sys.stderr)
        return 2
    card = cs.card_line()
    libs = build(builds)
    for name, (_, regs) in libs.items():
        print(f'[ima] build {name}: {regs}')
        if args.sass:
            sass = cs.run([str(pathlib.Path(_build.nvcc_path()).parent /
                               'cuobjdump'), '-sass', str(OUT / f'{name}.so')])
            (OUT / f'{name}.sass').write_text(sass)
    enc = {name: encoder(lib) for name, (lib, _) in libs.items()}
    mix = cs.make_poly().render(n_blocks=cs.n_blocks_60s())[0]
    frames = mix.shape[0] - 7
    order = builds + builds[::-1]
    for ch, spb in shapes:
        x = (mix[:frames] * torch.linspace(0.5, 2.5, ch, device=mix.device)
             ).contiguous()
        want = codecs.ima_encode(x, samples_per_block=spb)
        for name in builds:
            if CHAIN_ONLY[0] not in VARIANTS.get(name, ((), ()))[0]:
                assert torch.equal(enc[name](x, spb), want), (name, ch, spb)
        times = {name: [] for name in builds}
        for name in order:
            ms = cs.device_ms(lambda: enc[name](x, spb), 5, ('ima_encode',))
            times[name].append(ms)
        nb = -(-frames // spb)
        b_ms, b_by = cs.bound(cs.IMA_OPS * nb * (spb - 1) * ch,
                              frames * ch * 4 + want.numel())
        shown = ', '.join(
            f'{name} ' + ' / '.join('lost' if t is None else f'{t:.4f}'
                                    for t in ts)
            for name, ts in times.items())
        print(f'[ima] {ch} ch x {spb} ({nb} blocks, {nb * ch} chains): '
              f'device ms in turns: {shown}; bound {b_ms:.5f} ms ({b_by}); '
              f'payloads byte-identical to the shipped kernel\'s  [{card}]')
        del x, want
    print(f'[ima] card: {card}')
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
