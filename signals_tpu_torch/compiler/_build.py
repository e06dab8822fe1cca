"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` into a shared library
with a plain C interface, which is loaded with :mod:`ctypes`.  Each source
compiles to its own object file, all ``nvcc`` processes started together,
and one more ``nvcc`` links them.  The library lands in ``build/torch_ext/``
at the repository root, named by a hash of the sources, the headers and the
flags, so an edited source never loads a stale build.  Nothing here runs at
import time: the CPU-only tests import every module.

A failed build raises :class:`KernelBuildError` with the compiler's output;
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import typing

_CSRC = pathlib.Path(__file__).parent / 'csrc'
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / 'build' / 'torch_ext'
ARCH_FLAGS = ('-gencode=arch=compute_90a,code=sm_90a',)
COMPILE_FLAGS = ('-O3', '-std=c++17', *ARCH_FLAGS, '-Xcompiler', '-fPIC',
                 '-c')
LINK_FLAGS = ('-shared', *ARCH_FLAGS)

_lib: typing.Optional[ctypes.CDLL] = None


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    the first ``nvcc`` on ``PATH``."""
    for home in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if home and (pathlib.Path(home) / 'bin' / 'nvcc').is_file():
            return str(pathlib.Path(home) / 'bin' / 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise KernelBuildError('nvcc not found: set CUDA_HOME or put the '
                               'CUDA toolkit on PATH')
    return found


def _sources() -> list[pathlib.Path]:
    return sorted(_CSRC.glob('*.cu'))


def _digest() -> str:
    h = hashlib.sha256(' '.join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sorted(_CSRC.glob('*.cu*')):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands concurrently; raise with the output of the first
    that fails, else return all their output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise KernelBuildError(f'nvcc failed ({p.returncode}):\n'
                                   f'{" ".join(cmd)}\n{out}')
    return ''.join(outs)


def build() -> tuple[pathlib.Path, str]:
    """Compile the sources (if this exact build is not there yet) and
    return ``(library path, compiler output)``.  The output holds ``ptxas
    -v``'s per-kernel register and spill report (the flag changes no
    binary); it is kept beside the library and returned for a build made
    earlier too."""
    digest = _digest()
    target = BUILD_DIR / f'libsignals_kernels_{digest}.so'
    log = target.with_suffix('.log')
    if target.is_file():
        return target, log.read_text() if log.is_file() else ''
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f'{digest}.{os.getpid()}'
    objs = [BUILD_DIR / f'{src.stem}_{tag}.o' for src in _sources()]
    out = _run_all([[nvcc, *COMPILE_FLAGS, '-Xptxas', '-v', '-o', str(obj),
                     str(src)] for src, obj in zip(_sources(), objs)])
    tmp = target.with_suffix(f'.{os.getpid()}.tmp')
    out += _run_all([[nvcc, *LINK_FLAGS, '-o', str(tmp),
                      *map(str, objs)]])
    for obj in objs:
        obj.unlink()
    log.with_suffix(f'.{os.getpid()}.log').write_text(out)
    os.replace(log.with_suffix(f'.{os.getpid()}.log'), log)
    os.replace(tmp, target)
    return target, out


def load(path: pathlib.Path) -> ctypes.CDLL:
    """Load a built kernel library and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    q = ctypes.c_int64
    lib.sosfilt_segments_launch.argtypes = [p, p, q, q, p, p, i, i, i, i, i,
                                            i, i, p]
    lib.sosfilt_segments_launch.restype = i
    lib.sosfilt_segments_gen_launch.argtypes = [p, p, p, f, i, p, p, p, i, i,
                                                i, i, i, i, i, p]
    lib.sosfilt_segments_gen_launch.restype = i
    lib.sosfilt_timeline_launch.argtypes = [p, q, q, p, q, q, p, q, q, p, p,
                                            i, i, i, p]
    lib.sosfilt_timeline_launch.restype = i
    lib.sosfilt_batch_launch.argtypes = [p, q, q, q, p, q, q, q, p, q, q, q,
                                         p, p, i, i, i, i, i, p]
    lib.sosfilt_batch_launch.restype = i
    lib.sosfilt_segments_vjp_launch.argtypes = [p, p, q, q, p, p, f, i, p,
                                                i, p, p, p, i, i, i, i, i, i,
                                                i, p]
    lib.sosfilt_segments_vjp_launch.restype = i
    lib.sosfilt_rows_vjp_buffer.argtypes = [i, i, i, i]
    lib.sosfilt_rows_vjp_buffer.restype = q
    lib.sosfilt_rows_vjp_launch.argtypes = [p, q, q, q, p, q, q, q, p, p, p,
                                            p, p, p, p, q, i, i, i, i, i, p]
    lib.sosfilt_rows_vjp_launch.restype = i
    lib.ima_encode_launch.argtypes = [p, q, i, i, i, p, p]
    lib.ima_encode_launch.restype = i
    ints = ctypes.POINTER(ctypes.c_int)
    lib.fdn_ring_shared.argtypes = [ints]
    lib.fdn_ring_shared.restype = i
    lib.fdn_cluster_occupancy.argtypes = [ints]
    lib.fdn_cluster_occupancy.restype = i
    lib.fdn_advance_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, f,
                                       ints, p]
    lib.fdn_advance_launch.restype = i
    lib.fdn_advance_vjp_launch.argtypes = [p, p, p, p, p, p, i, i, i, f,
                                           ints, p]
    lib.fdn_advance_vjp_launch.restype = i
    lib.fdn_vjp_gain_launch.argtypes = [p, p, p, p, i, i, i, i, ints, p]
    lib.fdn_vjp_gain_launch.restype = i
    lib.signals_partial_width.argtypes = [i, i, i, i, i, i]
    lib.signals_partial_width.restype = i
    lib.signals_cuda_error_string.argtypes = [i]
    lib.signals_cuda_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        _lib = load(build()[0])
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = library().signals_cuda_error_string(code).decode()
        raise RuntimeError(f'{what} launch failed: CUDA error {code} ({msg})')
