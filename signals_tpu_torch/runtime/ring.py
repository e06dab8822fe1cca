"""ctypes binding to the native ring buffer and paced consumer
(``signals_tpu.runtime.ring``; the source is :file:`native/ring.cc`, a copy
of the JAX package's).

The library is built at first use with the host's C++ compiler (``$CXX``,
else ``g++``) into ``build/torch_ring/`` at the repository root, named by a
hash of the source and the flags, so an edited source never loads a stale
build.  Nothing is built at import time.  A failed build raises
:class:`RingCompileError` with the compiler's output: unlike the JAX package
there is no pure-Python fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import typing

import numpy as np

_SRC = pathlib.Path(__file__).parent / 'native' / 'ring.cc'
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / 'build' / 'torch_ring'
CXXFLAGS = ('-O2', '-std=c++17', '-fPIC', '-Wall', '-Wextra', '-shared')

_lib: typing.Optional[ctypes.CDLL] = None


class RingCompileError(RuntimeError):
    pass


def build() -> pathlib.Path:
    """Compile :file:`native/ring.cc` (unless this exact build is there)
    and return the library's path."""
    cxx = os.environ.get('CXX') or shutil.which('g++')
    if not cxx:
        raise RingCompileError('no C++ compiler: set CXX or put g++ on PATH')
    h = hashlib.sha256(' '.join(CXXFLAGS).encode())
    h.update(_SRC.read_bytes())
    target = BUILD_DIR / f'libsigring_{h.hexdigest()[:16]}.so'
    if target.is_file():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f'.{os.getpid()}.tmp')
    proc = subprocess.run([cxx, *CXXFLAGS, '-o', str(tmp), str(_SRC),
                           '-lpthread'], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise RingCompileError(f'{cxx} failed ({proc.returncode}):\n'
                               f'{proc.stdout}{proc.stderr}')
    os.replace(tmp, target)
    return target


def library() -> ctypes.CDLL:
    """The loaded ring library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.sig_ring_create.restype = ctypes.c_void_p
    lib.sig_ring_create.argtypes = [ctypes.c_uint32, ctypes.c_uint32]
    lib.sig_ring_destroy.argtypes = [ctypes.c_void_p]
    for name in ('sig_ring_readable', 'sig_ring_writable'):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_uint64
        fn.argtypes = [ctypes.c_void_p]
    for name in ('sig_ring_write', 'sig_ring_read'):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_uint32
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                       ctypes.c_uint32]
    lib.sig_ring_capacity.restype = ctypes.c_uint32
    lib.sig_ring_capacity.argtypes = [ctypes.c_void_p]
    lib.sig_consumer_start.restype = ctypes.c_void_p
    lib.sig_consumer_start.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                       ctypes.c_uint32, ctypes.c_int,
                                       ctypes.c_int]
    lib.sig_consumer_stop.argtypes = [ctypes.c_void_p]
    for name in ('sig_consumer_frames', 'sig_consumer_underruns'):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_uint64
        fn.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the native library builds and loads here (the ring has no
    other implementation)."""
    try:
        library()
    except (RingCompileError, OSError):
        return False
    return True


def _floats(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class RingBuffer:
    """SPSC float32 frame ring of ``capacity_frames`` frames rounded up to
    a power of two."""

    def __init__(self, *, capacity_frames: int, channels: int):
        if capacity_frames < 1 or channels < 1:
            raise ValueError(f'bad ring geometry {capacity_frames} x '
                             f'{channels}')
        self.channels = channels
        self._lib = library()
        self._handle = self._lib.sig_ring_create(capacity_frames, channels)
        self.capacity = self._lib.sig_ring_capacity(self._handle)

    def _check(self, block: np.ndarray) -> np.ndarray:
        if self._handle is None:
            raise ValueError('ring is closed')
        block = np.ascontiguousarray(block, dtype=np.float32)
        if block.ndim != 2 or block.shape[1] != self.channels:
            raise ValueError(f'block of shape {block.shape} for a '
                             f'{self.channels}-channel ring')
        return block

    def write(self, block: np.ndarray) -> int:
        """Copy up to ``len(block)`` frames in; returns frames accepted."""
        block = self._check(block)
        return self._lib.sig_ring_write(self._handle, _floats(block),
                                        block.shape[0])

    def read(self, frames: int) -> np.ndarray:
        out = np.zeros((frames, self.channels), dtype=np.float32)
        got = self.read_into(out)
        return out[:got]

    def read_into(self, out: np.ndarray) -> int:
        """Fill the first frames of ``out`` (float32, C-contiguous);
        returns frames delivered."""
        if (out.dtype != np.float32 or not out.flags.c_contiguous
                or out.ndim != 2 or out.shape[1] != self.channels):
            raise ValueError('read_into needs a C-contiguous float32 '
                             f'(frames, {self.channels}) array')
        if self._handle is None:
            raise ValueError('ring is closed')
        return self._lib.sig_ring_read(self._handle, _floats(out),
                                       out.shape[0])

    @property
    def readable(self) -> int:
        return self._lib.sig_ring_readable(self._handle)

    @property
    def writable(self) -> int:
        return self._lib.sig_ring_writable(self._handle)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.sig_ring_destroy(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, '_handle', None) is not None:
            self.close()


class PacedConsumer:
    """Drains a ring at the sample rate on its own native thread — the
    virtual output device.  Underruns are zero-filled and counted.

    ``fd`` (>= 0) receives every drained block: ``fmt='f32'`` raw float32,
    ``fmt='pcm16'`` 16-bit PCM at 32767 full scale (the production stream
    format: pipe it to a player, a device node, or a .raw file).  The
    caller owns ``fd`` and closes it after :meth:`stop`.
    """

    def __init__(self, ring: RingBuffer, *, rate: float, block_frames: int,
                 fd: int = -1, fmt: str = 'f32'):
        if fmt not in ('f32', 'pcm16'):
            raise ValueError(fmt)
        self.ring = ring
        self.rate = rate
        self.block_frames = block_frames
        self._fd = fd
        self._final = (0, 0)
        self._handle = ring._lib.sig_consumer_start(
            ring._handle, float(rate), block_frames, fd,
            1 if fmt == 'pcm16' else 0)
        if not self._handle:
            raise ValueError(f'consumer refused: rate {rate}, block '
                             f'{block_frames}')

    @property
    def frames(self) -> int:
        if self._handle is None:
            return self._final[0]
        return self.ring._lib.sig_consumer_frames(self._handle)

    @property
    def underruns(self) -> int:
        if self._handle is None:
            return self._final[1]
        return self.ring._lib.sig_consumer_underruns(self._handle)

    def stop(self) -> None:
        """Join the thread; the counters survive."""
        if self._handle is not None:
            self._final = (self.frames, self.underruns)
            self.ring._lib.sig_consumer_stop(self._handle)
            self._handle = None
