"""signals_tpu_torch — the PyTorch/CUDA port of ``signals_tpu``.

The same node/port/patch API as ``signals_tpu`` (its module tree and class
names are mirrored one to one), executed by PyTorch on a CPU or an NVIDIA
GPU.  Two engines share one set of node kernel definitions:

* the **pull interpreter** (:mod:`signals_tpu_torch.graph`) — numpy, the
  reference pull-evaluation semantics, used as the parity oracle;
* the **compiler** (:mod:`signals_tpu_torch.compiler`) — lowers a patch to
  eager PyTorch over whole multi-block windows, with the filter cascade in
  hand-written CUDA kernels on a GPU (plain PyTorch on the CPU).

This package never imports ``jax`` or ``signals_tpu``.  Flags and the root
error type mirror the reference (``src/signals/__init__.py:18-64``).

Importing it turns TF32 off for every matrix product and convolution of the
process (``torch.backends.cuda.matmul.allow_tf32``,
``torch.backends.cudnn.allow_tf32``): the parity budget is 1e-5 against an
f64 oracle, and a 10-bit mantissa anywhere near a spectrum or a mix breaks
it.  The renderer itself calls no matrix product.
"""

from __future__ import annotations

import enum
import functools
import json
import pathlib
import typing

import numpy as np
import torch

__version__ = '0.1.0'

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PortName = str


class SignalsError(Exception):
    """Root of the framework's error taxonomy (space-joined ``__str__``,
    as the REPL error reporting of the reference formats it)."""

    def __str__(self) -> str:
        return ' '.join((type(self).__name__,
                         *(str(a) for a in self.args)))


#: Value types a node state property may hold.
SigStateValue = typing.Union[float, int, bool, str, np.ndarray]


class SignalFlags(enum.Flag):
    """Node classification flags (reference ``src/signals/__init__.py:27-58``)."""

    #: may participate in cycles (implemented for Delay nodes)
    CYCLIC = enum.auto()

    SINK_DEVICE = enum.auto()
    SOURCE_DEVICE = enum.auto()
    DEVICE = SINK_DEVICE | SOURCE_DEVICE

    #: Generates audio from non-audio input.
    GENERATOR = enum.auto()
    #: Generates audio from audio.
    EFFECT = enum.auto()
    AUDIO = GENERATOR | EFFECT | SOURCE_DEVICE

    #: Has a predetermined maximum duration.
    EPOCH = enum.auto()
    #: Facilitates recording.
    RECORDER = enum.auto()
    #: Facilitates visualization.
    VIS = enum.auto()
    #: When disabled, returns its input instead of an empty result.
    PASSTHRU = enum.auto()
    #: Never alters its input; produces a side effect when enabled.
    SIDE_EFFECT = VIS | RECORDER | PASSTHRU


class _Env:
    """Filesystem anchors (reference ``src/signals/__init__.py:68-83``)."""

    @property
    def package_root(self) -> pathlib.Path:
        return pathlib.Path(__file__).parent

    @property
    def project_root(self) -> pathlib.Path:
        return self.package_root.parent


env = _Env()


class Config:
    """Per-project JSON configuration (reference ``__init__.py:86-101``):
    the theme name plus the engine defaults a patch is rendered with (block
    size and sample rate).  The same file format as the JAX package's."""

    def __init__(self,
                 *,
                 theme_: str = 'GREEN',
                 block_frames: int = 1024,
                 samplerate: int = 44100):
        self.theme_ = theme_
        self.block_frames = int(block_frames)
        self.samplerate = int(samplerate)

    @property
    def theme(self):
        import signals_tpu_torch.ui.theme
        return getattr(signals_tpu_torch.ui.theme, self.theme_)

    def asdict(self) -> dict:
        return {'theme_': self.theme_,
                'block_frames': self.block_frames,
                'samplerate': self.samplerate}

    @classmethod
    def load(cls, path: pathlib.Path) -> 'Config':
        with pathlib.Path(path).open('r') as f:
            return cls(**json.load(f))

    def save(self, path: pathlib.Path) -> None:
        with pathlib.Path(path).open('w') as f:
            json.dump(self.asdict(), f, indent=2)

    def __eq__(self, other) -> bool:
        return isinstance(other, Config) and self.asdict() == other.asdict()


class Project:
    """A project is a directory with a ``config.json``
    (reference ``__init__.py:104-118``); the default project is the
    repository's ``templates/default``, which both packages read."""

    def __init__(self, *, path: pathlib.Path):
        self.path = pathlib.Path(path)

    @property
    def name(self) -> str:
        return self.path.stem

    @functools.cached_property
    def config(self) -> Config:
        return Config.load(self.path / 'config.json')

    @classmethod
    def default(cls) -> 'Project':
        return cls(path=env.project_root / 'templates' / 'default')
