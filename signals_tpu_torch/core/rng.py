"""Stateless, seek-stable random numbers (``signals_tpu.core.rng``).

Noise is **counter-based**: a uint32 avalanche hash of ``(seed,
frame_index, channel)`` mapped to [0, 1), a pure function of the frame, so
noise is sample-exact across engines, seeks and replays.  The mixer is the
finalizer of Ellis's ``lowbias32`` hash (public domain), a standard 2-round
xor-shift/multiply avalanche.

The JAX package hashes in ``uint32``.  torch's ``uint32`` lacks most of the
ops, so this one hashes in ``int32``, under numpy and torch alike:
two's-complement multiplies and xors give the same low 32 bits as the
unsigned ones (array multiplies wrap in both namespaces), and each right
shift is made logical by masking off the sign bits that the arithmetic
shift copies in (``(x >> 16) & 0xFFFF``).  The bits are the JAX package's;
the temporaries are 4 bytes an element, at the width of the node that asks.
"""

from __future__ import annotations

import numpy as np

_GOLDEN = 0x9E3779B9
_MIX1 = 0x7FEB352D
_MIX2 = 0x846CA68B
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35


def _s32(c: int) -> int:
    """The uint32 constant ``c`` as the int32 with the same bits."""
    c &= 0xFFFFFFFF
    return c - (1 << 32) if c >= 1 << 31 else c


def uniform01(xp, seed, frame_idx, n_channels: int, *, salt: int = 0):
    """Uniform [0, 1) floats of shape ``(frames, n_channels)``.

    ``frame_idx``: integer column ``(frames, 1)`` of absolute frame indices
    (negative context indices wrap through uint32 — still deterministic).
    ``seed`` may be a parameter tensor.  ``salt`` (host int) selects an
    independent stream for the same seed (octave rows of pink noise etc.);
    ``salt=0`` is the unsalted stream.
    """
    i32 = xp.int32
    f = xp.astype(frame_idx, i32)
    c = xp.arange(n_channels, dtype=i32).reshape(1, -1)
    s = xp.astype(xp.asarray(seed), i32)
    x = (f * _s32(_GOLDEN)) ^ (c * _s32(_C1)) ^ (s * _s32(_C2))
    if salt:
        x = x ^ _s32(salt * _MIX1)
    x = x ^ ((x >> 16) & 0xFFFF)
    x = x * _s32(_MIX1)
    x = x ^ ((x >> 15) & 0x1FFFF)
    x = x * _s32(_MIX2)
    x = x ^ ((x >> 16) & 0xFFFF)
    # top 24 bits -> [0, 1) exactly representable in float32
    top = (x >> 8) & 0xFFFFFF
    return xp.astype(top, xp.float32) * np.float32(1.0 / (1 << 24))
