"""Cross-engine bit-exact transcendentals (``signals_tpu.core.mathx``).

Library ``sin`` differs between numpy and GPU/CPU torch kernels by an ulp or
two on the same float32 inputs.  :func:`sin2pi` removes that at the source:

* quadrant folding uses only exact f32 ops (Sterbenz subtractions,
  compares);
* the Horner chain runs in **float64 and rounds to float32 once**.  Eager
  torch issues each multiply and add as its own kernel (no FMA contraction
  across ops), so numpy, torch on the CPU and torch on a GPU produce the
  same bits; the CUDA generator kernel runs the same chain with
  ``__dmul_rn``/``__dadd_rn``;
* the coefficients are the Taylor terms of ``sin(2*pi*y)`` to degree 13
  (truncation <= 7e-10 relative on ``|y| <= 1/4``).
"""

from __future__ import annotations

import math

import numpy as np

F32 = np.float32

#: float64 Taylor coefficients of sin(2*pi*y) = y * P(y^2),
#: P(z) = sum_n C[n] * z^n with C[n] = (-1)^n (2*pi)^(2n+1) / (2n+1)!
_SIN2PI_COEFFS = tuple(
    (-1.0) ** n * (2.0 * math.pi) ** (2 * n + 1) / math.factorial(2 * n + 1)
    for n in range(7))


def sin2pi(xp, t):
    """``sin(2*pi*t)`` for f32 ``t`` in ``[0, 1)``, bit-identical across
    engines (``xp``: :data:`~signals_tpu_torch.core.xp.NP` or a
    :class:`~signals_tpu_torch.core.xp.TorchXP`).  Inputs outside
    ``[0, 1)`` must be range-reduced first."""
    # fold [0, 1) onto y in [-1/4, 1/4] with sin(2*pi*t) = -sin(2*pi*y)
    r = t - F32(0.5)
    y = xp.where(r > F32(0.25), F32(0.5) - r,
                 xp.where(r < F32(-0.25), F32(-0.5) - r, r))
    z = xp.astype(y * y, xp.float64)
    acc = xp.full_like(z, _SIN2PI_COEFFS[-1])
    for c in _SIN2PI_COEFFS[-2::-1]:
        acc = c + z * acc
    p = xp.astype(acc, xp.float32)
    return -(y * p)


def cos2pi(xp, t):
    """``cos(2*pi*t)`` for ``t`` in ``[0, 1)`` via the quarter-turn shift
    (the shift and re-reduction are exact ops)."""
    s = t + F32(0.25)
    s = s - xp.floor(s)
    return sin2pi(xp, s)
