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

:func:`tanh_exact` applies the same discipline to the saturator of
:class:`~signals_tpu_torch.nodes.fx.Drive`: a feedback loop re-injects any
difference between two ``tanh`` implementations on every pass.
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


#: float64 Taylor coefficients 1/n! for the deterministic exp kernel
_EXP_COEFFS = tuple(1.0 / math.factorial(n) for n in range(15))
#: fdlibm hi/lo split of ln 2: k * _LN2_HI is exact for |k| < 2^20
_LN2_HI = 6.93147180369123816490e-01
_LN2_LO = 1.90821492927058770002e-10
_LOG2E = 1.4426950408889634074
#: 2^k lookup (exact f64 constants: exp2/pow are library calls whose
#: rounding varies by backend; a table does not)
_POW2_TAB = np.ldexp(np.float64(1.0), np.arange(64))


def tanh_exact(xp, x):
    """``tanh(x)`` for float32 ``x``, bit-identical across engines.

    Everything runs in float64 **arithmetic only** (+ - * / floor, where, a
    table gather: no library call whose rounding could differ) and rounds
    to float32 once:

    * ``e = exp(2|x|)`` by Cody-Waite reduction (``k = round(y/ln2)``,
      ``r = y - k ln2`` via the hi/lo split, a degree-9 Taylor ``exp(r)``,
      exact ``2^k`` from a table), then ``tanh = (e-1)/(e+1)``;
    * ``|x| < 5e-7``: ``tanh(x) = x`` (true to 4e-20 there);
    * ``|x| > 10``: exactly 1.0 (within a quarter f32 ulp of the truth).

    The op sequence is the JAX package's, and eager torch runs each op as
    its own kernel (no contraction), so numpy, torch on the CPU and torch
    on a GPU agree bit for bit.
    """
    f64 = xp.float64
    xd = xp.astype(xp.asarray(x), f64)
    ax = xp.abs(xd)
    sign = xp.where(xd < 0.0, xp.full_like(xd, -1.0), xp.full_like(xd, 1.0))
    y = xp.minimum(2.0 * ax, xp.full_like(ax, 40.0))

    # e = exp(y) via Cody-Waite + exact 2^k; degree-9 Taylor
    k = xp.floor(y * _LOG2E + 0.5)
    r = (y - k * _LN2_HI) - k * _LN2_LO
    acce = xp.full_like(r, _EXP_COEFFS[9])
    for c in _EXP_COEFFS[8::-1]:
        acce = c + r * acce                        # exp(r)
    ki = xp.astype(xp.clip(k, 0, 63), xp.int32)
    e = acce * xp.asarray(_POW2_TAB)[ki]
    t = (e - 1.0) / (e + 1.0)
    t = xp.where(ax < 5e-7, ax, t)
    t = xp.where(ax > 10.0, xp.full_like(t, 1.0), t)
    return xp.astype(sign * t, xp.float32)
