"""The two array namespaces node kernels are written against.

``signals_tpu`` writes every node kernel once against ``ctx.xp``: numpy in
the pull engine, ``jax.numpy`` in the compiler.  The port keeps that design
with two small namespaces of the calls both engines need:

* :data:`NP` — numpy, plus :func:`astype` (numpy spells it as a method);
* :class:`TorchXP` — the same names over torch on one ``device``.

Kernels call ``xp.where``, ``xp.floor``, ``xp.maximum``, ``xp.sign``,
``xp.broadcast_to``, ``xp.astype(x, dtype)`` and friends; dtypes are
``xp.float32`` / ``xp.float64`` / ``xp.int32``.  Python and numpy scalars
mix with tensors as weak scalars (the tensor's dtype wins), as they do with
numpy arrays.  Reductions are called as functions with an ``axis``
(``xp.sum(x, axis=1)``, ``xp.min`` / ``xp.max`` / ``xp.mean``): the tensor
methods of the same names return other things.  Integer shifts, ``&`` and
``^`` are the operators themselves: ``>>`` is arithmetic on a signed
integer in both namespaces.
"""

from __future__ import annotations

import numpy as np
import torch


class _NumpyXP:
    """numpy with the extra spellings of :class:`TorchXP`."""

    is_torch = False
    float32, float64, int32 = np.float32, np.float64, np.int32

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def astype(x, dtype):
        return np.asarray(x).astype(dtype)


NP = _NumpyXP()


class TorchXP:
    """numpy-style functions over torch tensors on ``device``."""

    is_torch = True
    float32, float64, int32 = torch.float32, torch.float64, torch.int32

    def __init__(self, device):
        self.device = torch.device(device)

    def _t(self, x):
        """Tensor view of ``x``: numpy values keep their dtype, Python
        floats become f32 (the engines' audio dtype)."""
        if isinstance(x, torch.Tensor):
            return x
        if isinstance(x, float):
            return torch.tensor(x, dtype=torch.float32, device=self.device)
        return torch.as_tensor(np.asarray(x), device=self.device)

    def asarray(self, x, dtype=None):
        return self._t(x) if dtype is None else self._t(x).to(dtype)

    @staticmethod
    def astype(x, dtype):
        return x.to(dtype)

    def _pair(self, a, b):
        """Both operands as tensors; a scalar takes the other's dtype
        (numpy's weak-scalar rule)."""
        if not isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
            a = torch.tensor(a, dtype=b.dtype, device=b.device)
        elif not isinstance(b, torch.Tensor) and isinstance(a, torch.Tensor):
            b = torch.tensor(b, dtype=a.dtype, device=a.device)
        return self._t(a), self._t(b)

    def where(self, cond, a, b):
        a, b = self._pair(a, b)
        return torch.where(self._t(cond), a, b)

    def maximum(self, a, b):
        return torch.maximum(*self._pair(a, b))

    def minimum(self, a, b):
        return torch.minimum(*self._pair(a, b))

    def abs(self, x):
        return torch.abs(x)

    def clip(self, x, lo, hi):
        return torch.clamp(self._t(x), lo, hi)

    def floor(self, x):
        return torch.floor(x)

    def sign(self, x):
        return torch.sign(x)

    def sqrt(self, x):
        return torch.sqrt(x)

    def tan(self, x):
        return torch.tan(x)

    def cos(self, x):
        return torch.cos(x)

    def sin(self, x):
        return torch.sin(x)

    def arctan2(self, y, x):
        return torch.atan2(*self._pair(y, x))

    def mod(self, x, n):
        return torch.remainder(x, n)

    def broadcast_to(self, x, shape):
        return torch.broadcast_to(self._t(x), shape)

    def concatenate(self, xs, axis=0):
        return torch.cat([self._t(x) for x in xs], dim=axis)

    def stack(self, xs, axis=0):
        return torch.stack([self._t(x) for x in xs], dim=axis)

    def repeat(self, x, n, axis=0):
        return torch.repeat_interleave(x, n, dim=axis)

    def arange(self, n, dtype=None):
        return torch.arange(n, dtype=dtype or torch.int64, device=self.device)

    @staticmethod
    def zeros_like(x):
        return torch.zeros_like(x)

    @staticmethod
    def ones_like(x):
        return torch.ones_like(x)

    @staticmethod
    def full_like(x, value):
        return torch.full_like(x, value)

    @staticmethod
    def cummax(x, axis=0):
        return torch.cummax(x, dim=axis).values

    @staticmethod
    def exp(x):
        return torch.exp(x)

    @staticmethod
    def log(x):
        return torch.log(x)

    @staticmethod
    def argmin(x, axis):
        """numpy's ``argmin``: the FIRST index of the minimum along
        ``axis`` (ties included), written out so it holds on any device."""
        lo = torch.amin(x, dim=axis, keepdim=True)
        n = x.shape[axis]
        idx = torch.arange(n, device=x.device).reshape(
            [n if d == axis % x.dim() else 1 for d in range(x.dim())])
        return torch.amin(torch.where(x == lo, idx, n), dim=axis)

    @staticmethod
    def sum(x, axis=None, keepdims=False):
        return (torch.sum(x) if axis is None
                else torch.sum(x, dim=axis, keepdim=keepdims))

    @staticmethod
    def mean(x, axis=None, keepdims=False):
        return (torch.mean(x) if axis is None
                else torch.mean(x, dim=axis, keepdim=keepdims))

    @staticmethod
    def min(x, axis=None):
        return torch.amin(x) if axis is None else torch.amin(x, dim=axis)

    @staticmethod
    def max(x, axis=None):
        return torch.amax(x) if axis is None else torch.amax(x, dim=axis)

    @staticmethod
    def cumsum(x, axis=0):
        return torch.cumsum(x, dim=axis)

    @staticmethod
    def reshape(x, shape):
        return torch.reshape(x, shape)

    @staticmethod
    def pad(x, pad_width):
        """numpy's ``pad`` with zeros for a 2-D ``x`` padded along axis 0
        only: ``pad_width = ((before, after), (0, 0))``."""
        (before, after), (b1, a1) = pad_width
        if b1 or a1 or x.dim() != 2:
            raise NotImplementedError('pad: axis 0 of a 2-D tensor only')
        return torch.nn.functional.pad(x, (0, 0, before, after))

    @staticmethod
    def take_along_axis(x, idx, axis):
        """numpy's ``take_along_axis``; the indices may be int32 (``gather``
        takes them as int64)."""
        return torch.gather(x, axis, idx.to(torch.int64))

    class fft:
        """``xp.fft.rfft`` / ``irfft`` (f32 in, complex64 out, and back)."""

        @staticmethod
        def rfft(x, n=None, axis=-1):
            return torch.fft.rfft(x, n=n, dim=axis)

        @staticmethod
        def irfft(x, n=None, axis=-1):
            return torch.fft.irfft(x, n=n, dim=axis)
