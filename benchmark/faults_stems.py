#!/usr/bin/env python3
"""Faults planted under the ``stems`` cell's timed path (``learn.fit`` with
``learn.per_channel_spectral_loss``), to show that its check sees them.
Each is a context manager that breaks one thing in the program while it is
open (the helpers and the runner are ``faults.py``'s):

* ``loss_scaled``: the per-channel loss raised by 1%, which the check does
  not tell (:data:`UNSEEN`): the second and third steps' losses are each
  side's on its own Adam path, and those paths part by up to ~1% in sound
  runs where float32 gives a voice's near-zero gradient the other sign;
* ``odd_gains_zeroed``: the odd voices' stems zeroed inside the loss, as
  if their gains were 0 there;
* ``cutoff_grad_zeroed``: the low-pass's coefficient cotangent (B2's on
  the cell's 64 lanes) zeroed where the filter's backward returns it, so
  the cutoffs' gradient is 0 (the cutoffs alone feed the coefficients);
* ``unchanged_state``: ``faults.unchanged_state``, the optimizer's steps
  leave the parameters where they were (the losses are still computed);
* ``cutoff_grad_negated``: that cotangent negated.  The check compares
  leaves by their norms, which a sign leaves as they were (:data:`UNSEEN`).

The faults of :data:`UNSEEN` are planted to show what the check cannot
tell, not to be caught.

    python3 benchmark/faults_stems.py --workload stems-64v-fit \
        --fault <fault> --seeds 1 2 3 [--seconds 2]

runs the cell with the fault planted and prints one JSON line a seed with
the numbers compared.  The CPU tests plant them at tiny sizes.
"""

from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import faults  # noqa: E402


def _loss_patched(wrap):
    """``learn.per_channel_spectral_loss`` replaced by ``wrap(original)``
    while open."""
    from signals_tpu_torch import learn
    return faults._patched(learn, 'per_channel_spectral_loss',
                           wrap(learn.per_channel_spectral_loss))


def loss_scaled(kind):
    def wrap(original):
        return lambda *a, **k: 1.01 * original(*a, **k)
    return _loss_patched(wrap)


def odd_gains_zeroed(kind):
    import torch

    def wrap(original):
        def broken(pred, target, **kw):
            keep = torch.ones(pred.shape[1], dtype=pred.dtype,
                              device=pred.device)
            keep[1::2] = 0.0
            return original(pred * keep, target, **kw)
        return broken
    return _loss_patched(wrap)


def _coeff_cotangent(change):
    """The low-pass's coefficient cotangent replaced by ``change(gco)``
    where the filter's backward returns it, while open: from
    ``kernels.sosfilt_segments_vjp`` (B2, the segment kernels of 32 lanes
    or more: the cell's 64 voices) and ``kernels.sosfilt_batch_vjp`` (B3,
    the batched per-block replay of fewer lanes: the CPU tests' 4 voices),
    each on the CPU its plain version."""
    import contextlib
    from signals_tpu_torch.compiler import kernels
    segments, batch = kernels.sosfilt_segments_vjp, kernels.sosfilt_batch_vjp

    def segments_broken(*a, **k):
        gco, gx = segments(*a, **k)
        return change(gco), gx

    def batch_broken(*a, **k):
        gco, gx, gzi = batch(*a, **k)
        return change(gco), gx, gzi
    stack = contextlib.ExitStack()
    stack.enter_context(faults._patched(kernels, 'sosfilt_segments_vjp',
                                        segments_broken))
    stack.enter_context(faults._patched(kernels, 'sosfilt_batch_vjp',
                                        batch_broken))
    return stack


def cutoff_grad_zeroed(kind):
    import torch
    return _coeff_cotangent(torch.zeros_like)


def cutoff_grad_negated(kind):
    return _coeff_cotangent(lambda gco: -gco)


FAULTS = {f.__name__: f for f in (loss_scaled, odd_gains_zeroed,
                                  cutoff_grad_zeroed, faults.unchanged_state,
                                  cutoff_grad_negated)}
#: planted faults that the check does not tell
UNSEEN = ('loss_scaled', 'cutoff_grad_negated')


def main(argv=None) -> int:
    with faults._patched(faults, 'FAULTS', FAULTS):
        return faults.main(argv)


if __name__ == '__main__':
    sys.exit(main())
