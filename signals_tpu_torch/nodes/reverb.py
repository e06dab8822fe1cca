"""Feedback-delay-network reverb (``signals_tpu.nodes.reverb``).

A classic FDN: ``n_lines`` delay lines with mutually-prime lengths, mixed
through an energy-preserving Hadamard matrix and fed back with per-line
gains derived from the decay time (``g_i = 10^(-3 len_i / (t60 rate))``,
the standard Schroeder relation).  Delay reads are static slices of one
carried ``(L, n_lines, ch)`` buffer; the feedback mix is an unrolled 8-term
scaled sum in one fixed order in every engine (parity discipline: each
product and each sum is its own rounded f32 operation, never a matrix
product).

Feedback latency is one block (the FDN state advances per block, like
:class:`~signals_tpu_torch.nodes.delay.Delay`); line lengths are clamped to
at least one block accordingly.
"""

from __future__ import annotations

import numpy as np
import torch

from signals_tpu_torch import SignalFlags
from signals_tpu_torch.compiler import kernels as _kernels
from signals_tpu_torch.compiler.kernels import H8_COLS, hadamard_mix
from signals_tpu_torch.core.state import Param, all_of, ge, instance_of
from signals_tpu_torch.graph import (
    ImplicitChannels,
    KernelCtx,
    Receiver,
    StatefulEmitter,
    port,
)
from signals_tpu_torch.registry import register

F32 = np.float32

#: mutually-prime base delay lengths in seconds (scaled by ``size``);
#: classic FDN spread over ~30-90 ms
_BASE_SECONDS = (0.0297, 0.0371, 0.0411, 0.0437, 0.0533, 0.0617, 0.0693,
                 0.0797)


@register()
class Reverb(StatefulEmitter, ImplicitChannels, Receiver):
    """8-line Hadamard FDN reverb.

    ``t60`` (decay time to -60 dB, seconds) and ``mix`` (dry/wet) are
    traced — sweepable without recompiling; ``size`` scales the line
    lengths (structural: resizes the carried buffers).
    """

    input: Receiver.BoundPort = port('input')

    class State(StatefulEmitter.State):
        #: decay time to -60 dB, seconds
        t60: float = Param(2.0, validate=ge(0.01), traced=True)
        #: wet/dry balance in [0, 1]: 0 = dry, 1 = wet
        mix: float = Param(0.3, validate=ge(0.0), traced=True)
        #: room-size multiplier on the line lengths (structural)
        size: float = Param(1.0, validate=all_of(instance_of(float),
                                                 ge(0.1)))

    n_lines = len(_BASE_SECONDS)

    @classmethod
    def flags(cls) -> SignalFlags:
        return super().flags() | SignalFlags.EFFECT

    def _lengths(self, rate: int, block_frames: int) -> list[int]:
        """Static per-line delay lengths (frames), each >= one block."""
        return [max(int(round(b * self._state.size * rate)), block_frames)
                for b in _BASE_SECONDS]

    def init_carry(self, *, channels: int, rate: int,
                   block_frames: int) -> dict[str, np.ndarray]:
        L = max(self._lengths(rate, block_frames))
        return {'lines': np.zeros((L, self.n_lines, channels), dtype=F32)}

    def _gains(self, ctx: KernelCtx, lengths, rate: int):
        """Per-line feedback gains ``(1, n_lines, 1)`` from the Schroeder
        t60 relation, derived per call from the traced decay param."""
        xp = ctx.xp
        t60 = xp.asarray(ctx.param('t60'), dtype=xp.float32).reshape(())
        lens = xp.asarray(np.array(lengths, dtype=np.float32))
        g = xp.exp(lens * (F32(-3.0 * np.log(10.0)) / (t60 * F32(rate))))
        return g.reshape(1, self.n_lines, 1)

    def step(self, ctx: KernelCtx, carry: dict):
        xp = ctx.xp
        F = ctx.nframes
        ch = self.channels
        rate = int(ctx.rate)
        lengths = self._lengths(rate, F)
        buf = carry['lines']                       # (L, n_lines, ch)
        L = buf.shape[0]

        x = xp.broadcast_to(ctx.in_('input'), (F, ch))

        # per-line delayed output: static slices (len_i >= F guaranteed)
        outs = xp.concatenate(
            [buf[L - d:L - d + F, i:i + 1, :] for i, d in enumerate(lengths)],
            axis=1)                                # (F, n_lines, ch)
        fed = outs * self._gains(ctx, lengths, rate)
        mixed = hadamard_mix(xp.asarray(H8_COLS), fed)

        # inject the dry signal into every line and advance the buffers
        new = mixed + x[:, None, :] * F32(1.0 / self.n_lines)
        buf = xp.concatenate([buf, new], axis=0)[-L:]

        wet = xp.sum(outs, axis=1)                 # (F, ch)
        mix = xp.asarray(ctx.param('mix'), dtype=xp.float32).reshape(())
        out = mix * wet + (F32(1.0) - mix) * x
        return out, {'lines': buf}

    # --- whole-window (mega) lowering ------------------------------------

    @property
    def supports_mega_step(self) -> bool:
        return True

    def mega_step(self, ctx, carry: dict):
        """Whole-window FDN advance: ONE call of :func:`~signals_tpu_torch.
        compiler.kernels.fdn_advance` (the hand-written kernel of
        ``csrc/fdn.cu`` on a GPU, the plain turn loop on the CPU).

        Everything upstream lowers ONCE over the window; only the FDN
        recurrence is sequential.  The JAX package scans it block by block;
        the kernel advances it in turns of ``min(lengths)`` frames (1310 at
        44.1 kHz), each of which reads only rows that earlier turns wrote,
        with :meth:`step`'s per-frame values.  It returns the lines' whole
        ``(L + T, n_lines, ch)`` timeline, whose last ``L`` rows are the
        carry out.  The wet signal does not feed back, so it is summed once
        over the whole window (line 0 to 7 in order, as a sum over the line
        axis runs).  The call is an ``autograd.Function`` with a ``vmap``
        rule: gradients reach the input, the carried lines, ``t60`` and
        ``mix``, and under ``PolyPatch(layout='vmap')`` the voices fold
        into the kernel's lanes.
        """
        grid = ctx.block_grid
        F_, nb = grid if grid is not None else (ctx.nframes, 1)
        T = F_ * nb
        ch = self.channels
        rate = int(ctx.rate)
        lengths = self._lengths(rate, F_)
        n_lines = self.n_lines

        g = self._gains(ctx, lengths, rate).reshape(n_lines, 1)
        mixp = ctx.xp.asarray(ctx.param('mix'),
                              dtype=torch.float32).reshape(())
        x = torch.broadcast_to(ctx.in_('input'), (T, ch))
        L = carry['lines'].shape[0]
        tl = _kernels.fdn_advance(carry['lines'], x * F32(1.0 / n_lines), g,
                                  lengths)
        wet = tl[L - lengths[0]:L - lengths[0] + T, 0]
        for i in range(1, n_lines):
            d = lengths[i]
            wet = wet + tl[L - d:L - d + T, i]
        out = mixp * wet + (F32(1.0) - mixp) * x
        return out, {'lines': tl[T:].clone()}
