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


def _hadamard8() -> np.ndarray:
    h2 = np.array([[1.0, 1.0], [1.0, -1.0]])
    h = np.kron(np.kron(h2, h2), h2) / np.sqrt(8.0)
    return h.astype(np.float32)


_H8 = _hadamard8()
#: ``_H8_COLS[j]`` is column ``j`` of the matrix shaped ``(1, n_lines, 1)``:
#: what line ``j``'s fed-back signal contributes to every line's input
_H8_COLS = np.ascontiguousarray(_H8.T).reshape(8, 1, 8, 1)


def _hadamard_mix(cols, fed):
    """``mixed[:, i, :] = sum_j H8[i, j] * fed[:, j, :]`` for every line
    ``i`` at once, the terms added in the order ``j = 0 .. 7``: per element
    the very products and sums of the reference's doubly unrolled loop
    (each its own f32 operation), in 15 array operations instead of 120.
    ``cols`` is :data:`_H8_COLS` in ``fed``'s namespace."""
    acc = cols[0] * fed[:, 0:1, :]
    for j in range(1, cols.shape[0]):
        acc = acc + cols[j] * fed[:, j:j + 1, :]
    return acc


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

    #: whether :meth:`mega_step` replays its turn as a CUDA graph: None =
    #: on a GPU, for a window of at least :attr:`GRAPH_MIN_TURNS` whole
    #: turns (the capture costs about as much as a few eager turns)
    graph_turns = None
    GRAPH_MIN_TURNS = 8

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
        mixed = _hadamard_mix(xp.asarray(_H8_COLS), fed)

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
        """Whole-window FDN advance: a host loop over *turns*.

        Everything upstream lowers ONCE over the window; only the FDN
        recurrence is sequential.  The JAX package scans it block by block
        inside its XLA program; an eager loop pays the host for every
        array operation of every turn, so this one takes as few and as
        long turns as the recurrence allows:

        * every line is at least ``min(lengths)`` frames long, so a turn
          advances that many frames (1310 at 44.1 kHz), not one block: all
          its reads lie before its first write, and the per-frame values
          are those of :meth:`step`;
        * the lines' inputs are written into one preallocated ``(L + T,
          n_lines, ch)`` timeline (the carried buffer, then the window),
          which the delayed reads slice in place — no buffer is rebuilt per
          turn; its last ``L`` rows are the carry out;
        * the Hadamard mix is :func:`_hadamard_mix` on the stacked reads;
        * the wet signal does not feed back, so it is summed once over the
          whole window (line 0 to 7 in order, as a sum over the line axis
          runs);
        * on a GPU the whole turns after the first are ONE captured CUDA
          graph replayed per turn (:meth:`_graphed_turns`): the same
          kernels on the same values, one host call a turn instead of 18.
        """
        grid = ctx.block_grid
        F_, nb = grid if grid is not None else (ctx.nframes, 1)
        T = F_ * nb
        ch = self.channels
        rate = int(ctx.rate)
        lengths = self._lengths(rate, F_)
        n_lines = self.n_lines

        g = self._gains(ctx, lengths, rate)
        mixp = ctx.xp.asarray(ctx.param('mix'),
                              dtype=torch.float32).reshape(())
        x = torch.broadcast_to(ctx.in_('input'), (T, ch))
        inject = (x * F32(1.0 / n_lines))[:, None, :]
        buf = carry['lines']                       # (L, n_lines, ch)
        L = buf.shape[0]
        tl = torch.empty((L + T, n_lines, ch), dtype=torch.float32,
                         device=x.device)
        tl[:L] = buf
        cols = ctx.xp.asarray(_H8_COLS)
        turn = min(lengths)
        graphed = self.graph_turns
        if graphed is None:
            graphed = (x.device.type == 'cuda'
                       and T // turn >= self.GRAPH_MIN_TURNS)
        done = (self._graphed_turns(tl, inject, g, cols, lengths, T // turn)
                if graphed else 0)
        for t0 in range(done, T, turn):
            t1 = min(t0 + turn, T)
            reads = torch.stack(
                [tl[L + t0 - d:L + t1 - d, i] for i, d in enumerate(lengths)],
                dim=1)                             # (t1 - t0, n_lines, ch)
            mixed = _hadamard_mix(cols, reads * g)
            torch.add(mixed, inject[t0:t1], out=tl[L + t0:L + t1])
        wet = tl[L - lengths[0]:L - lengths[0] + T, 0]
        for i in range(1, n_lines):
            d = lengths[i]
            wet = wet + tl[L - d:L - d + T, i]
        out = mixp * wet + (F32(1.0) - mixp) * x
        return out, {'lines': tl[T:].clone()}

    @staticmethod
    def _graphed_turns(tl, inject, g, cols, lengths, n_turns: int) -> int:
        """Advance ``n_turns`` whole turns of the recurrence on the
        timeline ``tl`` and return the frames done.  A turn's kernels are
        those of the eager loop with its slices turned into indexed reads
        and writes at a frame offset kept on the device (a gather of the
        delayed rows, an ``index_select`` of the injected input, an
        ``index_copy_`` of the lines' new inputs, and the offset's own
        advance), so that one captured graph serves every turn.  The first
        turn runs eagerly (it also warms the kernels up), then the graph is
        captured once and replayed ``n_turns - 1`` times on the current
        stream."""
        dev = tl.device
        turn, ch = min(lengths), tl.shape[2]
        L = tl.shape[0] - inject.shape[0]
        rows0 = torch.arange(turn, device=dev)
        delays = torch.tensor(lengths, device=dev)
        base = (L + rows0[:, None] - delays[None, :])[:, :, None].expand(
            turn, len(lengths), ch).contiguous()
        t0 = torch.zeros((), dtype=torch.int64, device=dev)

        def one_turn():
            reads = torch.gather(tl, 0, base + t0)
            rows = rows0 + t0
            new = _hadamard_mix(cols, reads * g) + inject.index_select(0, rows)
            tl.index_copy_(0, rows + L, new)
            t0.add_(turn)

        one_turn()
        if n_turns > 1:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                one_turn()
            for _ in range(n_turns - 1):
                graph.replay()
        return n_turns * turn
