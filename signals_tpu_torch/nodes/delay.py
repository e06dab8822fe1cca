"""Delay lines and feedback (``signals_tpu.nodes.delay``): the CYCLIC flag
of ``signals_tpu_torch.SignalFlags``, implemented.

A ``Delay`` emits its input shifted ``frames`` samples later.  Because its
output for the current block depends only on *previous* blocks, the compiler
cuts the topological sort at its input edge — so patch cycles are legal iff
they pass through a delay of at least one block (feedback latency is
quantized to the block, the standard block-processing feedback rule).
"""

from __future__ import annotations

import numpy as np

from signals_tpu_torch import SignalFlags
from signals_tpu_torch.core import ChainLayerError, Request
from signals_tpu_torch.core.state import Param, all_of, ge, instance_of
from signals_tpu_torch.graph import (
    ExplicitChannels,
    KernelCtx,
    Receiver,
    StatefulEmitter,
    port,
)
from signals_tpu_torch.registry import register

F32 = np.float32


@register()
class Delay(StatefulEmitter, ExplicitChannels, Receiver):
    """Fixed-length delay line with explicit channels (channel inference
    through a feedback cycle would not terminate)."""

    input: Receiver.BoundPort = port('input')

    class State(ExplicitChannels.State, StatefulEmitter.State):
        #: delay length in frames (structural: sizes the carry buffer)
        frames: int = Param(4410, validate=all_of(instance_of(int), ge(1)))

    @classmethod
    def flags(cls) -> SignalFlags:
        return super().flags() | SignalFlags.EFFECT | SignalFlags.CYCLIC

    @property
    def channels(self) -> int:
        return self._state.channels

    def delay_frames(self, rate: int) -> int:
        return self._state.frames

    def init_carry(self, *, channels: int, rate: int, block_frames: int,
                   history: int = 0) -> dict[str, np.ndarray]:
        return {'buf': np.zeros((self._state.frames + history, channels),
                                dtype=F32)}

    def step(self, ctx: KernelCtx, carry: dict):  # pragma: no cover
        raise TypeError('Delay is lowered specially by the compiler')

    # --- pull engine -------------------------------------------------------
    #
    # Cycle-safe pull evaluation: the output is served from the buffer and
    # written into the block cache *before* the input is pulled, so a
    # feedback path re-requesting this block hits the cache instead of
    # recursing forever.

    def _get_result(self, request: Request) -> np.ndarray:
        return self._eval(request)

    def _eval(self, request: Request) -> np.ndarray:
        loc = request.loc
        nframes = loc.shape.frames
        D = self._state.frames
        ch = self.channels
        if (self._carry is not None
                and loc.end_position <= self._carry_position):
            # read-only history request (a context-filter lookback,
            # ``forward_with_context`` pulls past-then-current): served
            # from the retained input line WITHOUT touching the carry —
            # the compiled engine, which serves these from the carried
            # buffer, is the semantic model.  A fully-past
            # request from the STREAM START that retention cannot serve
            # is a *restart* (transport replay), not a lookback — fall
            # through to re-initialize and re-render; a context
            # consumer's clamped early reads grow retention in lockstep
            # and never land there (mirrors StatefulEmitter._eval).
            start = getattr(self, '_start_pos', 0)
            cp = self._carry_position
            B = self._carry['buf'].shape[0]
            # the window [q0, q1) is backed by INPUT frames [q0-D, q1-D):
            # serve when the retained line covers the in-stream part of
            # that span (context consumers always land here — their
            # clamped early reads grow retention in lockstep); when it
            # doesn't, a window whose backing span begins at/before the
            # stream start is a *restart* (transport replay, or a
            # one-off early re-read — rendering from scratch gives the
            # right values in both, at the cost of resetting the line),
            # and only a window backed strictly inside the stream is a
            # true mid-stream attach
            s0 = max(loc.position - D, start)
            if cp - s0 <= B:
                return self._read_history(loc)
            if loc.position - D > start:
                raise ChainLayerError(
                    f'Delay history of {B} frames cannot serve a '
                    f'context read {cp - s0} frames back; the '
                    f'consumer was attached mid-stream')
        if D < nframes:
            raise ChainLayerError(
                f'Delay of {D} frames is shorter than the {nframes}-frame '
                f'block; feedback delays must be at least one block long')
        if self._carry is None or loc.position < (self._carry_position or 0):
            self._carry = self.init_carry(channels=ch, rate=loc.rate,
                                          block_frames=nframes)
            self._carry_position = loc.position
            self._start_pos = loc.position
        if loc.position != self._carry_position:
            raise ChainLayerError(
                f'Delay requires block-monotonic pull evaluation (expected '
                f'position {self._carry_position}, got {loc.position})')
        buf = self._carry['buf']
        B = buf.shape[0]
        out = buf[B - D:B - D + nframes]
        if not self._state.enabled:
            out = np.zeros_like(out)
        self._write_block_cache(out, request)
        self._carry_position = loc.end_position
        in_port = self._ports['input']
        if in_port:
            block = np.broadcast_to(in_port.forward(request), (nframes, ch))
        else:
            block = np.zeros((nframes, ch), dtype=F32)
        self._carry = {'buf': np.concatenate([buf, block], axis=0)[-B:]}
        return out

    def _read_history(self, loc) -> np.ndarray:
        """Serve an output window that lies entirely behind the carry
        position: ``o[t] = u[t - D]`` off the retained input line.

        Retention grows adaptively: while the buffer still covers the
        whole stream (so the frames a wider buffer would need are
        provably pre-stream silence) it is zero-padded in place to the
        requested lookback — the context-filter pull pattern repeats
        every block from the stream start, so steady state is reached
        while that holds.  A lookback beyond retained history (e.g. a
        context consumer attached mid-stream) is an error, not silence.
        """
        D = self._state.frames
        ch = self.channels
        buf = self._carry['buf']
        B = buf.shape[0]
        cp = self._carry_position       # input retained through cp
        start = getattr(self, '_start_pos', 0)
        q0, q1 = loc.position, loc.end_position
        lo, hi = q0 - D, q1 - D         # input span backing this window
        out = np.zeros((loc.shape.frames, ch), dtype=F32)
        s0 = max(lo, start)             # frames before the stream: silence
        # proactive retention: this consumer's pattern implies reads
        # ``cp - lo`` frames back every block (early reads are clamped at
        # the stream start, so the current need understates it) — grow
        # while the buffer still covers the whole stream, i.e. while the
        # frames a wider buffer would hold are provably pre-stream zeros
        want = cp - lo
        if want > B and cp - start <= B:
            buf = np.concatenate(
                [np.zeros((want - B, ch), dtype=F32), buf])
            self._carry = {'buf': buf}
            B = want
        if s0 < hi:
            need = cp - s0              # lookback into the input line
            if need > B:
                raise ChainLayerError(
                    f'Delay history of {B} frames cannot serve a '
                    f'context read {need} frames back; the consumer '
                    f'was attached mid-stream')
            i0 = s0 - (cp - B)
            out[s0 - lo:hi - lo] = buf[i0:i0 + (hi - s0)]
        if not self._state.enabled:
            out = np.zeros_like(out)
        return out
