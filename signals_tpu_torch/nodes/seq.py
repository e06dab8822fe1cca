"""Note sequencing: gate and pitch event tracks (``signals_tpu.nodes.seq``).

Event tracks are traced params (``starts`` / ``ends`` / ``values`` in
frames, ``(C, E)``: one event row per output channel), so a song is program
data — editable and gradient-trainable without recompiling (only the event
count is structural).  Both nodes are stateless functions of the absolute
frame index: a sequenced patch keeps the loop-free render plans and seeks
to any block; ``loop`` > 0 wraps the timeline every ``loop`` frames.

The numpy pull engine evaluates the JAX package's literal form, a
``(frames, C, E)`` comparison of every frame with every event.  Over a
whole render window that tensor does not fit a device (a 60 s window of 64
voices and 300 events is ~51 GB as bool), so the compiled engine evaluates
the same function from the SORTED events with ``searchsorted``: memory
``O(C·(frames + E))``, the same bits (a gate is 0 or 1, a pitch one of the
track's values).

* ``GateSeq``: an event is active on ``[start, end)``; events with ``end <=
  start`` never are.  Over the valid events, ``#{start <= n} - #{end <=
  n}`` counts the active ones at frame ``n``.
* ``PitchSeq``: the value of the latest-started event, the FIRST index among
  equal starts (``argmax``'s tie rule), event 0's before anything started
  (the pad events at ``-1e9`` of :mod:`~signals_tpu_torch.parallel.voices`
  win only before the first real note).  A stable sort keeps equal starts
  in index order, so the first of them is where ``searchsorted(side=
  'left')`` finds their start.
"""

from __future__ import annotations

import numpy as np
import torch

from signals_tpu_torch import SignalFlags
from signals_tpu_torch.core.state import Param, all_of, array_2d, ge, \
    instance_of
from signals_tpu_torch.graph import BlockCachingEmitter, Emitter, KernelCtx
from signals_tpu_torch.registry import register

F32 = np.float32


def _empty_track() -> np.ndarray:
    return np.zeros((1, 0), dtype=np.float32)


def _track(v):
    return (np.asarray(v, dtype=np.float32)
            if isinstance(v, (np.ndarray, list, tuple)) else v)


def _frames_by_row(n, rows: int):
    """The frame times ``n`` ``(F, 1)`` as ``(rows, F)`` contiguous rows —
    ``searchsorted``'s values, one row per event row."""
    return n.reshape(1, -1).expand(rows, n.shape[0]).contiguous()


def gate_sorted(starts, ends, n):
    """``GateSeq``'s value at frame times ``n`` ``(F, 1)`` from ``(C, E)``
    tracks, through the sorted events: ``(F, C)`` float32 of 0 / 1."""
    inf = torch.full((), float('inf'), dtype=starts.dtype,
                     device=starts.device)
    valid = ends > starts                 # NaN and empty events: never
    s = torch.sort(torch.where(valid, starts, inf), dim=1).values
    e = torch.sort(torch.where(valid, ends, inf), dim=1).values
    nt = _frames_by_row(n, starts.shape[0])
    active = (torch.searchsorted(s, nt, right=True)
              > torch.searchsorted(e, nt, right=True))
    return active.to(torch.float32).T


def pitch_sorted(starts, values, n):
    """``PitchSeq``'s value at frame times ``n`` ``(F, 1)`` from ``(C, E)``
    tracks, through the sorted events: ``(F, C)``."""
    inf = torch.full((), float('inf'), dtype=starts.dtype,
                     device=starts.device)
    # a NaN start never starts: as +inf it sorts and counts like one
    s, order = torch.sort(torch.where(torch.isnan(starts), inf, starts),
                          dim=1, stable=True)
    nt = _frames_by_row(n, starts.shape[0])
    k = torch.searchsorted(s, nt, right=True)          # #{start <= n}
    last = torch.gather(s, 1, torch.clamp(k - 1, min=0))
    first = torch.searchsorted(s, last)                # first of its ties
    idx = torch.gather(order, 1, first)
    # nothing started, or only events at -inf (whose argmax key ties with
    # the unstarted ones): argmax's first index, event 0
    idx = torch.where((k > 0) & (last > -inf), idx, torch.zeros_like(idx))
    return torch.gather(values, 1, idx).T


class _SeqBase(BlockCachingEmitter):
    """Shared event-track machinery.  ``starts``/``ends`` are ``(C, E)``
    frame positions — one event row per output channel (``C = 1`` for the
    usual mono track; per-voice rows under the channel-voices polyphony
    layout); ``loop`` > 0 wraps the timeline every ``loop`` frames."""

    class State(Emitter.State):
        starts: np.ndarray = Param(_empty_track, validate=array_2d,
                                   convert=_track, traced=True)
        ends: np.ndarray = Param(_empty_track, validate=array_2d,
                                 convert=_track, traced=True)
        loop: int = Param(0, validate=all_of(instance_of(int), ge(0)))

    @classmethod
    def flags(cls) -> SignalFlags:
        return super().flags() | SignalFlags.GENERATOR

    @property
    def channels(self) -> int:
        return self._state.starts.shape[0]

    def _timeline(self, ctx: KernelCtx):
        n = ctx.frame_range_int
        loop = self._state.loop
        if loop > 0:
            n = ctx.xp.mod(n, np.int32(loop))
        return ctx.xp.astype(n, ctx.xp.float32)

    def set_events(self, events, *, rate: int = 44100) -> None:
        """Convenience: install ``(start_s, dur_s, value)`` tuples."""
        events = list(events)
        state = self.get_state()
        if not events:
            state.starts = _empty_track()
            state.ends = _empty_track()
            return
        starts = np.array([[e[0] * rate for e in events]], dtype=np.float32)
        ends = np.array([[(e[0] + e[1]) * rate for e in events]],
                        dtype=np.float32)
        state.starts = starts
        state.ends = ends
        if len(events[0]) > 2:
            state.values = np.array([[e[2] for e in events]],
                                    dtype=np.float32)


@register('signals_tpu.nodes.seq.GateSeq')
class GateSeq(_SeqBase):
    """1 while any event is active, else 0."""

    def kernel(self, ctx: KernelCtx):
        xp = ctx.xp
        starts = ctx.param('starts')          # (C, E)
        ends = ctx.param('ends')
        if starts.shape[1] == 0:
            return np.zeros((1, 1), dtype=F32)
        if xp.is_torch:
            return gate_sorted(starts, ends, self._timeline(ctx))
        n = self._timeline(ctx)[:, :, None]   # (F, 1, 1)
        active = (n >= starts) & (n < ends)   # (F, C, E)
        return xp.max(active.astype(F32), axis=2)


@register('signals_tpu.nodes.seq.PitchSeq')
class PitchSeq(_SeqBase):
    """Sample-and-hold value track: the most recently started event's value,
    held through and after the event (the usual mono-synth pitch behavior).
    Defaults to the first event's value before anything starts."""

    class State(_SeqBase.State):
        values: np.ndarray = Param(_empty_track, validate=array_2d,
                                   convert=_track, traced=True)

    def kernel(self, ctx: KernelCtx):
        xp = ctx.xp
        starts = ctx.param('starts')          # (C, E)
        values = ctx.param('values')
        if starts.shape[1] == 0:
            return np.zeros((1, 1), dtype=F32)
        if xp.is_torch:
            return pitch_sorted(starts, values, self._timeline(ctx))
        n = self._timeline(ctx)[:, :, None]   # (F, 1, 1)
        started = n >= starts                 # (F, C, E)
        key = np.where(started, starts, F32(-np.inf))
        idx = np.argmax(key, axis=2)          # (F, C) latest-started event
        vals = np.broadcast_to(values, (idx.shape[0], *values.shape))
        return np.take_along_axis(vals, idx[:, :, None], axis=2)[:, :, 0]
