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
the same function from the SORTED events: memory ``O(C·(frames + E))``,
the same bits (a gate is 0 or 1, a pitch one of the track's values).

* ``GateSeq``: an event is active on ``[start, end)``; events with ``end <=
  start`` never are.  Over the valid events, ``#{start <= n} - #{end <=
  n}`` counts the active ones at frame ``n``.
* ``PitchSeq``: the value of the latest-started event, the FIRST index among
  equal starts (``argmax``'s tie rule), event 0's before anything started
  (the pad events at ``-1e9`` of :mod:`~signals_tpu_torch.parallel.voices`
  win only before the first real note).  A stable sort keeps equal starts
  in index order, so the first of them is where ``searchsorted(side=
  'left')`` finds their start; the value after the first ``k`` sorted
  starts is one entry of a ``(C, E + 1)`` table.

A pitch is constant between sorted starts: an entry of the table numbered
by the count of starts at or before the frame.  A track that does not loop
reads frame times that never decrease (a dense window, a block-rate
sample), so its pitch is COUNTED: one search of the starts into the frames
gives each start's first frame (exact for any float32 frame times; past
2**24 consecutive frames round to one value), then a short window compares
every frame with every start, and a long one is filled tile by tile and
each start's run written over it (:func:`_hold`), no pass over the window
but the fill.  A looped track's frame times wrap, so its pitch is
SEARCHED: a binary search of the sorted starts a frame.  A gate is always
searched (its lookups read the ADSR's grid, a few hundred frames, where the
searches cost less than the count).  :data:`LOOKUPS` counts both.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as nnf

from signals_tpu_torch import SignalFlags
from signals_tpu_torch.core.state import Param, all_of, array_2d, ge, \
    instance_of
from signals_tpu_torch.graph import BlockCachingEmitter, Emitter, KernelCtx
from signals_tpu_torch.registry import register

F32 = np.float32
INF = float('inf')


def _empty_track() -> np.ndarray:
    return np.zeros((1, 0), dtype=np.float32)


def _track(v):
    return (np.asarray(v, dtype=np.float32)
            if isinstance(v, (np.ndarray, list, tuple)) else v)


#: lookups of an event track since :func:`reset_lookup_counts`:
#: ``counted`` (a pitch track that does not loop: frame times that never
#: decrease) and ``searched`` (a looped pitch track, and every gate)
LOOKUPS = {'counted': 0, 'searched': 0}


def reset_lookup_counts() -> None:
    for k in LOOKUPS:
        LOOKUPS[k] = 0


def _frames_by_row(n, rows: int):
    """The frame times ``n`` ``(F, 1)`` as ``(rows, F)`` contiguous rows —
    ``searchsorted``'s values, one row per event row."""
    return n.reshape(1, -1).expand(rows, n.shape[0]).contiguous()


def _edge_frames(edges, n):
    """Each of the ``(C, M)`` edges' first frame among the frame times
    ``n`` ``(F, 1)``, which never decrease: the first ``i`` with ``n[i] >=
    edge``, ``F`` past them (and for +inf).  ``M`` queries of the frames,
    ``(C, M)`` int64, sorted where the edges are."""
    return torch.searchsorted(n.reshape(-1), edges)


#: most frame-edge comparisons a row for a window to count its edges
#: densely (:func:`_hold`)
_DENSE = 1 << 20


def _hold(first, table, frames: int):
    """``(C, frames)``: at frame ``i`` the entry of ``table`` ``(C, M + 1)``
    numbered by ``#{first <= i}``, for ``first`` ``(C, M)`` sorted along
    its rows (:func:`_edge_frames`).

    A short window (``M frames <= _DENSE``) compares every frame with every
    edge.  A long one is cut into tiles of ``T`` frames, which take the
    entry at their start (``#{first < t T}``, a search of the tiles' starts
    into the edges); then each edge writes its entry over its run, up to
    the next edge and ``T`` frames at most: a frame past that lies in a
    later tile than its edge, whose start holds the edge's entry.  Tied
    edges' runs are empty but the last's; an empty slot goes to a slot
    past the window (``nt T > frames``), whose cotangent is 0: a slot in
    the window would take that frame's gradient once for each empty slot.
    So the rows come back as a slice of longer rows, not contiguous.  ``T``
    balances the tiles' search against the runs, and no pass over the
    window is made but the tiles' fill."""
    rows, m = first.shape
    dev = first.device
    if m * frames <= _DENSE:
        at = first[:, None, :] <= torch.arange(frames, device=dev)[:, None]
        return torch.gather(table, 1, at.sum(-1))
    tile = max(1, math.isqrt(frames // m))
    ticks = torch.arange(0, frames + 1, tile, device=dev)
    # the tiles' starts on every row (searchsorted's contiguous values)
    ticks = torch.add(ticks, first[:, :1], alpha=0)
    held = torch.gather(table, 1, torch.searchsorted(first, ticks))
    nt = held.shape[1]
    out = held[:, :, None].expand(rows, nt, tile).contiguous() \
        .view(rows, nt * tile)
    slot = first[:, :, None] + torch.arange(tile, device=dev)
    stop = nnf.pad(first[:, 1:], (0, 1), value=frames)[:, :, None]
    out.index_put_((torch.arange(rows, device=dev)[:, None, None],
                    torch.where(slot < stop, slot, frames)),
                   table[:, 1:, None])
    return out[:, :frames]


def gate_sorted(starts, ends, n):
    """``GateSeq``'s value at frame times ``n`` ``(F, 1)`` from ``(C, E)``
    tracks, through the sorted events: ``(F, C)`` float32 of 0 / 1."""
    LOOKUPS['searched'] += 1
    inf = torch.full((), float('inf'), dtype=starts.dtype,
                     device=starts.device)
    valid = ends > starts                 # NaN and empty events: never
    s = torch.sort(torch.where(valid, starts, inf), dim=1).values
    e = torch.sort(torch.where(valid, ends, inf), dim=1).values
    nt = _frames_by_row(n, starts.shape[0])
    active = (torch.searchsorted(s, nt, right=True)
              > torch.searchsorted(e, nt, right=True))
    return active.to(torch.float32).T


def pitch_sorted(starts, values, n, *, ascending: bool = False):
    """``PitchSeq``'s value at frame times ``n`` ``(F, 1)`` from ``(C, E)``
    tracks, through the sorted events: ``(F, C)``, an entry of a ``(C, E +
    1)`` table numbered by the count of starts at or before each frame.
    With ``ascending`` (``n`` never decreases) the entry is held between
    the starts (:func:`_hold`); else each frame searches the starts.

    A NaN start never starts, and one at -inf is never the latest (its
    ``argmax`` key ties with the unstarted ones'): both +inf, sorted last
    and never counted.  Entry ``k`` is the value of the first index among
    the ``k``-th sorted start's ties; entry 0 (nothing started) event 0's."""
    s, order = torch.sort(torch.nan_to_num(starts, nan=INF, posinf=INF,
                                           neginf=INF), dim=1, stable=True)
    table = torch.cat([values[:, :1], torch.gather(
        values, 1, torch.gather(order, 1, torch.searchsorted(s, s)))], dim=1)
    if ascending:
        LOOKUPS['counted'] += 1
        return _hold(_edge_frames(s, n), table, n.shape[0]).T
    LOOKUPS['searched'] += 1
    k = torch.searchsorted(s, _frames_by_row(n, s.shape[0]), right=True)
    return torch.gather(table, 1, k).T


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


@register()
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


@register()
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
            return pitch_sorted(starts, values, self._timeline(ctx),
                                ascending=self._state.loop == 0)
        n = self._timeline(ctx)[:, :, None]   # (F, 1, 1)
        started = n >= starts                 # (F, C, E)
        key = np.where(started, starts, F32(-np.inf))
        idx = np.argmax(key, axis=2)          # (F, C) latest-started event
        vals = np.broadcast_to(values, (idx.shape[0], *values.shape))
        return np.take_along_axis(vals, idx[:, :, None], axis=2)[:, :, 0]
