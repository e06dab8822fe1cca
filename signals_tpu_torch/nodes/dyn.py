"""Dynamics processing (``signals_tpu.nodes.dyn``; the reference has no
dynamics — its effect set is elementwise + filters,
``src/signals/chain/fx.py``).

:class:`Compressor` is an RMS compressor in the framework's stateless
context-window style: the envelope is a sliding-window RMS over the last
``window`` frames — a pure function of bounded history, exactly like the
filters' context semantics (``fx.py:82-106``), so it is seekable,
blocking-invariant, and mega-window compatible.  Gain is computed per
frame from the classic ratio law above the threshold.

Numerics: the windowed power sum is a difference of cumulative sums; in
float32 the cumulative sum grows without bound over long windows and the
difference cancels catastrophically (~1e-4 envelope error per rendered
minute).  The cumsum therefore runs in float64 and rounds once, in numpy
and on the device alike (``torch.cumsum`` of a float64 tensor) — which
also makes the engines agree at the f32 level (same argument as
:func:`signals_tpu_torch.core.mathx.sin2pi`).
"""

from __future__ import annotations

import numpy as np

from signals_tpu_torch import SignalFlags
from signals_tpu_torch.core.state import Param, all_of, ge, instance_of
from signals_tpu_torch.graph import (
    BlockCachingEmitter,
    ImplicitChannels,
    KernelCtx,
    Receiver,
    port,
)
from signals_tpu_torch.registry import register

F32 = np.float32


@register()
class Compressor(BlockCachingEmitter, ImplicitChannels, Receiver):
    """Sliding-RMS compressor.

    ``threshold`` (linear amplitude), ``ratio`` (>= 1) and ``makeup`` gain
    are traced — sweepable without recompiling; ``window`` (frames of RMS
    history) is structural.  Attack/release both equal the RMS window (a
    symmetric design; the window is the time constant).
    """

    input: Receiver.BoundPort = port('input')

    class State(BlockCachingEmitter.State):
        threshold: float = Param(0.5, validate=ge(1e-6), traced=True)
        ratio: float = Param(4.0, validate=ge(1.0), traced=True)
        makeup: float = Param(1.0, validate=ge(0.0), traced=True)
        #: structural: frames of RMS history (the attack/release time)
        window: int = Param(1024, validate=all_of(instance_of(int), ge(8)))

    @classmethod
    def flags(cls) -> SignalFlags:
        return super().flags() | SignalFlags.EFFECT

    def kernel(self, ctx: KernelCtx):
        xp = ctx.xp
        x, env = _rms_env(ctx, self._state.window, self.channels)
        thresh = _scalar(ctx, 'threshold')
        ratio = _scalar(ctx, 'ratio')
        makeup = _scalar(ctx, 'makeup')
        # above threshold, output level follows thresh * (env/thresh)^(1/R):
        # gain = (env/thresh)^(1/R - 1); below, unity
        over = env / thresh
        gain = xp.where(over > F32(1.0),
                        over ** (F32(1.0) / ratio - F32(1.0)),
                        F32(1.0))
        return x * gain * makeup


@register()
class Gate(BlockCachingEmitter, ImplicitChannels, Receiver):
    """Sliding-RMS noise gate (downward expander) — the Compressor's dual.

    Below ``threshold`` the output level follows
    ``thresh * (env/thresh)**ratio`` (gain ``(env/thresh)**(ratio-1)``,
    clamped at the linear ``floor``); at or above, unity.  ``window``
    frames of RMS history are the attack/release time, exactly the
    stateless context design of :class:`Compressor` — seekable,
    blocking-invariant, fast-path compatible on every engine.
    """

    input: Receiver.BoundPort = port('input')

    class State(BlockCachingEmitter.State):
        threshold: float = Param(0.1, validate=ge(1e-6), traced=True)
        #: expansion slope below threshold (1 = transparent)
        ratio: float = Param(3.0, validate=ge(1.0), traced=True)
        #: minimum linear gain (0 = hard gate at silence)
        floor: float = Param(0.0, validate=ge(0.0), traced=True)
        #: structural: frames of RMS history (the attack/release time)
        window: int = Param(1024, validate=all_of(instance_of(int), ge(8)))

    @classmethod
    def flags(cls) -> SignalFlags:
        return super().flags() | SignalFlags.EFFECT

    def kernel(self, ctx: KernelCtx):
        xp = ctx.xp
        x, env = _rms_env(ctx, self._state.window, self.channels)
        thresh = _scalar(ctx, 'threshold')
        ratio = _scalar(ctx, 'ratio')
        floor = _scalar(ctx, 'floor')
        under = env / thresh
        gain = xp.where(under < F32(1.0),
                        xp.maximum(under ** (ratio - F32(1.0)), floor),
                        F32(1.0))
        return x * gain


@register()
class Limiter(BlockCachingEmitter, ImplicitChannels, Receiver):
    """True-peak lookahead brick-wall limiter.

    Output is the input delayed by ``lookahead`` frames, scaled by
    ``min(1, ceiling / max |x|)`` over the ``lookahead+1`` frames ending
    *now* — i.e. the gain computer sees ``lookahead`` frames ahead of
    the (delayed) program, so attacks are anticipated instead of
    clipped: ``|out| <= ceiling`` exactly, every sample, by
    construction.  Release is window-held, like the other dynamics
    nodes (the gain recovers as soon as the peak leaves the window).

    Stateless context-window design: both the delayed dry tap and the
    peak window are pure lookbacks, so the node is seekable,
    blocking-invariant and fast-path eligible everywhere.  The sliding
    max runs in O(log lookahead) shifted maxima (two overlapping
    power-of-two windows cover any width) — no per-sample loop.

    Note the ``lookahead``-frame latency on the wet path (1.5 ms at the
    64-frame default, 44.1 kHz) — the standard lookahead-limiter
    tradeoff.
    """

    input: Receiver.BoundPort = port('input')

    class State(BlockCachingEmitter.State):
        ceiling: float = Param(0.9, validate=ge(1e-6), traced=True)
        #: structural: frames of anticipation (and of output latency)
        lookahead: int = Param(64, validate=all_of(instance_of(int),
                                                   ge(1)))

    @classmethod
    def flags(cls) -> SignalFlags:
        return super().flags() | SignalFlags.EFFECT

    def kernel(self, ctx: KernelCtx):
        xp = ctx.xp
        L = self._state.lookahead
        F = ctx.nframes
        ch = self.channels
        # dry path delayed by L: window [-2L, F); peak window for output
        # t is |x| over [t-L, t] in x-coordinates = samples the delayed
        # program is about to play plus L frames of its future
        x = ctx.in_context('input', 2 * L)
        if x.shape[0] < 2 * L + F:
            x = xp.pad(x, ((2 * L + F - x.shape[0], 0), (0, 0)))
        x = xp.broadcast_to(x, (2 * L + F, ch))
        mag = xp.abs(x)

        def shifted_max(m, s):
            if s == 0:
                return m
            return xp.maximum(m, xp.pad(m, ((s, 0), (0, 0)))[:-s])

        # doubling pass: m covers a trailing window of p frames
        W = L + 1
        m = mag
        p = 1
        while p * 2 <= W:
            m = shifted_max(m, p)
            p *= 2
        peak = shifted_max(m, W - p)       # two p-windows cover W
        ceiling = _scalar(ctx, 'ceiling')
        gain = xp.minimum(F32(1.0),
                          ceiling / xp.maximum(peak, F32(1e-9)))
        # output t = x[t - L] * gain at x-position t: slice both at the
        # last F entries of their respective alignments
        dry = x[L:L + F]
        return dry * gain[2 * L:]


def _scalar(ctx: KernelCtx, name: str):
    """A traced param as an f32 scalar in the ctx's namespace."""
    xp = ctx.xp
    return xp.asarray(ctx.param(name), dtype=xp.float32).reshape(())


def _rms_env(ctx: KernelCtx, W: int, ch: int):
    """(current block (F, ch), sliding-RMS envelope (F, ch)) over the
    last ``W`` frames — the shared dynamics front end.

    Numerics: the windowed power sum is a difference of f64 cumulative
    sums rounded once (see the module docstring); frames before position
    0 are zero-padded, matching both engines' silence-before-start."""
    xp = ctx.xp
    F = ctx.nframes
    x = ctx.in_context('input', W)
    if x.shape[0] < W + F:
        x = xp.pad(x, ((W + F - x.shape[0], 0), (0, 0)))
    x = xp.broadcast_to(x, (W + F, ch))
    x64 = xp.astype(x, xp.float64)
    cs = xp.cumsum(x64 * x64, axis=0)
    mean_pow = xp.astype((cs[W:] - cs[:-W]) / float(W), xp.float32)
    env = xp.sqrt(xp.maximum(mean_pow, F32(1e-20)))       # (F, ch)
    return x[W:], env
