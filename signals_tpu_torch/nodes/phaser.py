"""Phaser: a swept chain of first-order allpass sections
(``signals_tpu.nodes.phaser``).

An allpass chain passes every frequency at unit gain but rotates the phase
around a movable break frequency; mixed with the dry signal, the rotations
become moving notches.

With a per-frame coefficient ``g[n]`` each section is a one-state affine
recurrence ``y[n] = -g[n]·y[n-1] + b[n]``.  The compiled engine evaluates
it over a whole window as an inclusive scan of the affine maps in log2(n)
Hillis-Steele steps (:func:`~signals_tpu_torch.compiler._segment_scan`,
the counterpart of the JAX package's ``associative_scan``; another
association order, equal to f32 rounding): a mega window is ``stages``
scans with no block loop, the per-block ``step`` the same code over one
block.  The numpy pull engine runs the literal per-frame recurrence — the
sequential oracle the scan is held to.
"""

from __future__ import annotations

import numpy as np

from signals_tpu_torch import SignalFlags
from signals_tpu_torch.core.state import Param, all_of, ge, in_range, \
    instance_of
from signals_tpu_torch.graph import (
    ImplicitChannels,
    KernelCtx,
    Receiver,
    StatefulEmitter,
    port,
)
from signals_tpu_torch.registry import register

F32 = np.float32


@register('signals_tpu.nodes.phaser.Phaser')
class Phaser(StatefulEmitter, ImplicitChannels, Receiver):
    """Swept first-order allpass chain with dry mix.

    ``sweep`` is the allpass break frequency in Hz (an audio-rate signal:
    drive it with an LFO through Gain/Mix, like a filter cutoff);
    ``stages`` (structural) is the number of allpass sections; ``mix``
    (traced) blends dry and allpassed (0 = dry, 0.5 = deepest notches, 1 =
    pure allpass).

    Exact streaming state (one f32 per stage per channel): like
    ``streaming=True`` filters, the state depends on the position — a seek
    resets it.  Each section: ``y[n] = g[n]·x[n] + x[n-1] − g[n]·y[n-1]``
    with ``g = (tan(π·f/fs) − 1) / (tan(π·f/fs) + 1)`` (``|g| < 1`` for
    any f in (0, Nyquist): stable however hard the sweep modulates).
    """

    input: Receiver.BoundPort = port('input')
    sweep: Receiver.BoundPort = port('sweep')

    class State(StatefulEmitter.State):
        #: structural: number of first-order allpass sections
        stages: int = Param(4, validate=all_of(instance_of(int), ge(1)))
        mix: float = Param(0.5, validate=in_range(0.0, 1.0), traced=True)

    @classmethod
    def flags(cls) -> SignalFlags:
        return super().flags() | SignalFlags.EFFECT

    def init_carry(self, *, channels: int, rate: int,
                   block_frames: int) -> dict:
        S = self._state.stages
        return {
            # the last input frame each stage saw (stage 0: the raw input;
            # stage i: stage i-1's last output)
            'x1': np.zeros((S, channels), dtype=F32),
            # each stage's last output frame
            'y1': np.zeros((S, channels), dtype=F32),
        }

    def _coeff(self, xp, f, inv_rate):
        t = xp.tan(F32(np.pi) * f * inv_rate)
        return (t - F32(1.0)) / (t + F32(1.0))

    def step(self, ctx: KernelCtx, carry: dict):
        from signals_tpu_torch.compiler import _segment_scan
        xp = ctx.xp
        F = ctx.nframes
        ch = self.channels
        x = xp.astype(xp.broadcast_to(ctx.in_('input'), (F, ch)), xp.float32)
        f = xp.astype(xp.broadcast_to(ctx.in_('sweep'), (F, ch)), xp.float32)
        f = xp.clip(f, F32(1.0), F32(0.49) * ctx.rate_f32)
        g = self._coeff(xp, f, ctx.inv_rate_f32)     # (F, ch), |g| < 1
        mix = xp.reshape(xp.astype(ctx.param('mix'), xp.float32), ())

        x1 = carry['x1']
        y1 = carry['y1']
        wet = x
        x1_out = []
        y1_out = []
        for s in range(self._state.stages):
            xin = wet
            # x[n-1] within the window; frame 0 reads the carried frame
            xprev = xp.concatenate([x1[s][None, :], xin[:-1]], axis=0)
            b = g * xin + xprev
            if xp.is_torch:
                a_all, b_all = _segment_scan(-g, b)
                y = a_all * y1[s][None, :] + b_all
            else:                                   # pull engine: literal
                y = np.empty_like(xin)
                prev = y1[s]
                for n in range(F):
                    prev = b[n] - g[n] * prev
                    y[n] = prev
            x1_out.append(xin[-1])
            y1_out.append(y[-1])
            wet = y
        out = (F32(1.0) - mix) * x + mix * wet
        return out, {'x1': xp.stack(x1_out), 'y1': xp.stack(y1_out)}

    @property
    def supports_mega_step(self) -> bool:
        """The scan form does not depend on the window length: a mega
        window is the same ``stages`` scans over ``nb·F`` frames."""
        return True

    def mega_step(self, ctx: KernelCtx, carry: dict):
        return self.step(ctx, carry)
