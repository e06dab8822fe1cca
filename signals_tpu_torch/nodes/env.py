"""Envelope generators (``signals_tpu.nodes.env``).

:class:`ADSR` is a gate-driven attack/decay/sustain/release envelope.  The
gate is sampled at block rate, so edges are detected at block granularity;
within a block the envelope is a closed-form function of the frame index.
"""

from __future__ import annotations

import numpy as np

from signals_tpu_torch import SignalFlags
from signals_tpu_torch.core.state import Param, ge
from signals_tpu_torch.graph import (
    ImplicitChannels,
    KernelCtx,
    Receiver,
    StatefulEmitter,
    port,
)
from signals_tpu_torch.registry import register

F32 = np.float32


def _affine_scan(xp, m):
    """Inclusive scan of per-step affine maps along axis 0: ``m`` is ``(n,
    ch, 2, 3)``, each ``[A | b]`` mapping ``L -> A L + b``; row ``i`` of the
    result is the composition of steps ``0..i`` (newest applied last).  In
    log2(n) Hillis-Steele steps (step ``d`` composes each row with the row
    ``d`` before it) — the counterpart of ``jax.lax.associative_scan``; it
    associates the products in another order, so results agree with it to
    f32 rounding."""
    n = m.shape[0]
    d = 1
    while d < n:
        newer, older = m[d:], m[:-d]
        # newer o older: [Nn | nb] [Oo | ob] = [Nn Oo | Nn ob + nb]
        comp = (newer[..., :, :2, None] * older[..., None, :, :]).sum(-2)
        comp = comp + xp.concatenate(
            [xp.zeros_like(newer[..., :2]), newer[..., 2:]], axis=-1)
        m = xp.concatenate([m[:d], comp], axis=0)
        d *= 2
    return m


@register()
class ADSR(StatefulEmitter, ImplicitChannels):
    """Linear ADSR envelope driven by a gate signal (>0.5 = on).

    Retrigger-safe: attack restarts from the envelope's current level, and
    release decays linearly from the level at the off-edge.

    Execution: the pull engine steps carried state per block
    (:meth:`step`).  The compiler lowers the envelope **statelessly**
    (:meth:`grid_kernel`): the gate is sampled on the absolute block grid
    over a bounded ``horizon``, edge times come from a running maximum, and
    retrigger levels from a scan of the per-edge affine updates.  The two
    agree once boundary effects decay, i.e. when ``horizon`` comfortably
    exceeds ``attack+decay`` and ``release``.
    """

    #: compiler: lower via grid_kernel, carry-free
    is_grid_stateless = True

    gate: Receiver.BoundPort = port('gate')

    class State(StatefulEmitter.State):
        attack: float = Param(0.01, validate=ge(0.0), traced=True)
        decay: float = Param(0.1, validate=ge(0.0), traced=True)
        sustain: float = Param(0.7, validate=ge(0.0), traced=True)
        release: float = Param(0.2, validate=ge(0.0), traced=True)
        #: structural: seconds of gate history the compiled form retains
        horizon: float = Param(1.0, validate=ge(0.01))

    @classmethod
    def flags(cls) -> SignalFlags:
        return super().flags() | SignalFlags.GENERATOR

    def init_carry(self, *, channels: int, rate: int,
                   block_frames: int) -> dict[str, np.ndarray]:
        far = np.full((1, channels), -1e9, dtype=F32)
        zero = np.zeros((1, channels), dtype=F32)
        return {'gate': zero.copy(), 't_on': far.copy(), 't_off': far.copy(),
                'level_on': zero.copy(), 'level_off': zero.copy()}

    def _value(self, xp, t, gate_on, t_on, t_off, level_on, level_off,
               A, D, S, R):
        """Envelope level at frame(s) ``t`` given edge state."""
        dt_on = t - t_on
        attack_v = level_on + (F32(1.0) - level_on) * (dt_on / A)
        decay_v = F32(1.0) - (F32(1.0) - S) * ((dt_on - A) / D)
        on_v = xp.where(dt_on < A, attack_v,
                        xp.where(dt_on < A + D, decay_v, S))
        off_v = level_off * xp.maximum(
            F32(0.0), F32(1.0) - (t - t_off) / R)
        return xp.where(gate_on, on_v, off_v)

    def _adsr_params(self, ctx):
        xp = ctx.xp
        rate = ctx.rate_f32
        one = F32(1.0)
        A = xp.maximum(ctx.param('attack') * rate, one)
        D = xp.maximum(ctx.param('decay') * rate, one)
        S = ctx.param('sustain')
        R = xp.maximum(ctx.param('release') * rate, one)
        return A, D, S, R

    def step(self, ctx: KernelCtx, carry: dict):
        xp = ctx.xp
        A, D, S, R = self._adsr_params(ctx)

        g = ctx.in_block_rate('gate') > F32(0.5)      # (1, ch-ish) bool
        prev = carry['gate'] > F32(0.5)
        pos = ctx.frame_range[0:1]                    # (1, 1)

        level_now = self._value(xp, pos, prev,
                                carry['t_on'], carry['t_off'],
                                carry['level_on'], carry['level_off'],
                                A, D, S, R)
        on_edge = g & ~prev
        off_edge = ~g & prev
        t_on = xp.where(on_edge, pos, carry['t_on'])
        level_on = xp.where(on_edge, level_now, carry['level_on'])
        t_off = xp.where(off_edge, pos, carry['t_off'])
        level_off = xp.where(off_edge, level_now, carry['level_off'])

        t = ctx.frame_range                           # (F, 1)
        out = self._value(xp, t, g, t_on, t_off, level_on, level_off,
                          A, D, S, R)
        ch = self.channels

        def row(v):
            return xp.astype(xp.broadcast_to(v, (1, ch)), xp.float32)

        new_carry = {
            'gate': row(xp.where(g, F32(1.0), F32(0.0))),
            't_on': row(t_on),
            't_off': row(t_off),
            'level_on': row(level_on),
            'level_off': row(level_off),
        }
        return out, new_carry

    # --- compiled engine: stateless bounded-horizon lowering ---------------

    def _grid_count(self, stride: int, rate: int) -> int:
        return max(2, int(np.ceil(self._state.horizon * rate / stride)) + 1)

    def grid_windows(self, stride: int, rate: int):
        """(port, stride, count) grid-history requirements, for the
        compiler's window-collection pass."""
        return [('gate', stride, self._grid_count(stride, rate))]

    def grid_kernel(self, ctx: KernelCtx, stride: int):
        """Carry-free evaluation from ``K`` grid samples of the gate.

        Edge *times* are running maxima (``xp.cummax``) over the sampled
        history; edge *levels* obey a linear recurrence in ``(level_on,
        level_off)`` whose per-step update is affine, composed with one
        scan (:func:`_affine_scan`) — no sequential dependence between
        blocks.
        """
        xp = ctx.xp
        A, D, S, R = self._adsr_params(ctx)
        K = self._grid_count(stride, ctx.rate)
        horizon_frames = F32(K * stride)

        # the window may span several grid cells (a multi-block window):
        # sample the gate across all of them and evaluate each frame
        # against the state of its own cell
        w = ctx.window
        anchor_off = stride * (w.offset // stride)
        nb = 1 + (w.end - 1 - anchor_off) // stride
        total = K + nb - 1

        g = ctx.in_grid_samples('gate', stride, total, ahead=nb - 1)
        ch = g.shape[1]
        on = g > F32(0.5)
        prev_on = xp.concatenate([on[:1], on[:-1]], axis=0)
        rise = on & ~prev_on
        fall = ~on & prev_on

        # absolute positions of the grid samples (newest = window anchor);
        # integer arithmetic so large positions stay exact
        fri0 = ctx.frame_range_int[0:1]
        anchor = xp.astype(fri0 - xp.mod(fri0, stride), xp.float32)
        steps = xp.astype(xp.arange(total, dtype=xp.int32), xp.float32)
        pos = anchor + F32(stride) * (steps.reshape(-1, 1) - F32(K - 1))
        sentinel = anchor - horizon_frames              # "long ago"

        # latest edge positions at-or-before each sample: running maximum
        t_on_seq = xp.cummax(xp.where(rise, pos, sentinel), axis=0)
        t_off_seq = xp.cummax(xp.where(fall, pos, sentinel), axis=0)
        first = xp.broadcast_to(sentinel, (1, ch))
        t_on_prev = xp.concatenate([first, t_on_seq[:-1]], axis=0)
        t_off_prev = xp.concatenate([first, t_off_seq[:-1]], axis=0)

        # per-step affine update of L = (lv_on, lv_off):
        #  rise (gate was off): lv_on' = beta*lv_off  (release value)
        #  fall (gate was on):  lv_off' = alpha*lv_on + gamma (on-side value)
        dt_on = pos - t_on_prev
        in_attack = dt_on < A
        alpha = xp.where(in_attack, F32(1.0) - dt_on / A, F32(0.0))
        gamma = xp.where(
            in_attack, dt_on / A,
            xp.where(dt_on < A + D,
                     F32(1.0) - (F32(1.0) - S) * ((dt_on - A) / D), S))
        beta = xp.maximum(F32(0.0), F32(1.0) - (pos - t_off_prev) / R)

        riz = xp.astype(rise, xp.float32)
        fal = xp.astype(fall, xp.float32)
        idm = F32(1.0) - riz - fal
        # lv_on' = a11 lv_on + a12 lv_off + b1 ; lv_off' = a21 lv_on + a22 lv_off + b2
        a11 = idm + fal
        a12 = riz * beta
        b1 = xp.zeros_like(riz)
        a21 = fal * alpha
        a22 = idm + riz
        b2 = fal * gamma
        maps = xp.stack([a11, a12, b1, a21, a22, b2], axis=-1)
        levels = _affine_scan(xp, maps.reshape(total, ch, 2, 3))
        # applied to the boundary state (0, 0): levels = the b terms
        lv_on_seq, lv_off_seq = levels[..., 0, 2], levels[..., 1, 2]

        # evaluate every frame against the state of its own grid cell,
        # picking rows with slices where the cell mapping is static
        nframes = ctx.nframes
        aligned = w.offset % stride == 0

        def pick(arr):
            if nb == 1:
                return arr[K - 1:K]                    # (1, ch) broadcast row
            if aligned and w.stride == stride:
                return arr[K - 1:K - 1 + nframes]      # one row per frame
            if aligned and w.stride == 1 and nframes == nb * stride:
                return xp.repeat(arr[K - 1:K - 1 + nb], stride, axis=0)
            fri_ = ctx.frame_range_int
            cell = ((fri_ - (fri0 - xp.mod(fri0, stride))) // stride)[:, 0]
            return arr[cell + (K - 1)]

        t = ctx.frame_range
        return self._value(xp, t, pick(on), pick(t_on_seq), pick(t_off_seq),
                           pick(lv_on_seq), pick(lv_off_seq),
                           A, D, S, R)
