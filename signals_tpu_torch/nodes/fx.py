"""Effects and filters (``signals_tpu.nodes.fx``).

Elementwise effects (Mix/RingMod/Gain/Amp/Drive/Pan/Quantize) lower to
eager tensor ops.  The critically-tuned Butterworth filters (LowPass,
HighPass, BandPass, BandStop) and the RBJ EQ family (Peak, LowShelf,
HighShelf, Notch, Allpass) keep the reference's *stateless
context-window* semantics — re-pull context frames, filter from zero
initial state, return the tail — with coefficients designed per block from
the cutoff signal.  Swept (non-``Fixed``) cutoffs additionally carry state
across multi-block segments (:meth:`CritFilter.swept_carry_m`).  In the
compiler the cascade runs in the kernels of
:mod:`signals_tpu_torch.compiler.kernels`: the segment kernels or the
batched replay over multi-block windows, the timeline kernel for a
per-block step and for context windows.  ``streaming=True`` filters are
exact IIRs whose coupled-form state is carried from block to block: the
carried-state kernel per step, and per multi-block window one batched
launch plus a scan of the blocks' state maps (:meth:`CritFilter.mega_step`).
"""

from __future__ import annotations

import abc
import typing

import numpy as np
import torch

from signals_tpu_torch import SignalFlags
from signals_tpu_torch.compiler import filters as _filters
from signals_tpu_torch.core.state import Param, all_of, ge, instance_of
from signals_tpu_torch.graph import (
    BlockCachingEmitter,
    ImplicitChannels,
    KernelCtx,
    Receiver,
    StatefulEmitter,
    port,
)
from signals_tpu_torch.registry import register

F32 = np.float32


class Effect(BlockCachingEmitter, ImplicitChannels, abc.ABC):

    @classmethod
    def flags(cls) -> SignalFlags:
        return super().flags() | SignalFlags.EFFECT


class BinaryEffect(Effect, abc.ABC):
    left: Receiver.BoundPort = port('left')
    right: Receiver.BoundPort = port('right')


@register('signals.chain.fx.Mix')
class Mix(BinaryEffect):
    """Crossfade: ``mix*L + (1-mix)*R`` with ``mix`` at block rate."""

    mix: Receiver.BoundPort = port('mix')

    def kernel(self, ctx: KernelCtx):
        mix = ctx.in_block_rate('mix')
        return mix * ctx.in_('left') + (F32(1.0) - mix) * ctx.in_('right')


@register('signals.chain.fx.RingMod')
class RingMod(BinaryEffect):

    def kernel(self, ctx: KernelCtx):
        return ctx.in_('left') * ctx.in_('right')


@register('signals.chain.fx.Gain')
class Gain(BinaryEffect):
    """``L * R`` with the gain side sampled at block rate."""

    def kernel(self, ctx: KernelCtx):
        return ctx.in_('left') * ctx.in_block_rate('right')


@register('signals.chain.fx.Amp')
class Amp(BinaryEffect):
    """Signed power: ``sign(L) * |L| ** R`` with the exponent at block
    rate (finite for negative L and fractional R)."""

    def kernel(self, ctx: KernelCtx):
        xp = ctx.xp
        x = ctx.in_('left')
        exp = ctx.in_block_rate('right')
        return xp.sign(x) * xp.abs(x) ** exp


@register()
class Drive(Effect):
    """Soft saturation: ``tanh(input * drive) / tanh(drive)`` with the
    drive amount at block rate (normalized so unity passes through at low
    drive).  The saturator is :func:`~signals_tpu_torch.core.mathx.
    tanh_exact`: a library ``tanh`` differs between engines by an ulp or
    two, which a feedback loop re-injects on every pass."""

    input: Receiver.BoundPort = port('input')
    drive: Receiver.BoundPort = port('drive')

    def kernel(self, ctx: KernelCtx):
        from signals_tpu_torch.core.mathx import tanh_exact
        xp = ctx.xp
        x = ctx.in_('input')
        d = xp.maximum(ctx.in_block_rate('drive'), F32(1e-3))
        return tanh_exact(xp, x * d) / tanh_exact(xp, d)


@register()
class Pan(Effect):
    """Equal-power stereo panner: mono in, two channels out.  ``position``
    (block rate) in [-1, 1], left to right; a wider input is averaged to
    mono first."""

    input: Receiver.BoundPort = port('input')
    position: Receiver.BoundPort = port('position')

    @property
    def channels(self) -> int:
        return 2

    def kernel(self, ctx: KernelCtx):
        xp = ctx.xp
        x = ctx.in_full('input')
        mono = (x if x.shape[1] == 1
                else xp.mean(x, axis=1, keepdims=True))
        p = xp.clip(ctx.in_block_rate('position'), F32(-1.0), F32(1.0))
        theta = (p[:, :1] + F32(1.0)) * F32(np.pi / 4)
        left = mono * xp.cos(theta)
        right = mono * xp.sin(theta)
        return xp.concatenate(
            [xp.broadcast_to(left, (ctx.nframes, 1)),
             xp.broadcast_to(right, (ctx.nframes, 1))], axis=1)


def _pad_rows(x, n: int, edge: bool = False):
    """``x`` ``(k, ch)`` extended to ``n`` rows: with zeros, or with
    copies of its last row (``edge``)."""
    k = x.shape[0]
    if k == n:
        return x
    tail = (torch.broadcast_to(x[-1:], (n - k, x.shape[1])) if edge
            else torch.zeros((n - k, x.shape[1]), dtype=x.dtype,
                             device=x.device))
    return torch.cat([x, tail])


def _rotation_scan(m):
    """Inclusive scan along axis 1 of the affine maps ``z -> P z + d`` with
    ``P`` a scaled rotation: ``m`` is ``(4, n, ch)`` = (Pc, Ps, d1, d2),
    row ``i`` of the result the composition of maps ``0..i`` (newest applied
    last), in log2(n) Hillis-Steele steps — the counterpart of the JAX
    package's ``associative_scan`` in :meth:`CritFilter.mega_step` (another
    association order: equal to f32 rounding)."""
    n = m.shape[1]
    d = 1
    while d < n:
        oac, oas, od1, od2 = m[:, :-d]
        nac, nas, nd1, nd2 = m[:, d:]
        comp = torch.stack([nac * oac - nas * oas,
                            nas * oac + nac * oas,
                            nac * od1 - nas * od2 + nd1,
                            nas * od1 + nac * od2 + nd2])
        m = torch.cat([m[:, :d], comp], dim=1)
        d *= 2
    return m


class CritFilter(StatefulEmitter, ImplicitChannels, abc.ABC):
    """Critically-tuned order-2 Butterworth filtering.

    Filtering is a pure function of the last ``context_frames() +
    nframes`` input frames (state recomputed from a bounded context window
    every block), with coefficients recomputed per block from the cutoff
    signal.  ``streaming=True`` switches to **exact IIR**: the filter state
    is carried across blocks instead of recomputed from context — no
    window approximation, at the cost of position-dependent state (a seek
    resets it).
    """

    input: Receiver.BoundPort = port('input')

    order = 2

    class State(StatefulEmitter.State):
        #: structural: frames of input history recomputed each block
        context: int = Param(1024, validate=all_of(instance_of(int), ge(1)))
        #: structural: exact carried-state IIR instead of context windows
        streaming: bool = Param(False, validate=instance_of(bool))
        #: structural: blocks per state-carry segment for SWEPT crits
        #: (0 = engine default ``SEG_CARRY_BLOCKS``, 1 = per-block context
        #: replay).  See :meth:`swept_carry_m`.
        carry: int = Param(0, validate=all_of(instance_of(int), ge(0)))

    @classmethod
    def flags(cls) -> SignalFlags:
        return super().flags() | SignalFlags.EFFECT

    def is_stateful(self) -> bool:
        return self._state.streaming

    @property
    def n_sections(self) -> int:
        return 2 if self.type_code() in (_filters.BANDPASS,
                                         _filters.BANDSTOP) else 1

    def init_carry(self, *, channels: int, rate: int,
                   block_frames: int) -> dict:
        return {'zi': np.zeros((self.n_sections, 2, channels), dtype=F32)}

    def step(self, ctx: KernelCtx, carry: dict):
        nyquist = ctx.rate_f32 * F32(0.5)
        coeffs = _filters.design_coupled(ctx.xp, self.type_code(),
                                         self._crits(ctx), nyquist)
        x = ctx.xp.broadcast_to(ctx.in_('input'),
                                (ctx.nframes, self.channels))
        y, zf = ctx.sosfilt_stream(coeffs, x, carry['zi'])
        return y, {'zi': zf}

    @property
    def supports_mega_step(self) -> bool:
        """Streaming filters render a whole multi-block window without a
        block loop (:meth:`mega_step`)."""
        return self._state.streaming

    def mega_step(self, ctx, carry: dict):
        """Exact streaming IIR over a window of ``nb`` whole blocks, no
        block loop (the JAX package's algorithm).

        With per-block coefficients, block ``b`` maps the incoming state by
        ``z' = A_b^F z + zf_b`` where ``zf_b`` is the block's zero-state end
        state — affine maps composed across blocks by one scan.  The
        per-frame output correction for an incoming state is ``y[k] += d1
        s1m[k] + d2 s2m[k]`` with ``(s1m, s2m) = A_b^k z_b`` in closed form
        (the coupled-form transition is a scaled rotation, ``A^k = rho^k
        Rot(k theta)``), the powers in float64 so that large ``k theta``
        stay accurate at any cutoff.  Band filters run the algorithm once
        per section, each fed the previous section's corrected output.

        The zero-state filtering of all blocks and their end states is ONE
        :func:`~signals_tpu_torch.compiler.kernels.sosfilt_batch` call per
        section over ``nb`` non-overlapping windows of ``F`` rows, read in
        place.

        Static crits (:meth:`crits_static`) design the same coefficients
        for every block, so the window is one run of the carried-state
        cascade: ONE :func:`~signals_tpu_torch.compiler.kernels.
        sosfilt_stream` call over all ``nb*F`` rows, all sections, and no
        scan or correction."""
        F_, nb = ctx.block_grid
        nyquist = ctx.rate_f32 * F32(0.5)
        x = ctx.in_('input')                           # (nb*F, ch_in)
        if self.crits_static():
            crits = tuple(g[:1] for g in self._crits_grid(ctx))
            coeffs = _filters.design_coupled(ctx.xp, self.type_code(), crits,
                                             nyquist)
            ch = max(x.shape[1], coeffs.shape[1], self.channels)
            y, zf = ctx.sosfilt_stream(
                coeffs, torch.broadcast_to(x, (nb * F_, ch)), carry['zi'])
            return y, {'zi': zf}
        co = self._block_coeffs(ctx, nb, nyquist)      # (nb, nsec, chs, 11)
        ch = max(x.shape[1], co.shape[2], self.channels)
        y = torch.broadcast_to(x, (nb * F_, ch)).reshape(nb, F_, ch)
        zi = carry['zi']
        zfs = []
        for s in range(co.shape[1]):
            cs = torch.broadcast_to(co[:, s:s + 1], (nb, 1, ch, 11))
            y, zf_s = self._mega_step_section(cs, y, zi[s], F_, nb, ch)
            zfs.append(zf_s)
        return y.reshape(nb * F_, ch), {'zi': torch.stack(zfs)}

    @staticmethod
    def _mega_step_section(co, xb, zi_s, F_, nb, ch):
        """One section of :meth:`mega_step`: ``xb`` (nb, F, ch) input
        blocks, ``co`` (nb, 1, ch, 11) per-block coefficients, ``zi_s``
        (2, ch0) incoming coupled-form state.  Returns ``(y (nb, F, ch),
        zf (2, ch))``."""
        from signals_tpu_torch.compiler.kernels import sosfilt_batch
        # 1. zero-state filtering per block, with each block's end state
        yt, zf = sosfilt_batch(co, xb.permute(1, 0, 2), tail=F_,
                               return_state=True)
        y0 = yt.permute(1, 0, 2)                        # (nb, F, ch)
        rc, rs = co[:, 0, :, 6], co[:, 0, :, 7]         # (nb, ch)
        d1, d2 = co[:, 0, :, 9], co[:, 0, :, 10]

        # 2. A_b^F by square-and-multiply, then the affine scan over blocks
        pc, ps = torch.ones_like(rc), torch.zeros_like(rs)
        bc, bs = rc, rs
        n = F_
        while n:
            if n & 1:
                pc, ps = pc * bc - ps * bs, ps * bc + pc * bs
            n >>= 1
            if n:
                bc, bs = bc * bc - bs * bs, 2 * bc * bs
        Pc, Ps, D1, D2 = _rotation_scan(
            torch.stack([pc, ps, zf[:, 0, 0], zf[:, 0, 1]]))
        zi1 = torch.broadcast_to(zi_s[0], (ch,))
        zi2 = torch.broadcast_to(zi_s[1], (ch,))
        Z1 = Pc * zi1 - Ps * zi2 + D1                   # (nb, ch)
        Z2 = Ps * zi1 + Pc * zi2 + D2
        z_in1 = torch.cat([zi1[None], Z1[:-1]])
        z_in2 = torch.cat([zi2[None], Z2[:-1]])

        # 3. per-frame correction: (s1m, s2m)[b, k] = A_b^k z_in[b]
        rc64, rs64 = rc.to(torch.float64), rs.to(torch.float64)
        rho = torch.sqrt(rc64 ** 2 + rs64 ** 2)
        theta = torch.atan2(rs64, rc64)
        k = torch.arange(F_, dtype=torch.float64,
                         device=rc.device)[None, :, None]
        mag = torch.exp(k * torch.log(torch.clamp(rho, min=1e-300))[:, None])
        ang = k * theta[:, None]
        ck = (mag * torch.cos(ang)).to(torch.float32)   # (nb, F, ch)
        sk = (mag * torch.sin(ang)).to(torch.float32)
        s1m = ck * z_in1[:, None] - sk * z_in2[:, None]
        s2m = sk * z_in1[:, None] + ck * z_in2[:, None]
        y = y0 + d1[:, None] * s1m + d2[:, None] * s2m
        return y, torch.stack([Z1[-1], Z2[-1]])

    def context_frames(self) -> int:
        return 0 if self._state.streaming else self._state.context

    @staticmethod
    def context_for(min_hz: float, rate: int = 44100,
                    tol: float = 1e-7) -> int:
        """Smallest 128-aligned context window whose truncation error is
        below ``tol`` for every pole frequency at or above ``min_hz``: the
        replayed state differs from the exact IIR state by at most
        ``|pole|**C = exp(-xi * 2*pi*f0/rate * C)``, with a conservative
        ``xi = 0.5``.

        >>> CritFilter.context_for(550.0)
        512
        """
        import math
        decay = 0.5 * 2.0 * math.pi * float(min_hz) / float(rate)
        n = math.log(1.0 / tol) / max(decay, 1e-12)
        return max(128, -(-int(math.ceil(n)) // 128) * 128)

    def crits_static(self) -> bool:
        """Whether every crit input is a ``Fixed`` or unconnected — the
        coefficients are then the same for every block."""
        from signals_tpu_torch.nodes.fixed import Fixed
        for pname in self.port_names():
            if pname == 'input':
                continue
            sig = self._ports[pname].sig
            if sig is not None and type(sig) is not Fixed:
                return False
        return True

    def swept_carry_m(self, engine_m: typing.Optional[int] = None) -> int:
        """Blocks per state-carry segment for SWEPT (non-``Fixed``) crits —
        the product semantics of time-varying filtering, identical in the
        numpy pull oracle and the compiled kernels.

        On the :data:`~signals_tpu_torch.compiler.filters.CARRY_GRID_FRAMES`
        block grid, blocks group into segments of ``m`` aligned to ABSOLUTE
        frame multiples of ``m * F``; at each segment start the state
        restarts from zero and warms up over the ``context`` window under
        the segment's first block's coefficients; inside a segment the
        state carries across blocks while coefficients switch per block.
        ``State.carry = 1`` restores per-block replay.

        Returns 1 when carry does not engage: streaming filters, static
        crits (every block replays its own context), or ``carry = 1``.
        """
        if self._state.streaming:
            return 1
        m = self._state.carry
        if m == 0:
            m = (_filters.resolve_seg_carry_blocks() if engine_m is None
                 else engine_m)
        if m <= 1 or self.crits_static():
            return 1
        return m

    @abc.abstractmethod
    def type_code(self) -> str:
        """One of the :mod:`signals_tpu_torch.compiler.filters` type codes."""
        raise NotImplementedError

    @abc.abstractmethod
    def _crits(self, ctx: KernelCtx) -> tuple:
        raise NotImplementedError

    @abc.abstractmethod
    def _crits_grid(self, ctx) -> tuple:
        raise NotImplementedError

    def kernel(self, ctx: KernelCtx):
        nyquist = ctx.rate_f32 * F32(0.5)
        grid = getattr(ctx, 'block_grid', None)
        if grid is not None:
            return self._mega_kernel(ctx, grid, nyquist)
        req = getattr(ctx, 'request', None)
        if req is not None:
            # numpy pull oracle: carry engages on whole-block-aligned
            # requests (see swept_carry_m's contract)
            m = self.swept_carry_m()
            loc = req.loc
            FC = _filters.CARRY_GRID_FRAMES
            if (m > 1 and loc.shape.frames % FC == 0
                    and loc.position % FC == 0):
                return self._pull_carry_kernel(ctx, m, nyquist)
        elif ctx.xp.is_torch:
            w = ctx.window
            if w.stride > 1:
                return self._sampled_kernel(ctx, nyquist)
            comp = ctx.compiler
            FC = _filters.CARRY_GRID_FRAMES
            m = self.swept_carry_m(comp.index.seg_carry_blocks)
            if (m > 1 and comp.block_frames == FC and w.offset % FC == 0
                    and w.frames % FC == 0):
                # the per-block step of a swept filter: its carry segment
                # up to this block, one segment-kernel call
                y = self._family_compute(ctx, (FC, w.frames // FC), nyquist,
                                         sum_groups=0)
                return y.reshape(w.frames, y.shape[-1])
        # per-block replay: zero-state filtering of the window and its
        # context (the CUDA timeline kernel when compiled for a GPU)
        coeffs = _filters.design_coupled(ctx.xp, self.type_code(),
                                         self._crits(ctx), nyquist)
        x = ctx.in_context('input', self.context_frames())
        y = ctx.sosfilt(coeffs, x)
        return y[-ctx.nframes:]

    def _pull_carry_kernel(self, ctx, m: int, nyquist):
        """Swept-carry semantics in the pull oracle: statelessly replay
        each requested block's containing segment — ``context`` warmup
        under the segment's first block's coefficients from zero state,
        then the blocks up to the requested one with per-block
        coefficients, the coupled-form state threaded.  Multi-block
        requests evaluate blockwise and concatenate."""
        from signals_tpu_torch.core import Request, Shape
        loc = ctx.request.loc
        F = _filters.CARRY_GRID_FRAMES
        n_blocks = loc.shape.frames // F
        beta0 = loc.position // F

        def one_block(beta):
            seg0 = (beta // m) * m
            zi = None
            out = None
            ch = self.channels
            for b in range(seg0, beta + 1):
                bloc = loc._replace(position=b * F,
                                    shape=Shape(F, loc.shape.channels))
                bctx = type(ctx)(self, Request(
                    requestor=ctx.request.requestor,
                    port=ctx.request.port, loc=bloc))
                coeffs = _filters.design_coupled(
                    ctx.xp, self.type_code(), self._crits(bctx), nyquist)
                if b == seg0:
                    xw = bctx.in_context('input', self.context_frames())
                    ch = max(ch, xw.shape[1], coeffs.shape[1])
                    zi = np.zeros((coeffs.shape[0], 2, ch), dtype=F32)
                    y, zi = bctx.sosfilt_stream(coeffs, xw, zi)
                    out = y[-F:]
                else:
                    xb = bctx.in_('input')
                    xb = np.broadcast_to(xb, (F, max(xb.shape[1], ch)))
                    out, zi = bctx.sosfilt_stream(coeffs, xb, zi)
            return out

        blocks = [one_block(beta0 + i) for i in range(n_blocks)]
        ch = max(b.shape[1] for b in blocks)
        return np.concatenate(
            [np.broadcast_to(b, (F, ch)) for b in blocks], axis=0)

    # --- compiled engine ----------------------------------------------------

    def _mega_kernel(self, ctx, grid, nyquist):
        """Whole-window lowering: every block of the window through one
        kernel call, output ``(nb*F, ch)`` — the JAX package's
        ``_mega_kernel`` and ``_mega_carry`` kernel branches in one (see
        :meth:`_family_compute`)."""
        F_, nb = grid
        y = self._family_compute(ctx, grid, nyquist, sum_groups=0)
        return y.reshape(nb * F_, y.shape[-1])

    def family_sum(self, ctx, grid):
        """The voice sum of this filter's output over the window, computed
        *in-kernel* (the mix epilogue: the full-width output is never
        written to device memory): ``(nb, F, 1)``, before ``enabled``
        gating."""
        nyquist = ctx.rate_f32 * F32(0.5)
        return self._family_compute(ctx, grid, nyquist,
                                    sum_groups=self.channels)

    @staticmethod
    def _segment_gate(C: int, chx: int) -> bool:
        """The JAX package's geometry gate for the timeline segment kernel
        on a window without carry (``signals_tpu/nodes/fx.py:892-893``):
        a 128-aligned context and a lane width of at least 32 that divides
        128 or is a multiple of it.  Windows that fail it take the batched
        per-block replay (:meth:`_batch_compute`), so both packages run the
        same kernel for the same patch."""
        return C % 128 == 0 and chx >= 32 and (128 % chx == 0
                                               or chx % 128 == 0)

    def _carry_blocks(self, ctx, nb: int) -> int:
        """Blocks per segment of a timeline-kernel call without swept carry:
        the largest divisor of ``nb`` within the compile-time
        ``SEG_CARRY_BLOCKS`` snapshot when the crits are static (the
        coefficients are the same for every block, so a longer segment only
        warms the state up less often), else 1."""
        if not self.crits_static():
            return 1
        m = min(ctx.compiler.index.seg_carry_blocks, nb)
        while nb % m:
            m -= 1
        return m

    def _block_coeffs(self, ctx, nb: int, nyquist, grids=None):
        """Coefficients of the window's ``nb`` blocks from per-block crit
        samples (``grids``, each ``(nb, ch_i)``; None: the window's own):
        ``(nb, nsec, chs, 11)``."""
        xp = ctx.xp
        if grids is None:
            grids = self._crits_grid(ctx)                  # each (nb, ch_i)
        chs = max(g.shape[1] for g in grids)
        crits = tuple(xp.broadcast_to(g, (nb, chs)).reshape(1, -1)
                      for g in grids)                      # (1, nb*chs)
        coeffs = _filters.design_coupled(xp, self.type_code(), crits,
                                         nyquist)          # (nsec, nb*chs, 11)
        nsec = coeffs.shape[0]
        return coeffs.reshape(nsec, nb, chs, 11).permute(1, 0, 2, 3)

    def _family_compute(self, ctx, grid, nyquist, sum_groups: int):
        """The filter output over a window of ``nb`` whole blocks,
        ``(nb, F, ch)`` (or ``(nb, F, 1)`` voice sums with ``sum_groups``).

        * Swept crits on the carry grid (``m`` > 1): the window widens back
          to the absolute carry-segment boundary at or before its start
          (the segment phase is a host integer) and runs ONE segment-kernel
          call — the segment up to the window if it is shorter than a
          segment, else whole segments; the leading and trailing blocks
          are dropped.  The input and the crits are read over a FIXED
          window, ``m - 1`` blocks (and the context) back from the window
          up to its end, whatever the phase (what the collect pass
          registered: :meth:`~signals_tpu_torch.compiler._Compiler.
          _collect_swept`), so a delay line, a stateful producer's history
          ring or a host input serves them; the rows past the window's end
          are zero (the filter is causal: they cannot change the rows
          kept).  This is what the JAX package's per-block prefix,
          ``_tv_carry_kernel`` and ``sosfilt_tv`` compute, at one launch.
        * Otherwise (static crits, ``carry = 1``, another block size): the
          segment kernels when :meth:`_segment_gate` passes, else the
          batched per-block replay."""
        F_, nb = grid
        comp = ctx.compiler
        m = (self.swept_carry_m(comp.index.seg_carry_blocks)
             if F_ == _filters.CARRY_GRID_FRAMES else 1)
        chx = self.channels        # lanes: the input and crits broadcast
        if m == 1:
            if not self._segment_gate(self.context_frames(), chx):
                y = self._batch_compute(ctx, grid, nyquist)
                return y.sum(dim=-1, keepdim=True) if sum_groups else y
            return self._segments_compute(ctx, grid, nyquist, chx, 1,
                                          sum_groups)
        lead = ((comp.position + ctx.window.offset) // F_) % m
        span = lead + nb
        per_seg = min(m, span)
        nbp = -(-span // per_seg) * per_seg
        back = (m - 1) * F_
        fixed = (ctx.at_window(ctx.window.offset - back, back + nb * F_),
                 m - 1 - lead)
        wctx = ctx.at_window(ctx.window.offset - lead * F_, nbp * F_)
        y = self._segments_compute(wctx, (F_, nbp), nyquist, chx, per_seg,
                                   sum_groups, fixed)
        return y[lead:lead + nb]

    def _segments_compute(self, ctx, grid, nyquist, chx, m, sum_groups,
                          fixed=None):
        """Per-block coefficients for the window's blocks, then ONE segment
        kernel call with ``m`` blocks per carry segment (the window starts
        on a segment boundary): the generator-fed kernel when the input is
        an eligible oscillator (and the compile-time ``SEG_SOURCE_GEN``
        snapshot is on), else the timeline kernel over the lowered input
        with its context.  ``fixed = (fctx, skip)``: read the crits and the
        input over ``fctx``'s window instead, dropping its first ``skip``
        blocks, the blocks past its end padded (the crits with their last
        block's, the input with zeros)."""
        from signals_tpu_torch.compiler.kernels import sosfilt_segments
        F_, nb = grid
        C = self.context_frames()
        grids = None
        if fixed is not None:
            fctx, skip = fixed
            grids = tuple(_pad_rows(g[skip:], nb, edge=True)
                          for g in self._crits_grid(fctx))
        co = self._block_coeffs(ctx, nb, nyquist, grids)
        co = torch.broadcast_to(co, (nb, co.shape[1], chx, 11))
        gen = (self._gen_input_spec(chx) if ctx.compiler.index.seg_source_gen
               else None)
        if gen is not None:
            return self._family_gen(ctx, gen, co, F_, nb, C, chx, m,
                                    sum_groups)
        if fixed is None:
            x = ctx.in_context('input', C)                 # (C + nb*F, ch)
        else:
            x = _pad_rows(fctx.in_context('input', C)[skip * F_:],
                          C + nb * F_)
        if m == 1:
            mc = self._carry_blocks(ctx, nb)
            y = sosfilt_segments(co[::mc], x, n_segments=nb // mc,
                                 seg_frames=mc * F_, context=C,
                                 sum_groups=sum_groups)
            return y.reshape(nb, F_, y.shape[-1])
        return sosfilt_segments(co, x, n_segments=nb, seg_frames=F_,
                                context=C, sum_groups=sum_groups,
                                blocks_per_seg=m)

    def _batch_compute(self, ctx, grid, nyquist):
        """Batched per-block replay (the JAX package's ``sosfilt_batch``
        branch, ``signals_tpu/nodes/fx.py:939-958``): each block's context
        window of ``C + F`` frames, read in place from the lowered timeline
        (overlapping views, no gathered copy), filtered from zero state
        with that block's coefficients, the last ``F`` rows kept —
        ``(nb, F, ch)``."""
        from signals_tpu_torch.compiler.kernels import sosfilt_batch
        F_, nb = grid
        C = self.context_frames()
        co = self._block_coeffs(ctx, nb, nyquist)
        x = ctx.in_context('input', C)                     # (C + nb*F, ch)
        xw = x.unfold(0, C + F_, F_)[:nb].permute(2, 0, 1)  # (C + F, nb, ch)
        yt = sosfilt_batch(co, xw, tail=F_)                # (F, nb, ch)
        return yt.permute(1, 0, 2)

    def _sampled_kernel(self, ctx, nyquist):
        """The filter sampled on a grid (one frame every ``stride``: the
        block-rate side of a node under a multi-block window).  Each sample
        is the last frame of its own ``context + 1``-frame window filtered
        from zero state — what the per-block step computes at that frame —
        so the windows, read in place from the timeline, run through one
        batched call with ``tail = 1``."""
        from signals_tpu_torch.compiler.kernels import sosfilt_batch
        w = ctx.window
        n, C = w.frames, self.context_frames()
        grids = self._crits(ctx)                 # sampled on w's grid
        chs = max(g.shape[1] for g in grids)
        crits = tuple(ctx.xp.broadcast_to(g, (n, chs)).reshape(1, -1)
                      for g in grids)
        coeffs = _filters.design_coupled(ctx.xp, self.type_code(), crits,
                                         nyquist)
        co = coeffs.reshape(coeffs.shape[0], n, chs, 11).permute(1, 0, 2, 3)
        span = (n - 1) * w.stride + 1
        x = ctx.at_window(w.offset, span).in_context('input', C)
        xw = x.unfold(0, C + 1, w.stride)[:n].permute(2, 0, 1)
        return sosfilt_batch(co, xw, tail=1)[0]            # (n, ch)

    def _gen_input_spec(self, chx):
        """``(osc_code, osc, hz_node, phase_node)`` when this filter's
        input is an oscillator the segment kernel can synthesize in-kernel:
        a Sine/Saw/Square/Triangle whose ``hertz``/``phase`` are ``Fixed``
        (or unconnected) with widths broadcastable to ``chx`` lanes.  All
        four waves are synthesized bit-exactly (the sine with the f64
        ``sin2pi`` chain)."""
        from signals_tpu_torch.compiler.kernels import (
            OSC_SAW, OSC_SINE, OSC_SQUARE, OSC_TRIANGLE)
        from signals_tpu_torch.nodes.fixed import Fixed
        from signals_tpu_torch.nodes.osc import (Sawtooth, Sine, Square,
                                                 Triangle)
        inp = self._ports['input'].sig
        code = {Sine: OSC_SINE, Sawtooth: OSC_SAW, Square: OSC_SQUARE,
                Triangle: OSC_TRIANGLE}.get(type(inp))
        if code is None:
            return None
        nodes = []
        for pname in ('hertz', 'phase'):
            sig = inp._ports[pname].sig
            if sig is not None:
                if type(sig) is not Fixed:
                    return None
                v = sig.get_state().value
                if v.shape not in ((1, 1), (1, chx)):
                    return None
            nodes.append(sig)
        return code, inp, nodes[0], nodes[1]

    def _family_gen(self, ctx, gen, co, F_, nb, C, chx, m, sum_groups):
        """Generator-fed lowering: per-lane oscillator parameters from the
        traced ``Fixed`` values (``enabled`` gates folded in), zero input
        memory traffic."""
        from signals_tpu_torch.compiler.kernels import sosfilt_segments_gen
        code, osc_node, hz_node, ph_node = gen
        comp = ctx.compiler
        dev = co.device
        zero = torch.zeros((), dtype=torch.float32, device=dev)

        def lane_row(node):
            if node is None:
                return torch.zeros((chx,), dtype=torch.float32, device=dev)
            v = comp.node_param(node, 'value').reshape(1, -1)
            v = torch.where(comp.node_param(node, 'enabled'), v, zero)
            return torch.broadcast_to(v, (1, chx)).reshape(chx)

        amp = torch.where(comp.node_param(osc_node, 'enabled'),
                          torch.ones((), device=dev), zero)
        lanef = torch.stack([lane_row(hz_node), lane_row(ph_node),
                             torch.broadcast_to(amp, (chx,))])
        toff = torch.full((chx,), comp.position + ctx.window.offset - C,
                          dtype=torch.int32, device=dev)
        return sosfilt_segments_gen(
            co, toff, lanef, n_segments=nb, seg_frames=F_, context=C,
            osc_code=code, rate=ctx.rate, sum_groups=sum_groups,
            blocks_per_seg=m)


class SingleCritFilter(CritFilter, abc.ABC):
    cutoff: Receiver.BoundPort = port('cutoff')

    def _crits(self, ctx: KernelCtx) -> tuple:
        return (ctx.in_block_rate('cutoff'),)

    def _crits_grid(self, ctx) -> tuple:
        return (ctx.in_block_rate_grid('cutoff'),)


class DoubleCritFilter(CritFilter, abc.ABC):
    """Band filters: two crit ports, an order-4 design as two sections."""
    low: Receiver.BoundPort = port('low')
    high: Receiver.BoundPort = port('high')

    def _crits(self, ctx: KernelCtx) -> tuple:
        return (ctx.in_block_rate('low'), ctx.in_block_rate('high'))

    def _crits_grid(self, ctx) -> tuple:
        return (ctx.in_block_rate_grid('low'),
                ctx.in_block_rate_grid('high'))


@register('signals.chain.fx.LowPass')
class LowPass(SingleCritFilter):

    def type_code(self) -> str:
        return _filters.LOWPASS


@register('signals.chain.fx.HighPass')
class HighPass(SingleCritFilter):

    def type_code(self) -> str:
        return _filters.HIGHPASS


@register('signals.chain.fx.BandPass')
class BandPass(DoubleCritFilter):

    def type_code(self) -> str:
        return _filters.BANDPASS


@register('signals.chain.fx.BandStop')
class BandStop(DoubleCritFilter):

    def type_code(self) -> str:
        return _filters.BANDSTOP


class ParametricFilter(CritFilter, abc.ABC):
    """RBJ audio-EQ-cookbook biquads (peaking EQ, shelves, notch,
    allpass) — the parametric-EQ family the reference lacks.

    The same :class:`CritFilter` contract as the Butterworth nodes: the
    center/corner frequency, Q and gain are *signals* sampled at block rate
    (an LFO on ``freq`` is a sweepable EQ), coefficients are designed in
    float64 on the device (:func:`~signals_tpu_torch.compiler.filters.
    _design_eq`) and rounded once, and every path (context windows,
    ``streaming``, swept carry, the mix plan) runs them unchanged.

    Port conventions: an unconnected ``q`` reads as 0 and means "default
    Q" (1/√2); an unconnected ``gain`` means 0 dB.  Resonance amplifies the
    f32 recurrence's rounding, so agreement with the float64 pull oracle
    scales with Q: 1e-5 up to Q ~4, 1e-4 at Q 8, 2.5e-4 at Q 16
    (``tests/test_torch_eq.py``).
    """

    freq: Receiver.BoundPort = port('freq')
    q: Receiver.BoundPort = port('q')


class GainParametricFilter(ParametricFilter, abc.ABC):
    """Parametric types with a boost/cut amount: crits (freq, gain, q)."""

    gain: Receiver.BoundPort = port('gain')

    def _crits(self, ctx: KernelCtx) -> tuple:
        return (ctx.in_block_rate('freq'), ctx.in_block_rate('gain'),
                ctx.in_block_rate('q'))

    def _crits_grid(self, ctx) -> tuple:
        return (ctx.in_block_rate_grid('freq'),
                ctx.in_block_rate_grid('gain'),
                ctx.in_block_rate_grid('q'))


class GainlessParametricFilter(ParametricFilter, abc.ABC):
    """Parametric types without a gain: crits (freq, q)."""

    def _crits(self, ctx: KernelCtx) -> tuple:
        return (ctx.in_block_rate('freq'), ctx.in_block_rate('q'))

    def _crits_grid(self, ctx) -> tuple:
        return (ctx.in_block_rate_grid('freq'),
                ctx.in_block_rate_grid('q'))


@register()
class Peak(GainParametricFilter):
    """Peaking (bell) EQ: boost/cut of ``gain`` dB around ``freq``,
    bandwidth set by ``q``; unity far from the center."""

    def type_code(self) -> str:
        return _filters.PEAK


@register()
class LowShelf(GainParametricFilter):
    """Low shelf: ``gain`` dB below the corner, unity above."""

    def type_code(self) -> str:
        return _filters.LOWSHELF


@register()
class HighShelf(GainParametricFilter):
    """High shelf: ``gain`` dB above the corner, unity below."""

    def type_code(self) -> str:
        return _filters.HIGHSHELF


@register()
class Notch(GainlessParametricFilter):
    """Notch: kills a narrow band around ``freq``, unity elsewhere."""

    def type_code(self) -> str:
        return _filters.NOTCH


@register()
class Allpass(GainlessParametricFilter):
    """Second-order allpass: unit magnitude everywhere, phase rotation
    around ``freq``."""

    def type_code(self) -> str:
        return _filters.ALLPASS


@register()
class Quantize(Effect):
    """Pitch quantizer: snap a control signal in Hz to the nearest tone of
    an equal-temperament scale (semitone pitch classes in ``scale``,
    relative to ``root`` Hz).  Stateless and elementwise.

    The output is Hz-valued through log/pow, so engines agree to ~2e-5
    *relative*, not to the absolute audio tolerance.  Of two equally near
    candidates the first (the lower, in ``scale`` order) wins in every
    engine.
    """

    input: Receiver.BoundPort = port('input')

    class State(Effect.State):
        #: semitone pitch classes of the scale (e.g. major =
        #: [[0,2,4,5,7,9,11]]); traced: re-scale without recompiling
        scale: np.ndarray = Param(
            lambda: np.arange(12, dtype=np.float32).reshape(1, -1),
            validate=lambda v: None if (isinstance(v, np.ndarray)
                                        and v.ndim == 2 and v.size > 0)
            else 'must be a non-empty 2D array',
            convert=lambda v: np.asarray(v, dtype=np.float32)
            if isinstance(v, (np.ndarray, list, tuple)) else v,
            traced=True)
        #: reference frequency of pitch class 0
        root: float = Param(261.6256, validate=ge(1.0), traced=True)

    def kernel(self, ctx: KernelCtx):
        xp = ctx.xp
        hz = xp.maximum(ctx.in_('input'), F32(1e-3))    # (F, C)
        root = xp.astype(ctx.param('root'), xp.float32).reshape(())
        scale = ctx.param('scale').reshape(-1)           # (K,)
        semis = F32(12.0) * (xp.log(hz / root)
                             * F32(1.0 / np.log(2.0)))   # (F, C)
        octave = xp.floor(semis * F32(1.0 / 12.0)) * F32(12.0)
        pc = semis - octave                              # [0, 12)
        # candidate tones: scale degrees in this octave and both neighbors
        cands = xp.concatenate([scale - F32(12.0), scale,
                                scale + F32(12.0)])      # (3K,)
        dist = xp.abs(pc[:, :, None] - cands)            # (F, C, 3K)
        tone = cands[xp.argmin(dist, axis=2)]            # (F, C)
        return root * F32(2.0) ** ((octave + tone) * F32(1.0 / 12.0))
