"""The cascade kernels (``signals_tpu.compiler.pallas_kernels``).

Five entry points, each with a plain PyTorch version of the same signature:

* :func:`sosfilt_segments_gen` — the coupled-form biquad cascade over carry
  segments with its input synthesized from an oscillator spec (replaces the
  TPU kernel ``_seg_kernel_gen``);
* :func:`sosfilt_segments` — the same cascade fed from a timeline in memory
  (replaces ``_seg_kernel`` / ``_seg_kernel_reuse``);
* :func:`sosfilt_batch` — the zero-state cascade over a batch of
  independent windows, writing only each window's tail (replaces
  ``_batch_kernel``);
* :func:`sosfilt_timeline` — the zero-state cascade over one whole
  timeline (replaces ``_section_kernel``, ``sosfilt_pallas``);
* :func:`sosfilt_stream` — the carried-state entry of the same kernel: one
  window from a start state ``zi`` to its end state ``zf`` (the exact IIR
  of a ``streaming=True`` filter; the JAX package runs it as an associative
  scan inside its XLA program).  :func:`sosfilt_batch` takes ``zi`` and
  returns ``zf`` too (``return_state=True``).

One more entry is no port of a Pallas kernel: :func:`fdn_advance`, the
``Reverb``'s feedback delay network over a window (``csrc/fdn.cu``; the JAX
package scans it, ``signals_tpu/nodes/reverb.py:171-189``), with its
adjoint :func:`fdn_advance_vjp`.

The segment kernels take ``sum_groups = g`` (the mix epilogue: return each
``g``-lane group's sum instead of the lanes) and ``blocks_per_seg = m``
(carry segments: ``m`` coefficient blocks share one state that warms up
over ``context`` rows under the segment's first block's coefficients).

A wrapper runs the plain version only because its tensors lie on the CPU.
On a CUDA tensor it launches the hand-written kernel (``csrc/segments.cu``,
``csrc/rows.cu``, built at first use by :mod:`._build`) or raises; each
launch adds one to :data:`LAUNCHES`.  Under ``torch.func.vmap`` (the vmap
layout of :class:`~signals_tpu_torch.parallel.PolyPatch`) every entry folds
the voice axis into its lanes and makes one call for all voices (the
``vmap`` rule of each entry's ``autograd.Function``, :func:`_fold`).
The segment kernels take 1 or 2 order-2 sections per lane (every
Butterworth design), the zero-state and carried-state kernels 1 to
:data:`MAX_SECTIONS`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from signals_tpu_torch.compiler import filters as _filters
from signals_tpu_torch.compiler.filters import (sosfilt_scan,
                                                 sosfilt_stream_scan)
from signals_tpu_torch.core.mathx import _SIN2PI_COEFFS, sin2pi
from signals_tpu_torch.core.xp import (COPIES, TorchXP,  # noqa: F401
                                       reset_copy_counts)

OSC_SINE, OSC_SQUARE, OSC_SAW, OSC_TRIANGLE = 0, 1, 2, 3

#: launches of each hand-written kernel since :func:`reset_launch_counts`
#: (``*_vjp``: the backward kernels of ``csrc/adjoint.cu``; ``ima``: the
#: IMA ADPCM encoder of ``csrc/codecs.cu``, launched by
#: :func:`signals_tpu_torch.runtime.codecs.ima_encode`; ``fdn`` /
#: ``fdn_vjp``: the reverb's network and its adjoint's serial chain,
#: ``fdn_vjp_gain``: the adjoint's gain sums, ``csrc/fdn.cu``)
LAUNCHES = {'segments_gen': 0, 'segments': 0, 'batch': 0, 'timeline': 0,
            'stream': 0, 'segments_gen_vjp': 0, 'segments_vjp': 0,
            'batch_vjp': 0, 'timeline_vjp': 0, 'stream_vjp': 0, 'ima': 0,
            'fdn': 0, 'fdn_vjp': 0, 'fdn_vjp_gain': 0}
# beside it, COPIES and reset_copy_counts (from core.xp, whose to_device
# makes them): the host-to-device copies of the render and fit paths

#: calls of :func:`sosfilt_batch`'s kernel (or, on the CPU, its plain
#: version) by the layout they wrote, since :func:`reset_launch_counts`:
#: ``time_major`` each lane's rows consecutive, ``lane_major`` each row's
#: lanes (kept apart from :data:`LAUNCHES`, which counts launches by kernel)
ROWS_OUT = {'time_major': 0, 'lane_major': 0}

#: sections per lane the segment kernels take (the Butterworth designs: 1
#: for low/high-pass, 2 for band-pass/band-stop)
SEGMENT_SECTIONS = (1, 2)
#: most sections per lane the zero-state kernels keep in registers
MAX_SECTIONS = 4

_SIN_C = (ctypes.c_double * len(_SIN2PI_COEFFS))(*_SIN2PI_COEFFS)


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, ROWS_OUT):
        for k in counts:
            counts[k] = 0


def _check_common(coeffs, n_segments, seg_frames, context, sum_groups,
                  blocks_per_seg):
    if coeffs.dtype != torch.float32 or coeffs.dim() != 4 \
            or coeffs.shape[-1] != 11:
        raise ValueError(f'coeffs must be float32 (n_blocks, nsec, lanes, '
                         f'11), got {tuple(coeffs.shape)} {coeffs.dtype}')
    n, nsec, lanes, _ = coeffs.shape
    if n != n_segments:
        raise ValueError(f'coeffs hold {n} blocks, expected {n_segments}')
    if nsec not in SEGMENT_SECTIONS:
        raise ValueError(f'{nsec} sections: the segment kernels take '
                         f'{SEGMENT_SECTIONS}')
    if seg_frames < 1 or context < 0:
        raise ValueError(f'bad geometry F={seg_frames} C={context}')
    if n_segments % blocks_per_seg:
        raise ValueError(f'n_segments {n_segments} must be a multiple of '
                         f'blocks_per_seg {blocks_per_seg}')
    if sum_groups and lanes % sum_groups:
        raise ValueError(f'sum_groups {sum_groups} must divide the {lanes} '
                         f'lanes')
    return lanes


def _device_kind(*tensors) -> str:
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1:
        raise ValueError(f'tensors on mixed devices {kinds}')
    kind = kinds.pop()
    if kind not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {kind!r}')
    return kind


def _outputs(lib, coeffs, seg_frames, context, blocks_per_seg, lanes,
             sum_groups):
    """The output tensor and, for a lane group wider than the kernel sums
    in one pass (its geometry decides), the partial-sum buffer (else a null
    pointer)."""
    n = coeffs.shape[0]
    width = lanes // sum_groups if sum_groups else lanes
    out = torch.empty((n, seg_frames, width), dtype=torch.float32,
                      device=coeffs.device)
    pw = lib.signals_partial_width(n, lanes, seg_frames, context,
                                   blocks_per_seg, sum_groups)
    partial = (torch.empty((n, seg_frames, pw), dtype=torch.float32,
                           device=coeffs.device) if pw else None)
    return out, partial, (partial.data_ptr() if pw else None)


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _needs_grad(*tensors) -> bool:
    """Whether a call must record its backward: grad mode is on and an
    input requires grad.  Otherwise the entry runs as a plain forward and
    saves nothing (the serving paths)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _function_call(*tensors) -> bool:
    """Whether an entry must run as its ``autograd.Function``: to record its
    backward (:func:`_needs_grad`), or because an input is batched by
    ``torch.func.vmap`` — the Function's ``vmap`` rule then folds the voice
    axis into the lanes (:func:`_fold`)."""
    return (any(t is not None and torch._C._functorch.is_batchedtensor(t)
                for t in tensors)
            or _needs_grad(*tensors))


def _fold(t, bdim, n: int, axis: int):
    """A ``vmap`` rule's argument with its batch axis folded into the lane
    axis: ``t`` is the physical tensor (batch axis ``bdim``; None: unbatched,
    expanded to the ``n`` voices as a stride-0 view), ``axis`` the lane axis
    of one call's argument.  Lanes are voice-major (lane ``v * L + l``), so
    a lane group of ``sum_groups`` dividing ``L`` stays inside one voice.  A
    view where the strides allow it (a one-lane input, a broadcast lane),
    else a copy."""
    t = (t.expand((n,) + t.shape) if bdim is None else t.movedim(bdim, 0))
    axis %= t.dim() - 1
    return t.movedim(0, axis).flatten(axis, axis + 1)


def _unfold(t, n: int, axis: int):
    """A folded result's lane axis split back into ``(voices, lanes)``, the
    voices first (the rule's ``out_dims`` 0)."""
    axis %= t.dim()
    return t.unflatten(axis, (n, -1)).movedim(axis, 0)


# --- the generator-fed cascade ------------------------------------------------


def gen_source_rows(toff, lanef, *, n_segments: int, seg_frames: int,
                    context: int, osc_code: int, rate: int):
    """The oscillator rows the generator kernel synthesizes:
    ``(n_segments, context + seg_frames, lanes)`` from per-lane frame
    offsets ``toff`` and ``lanef`` = (hertz, phase, amplitude) rows —
    ``nodes/osc.py``'s op sequence; rows with a negative frame index are
    zero."""
    xp = TorchXP(toff.device)
    f32 = np.float32
    seg = (torch.arange(n_segments, dtype=torch.int32, device=toff.device)
           * seg_frames)[:, None, None]
    row = torch.arange(context + seg_frames, dtype=torch.int32,
                       device=toff.device)[None, :, None]
    t_i = toff[None, None, :] + seg + row
    tf = t_i.to(torch.float32)
    hz, ph, amp = lanef[0], lanef[1], lanef[2]

    def frac(v):
        return v - torch.floor(v)

    turns = frac(tf * f32(1.0 / rate) * hz)
    tt = frac(turns + ph)
    if osc_code == OSC_SINE:
        x = sin2pi(xp, tt)
    elif osc_code == OSC_SQUARE:
        x = torch.sign(f32(0.5) - frac(tt))
    elif osc_code == OSC_SAW:
        x = f32(2.0) * frac(tt - f32(0.5)) - f32(1.0)
    elif osc_code == OSC_TRIANGLE:
        t3 = tt - f32(0.25)
        x = ((f32(4.0) * (f32(0.5) * frac(t3 * f32(2.0))) - f32(1.0))
             * torch.sign(frac(t3) - f32(0.5)))
    else:
        raise ValueError(f'unknown osc_code {osc_code}')
    return torch.where(t_i >= 0, amp * x, torch.zeros((), device=x.device))


def _cascade_windows_plain(coeffs, xw, *, seg_frames, context, sum_groups,
                           blocks_per_seg):
    """Shared body of the plain versions: ``xw`` (n_units, C + m*F, lanes)
    input windows of the carry segments; segments ride the channel axis of
    :func:`~signals_tpu_torch.compiler.filters.sosfilt_stream_scan`."""
    m, F, C = blocks_per_seg, seg_frames, context
    n_blocks, nsec, lanes, _ = coeffs.shape
    n_units = n_blocks // m
    # (rows, n_units*lanes) timeline; coefficient block j of every unit as
    # (nsec, n_units*lanes, 11)
    x = xw.permute(1, 0, 2).reshape(C + m * F, n_units * lanes)
    co = coeffs.reshape(n_units, m, nsec, lanes, 11)

    def block_coeffs(j):
        return co[:, j].permute(1, 0, 2, 3).reshape(nsec, n_units * lanes, 11)

    z = torch.zeros((nsec, 2, n_units * lanes), dtype=torch.float32,
                    device=coeffs.device)
    _, z = sosfilt_stream_scan(block_coeffs(0), x[:C], z)
    ys = []
    for j in range(m):
        y, z = sosfilt_stream_scan(block_coeffs(j),
                                   x[C + j * F:C + (j + 1) * F], z)
        ys.append(y.reshape(F, n_units, lanes))
    y = torch.stack(ys, dim=1)                       # (F, m, n_units, lanes)
    y = y.permute(2, 1, 0, 3).reshape(n_blocks, F, lanes)
    if sum_groups:
        y = y.reshape(n_blocks, F, lanes // sum_groups, sum_groups).sum(-1)
    return y


def sosfilt_segments_gen_plain(coeffs, toff, lanef, *, n_segments: int,
                               seg_frames: int, context: int, osc_code: int,
                               rate: int, sum_groups: int = 0,
                               blocks_per_seg: int = 1):
    """Plain PyTorch version of :func:`sosfilt_segments_gen`: the source
    rows synthesized in one vectorized pass, then the cascade as a Python
    loop over rows, vectorized over segments x lanes."""
    m = blocks_per_seg
    xw = gen_source_rows(toff, lanef, n_segments=n_segments // m,
                         seg_frames=m * seg_frames, context=context,
                         osc_code=osc_code, rate=rate)
    return _cascade_windows_plain(coeffs, xw, seg_frames=seg_frames,
                                  context=context, sum_groups=sum_groups,
                                  blocks_per_seg=m)


def sosfilt_segments_gen(coeffs, toff, lanef, *, n_segments: int,
                         seg_frames: int, context: int, osc_code: int,
                         rate: int, sum_groups: int = 0,
                         blocks_per_seg: int = 1):
    """The cascade with its input synthesized in-kernel from an oscillator
    spec — zero input memory traffic.

    ``coeffs``: ``(n_segments, nsec, lanes, 11)`` float32 (one coefficient
    block per ``seg_frames`` frames); ``toff``: ``(lanes,)`` int32 absolute
    frame of each lane's first context row; ``lanef``: ``(3, lanes)``
    float32 (hertz, phase, amplitude); ``osc_code``: one of ``OSC_*``;
    ``1/rate`` reaches the kernel as a runtime value.  Carry segment ``u``
    synthesizes frames ``toff + u*m*F + [0, C + m*F)``.  Returns
    ``(n_segments, seg_frames, lanes)``, or ``(..., lanes // sum_groups)``
    group sums.
    """
    m = max(1, int(blocks_per_seg))
    lanes = _check_common(coeffs, n_segments, seg_frames, context,
                          sum_groups, m)
    if toff.dtype != torch.int32 or tuple(toff.shape) != (lanes,):
        raise ValueError(f'toff must be int32 ({lanes},)')
    if lanef.dtype != torch.float32 or tuple(lanef.shape) != (3, lanes):
        raise ValueError(f'lanef must be float32 (3, {lanes})')
    if osc_code not in (OSC_SINE, OSC_SQUARE, OSC_SAW, OSC_TRIANGLE):
        raise ValueError(f'unknown osc_code {osc_code}')
    kw = dict(n_segments=n_segments, seg_frames=seg_frames,
              context=context, osc_code=osc_code, rate=rate,
              sum_groups=sum_groups, blocks_per_seg=m)
    if _function_call(coeffs, toff, lanef):
        return _SegmentsGenFn.apply(coeffs, toff, lanef, kw)
    return _segments_gen_run(coeffs, toff, lanef, kw)


def _segments_gen_run(coeffs, toff, lanef, kw):
    """The forward of :func:`sosfilt_segments_gen` on checked inputs: the
    plain version on the CPU, the kernel on a GPU."""
    if _device_kind(coeffs, toff, lanef) == 'cpu':
        return sosfilt_segments_gen_plain(coeffs, toff, lanef, **kw)
    from signals_tpu_torch.compiler import _build
    lib = _build.library()
    F, C, m, g = (kw['seg_frames'], kw['context'], kw['blocks_per_seg'],
                  kw['sum_groups'])
    lanes = coeffs.shape[2]
    coeffs, toff, lanef = (t.contiguous() for t in (coeffs, toff, lanef))
    out, _partial, partial_ptr = _outputs(lib, coeffs, F, C, m, lanes, g)
    code = lib.sosfilt_segments_gen_launch(
        coeffs.data_ptr(), toff.data_ptr(), lanef.data_ptr(),
        float(np.float32(1.0 / kw['rate'])), kw['osc_code'], _SIN_C,
        out.data_ptr(), partial_ptr, kw['n_segments'], coeffs.shape[1],
        lanes, F, C, m, g, _stream(coeffs.device))
    _build.check(code, 'sosfilt_segments_gen')
    LAUNCHES['segments_gen'] += 1
    return out


# --- the timeline-fed cascade -------------------------------------------------


def _timeline(coeffs, x, n_segments, seg_frames, context):
    """``x`` zero-padded to the ``context + n_segments*seg_frames`` rows the
    segments read and broadcast to the coefficient lanes — as a view: a
    one-channel timeline under many lanes keeps its one column in memory
    (lane stride 0)."""
    lanes = max(coeffs.shape[2], x.shape[1])
    coeffs = torch.broadcast_to(coeffs, coeffs.shape[:2] + (lanes, 11))
    need = context + n_segments * seg_frames
    if x.shape[0] < need:
        x = torch.cat([x, x.new_zeros((need - x.shape[0], x.shape[1]))])
    return coeffs, torch.broadcast_to(x[:need], (need, lanes))


def sosfilt_segments_plain(coeffs, x, *, n_segments: int, seg_frames: int,
                           context: int, sum_groups: int = 0,
                           blocks_per_seg: int = 1):
    """Plain PyTorch version of :func:`sosfilt_segments`."""
    m = blocks_per_seg
    coeffs, x = _timeline(coeffs, x, n_segments, seg_frames, context)
    n_units, L = n_segments // m, context + m * seg_frames
    xw = x.unfold(0, L, m * seg_frames)[:n_units].permute(0, 2, 1)
    return _cascade_windows_plain(coeffs, xw, seg_frames=seg_frames,
                                  context=context, sum_groups=sum_groups,
                                  blocks_per_seg=m)


def sosfilt_segments(coeffs, x, *, n_segments: int, seg_frames: int,
                     context: int, sum_groups: int = 0,
                     blocks_per_seg: int = 1):
    """Filter the carry segments of a ``(context + n_segments*seg_frames,
    ch)`` timeline.  Coefficient block ``b`` covers rows ``[C + b*F, C +
    (b+1)*F)``; carry segment ``u`` (``m`` blocks) reads rows ``[u*m*F, u*m*F
    + C + m*F)``, warming up from zero state over its first ``C`` rows.
    ``x`` and ``coeffs`` ``(n_segments, nsec, ch, 11)`` broadcast to the
    wider channel count; the kernel reads ``x`` through its strides, so a
    one-channel timeline under ``ch`` coefficient lanes (a mono noise
    source feeding ``ch`` filters) is read in place, never copied out to
    the lanes.  Returns ``(n_segments, seg_frames, ch)`` block-major, or
    ``(..., ch // sum_groups)`` group sums."""
    m = max(1, int(blocks_per_seg))
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f'x must be float32 (T, ch), got '
                         f'{tuple(x.shape)} {x.dtype}')
    if coeffs.dim() != 4:
        raise ValueError(f'coeffs must be (n_blocks, nsec, ch, 11), got '
                         f'{tuple(coeffs.shape)}')
    coeffs, x = _timeline(coeffs, x, n_segments, seg_frames, context)
    lanes = _check_common(coeffs, n_segments, seg_frames, context,
                          sum_groups, m)
    kw = dict(n_segments=n_segments, seg_frames=seg_frames,
              context=context, sum_groups=sum_groups, blocks_per_seg=m)
    if _function_call(coeffs, x):
        return _SegmentsFn.apply(coeffs, x, kw)
    return _segments_run(coeffs, x, kw)


def _segments_run(coeffs, x, kw):
    """The forward of :func:`sosfilt_segments` on the checked, padded and
    broadcast inputs."""
    if _device_kind(coeffs, x) == 'cpu':
        return sosfilt_segments_plain(coeffs, x, **kw)
    from signals_tpu_torch.compiler import _build
    lib = _build.library()
    F, C, m, g = (kw['seg_frames'], kw['context'], kw['blocks_per_seg'],
                  kw['sum_groups'])
    lanes = coeffs.shape[2]
    coeffs = coeffs.contiguous()
    out, _partial, partial_ptr = _outputs(lib, coeffs, F, C, m, lanes, g)
    code = lib.sosfilt_segments_launch(
        coeffs.data_ptr(), x.data_ptr(), *x.stride(), out.data_ptr(),
        partial_ptr, kw['n_segments'], coeffs.shape[1], lanes, F, C, m, g,
        _stream(coeffs.device))
    _build.check(code, 'sosfilt_segments')
    LAUNCHES['segments'] += 1
    return out


# --- the zero-state and carried-state cascades --------------------------------


def _check_rows_coeffs(coeffs, dims: int, layout: str):
    if coeffs.dtype != torch.float32 or coeffs.dim() != dims \
            or coeffs.shape[-1] != 11:
        raise ValueError(f'coeffs must be float32 {layout}, got '
                         f'{tuple(coeffs.shape)} {coeffs.dtype}')
    nsec = coeffs.shape[-3]
    if not 1 <= nsec <= MAX_SECTIONS:
        raise ValueError(f'{nsec} sections: the zero-state kernels take 1 to '
                         f'{MAX_SECTIONS}')
    return nsec


def _columns_contiguous(coeffs):
    """``coeffs`` as the kernels read it: any strides (a broadcast window or
    channel is stride 0) but the 11 columns contiguous."""
    return coeffs if coeffs.stride(-1) == 1 else coeffs.contiguous()


def _check_state(zi, shape, what: str):
    """A start state as the kernels read it: float32 of ``shape``
    (a one-channel state widens to the channels), contiguous."""
    if (zi.dtype != torch.float32 or zi.dim() != len(shape)
            or tuple(zi.shape[:-1]) != tuple(shape[:-1])
            or zi.shape[-1] not in (1, shape[-1])):
        raise ValueError(f'{what} must be float32 {tuple(shape)}, got '
                         f'{tuple(zi.shape)} {zi.dtype}')
    return torch.broadcast_to(zi, shape).contiguous()


def sosfilt_timeline_plain(coeffs, x):
    """Plain PyTorch version of :func:`sosfilt_timeline`."""
    return sosfilt_scan(coeffs, x)


def _timeline_args(coeffs, x):
    """Checks and broadcasts shared by :func:`sosfilt_timeline` and
    :func:`sosfilt_stream`: ``(nsec, ch, coeffs, x)``."""
    nsec = _check_rows_coeffs(coeffs, 3, '(nsec, ch, 11)')
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f'x must be float32 (N, ch), got '
                         f'{tuple(x.shape)} {x.dtype}')
    ch = max(coeffs.shape[1], x.shape[1])
    return (nsec, ch, torch.broadcast_to(coeffs, (nsec, ch, 11)),
            torch.broadcast_to(x, (x.shape[0], ch)))


def _timeline_launch(coeffs, x, out, zi, zf, nsec, ch, what: str) -> None:
    from signals_tpu_torch.compiler import _build
    lib = _build.library()
    coeffs = _columns_contiguous(coeffs)
    code = lib.sosfilt_timeline_launch(
        coeffs.data_ptr(), *coeffs.stride()[:2], x.data_ptr(), *x.stride(),
        out.data_ptr(), *out.stride(), None if zi is None else zi.data_ptr(),
        None if zf is None else zf.data_ptr(), nsec, ch, x.shape[0],
        _stream(x.device))
    _build.check(code, what)


def sosfilt_timeline(coeffs, x):
    """Zero-state cascade over a whole ``(N, ch)`` float32 timeline with
    coefficients ``(nsec, ch, 11)`` from ``design_coupled``; the channel
    axes broadcast to the wider count.  Returns ``(N, ch)``.  Computes what
    ``sosfilt_pallas`` computes (the TPU runs one section per call, the
    kernel all sections per row; the result is the same up to rounding).
    The kernel reads ``x`` and ``coeffs`` through their strides: a strided
    or broadcast view is not copied."""
    nsec, ch, coeffs, x = _timeline_args(coeffs, x)
    if _function_call(coeffs, x):
        return _TimelineFn.apply(coeffs, x)
    return _timeline_run(coeffs, x)


def _timeline_run(coeffs, x):
    nsec, ch = coeffs.shape[0], coeffs.shape[1]
    if _device_kind(coeffs, x) == 'cpu':
        return sosfilt_timeline_plain(coeffs, x)
    out = torch.empty((x.shape[0], ch), dtype=torch.float32, device=x.device)
    if x.shape[0] * ch == 0:
        return out
    _timeline_launch(coeffs, x, out, None, None, nsec, ch, 'sosfilt_timeline')
    LAUNCHES['timeline'] += 1
    return out


def sosfilt_stream_plain(coeffs, x, zi):
    """Plain PyTorch version of :func:`sosfilt_stream`: the loop over
    frames (:func:`~signals_tpu_torch.compiler.filters.sosfilt_stream_scan`)."""
    return sosfilt_stream_scan(coeffs, x, zi)


def sosfilt_stream(coeffs, x, zi):
    """The carried-state cascade over one window: continue from the
    coupled-form state ``zi`` ``(nsec, 2, ch)`` over the ``(N, ch)`` float32
    rows ``x`` with coefficients ``(nsec, ch, 11)``; returns ``(y (N, ch),
    zf (nsec, 2, ch))``, ``zf`` the state after the last row.  The channel
    axes broadcast to the widest count.  Two calls over the halves of a
    window give one call's result up to rounding (the scan cuts the rows
    into other slices).  On a GPU this is the timeline kernel started from
    ``zi``; it never runs the frame loop there."""
    nsec, ch, coeffs, x = _timeline_args(coeffs, x)
    ch = max(ch, zi.shape[-1])
    coeffs = torch.broadcast_to(coeffs, (nsec, ch, 11))
    x = torch.broadcast_to(x, (x.shape[0], ch))
    zi = _check_state(zi, (nsec, 2, ch), 'zi')
    if _function_call(coeffs, x, zi):
        return _StreamFn.apply(coeffs, x, zi)
    return _stream_run(coeffs, x, zi)


def _stream_run(coeffs, x, zi):
    nsec, ch = coeffs.shape[0], coeffs.shape[1]
    if _device_kind(coeffs, x, zi) == 'cpu':
        return sosfilt_stream_plain(coeffs, x, zi)
    out = torch.empty((x.shape[0], ch), dtype=torch.float32, device=x.device)
    if x.shape[0] * ch == 0:
        return out, zi
    zf = torch.empty_like(zi)
    _timeline_launch(coeffs, x, out, zi, zf, nsec, ch, 'sosfilt_stream')
    LAUNCHES['stream'] += 1
    return out, zf


def sosfilt_batch_plain(coeffs, x_t, *, tail=None, zi=None,
                        return_state=False):
    """Plain PyTorch version of :func:`sosfilt_batch`: the windows ride the
    channel axis of the frame loop."""
    L, B = x_t.shape[0], x_t.shape[1]
    nsec, ch = coeffs.shape[1], max(coeffs.shape[2], x_t.shape[2])
    tail = L if tail is None else tail
    co = torch.broadcast_to(coeffs, (B, nsec, ch, 11)).permute(1, 0, 2, 3)
    x = torch.broadcast_to(x_t, (L, B, ch)).reshape(L, B * ch)
    if zi is None:
        z = torch.zeros((nsec, 2, B * ch), dtype=torch.float32,
                        device=x.device)
    else:
        z = torch.broadcast_to(zi, (B, nsec, 2, ch)).permute(
            1, 2, 0, 3).reshape(nsec, 2, B * ch)
    y, zf = sosfilt_stream_scan(co.reshape(nsec, B * ch, 11), x, z)
    y = y[L - tail:].reshape(tail, B, ch)
    if not return_state:
        return y
    return y, zf.reshape(nsec, 2, B, ch).permute(2, 0, 1, 3).contiguous()


def sosfilt_batch(coeffs, x_t, *, tail=None, zi=None, return_state=False,
                  time_major=False):
    """Cascade over ``B`` independent windows, from zero state or from
    ``zi``.

    ``x_t``: ``(L, B, ch)`` float32 — L frames of B windows (e.g. the
    per-block context slices of a multi-block window) x ch channels;
    ``coeffs``: ``(B, nsec, ch, 11)`` per-window ``design_coupled`` output.
    The channel axes broadcast to the wider count.  Returns the last
    ``tail`` rows ``(tail, B, ch)`` (all ``L`` rows by default): the first
    ``L - tail`` rows only warm the state up and are never written.

    ``zi`` ``(B, nsec, 2, ch)`` starts every window from a coupled-form
    state instead of zero; ``return_state=True`` returns ``(y, zf)`` with
    ``zf`` ``(B, nsec, 2, ch)`` the state after each window's last row (how
    a streaming filter's whole-window form gets the zero-state end state of
    every block in one launch).

    ``time_major=True`` returns ``y`` with each lane's rows consecutive in
    memory (strides ``(1, tail, B * tail)``) instead of each row's lanes
    (``(B * ch, ch, 1)``): the same values, so that a caller that wants a
    window's blocks one after another (:class:`_BatchFn`'s ``vmap`` rule,
    one lane per voice) views them without a transposing copy.

    The kernel reads ``x_t`` and ``coeffs`` through their strides, so the
    windows may be a view of one timeline — overlapping, e.g.
    ``x.unfold(0, L, step).permute(2, 0, 1)`` — or a broadcast: nothing is
    gathered or copied."""
    nsec = _check_rows_coeffs(coeffs, 4, '(B, nsec, ch, 11)')
    if x_t.dim() != 3 or x_t.dtype != torch.float32:
        raise ValueError(f'x_t must be float32 (L, B, ch), got '
                         f'{tuple(x_t.shape)} {x_t.dtype}')
    L, B = x_t.shape[0], x_t.shape[1]
    if coeffs.shape[0] != B:
        raise ValueError(f'coeffs hold {coeffs.shape[0]} windows, x_t {B}')
    tail = L if tail is None else int(tail)
    if not 1 <= tail <= L:
        raise ValueError(f'tail {tail} must lie in [1, {L}]')
    ch = max(coeffs.shape[2], x_t.shape[2])
    coeffs = torch.broadcast_to(coeffs, (B, nsec, ch, 11))
    x_t = torch.broadcast_to(x_t, (L, B, ch))
    tensors = [coeffs, x_t]
    if zi is not None:
        zi = _check_state(zi, (B, nsec, 2, ch), 'zi')
        tensors.append(zi)
    if _function_call(*tensors):
        y, zf = _BatchFn.apply(coeffs, x_t, zi, tail, time_major)
        return (y, zf) if return_state else y
    return _batch_run(coeffs, x_t, zi, tail, return_state, time_major)


def _batch_run(coeffs, x_t, zi, tail, return_state, time_major):
    L, B = x_t.shape[0], x_t.shape[1]
    nsec, ch = coeffs.shape[1], coeffs.shape[2]
    tensors = [coeffs, x_t] + ([] if zi is None else [zi])
    out = (torch.empty_strided((tail, B, ch), (1, tail, B * tail),
                               dtype=torch.float32, device=x_t.device)
           if time_major else
           torch.empty((tail, B, ch), dtype=torch.float32, device=x_t.device))
    layout = 'time_major' if time_major else 'lane_major'
    if _device_kind(*tensors) == 'cpu':
        ROWS_OUT[layout] += 1
        y = sosfilt_batch_plain(coeffs, x_t, tail=tail, zi=zi,
                                return_state=return_state)
        if not return_state:
            return out.copy_(y)
        return out.copy_(y[0]), y[1]
    zf = (torch.empty((B, nsec, 2, ch), dtype=torch.float32,
                      device=x_t.device) if return_state else None)
    if B * ch == 0:
        return (out, zf) if return_state else out
    from signals_tpu_torch.compiler import _build
    lib = _build.library()
    coeffs = _columns_contiguous(coeffs)
    code = lib.sosfilt_batch_launch(
        coeffs.data_ptr(), *coeffs.stride()[:3], x_t.data_ptr(),
        *x_t.stride(), out.data_ptr(), *out.stride(),
        None if zi is None else zi.data_ptr(),
        None if zf is None else zf.data_ptr(), nsec, B, ch, L, tail,
        _stream(x_t.device))
    _build.check(code, 'sosfilt_batch')
    LAUNCHES['batch'] += 1
    ROWS_OUT[layout] += 1
    return (out, zf) if return_state else out


# --- backward: the adjoint kernels and their plain versions -------------------
#
# Every entry above is differentiable: called with an input that requires
# grad, it runs as a ``torch.autograd.Function`` whose forward is the entry
# itself and whose backward is the analytic adjoint of the cascade
# (:func:`signals_tpu_torch.compiler.filters.sosfilt_stream_vjp_plain`):
# on a GPU the hand-written kernels of ``csrc/adjoint.cu`` (``B1``
# ``seg_cascade_vjp<GEN = true>``, ``B2`` ``seg_cascade_vjp<GEN = false>``,
# ``B3`` ``rows_cascade_vjp<NSEC>``), on the CPU their plain versions
# (``*_vjp_plain``).  The JAX package wraps each entry in ``jax.custom_vjp``
# with the VJP of its scan reference as the backward
# (``signals_tpu/compiler/pallas_kernels.py:1574-1869``).  Gradients reach
# columns 6-10 of the coefficients (``rc rs d0 d1 d2``, what the cascade
# reads); columns 0-5 get zero.  A backward kernel keeps nothing across
# calls: each recomputes the forward's states as a time-sliced adjoint scan
# (the slices' start states in registers, per-chunk checkpoints in shared
# memory).  Only B3 over a window too long for those checkpoints takes a
# buffer for the call (``sosfilt_rows_vjp_buffer``: (NSEC + 1) complex
# numbers per 16-row chunk and thread, 1/16 of a row's state).


def _lane_cotangent(gy, sum_groups: int):
    """The cotangent of each lane's output: with ``sum_groups = g`` lane
    ``l`` reads its group's, ``l // g``."""
    return gy.repeat_interleave(sum_groups, dim=-1) if sum_groups else gy


def _cascade_windows_vjp_plain(coeffs, xw, gy, *, seg_frames, context,
                               sum_groups, blocks_per_seg):
    """The adjoint of :func:`_cascade_windows_plain`: ``(gxw (n_units, C +
    m*F, lanes), gcoeffs (n_blocks, nsec, lanes, 11))`` from the output's
    cotangent ``gy``.  A forward pass records the state at each block's
    start; then the blocks run backwards through the frame-loop adjoint
    with the state's cotangent carried, the context rows last (under block
    0's coefficients, so they add to block 0's gradient)."""
    m, F, C = blocks_per_seg, seg_frames, context
    n_blocks, nsec, lanes, _ = coeffs.shape
    n_units = n_blocks // m
    NL = n_units * lanes
    x = xw.permute(1, 0, 2).reshape(C + m * F, NL)
    co = coeffs.reshape(n_units, m, nsec, lanes, 11)

    def block_coeffs(j):
        return co[:, j].permute(1, 0, 2, 3).reshape(nsec, NL, 11)

    gl = _lane_cotangent(gy, sum_groups).reshape(n_units, m, F, lanes)
    gl = gl.permute(1, 2, 0, 3).reshape(m, F, NL)
    zero = torch.zeros((nsec, 2, NL), dtype=torch.float32,
                       device=coeffs.device)
    _, z = sosfilt_stream_scan(block_coeffs(0), x[:C], zero)
    starts = [z]
    for j in range(m - 1):
        _, z = sosfilt_stream_scan(block_coeffs(j),
                                   x[C + j * F:C + (j + 1) * F], z)
        starts.append(z)
    gz = None
    gxs = [None] * m
    gco = torch.zeros((m, nsec, NL, 11), dtype=torch.float32,
                      device=coeffs.device)
    for j in range(m - 1, -1, -1):
        gco[j], gxs[j], gz = _filters.sosfilt_stream_vjp_plain(
            block_coeffs(j), x[C + j * F:C + (j + 1) * F], starts[j], gl[j],
            gz)
    gco_c, gx_c, _ = _filters.sosfilt_stream_vjp_plain(
        block_coeffs(0), x[:C], zero, torch.zeros_like(x[:C]), gz)
    gco[0] += gco_c
    gxw = torch.cat([gx_c] + gxs).reshape(C + m * F, n_units, lanes)
    gco = gco.reshape(m, nsec, n_units, lanes, 11).permute(2, 0, 1, 3, 4)
    return (gxw.permute(1, 0, 2),
            gco.reshape(n_blocks, nsec, lanes, 11))


def _fold_windows(gxw, n_rows: int, step: int):
    """The cotangent of a timeline read as overlapping windows: window
    ``u`` (``gxw[u]``, ``W`` rows) covers rows ``[u*step, u*step + W)``.
    A fixed number of shifted adds, ``ceil(W / step)``, in window order (no
    atomics: the same bits every time), so a context longer than a
    segment is folded too."""
    n_units, W, lanes = gxw.shape
    k_max = -(-W // step)
    g = torch.nn.functional.pad(gxw, (0, 0, 0, k_max * step - W))
    g = g.reshape(n_units, k_max, step, lanes)
    out = torch.zeros(((n_units + k_max - 1) * step, lanes),
                      dtype=gxw.dtype, device=gxw.device)
    for k in range(k_max):
        out[k * step:(k + n_units) * step] += g[:, k].reshape(-1, lanes)
    return out[:n_rows]


def _source_lanef_grad(toff, lanef, gsrc, kw):
    """The cotangent of ``lanef`` from the source rows' ``gsrc``: autograd
    through :func:`gen_source_rows` (elementwise; ``floor`` and ``sign``
    have zero gradient, as in the JAX package)."""
    m = kw['blocks_per_seg']
    with torch.enable_grad():
        lf = lanef.detach().requires_grad_()
        xw = gen_source_rows(toff, lf, n_segments=kw['n_segments'] // m,
                             seg_frames=m * kw['seg_frames'],
                             context=kw['context'], osc_code=kw['osc_code'],
                             rate=kw['rate'])
        (g,) = torch.autograd.grad(xw, lf, gsrc)
    return g


def sosfilt_segments_gen_vjp_plain(coeffs, toff, lanef, gy, *,
                                   n_segments: int, seg_frames: int,
                                   context: int, osc_code: int, rate: int,
                                   sum_groups: int = 0,
                                   blocks_per_seg: int = 1,
                                   source_grad: bool = True):
    """Plain PyTorch version of :func:`sosfilt_segments_gen_vjp`."""
    m = blocks_per_seg
    xw = gen_source_rows(toff, lanef, n_segments=n_segments // m,
                         seg_frames=m * seg_frames, context=context,
                         osc_code=osc_code, rate=rate)
    gxw, gco = _cascade_windows_vjp_plain(
        coeffs, xw, gy, seg_frames=seg_frames, context=context,
        sum_groups=sum_groups, blocks_per_seg=m)
    return gco, (gxw if source_grad else None)


def sosfilt_segments_gen_vjp(coeffs, toff, lanef, gy, *, n_segments: int,
                             seg_frames: int, context: int, osc_code: int,
                             rate: int, sum_groups: int = 0,
                             blocks_per_seg: int = 1,
                             source_grad: bool = True):
    """The backward of :func:`sosfilt_segments_gen` (same geometry): from
    the output's cotangent ``gy`` (its shape), ``(gcoeffs (n_segments,
    nsec, lanes, 11), gsrc)`` with ``gsrc`` ``(n_units, C + m*F, lanes)``
    the cotangent of the synthesized source rows (None unless
    ``source_grad``).  On a GPU the kernel B1 synthesizes the rows again
    in-kernel."""
    m = max(1, int(blocks_per_seg))
    kw = dict(n_segments=n_segments, seg_frames=seg_frames,
              context=context, osc_code=osc_code, rate=rate,
              sum_groups=sum_groups, blocks_per_seg=m)
    if _device_kind(coeffs, toff, lanef, gy) == 'cpu':
        return sosfilt_segments_gen_vjp_plain(coeffs, toff, lanef, gy,
                                              source_grad=source_grad, **kw)
    from signals_tpu_torch.compiler import _build
    lib = _build.library()
    coeffs, toff, lanef, gy = (t.contiguous()
                               for t in (coeffs, toff, lanef, gy))
    nsec, lanes = coeffs.shape[1], coeffs.shape[2]
    n_units, n_rows = n_segments // m, context + m * seg_frames
    gco = torch.zeros_like(coeffs)
    gsrc = (torch.empty((n_units, n_rows, lanes), dtype=torch.float32,
                        device=coeffs.device) if source_grad else None)
    code = lib.sosfilt_segments_vjp_launch(
        coeffs.data_ptr(), None, 0, 0, toff.data_ptr(), lanef.data_ptr(),
        float(np.float32(1.0 / rate)), osc_code, _SIN_C, 1, gy.data_ptr(),
        None if gsrc is None else gsrc.data_ptr(), gco.data_ptr(),
        n_segments, nsec, lanes, seg_frames, context, m, sum_groups,
        _stream(coeffs.device))
    _build.check(code, 'sosfilt_segments_gen_vjp')
    LAUNCHES['segments_gen_vjp'] += 1
    return gco, gsrc


def sosfilt_segments_vjp_plain(coeffs, x, gy, *, n_segments: int,
                               seg_frames: int, context: int,
                               sum_groups: int = 0, blocks_per_seg: int = 1):
    """Plain PyTorch version of :func:`sosfilt_segments_vjp`."""
    m = blocks_per_seg
    n_units, L = n_segments // m, context + m * seg_frames
    xw = x.unfold(0, L, m * seg_frames)[:n_units].permute(0, 2, 1)
    gxw, gco = _cascade_windows_vjp_plain(
        coeffs, xw, gy, seg_frames=seg_frames, context=context,
        sum_groups=sum_groups, blocks_per_seg=m)
    return gco, _fold_windows(gxw, x.shape[0], m * seg_frames)


def sosfilt_segments_vjp(coeffs, x, gy, *, n_segments: int, seg_frames: int,
                         context: int, sum_groups: int = 0,
                         blocks_per_seg: int = 1, input_grad: bool = True):
    """The backward of :func:`sosfilt_segments` on the inputs its kernel
    reads (``coeffs`` ``(n_segments, nsec, lanes, 11)``, ``x`` the padded
    ``(C + n_segments*F, lanes)`` timeline, any strides): ``(gcoeffs,
    gx)``, ``gx`` dense in ``x``'s shape (None without ``input_grad``).  On
    a GPU the kernel B2 writes each window's input cotangent, which
    :func:`_fold_windows` folds into the timeline."""
    m = max(1, int(blocks_per_seg))
    kw = dict(n_segments=n_segments, seg_frames=seg_frames,
              context=context, sum_groups=sum_groups, blocks_per_seg=m)
    if _device_kind(coeffs, x, gy) == 'cpu':
        gco, gx = sosfilt_segments_vjp_plain(coeffs, x, gy, **kw)
        return gco, gx if input_grad else None
    from signals_tpu_torch.compiler import _build
    lib = _build.library()
    coeffs, gy = coeffs.contiguous(), gy.contiguous()
    nsec, lanes = coeffs.shape[1], coeffs.shape[2]
    n_units, n_rows = n_segments // m, context + m * seg_frames
    gco = torch.zeros_like(coeffs)
    gxw = (torch.empty((n_units, n_rows, lanes), dtype=torch.float32,
                       device=coeffs.device) if input_grad else None)
    code = lib.sosfilt_segments_vjp_launch(
        coeffs.data_ptr(), x.data_ptr(), *x.stride(), None, None, 0.0, 0,
        None, 0, gy.data_ptr(), None if gxw is None else gxw.data_ptr(),
        gco.data_ptr(), n_segments, nsec, lanes, seg_frames, context, m,
        sum_groups, _stream(coeffs.device))
    _build.check(code, 'sosfilt_segments_vjp')
    LAUNCHES['segments_vjp'] += 1
    if gxw is None:
        return gco, None
    return gco, _fold_windows(gxw, x.shape[0], m * seg_frames)


def sosfilt_batch_vjp_plain(coeffs, x_t, gy, *, tail=None, zi=None,
                            gzf=None):
    """Plain PyTorch version of :func:`sosfilt_batch_vjp`: the windows ride
    the channel axis of the frame-loop adjoint."""
    L, B = x_t.shape[0], x_t.shape[1]
    nsec, ch = coeffs.shape[1], max(coeffs.shape[2], x_t.shape[2])
    tail = L if tail is None else tail
    co = torch.broadcast_to(coeffs, (B, nsec, ch, 11)).permute(1, 0, 2, 3)
    x = torch.broadcast_to(x_t, (L, B, ch)).reshape(L, B * ch)

    def lanes_of(z):
        return torch.broadcast_to(z, (B, nsec, 2, ch)).permute(
            1, 2, 0, 3).reshape(nsec, 2, B * ch)

    z = (torch.zeros((nsec, 2, B * ch), dtype=torch.float32,
                     device=x.device) if zi is None else lanes_of(zi))
    g = torch.zeros((L, B * ch), dtype=torch.float32, device=x.device)
    g[L - tail:] = gy.reshape(tail, B * ch)
    gco, gx, gzi = _filters.sosfilt_stream_vjp_plain(
        co.reshape(nsec, B * ch, 11), x, z, g,
        None if gzf is None else lanes_of(gzf))
    gco = gco.reshape(nsec, B, ch, 11).permute(1, 0, 2, 3).contiguous()
    gzi = (None if zi is None else
           gzi.reshape(nsec, 2, B, ch).permute(2, 0, 1, 3).contiguous())
    return gco, gx.reshape(L, B, ch), gzi


def _rows_vjp(coeffs, x_t, gy, tail, zi, gzf, what: str):
    """B3 over ``(L, B, ch)`` windows: ``(gcoeffs (B, nsec, ch, 11), gx
    (L, B, ch), gzi or None)``; ``coeffs`` and ``x_t`` any strides (the
    forward's views), ``zi``/``gzf`` ``(B, nsec, 2, ch)`` or None."""
    from signals_tpu_torch.compiler import _build
    lib = _build.library()
    L, B, ch = x_t.shape
    nsec = coeffs.shape[1]
    dev = x_t.device
    coeffs = _columns_contiguous(coeffs)
    gy = gy.contiguous()
    zi = None if zi is None else zi.contiguous()
    gzf = None if gzf is None else gzf.contiguous()
    gco = torch.zeros((B, nsec, ch, 11), dtype=torch.float32, device=dev)
    gx = torch.empty((L, B, ch), dtype=torch.float32, device=dev)
    gzi = None if zi is None else torch.empty_like(zi)
    if B * ch == 0 or L == 0:
        return gco, gx.zero_(), None if gzi is None else gzi.zero_()
    n_ck = lib.sosfilt_rows_vjp_buffer(nsec, B, ch, L)
    ck = (torch.empty(n_ck, dtype=torch.float32, device=dev) if n_ck
          else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    code = lib.sosfilt_rows_vjp_launch(
        coeffs.data_ptr(), *coeffs.stride()[:3], x_t.data_ptr(),
        *x_t.stride(), ptr(zi), gy.data_ptr(), ptr(gzf), gx.data_ptr(),
        gco.data_ptr(), ptr(gzi), ptr(ck), n_ck, nsec, B, ch, L, tail,
        _stream(dev))
    _build.check(code, what)
    LAUNCHES[what.replace('sosfilt_', '')] += 1
    return gco, gx, gzi


def sosfilt_batch_vjp(coeffs, x_t, gy, *, tail=None, zi=None, gzf=None):
    """The backward of :func:`sosfilt_batch` on the inputs its kernel reads
    (``coeffs`` ``(B, nsec, ch, 11)``, ``x_t`` ``(L, B, ch)``, both at the
    full channel count, any strides; ``zi`` ``(B, nsec, 2, ch)`` or None):
    from ``gy`` ``(tail, B, ch)`` and the end state's ``gzf`` (or None),
    ``(gcoeffs, gx (L, B, ch), gzi)``, ``gzi`` None without ``zi``.  On a
    GPU the kernel B3."""
    L = x_t.shape[0]
    tail = L if tail is None else int(tail)
    if _device_kind(*[t for t in (coeffs, x_t, gy, zi, gzf)
                      if t is not None]) == 'cpu':
        return sosfilt_batch_vjp_plain(coeffs, x_t, gy, tail=tail, zi=zi,
                                       gzf=gzf)
    return _rows_vjp(coeffs, x_t, gy, tail, zi, gzf, 'sosfilt_batch_vjp')


def sosfilt_timeline_vjp_plain(coeffs, x, gy):
    """Plain PyTorch version of :func:`sosfilt_timeline_vjp`."""
    zi = torch.zeros((coeffs.shape[0], 2, coeffs.shape[1]),
                     dtype=torch.float32, device=x.device)
    gco, gx, _ = _filters.sosfilt_stream_vjp_plain(coeffs, x, zi, gy)
    return gco, gx


def sosfilt_timeline_vjp(coeffs, x, gy):
    """The backward of :func:`sosfilt_timeline` (``coeffs`` ``(nsec, ch,
    11)`` and ``x`` ``(N, ch)`` at the full channel count): ``(gcoeffs,
    gx)``.  On a GPU the kernel B3 over one window."""
    if _device_kind(coeffs, x, gy) == 'cpu':
        return sosfilt_timeline_vjp_plain(coeffs, x, gy)
    gco, gx, _ = _rows_vjp(coeffs[None], x[:, None], gy[:, None], x.shape[0],
                           None, None, 'sosfilt_timeline_vjp')
    return gco[0], gx[:, 0]


# the plain version of :func:`sosfilt_stream_vjp`
sosfilt_stream_vjp_plain = _filters.sosfilt_stream_vjp_plain


def sosfilt_stream_vjp(coeffs, x, zi, gy, gzf=None):
    """The backward of :func:`sosfilt_stream` (``coeffs`` ``(nsec, ch,
    11)``, ``x`` ``(N, ch)``, ``zi`` ``(nsec, 2, ch)``, all at the full
    channel count): from ``gy`` and the end state's ``gzf`` (or None),
    ``(gcoeffs, gx, gzi)``.  On a GPU the kernel B3 from ``zi``."""
    if _device_kind(*[t for t in (coeffs, x, zi, gy, gzf)
                      if t is not None]) == 'cpu':
        return sosfilt_stream_vjp_plain(coeffs, x, zi, gy, gzf)
    gco, gx, gzi = _rows_vjp(coeffs[None], x[:, None], gy[:, None],
                             x.shape[0], zi[None],
                             None if gzf is None else gzf[None],
                             'sosfilt_stream_vjp')
    return gco[0], gx[:, 0], gzi[0]


# Each entry's Function takes the ``setup_context`` form, which
# ``torch.func.vmap`` requires, and a ``vmap`` rule: under the vmap layout
# of ``PolyPatch`` an entry sees tensors batched over the voices, which have
# no storage for a kernel to read.  The rule folds the voice axis into the
# lane axis — lanes are independent in every cascade — with the unbatched
# operands (shared coefficients or input) expanded, makes ONE call of the
# entry on ``V x lanes`` lanes (one launch on a GPU, the plain version on
# the CPU, and, under grad, the same Function with its backward kernel) and
# splits the result back into voices.


class _SegmentsGenFn(torch.autograd.Function):
    @staticmethod
    def forward(coeffs, toff, lanef, kw):
        return _segments_gen_run(coeffs, toff, lanef, kw)

    @staticmethod
    def setup_context(ctx, inputs, output):
        coeffs, toff, lanef, kw = inputs
        ctx.save_for_backward(coeffs, toff, lanef)
        ctx.kw = kw

    @staticmethod
    def backward(ctx, gy):
        coeffs, toff, lanef = ctx.saved_tensors
        gco, gsrc = sosfilt_segments_gen_vjp(
            coeffs, toff, lanef, gy, source_grad=ctx.needs_input_grad[2],
            **ctx.kw)
        glf = (None if gsrc is None
               else _source_lanef_grad(toff, lanef, gsrc, ctx.kw))
        return gco, None, glf, None

    @staticmethod
    def vmap(info, in_dims, coeffs, toff, lanef, kw):
        n = info.batch_size
        y = sosfilt_segments_gen(_fold(coeffs, in_dims[0], n, 2),
                                 _fold(toff, in_dims[1], n, 0),
                                 _fold(lanef, in_dims[2], n, 1), **kw)
        return _unfold(y, n, 2), 0


class _SegmentsFn(torch.autograd.Function):
    @staticmethod
    def forward(coeffs, x, kw):
        return _segments_run(coeffs, x, kw)

    @staticmethod
    def setup_context(ctx, inputs, output):
        coeffs, x, kw = inputs
        ctx.save_for_backward(coeffs, x)
        ctx.kw = kw

    @staticmethod
    def backward(ctx, gy):
        coeffs, x = ctx.saved_tensors
        gco, gx = sosfilt_segments_vjp(
            coeffs, x, gy, input_grad=ctx.needs_input_grad[1], **ctx.kw)
        return gco, gx, None

    @staticmethod
    def vmap(info, in_dims, coeffs, x, kw):
        n = info.batch_size
        y = sosfilt_segments(_fold(coeffs, in_dims[0], n, 2),
                             _fold(x, in_dims[1], n, 1), **kw)
        return _unfold(y, n, 2), 0


class _BatchFn(torch.autograd.Function):
    @staticmethod
    def forward(coeffs, x_t, zi, tail, time_major):
        return _batch_run(coeffs, x_t, zi, tail, True, time_major)

    @staticmethod
    def setup_context(ctx, inputs, output):
        coeffs, x_t, zi, tail, _ = inputs
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(coeffs, x_t, zi)
        ctx.tail = tail

    @staticmethod
    def backward(ctx, gy, gzf):
        coeffs, x_t, zi = ctx.saved_tensors
        L, B = x_t.shape[0], x_t.shape[1]
        gy = (torch.zeros((ctx.tail, B, x_t.shape[2]), dtype=torch.float32,
                          device=x_t.device) if gy is None else gy)
        gco, gx, gzi = sosfilt_batch_vjp(coeffs, x_t, gy, tail=ctx.tail,
                                         zi=zi, gzf=gzf)
        return gco, gx, gzi, None, None

    @staticmethod
    def vmap(info, in_dims, coeffs, x_t, zi, tail, time_major):
        # With one lane per voice (the lanes are the voices of each window)
        # the kernel writes time-major: a voice's (tail, B, 1) result is then
        # its windows' rows one after another, and the caller's (B * tail)
        # rows of the voice a view, not a transposing copy of every row.
        n = info.batch_size
        x_t = _fold(x_t, in_dims[1], n, 2)
        y, zf = sosfilt_batch(
            _fold(coeffs, in_dims[0], n, 2), x_t, tail=tail,
            zi=None if zi is None else _fold(zi, in_dims[2], n, 3),
            return_state=True,
            time_major=time_major or (tail > 1 and x_t.shape[2] == n))
        return (_unfold(y, n, 2), _unfold(zf, n, 3)), (0, 0)


class _TimelineFn(torch.autograd.Function):
    @staticmethod
    def forward(coeffs, x):
        return _timeline_run(coeffs, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, gy):
        coeffs, x = ctx.saved_tensors
        return sosfilt_timeline_vjp(coeffs, x, gy)

    @staticmethod
    def vmap(info, in_dims, coeffs, x):
        n = info.batch_size
        y = sosfilt_timeline(_fold(coeffs, in_dims[0], n, 1),
                             _fold(x, in_dims[1], n, 1))
        return _unfold(y, n, 1), 0


class _StreamFn(torch.autograd.Function):
    @staticmethod
    def forward(coeffs, x, zi):
        return _stream_run(coeffs, x, zi)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, gy, gzf):
        coeffs, x, zi = ctx.saved_tensors
        gy = torch.zeros_like(x) if gy is None else gy
        return sosfilt_stream_vjp(coeffs, x, zi, gy, gzf)

    @staticmethod
    def vmap(info, in_dims, coeffs, x, zi):
        n = info.batch_size
        y, zf = sosfilt_stream(_fold(coeffs, in_dims[0], n, 1),
                               _fold(x, in_dims[1], n, 1),
                               _fold(zi, in_dims[2], n, 2))
        return (_unfold(y, n, 1), _unfold(zf, n, 2)), (0, 0)


# --- the reverb's feedback delay network --------------------------------------


def _hadamard8() -> np.ndarray:
    h2 = np.array([[1.0, 1.0], [1.0, -1.0]])
    h = np.kron(np.kron(h2, h2), h2) / np.sqrt(8.0)
    return h.astype(np.float32)


#: the FDN's mixing matrix: the 8x8 Sylvester Hadamard matrix over
#: ``sqrt(8)``, float32 (symmetric; ``H8[i, j] = (-1)^popcount(i & j) h``)
H8 = _hadamard8()
FDN_LINES = H8.shape[0]
#: ``H8_COLS[j]`` is column ``j`` of the matrix shaped ``(1, n_lines, 1)``:
#: what line ``j``'s fed-back signal contributes to every line's input
H8_COLS = np.ascontiguousarray(H8.T).reshape(8, 1, 8, 1)


def hadamard_mix(cols, fed):
    """``mixed[:, i, :] = sum_j H8[i, j] * fed[:, j, :]`` for every line
    ``i`` at once, the terms added in the order ``j = 0 .. 7``: per element
    the very products and sums of the reference's doubly unrolled loop
    (each its own f32 operation), in 15 array operations instead of 120.
    ``cols`` is :data:`H8_COLS` in ``fed``'s namespace."""
    acc = cols[0] * fed[:, 0:1, :]
    for j in range(1, cols.shape[0]):
        acc = acc + cols[j] * fed[:, j:j + 1, :]
    return acc


def _check_fdn(lines, inject, g, lengths):
    """``(lines, inject, g)`` at the widest lane count, ``g`` ``(8,
    lanes)``; raises on what the network does not take."""
    if (lines.dtype != torch.float32 or lines.dim() != 3
            or lines.shape[1] != FDN_LINES):
        raise ValueError(f'lines must be float32 (L, {FDN_LINES}, lanes), '
                         f'got {tuple(lines.shape)} {lines.dtype}')
    if inject.dtype != torch.float32 or inject.dim() != 2:
        raise ValueError(f'inject must be float32 (T, lanes), got '
                         f'{tuple(inject.shape)} {inject.dtype}')
    if g.dtype != torch.float32 or g.dim() != 2 or g.shape[0] != FDN_LINES:
        raise ValueError(f'g must be float32 ({FDN_LINES}, lanes), got '
                         f'{tuple(g.shape)} {g.dtype}')
    L = lines.shape[0]
    if len(lengths) != FDN_LINES or not all(1 <= d <= L for d in lengths):
        raise ValueError(f'lengths {lengths}: {FDN_LINES} delays in [1, {L}]')
    lanes = max(lines.shape[2], inject.shape[1], g.shape[1])
    return (torch.broadcast_to(lines, (L, FDN_LINES, lanes)),
            torch.broadcast_to(inject, (inject.shape[0], lanes)),
            torch.broadcast_to(g, (FDN_LINES, lanes)))


def fdn_advance_plain(lines, inject, g, lengths):
    """Plain PyTorch version of :func:`fdn_advance`: a loop over turns of
    ``min(lengths)`` frames (every read of a turn lies before its first
    write), the delayed rows sliced from the timeline in place and mixed
    by :func:`hadamard_mix`."""
    L, n, lanes = lines.shape
    T = inject.shape[0]
    tl = torch.empty((L + T, n, lanes), dtype=torch.float32,
                     device=lines.device)
    tl[:L] = lines
    cols = torch.as_tensor(H8_COLS, device=lines.device)
    g = g.reshape(1, n, lanes)
    inj = inject[:, None, :]
    turn = min(lengths)
    for t0 in range(0, T, turn):
        t1 = min(t0 + turn, T)
        reads = torch.stack(
            [tl[L + t0 - d:L + t1 - d, i] for i, d in enumerate(lengths)],
            dim=1)                                 # (t1 - t0, n, lanes)
        torch.add(hadamard_mix(cols, reads * g), inj[t0:t1],
                  out=tl[L + t0:L + t1])
    return tl


def fdn_advance(lines, inject, g, lengths):
    """Advance the reverb's eight delay lines over a window of ``T``
    frames: ``lines`` ``(L, 8, lanes)`` float32, the carried timeline
    (row ``L - 1`` the newest); ``inject`` ``(T, lanes)``, the signal added
    to every line's input; ``g`` ``(8, lanes)``, each line's feedback gain
    per lane; ``lengths``, the eight delays (frames, each in ``[1, L]``).
    Returns the timeline ``tl`` ``(L + T, 8, lanes)``: the lines, then
    ``tl[L + t, i] = sum_j H8[i, j] (g_j tl[L + t - d_j, j]) + inject[t]``,
    each product and sum its own f32 operation in the order ``j = 0 .. 7``
    (the JAX package's order, so the kernel, the plain loop and the
    per-block :meth:`~signals_tpu_torch.nodes.reverb.Reverb.step` agree bit
    for bit).  The lane axes broadcast to the widest count.  Its last
    ``L`` rows are the carry out; the rows a line's output reads are
    ``tl[L - d_j : L - d_j + T, j]``.  Differentiable in ``lines``,
    ``inject`` and ``g``; under ``torch.func.vmap`` the batch folds into
    the lanes (one launch)."""
    lengths = tuple(int(d) for d in lengths)
    lines, inject, g = _check_fdn(lines, inject, g, lengths)
    if _function_call(lines, inject, g):
        return _FdnFn.apply(lines, inject, g, lengths)
    return _fdn_run(lines, inject, g, lengths)


#: CTAs (lanes) of a thread-block cluster of the forward kernel
FDN_CLUSTER = 8


def fdn_cluster(lanes: int) -> bool:
    """Whether the forward kernel runs ``lanes`` lanes as clusters of
    :data:`FDN_CLUSTER` CTAs (a CTA a lane; each stages its rows whole and
    stores a share of 8 lanes' rows as whole 32-byte runs): from 8 lanes
    on.  Below that one CTA a lane stores its own rows."""
    return lanes >= FDN_CLUSTER


def fdn_gain_chunks(T: int, lanes: int, sms: int) -> int:
    """Chunks of the window's rows the gain kernel ``fdn_vjp_gain`` sums
    apart (then adds in chunk order): about two CTAs an SM over the
    ``ceil(8 lanes / 1024)`` pair groups, at least 32 products a thread."""
    groups = -(-FDN_LINES * lanes // 1024)
    per_sm = max(1, 2 * sms // groups)
    return max(1, min(per_sm, T * FDN_LINES * lanes // (1024 * 32)))


def _delays(lengths):
    return (ctypes.c_int * FDN_LINES)(*lengths)


def _fdn_rings(lib, dev, lengths, ctas: int):
    """The global scratch for the kernels' delay rings (``sum(lengths)``
    floats a CTA), or None where they fit a block's shared memory."""
    if lib.fdn_ring_shared(_delays(lengths)):
        return None
    return torch.empty(ctas * sum(lengths), dtype=torch.float32, device=dev)


def _aligned(t):
    """``t``, copied where its data is not 16-byte aligned (the one-lane
    kernels move whole rows as float4)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fdn_run(lines, inject, g, lengths):
    if _device_kind(lines, inject, g) == 'cpu':
        return fdn_advance_plain(lines, inject, g, lengths)
    from signals_tpu_torch.compiler import _build
    lib = _build.library()
    L, n, lanes = lines.shape
    T = inject.shape[0]
    dev = lines.device
    lines, inject, g = (t.contiguous() for t in (lines, inject, g))
    tl = torch.empty((L + T, n, lanes), dtype=torch.float32, device=dev)
    cluster = fdn_cluster(lanes)
    ctas = -(-lanes // FDN_CLUSTER) * FDN_CLUSTER if cluster else lanes
    rings = _fdn_rings(lib, dev, lengths, ctas)
    # the clusters' staged rows: two turns a CTA
    stage = (torch.empty((ctas, 2, min(lengths), n), dtype=torch.float32,
                         device=dev) if cluster else None)
    code = lib.fdn_advance_launch(
        lines.data_ptr(), inject.data_ptr(), g.data_ptr(), tl.data_ptr(),
        None if rings is None else rings.data_ptr(),
        None if stage is None else stage.data_ptr(), L, T, lanes,
        int(cluster), float(H8[0, 0]), _delays(lengths), _stream(dev))
    _build.check(code, 'fdn_advance')
    LAUNCHES['fdn'] += 1
    return tl


def fdn_advance_vjp_plain(tl, g, gtl, lengths, L: int):
    """Plain PyTorch version of :func:`fdn_advance_vjp`: the adjoint
    recurrence as a loop over turns from the end.  A turn's rows are final
    once the turns after it are done (a row's cotangent comes from rows at
    least ``min(lengths)`` later); each hands ``g_j (H u)_j`` to the rows
    ``d_j`` earlier and adds ``r_j (H u)_j`` to ``g_j``'s cotangent."""
    n, lanes = tl.shape[1], tl.shape[2]
    T = tl.shape[0] - L
    h = torch.as_tensor(H8, device=tl.device)
    u = gtl.clone()
    gg = torch.zeros((n, lanes), dtype=torch.float32, device=tl.device)
    turn = min(lengths)
    for p1 in range(L + T, L, -turn):
        p0 = max(p1 - turn, L)
        hu = torch.einsum('ij,pjc->pic', h, u[p0:p1])
        for j, d in enumerate(lengths):
            u[p0 - d:p1 - d, j] += g[j] * hu[:, j]
            gg[j] += (tl[p0 - d:p1 - d, j] * hu[:, j]).sum(dim=0)
    return u[:L].clone(), u[L:].sum(dim=1), gg


def fdn_advance_vjp(tl, g, gtl, lengths, L: int):
    """The backward of :func:`fdn_advance`: from the forward's timeline
    ``tl`` ``(L + T, 8, lanes)``, its gains ``g`` ``(8, lanes)`` (both at
    the full lane count) and the timeline's cotangent ``gtl``, the
    cotangents ``(glines (L, 8, lanes), ginject (T, lanes), gg (8,
    lanes))``.  On a GPU two kernels of ``csrc/fdn.cu``: the serial chain
    ``fdn_advance_vjp`` (``LAUNCHES['fdn_vjp']``), which writes ``H u`` of
    the window's rows, then :func:`fdn_vjp_gain` (``'fdn_vjp_gain'``),
    which sums ``gg`` over time in a fixed order (the same bits on every
    run)."""
    lengths = tuple(int(d) for d in lengths)
    if _device_kind(tl, g, gtl) == 'cpu':
        return fdn_advance_vjp_plain(tl, g, gtl, lengths, L)
    from signals_tpu_torch.compiler import _build
    lib = _build.library()
    n, lanes = tl.shape[1], tl.shape[2]
    T = tl.shape[0] - L
    dev = tl.device
    tl, g = tl.contiguous(), g.contiguous()
    gtl = _aligned(gtl.contiguous())
    hu = torch.empty((lanes, T, n), dtype=torch.float32, device=dev)
    glines = torch.empty((L, n, lanes), dtype=torch.float32, device=dev)
    ginject = torch.empty((T, lanes), dtype=torch.float32, device=dev)
    rings = _fdn_rings(lib, dev, lengths, lanes)
    code = lib.fdn_advance_vjp_launch(
        gtl.data_ptr(), g.data_ptr(),
        None if rings is None else rings.data_ptr(), hu.data_ptr(),
        glines.data_ptr(), ginject.data_ptr(), L, T, lanes,
        float(H8[0, 0]), _delays(lengths), _stream(dev))
    _build.check(code, 'fdn_advance_vjp')
    LAUNCHES['fdn_vjp'] += 1
    return glines, ginject, fdn_vjp_gain(tl, hu, lengths, L)


def fdn_vjp_gain_plain(tl, hu, lengths, L: int):
    """Plain PyTorch version of :func:`fdn_vjp_gain`."""
    T = hu.shape[1]
    return torch.stack([(tl[L - d:L - d + T, j] * hu[:, :, j].T).sum(dim=0)
                        for j, d in enumerate(lengths)])


def fdn_vjp_gain(tl, hu, lengths, L: int):
    """The gains' cotangent ``gg[j, c] = sum_t tl[L + t - d_j, j, c] *
    hu[c, t, j]`` (``(8, lanes)``) from the forward's timeline ``tl`` and
    ``hu`` ``(lanes, T, 8)``, the ``H u`` of the window's rows that the
    adjoint's chain writes (lane-major: a row whole at any lane count).  On
    a GPU the kernel ``fdn_vjp_gain`` of ``csrc/fdn.cu`` (then its chunk
    sum): per chunk of rows a fixed-order sum, the chunks added in order,
    so the same bits on every run."""
    lengths = tuple(int(d) for d in lengths)
    if _device_kind(tl, hu) == 'cpu':
        return fdn_vjp_gain_plain(tl, hu, lengths, L)
    from signals_tpu_torch.compiler import _build
    lib = _build.library()
    lanes, T, n = hu.shape
    dev = hu.device
    tl, hu = tl.contiguous(), hu.contiguous()
    chunks = fdn_gain_chunks(
        T, lanes, torch.cuda.get_device_properties(dev).multi_processor_count)
    partial = torch.empty((chunks, lanes, n), dtype=torch.float32,
                          device=dev)
    gg = torch.empty((n, lanes), dtype=torch.float32, device=dev)
    code = lib.fdn_vjp_gain_launch(
        tl.data_ptr(), hu.data_ptr(), partial.data_ptr(), gg.data_ptr(), L,
        T, lanes, chunks, _delays(lengths), _stream(dev))
    _build.check(code, 'fdn_vjp_gain')
    LAUNCHES['fdn_vjp_gain'] += 1
    return gg


class _FdnFn(torch.autograd.Function):
    """:func:`fdn_advance` under autograd and ``torch.func.vmap``: the
    backward is :func:`fdn_advance_vjp` on the saved timeline; the ``vmap``
    rule folds the batch into the lanes (a per-voice ``t60`` is a per-lane
    ``g``), one call for all voices."""

    @staticmethod
    def forward(lines, inject, g, lengths):
        return _fdn_run(lines, inject, g, lengths)

    @staticmethod
    def setup_context(ctx, inputs, output):
        lines, _inject, g, lengths = inputs
        ctx.save_for_backward(output, g)
        ctx.lengths = lengths
        ctx.L = lines.shape[0]

    @staticmethod
    def backward(ctx, gtl):
        tl, g = ctx.saved_tensors
        glines, ginject, gg = fdn_advance_vjp(tl, g, gtl, ctx.lengths, ctx.L)
        return glines, ginject, gg, None

    @staticmethod
    def vmap(info, in_dims, lines, inject, g, lengths):
        n = info.batch_size
        tl = fdn_advance(_fold(lines, in_dims[0], n, 2),
                         _fold(inject, in_dims[1], n, 1),
                         _fold(g, in_dims[2], n, 1), lengths)
        return _unfold(tl, n, 2), 0
