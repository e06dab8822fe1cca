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

The segment kernels take ``sum_groups = g`` (the mix epilogue: return each
``g``-lane group's sum instead of the lanes) and ``blocks_per_seg = m``
(carry segments: ``m`` coefficient blocks share one state that warms up
over ``context`` rows under the segment's first block's coefficients).

A wrapper runs the plain version only because its tensors lie on the CPU.
On a CUDA tensor it launches the hand-written kernel (``csrc/segments.cu``,
``csrc/rows.cu``, built at first use by :mod:`._build`) or raises; each
launch adds one to :data:`LAUNCHES`.  The segment kernels take 1 or 2
order-2 sections per lane (every Butterworth design), the zero-state and
carried-state kernels 1 to :data:`MAX_SECTIONS`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from signals_tpu_torch.compiler.filters import (sosfilt_scan,
                                                 sosfilt_stream_scan)
from signals_tpu_torch.core.mathx import _SIN2PI_COEFFS, sin2pi
from signals_tpu_torch.core.xp import TorchXP

OSC_SINE, OSC_SQUARE, OSC_SAW, OSC_TRIANGLE = 0, 1, 2, 3

#: launches of each hand-written kernel since :func:`reset_launch_counts`
LAUNCHES = {'segments_gen': 0, 'segments': 0, 'batch': 0, 'timeline': 0,
            'stream': 0}

#: sections per lane the segment kernels take (the Butterworth designs: 1
#: for low/high-pass, 2 for band-pass/band-stop)
SEGMENT_SECTIONS = (1, 2)
#: most sections per lane the zero-state kernels keep in registers
MAX_SECTIONS = 4

_SIN_C = (ctypes.c_double * len(_SIN2PI_COEFFS))(*_SIN2PI_COEFFS)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    if _device_kind(coeffs, toff, lanef) == 'cpu':
        return sosfilt_segments_gen_plain(coeffs, toff, lanef, **kw)
    from signals_tpu_torch.compiler import _build
    lib = _build.library()
    coeffs, toff, lanef = (t.contiguous() for t in (coeffs, toff, lanef))
    out, _partial, partial_ptr = _outputs(lib, coeffs, seg_frames, context,
                                          m, lanes, sum_groups)
    code = lib.sosfilt_segments_gen_launch(
        coeffs.data_ptr(), toff.data_ptr(), lanef.data_ptr(),
        float(np.float32(1.0 / rate)), osc_code, _SIN_C, out.data_ptr(),
        partial_ptr, n_segments, coeffs.shape[1], lanes, seg_frames, context,
        m, sum_groups, _stream(coeffs.device))
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
    if _device_kind(coeffs, x) == 'cpu':
        return sosfilt_segments_plain(coeffs, x, **kw)
    from signals_tpu_torch.compiler import _build
    lib = _build.library()
    coeffs = coeffs.contiguous()
    out, _partial, partial_ptr = _outputs(lib, coeffs, seg_frames, context,
                                          m, lanes, sum_groups)
    code = lib.sosfilt_segments_launch(
        coeffs.data_ptr(), x.data_ptr(), *x.stride(), out.data_ptr(),
        partial_ptr,
        n_segments, coeffs.shape[1], lanes, seg_frames, context, m,
        sum_groups, _stream(coeffs.device))
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
        out.data_ptr(), None if zi is None else zi.data_ptr(),
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


def sosfilt_batch(coeffs, x_t, *, tail=None, zi=None, return_state=False):
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
    if _device_kind(*tensors) == 'cpu':
        return sosfilt_batch_plain(coeffs, x_t, tail=tail, zi=zi,
                                   return_state=return_state)
    out = torch.empty((tail, B, ch), dtype=torch.float32, device=x_t.device)
    zf = (torch.empty((B, nsec, 2, ch), dtype=torch.float32,
                      device=x_t.device) if return_state else None)
    if B * ch == 0:
        return (out, zf) if return_state else out
    from signals_tpu_torch.compiler import _build
    lib = _build.library()
    coeffs = _columns_contiguous(coeffs)
    code = lib.sosfilt_batch_launch(
        coeffs.data_ptr(), *coeffs.stride()[:3], x_t.data_ptr(),
        *x_t.stride(), out.data_ptr(),
        None if zi is None else zi.data_ptr(),
        None if zf is None else zf.data_ptr(), nsec, B, ch, L, tail,
        _stream(x_t.device))
    _build.check(code, 'sosfilt_batch')
    LAUNCHES['batch'] += 1
    return (out, zf) if return_state else out
