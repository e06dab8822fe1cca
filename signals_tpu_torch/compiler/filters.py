"""Butterworth filter design and the coupled-form cascade
(``signals_tpu.compiler.filters``).

The cutoff is a *signal* sampled per block, so coefficients are designed
inside the render from the lowered cutoff values:

* :func:`design_coupled` — closed-form bilinear-transform Butterworth
  design (order-2 low/high-pass, order-4 band-pass/band-stop as two
  sections), written against an array namespace
  (:data:`~signals_tpu_torch.core.xp.NP` or a
  :class:`~signals_tpu_torch.core.xp.TorchXP`).  The design math runs in
  **float64** in both engines and rounds to float32 once, so the
  coefficients are bit-identical across engines; the coupled taps involve a
  catastrophic cancellation and are derived inside the f64 pipeline.
* :func:`sosfilt_stream_scan` — the stateful cascade in plain PyTorch (a
  loop over frames), the reference the CUDA kernels are held to;
* :func:`sosfilt_stream` — the stateful cascade of one window: the CUDA
  kernel :func:`~signals_tpu_torch.compiler.kernels.sosfilt_stream` on a
  GPU, the frame loop on the CPU;
* :func:`sosfilt` — the zero-state cascade of a whole timeline: the CUDA
  kernel :func:`~signals_tpu_torch.compiler.kernels.sosfilt_timeline` on a
  GPU, its plain version :func:`sosfilt_scan` on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F32 = np.float32

#: filter type codes (reference ``fx.py:124-163``); the port designs the
#: Butterworth family (the RBJ EQ types are not ported yet)
LOWPASS, HIGHPASS, BANDPASS, BANDSTOP = 'lp', 'hp', 'bp', 'bs'

_WN_MIN = 1e-5
_WN_MAX = 1.0 - 1e-5

#: generator-fed cascade: when a filter's input is a plain oscillator
#: (Sine/Saw/Square/Triangle) driven by ``Fixed`` controls, synthesize it
#: INSIDE the segment kernel (:func:`~signals_tpu_torch.compiler.kernels.
#: sosfilt_segments_gen`) — the input timeline is then never written to
#: device memory.  'auto' = on for a CUDA device, off (the lowered
#: oscillator feeds the timeline kernel) on the CPU.  Snapshotted into the
#: graph hash at compile time.
SEG_SOURCE_GEN = 'auto'

#: blocks per swept-filter carry segment: state carries across ``m``
#: blocks with per-block coefficients, segments aligned to absolute
#: multiples of ``m *`` :data:`CARRY_GRID_FRAMES`, the context warmup
#: replayed once per segment (see ``CritFilter.swept_carry_m``).  'auto' = 8.
SEG_CARRY_BLOCKS = 'auto'

#: the block grid swept-filter carry segments are defined on (the product
#: default block size): carry engages only when the block size equals this;
#: other block sizes keep per-block context replay
CARRY_GRID_FRAMES = 1024


def resolve_seg_carry_blocks() -> int:
    if SEG_CARRY_BLOCKS == 'auto':
        return 8
    return max(1, int(SEG_CARRY_BLOCKS))


def resolve_seg_source_gen(device) -> bool:
    if SEG_SOURCE_GEN == 'auto':
        return torch.device(device).type == 'cuda'
    return bool(SEG_SOURCE_GEN)


_SQRT2 = math.sqrt(2.0)


def _design_lp_hp(xp, btype, wn):
    c = xp.tan((math.pi / 2) * wn)
    c2 = c * c
    d = 1.0 + _SQRT2 * c + c2
    a1 = 2.0 * (c2 - 1.0) / d
    a2 = (1.0 - _SQRT2 * c + c2) / d
    if btype == LOWPASS:
        b0 = c2 / d
        b1 = 2.0 * b0
    else:
        b0 = 1.0 / d
        b1 = -2.0 * b0
    one = xp.ones_like(a1)
    return xp.stack([b0, b1, b0, one, a1, a2], axis=-1)[None]  # (1, ch, 6)


def _csqrt(xp, re, im):
    """Principal complex sqrt via real arithmetic."""
    mag = xp.sqrt(xp.sqrt(re * re + im * im))
    ang = 0.5 * xp.arctan2(im, re)
    return mag * xp.cos(ang), mag * xp.sin(ang)


def _bilinear_pole(xp, re, im):
    """z = (4 + s) / (4 - s) for a complex pole s, returning (Re z, |z|^2,
    |4-s|^2) — everything the section denominator and gain need."""
    nr, ni = 4.0 + re, im
    dr, di = 4.0 - re, -im
    den = dr * dr + di * di
    zr = (nr * dr + ni * di) / den
    zmag2 = (nr * nr + ni * ni) / den
    return zr, zmag2, den


def _design_band(xp, btype, w1, w2):
    """Order-2 prototype -> order-4 band filter as two biquad sections.

    scipy's zpk pipeline (buttap -> lp2bp/lp2bs -> bilinear -> sos) in
    closed form.  Prototype poles are exp(±i 3π/4); only one of each
    conjugate pair is tracked (sections pair conjugates).  The pre-warp is
    ``warped = 2*fs*tan(pi*Wn/fs)`` at fs=2 (scipy convention).  The op
    sequence is the JAX package's, so the numpy design is bit-identical.
    """
    warped1 = 4.0 * xp.tan((math.pi / 2) * w1)
    warped2 = 4.0 * xp.tan((math.pi / 2) * w2)
    bw = warped2 - warped1
    wo2 = warped1 * warped2
    half = 0.5 * bw
    # one prototype pole p = exp(i 3π/4) = (-√2/2, +√2/2)
    if btype == BANDPASS:
        # lp2bp: u = p*bw/2 ; poles = u ± sqrt(u² - wo²)
        ur, ui = (-_SQRT2 / 2) * half, (_SQRT2 / 2) * half
    else:
        # lp2bs: u = (bw/2)/p = (bw/2) * conj(p)  (|p| = 1)
        ur, ui = (-_SQRT2 / 2) * half, -(_SQRT2 / 2) * half
    dr = ur * ur - ui * ui - wo2
    di = 2.0 * ur * ui
    sr, si = _csqrt(xp, dr, di)
    poles = [(ur + sr, ui + si), (ur - sr, ui - si)]
    zr_list, zmag2_list, den_list = [], [], []
    for (re, im) in poles:
        zr, zmag2, den = _bilinear_pole(xp, re, im)
        zr_list.append(zr)
        zmag2_list.append(zmag2)
        den_list.append(den)

    # gain after bilinear: k_d = k_analog * prod(4 - z_analog)/prod(4 - p_analog)
    # prod over all 4 poles = |4-P1|² |4-P2|² = den1 * den2
    pole_prod = den_list[0] * den_list[1]
    if btype == BANDPASS:
        # analog zeros: two at 0 -> prod(4 - 0) = 16 ; k_analog = bw²
        k = bw * bw * 16.0 / pole_prod
        # digital zeros: +1, +1, -1, -1 -> numerator (z-1)(z+1) per section
        n0s, n2s = (1.0, 1.0), (-1.0, -1.0)
        zz = xp.zeros_like(k)
        n1s = [zz, zz]
    else:
        # analog zeros: ±i wo twice -> prod = (16 + wo²)² ; k_analog = 1
        k = (16.0 + wo2) ** 2 / pole_prod
        # digital zeros: conj pair at (4+i wo)/(4-i wo), |z| = 1, duplicated
        zzr = (16.0 - wo2) / (16.0 + wo2)
        n0s, n2s = (1.0, 1.0), (1.0, 1.0)
        n1s = [-2.0 * zzr, -2.0 * zzr]
    sections = []
    ones = xp.ones_like(k)
    for idx in range(2):
        g = k if idx == 0 else ones
        sections.append(xp.stack(
            [g * n0s[idx], g * n1s[idx], g * n2s[idx],
             ones, -2.0 * zr_list[idx], zmag2_list[idx]], axis=-1))
    return xp.stack(sections, axis=0)  # (2, ch, 6)


def _design64(xp, btype: str, crits, nyquist):
    """Crit normalization + per-type dispatch in float64: SOS
    ``(nsec, ch, 6)``.  Cutoffs clip to the open interval (0, 1) of
    Nyquist (the reference clips to the closed one and then crashes in
    scipy); band crits broadcast to a common channel count."""
    f64 = xp.float64
    crits64 = [xp.astype(xp.asarray(c), f64).reshape(-1) for c in crits]
    if len(crits64) > 1:
        ch = max(c.shape[0] for c in crits64)
        crits64 = [xp.broadcast_to(c, (ch,)) for c in crits64]
    nyq = xp.astype(xp.asarray(nyquist), f64)
    if btype in (LOWPASS, HIGHPASS):
        (c,) = crits64
        return _design_lp_hp(xp, btype, xp.clip(c / nyq, _WN_MIN, _WN_MAX))
    if btype in (BANDPASS, BANDSTOP):
        c1, c2 = crits64
        return _design_band(xp, btype,
                            xp.clip(c1 / nyq, _WN_MIN, _WN_MAX),
                            xp.clip(c2 / nyq, _WN_MIN, _WN_MAX))
    raise NotImplementedError(f'filter type {btype!r} is not ported yet')


def design_coupled(xp, btype: str, crits, nyquist):
    """Design order-2 Butterworth sections, vectorized over channels.

    ``crits``: one (lp/hp) or two (bp/bs) cutoff arrays in hertz, each
    ``(1, ch)``; ``nyquist``: rate/2.
    Returns float32 ``(nsec, ch, 11)``: ``[b0 b1 b2 1 a1 a2 | rc rs d0 d1
    d2]`` — the b/a form for reference implementations plus the
    **coupled-form** parameters the cascade kernels run on.
    """
    sos = _design64(xp, btype, crits, nyquist)
    b0, b1, b2 = sos[..., 0], sos[..., 1], sos[..., 2]
    a1, a2 = sos[..., 4], sos[..., 5]
    rc = -0.5 * a1
    rs = xp.sqrt(xp.maximum(a2 - 0.25 * a1 * a1, 1e-300))
    d0 = b0
    d1 = b1 - a1 * b0
    d2 = (b2 - a2 * b0 + rc * d1) / rs
    out = xp.concatenate(
        [sos, xp.stack([rc, rs, d0, d1, d2], axis=-1)], axis=-1)
    return xp.astype(out, xp.float32)


def _coupled_params(coeffs, s):
    """Per-section coupled-form parameters ``(rc, rs, d0, d1, d2)``, each
    ``(ch,)``, from 11-column :func:`design_coupled` rows."""
    return tuple(coeffs[s, :, k] for k in range(6, 11))


def sosfilt_stream_scan(coeffs, x, zi):
    """Stateful cascade in plain PyTorch: continue from (and return) the
    coupled-form state ``zi`` of shape ``(nsec, 2, ch)``.  ``coeffs``
    ``(nsec, ch, 11)``; ``x`` ``(n, ch)``; returns ``(y (n, ch), zf)``.

    Per section and frame (the op order of the segment kernels):
    ``y = d0 x + d1 s1 + d2 s2``, ``s1' = rc s1 - rs s2 + x``,
    ``s2' = rs s1 + rc s2`` — a Python loop over frames, vectorized over
    channels.
    """
    nsec = coeffs.shape[0]
    n = x.shape[0]
    ch = max(coeffs.shape[1], x.shape[1], zi.shape[-1])
    x = torch.broadcast_to(x, (n, ch))
    zf = []
    for s in range(nsec):
        rc, rs, d0, d1, d2 = (torch.broadcast_to(p, (ch,))
                              for p in _coupled_params(coeffs, s))
        s1 = torch.broadcast_to(zi[s, 0], (ch,))
        s2 = torch.broadcast_to(zi[s, 1], (ch,))
        ys = []
        for t in range(n):
            v = x[t]
            ys.append(d0 * v + d1 * s1 + d2 * s2)
            s1, s2 = rc * s1 - rs * s2 + v, rs * s1 + rc * s2
        x = torch.stack(ys) if ys else x
        zf.append(torch.stack([s1, s2]))
    return x, torch.stack(zf)


def sosfilt_scan(coeffs, x):
    """Zero-initial-state cascade in plain PyTorch:
    :func:`sosfilt_stream_scan` from zero state.  ``coeffs`` ``(nsec, ch,
    11)`` from :func:`design_coupled`; ``x`` ``(N, ch)`` (the channel axes
    broadcast to the wider count).  The plain version of the CUDA kernel
    :func:`~signals_tpu_torch.compiler.kernels.sosfilt_timeline`."""
    ch = max(coeffs.shape[1], x.shape[1])
    zi = torch.zeros((coeffs.shape[0], 2, ch), dtype=torch.float32,
                     device=x.device)
    return sosfilt_stream_scan(coeffs, x, zi)[0]


def sosfilt(coeffs, x):
    """The zero-state cascade of a whole timeline (``signals_tpu``'s
    ``filters.sosfilt``): the CUDA kernel for a tensor on a GPU, the plain
    :func:`sosfilt_scan` for one on the CPU."""
    from signals_tpu_torch.compiler.kernels import sosfilt_timeline
    return sosfilt_timeline(coeffs, x)


def sosfilt_stream(coeffs, x, zi):
    """The stateful cascade of one window (``signals_tpu``'s
    ``filters.sosfilt_stream``): continue from the coupled-form state
    ``zi`` ``(nsec, 2, ch)``, return ``(y, zf)``.  The CUDA kernel for
    tensors on a GPU, the frame loop :func:`sosfilt_stream_scan` for
    tensors on the CPU."""
    from signals_tpu_torch.compiler import kernels
    return kernels.sosfilt_stream(coeffs, x, zi)
