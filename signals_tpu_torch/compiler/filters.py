"""Filter design and the coupled-form cascade
(``signals_tpu.compiler.filters``).

The cutoff is a *signal* sampled per block, so coefficients are designed
inside the render from the lowered cutoff values:

* :func:`design_coupled` — closed-form bilinear-transform Butterworth
  design (order-2 low/high-pass, order-4 band-pass/band-stop as two
  sections) and the RBJ audio-EQ-cookbook biquads (peak, shelves, notch,
  allpass: :func:`_design_eq`), written against an array namespace
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

#: filter type codes — Butterworth (reference ``fx.py:124-163``) ...
LOWPASS, HIGHPASS, BANDPASS, BANDSTOP = 'lp', 'hp', 'bp', 'bs'
#: ... and the RBJ cookbook EQ biquads (no reference counterpart): peaking
#: EQ, notch, allpass, low/high shelf.  Same SOS/coupled-form contract as
#: the Butterworth codes, so every execution path runs them unchanged.
PEAK, NOTCH, ALLPASS, LOWSHELF, HIGHSHELF = 'pk', 'nt', 'ap', 'ls', 'hs'

#: EQ types taking a gain crit (freq, gain_db, q); the others take (freq, q)
_EQ_GAIN_TYPES = (PEAK, LOWSHELF, HIGHSHELF)
_EQ_TYPES = _EQ_GAIN_TYPES + (NOTCH, ALLPASS)

_WN_MIN = 1e-5
_WN_MAX = 1.0 - 1e-5

#: EQ parameter domains.  ``q <= 0`` (e.g. an unconnected ``q`` port, which
#: reads as zero) means "default Q" = 1/sqrt(2), the Butterworth-slope
#: choice.  Gain is clipped to ±40 dB (A in [0.1, 10] at the ``10^(g/40)``
#: convention).
_Q_DEFAULT = 0.7071067811865476
_Q_MIN = 0.05
_Q_MAX = 40.0
_GAIN_DB_MAX = 40.0

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


def _design_eq(xp, btype, wn, gain_db, q):
    """RBJ audio-EQ-cookbook biquads in float64, vectorized over channels
    (the JAX package's op sequence).

    ``wn`` is the center/corner frequency normalized by Nyquist (already
    clipped to the open interval), ``gain_db`` the boost/cut in dB
    (``10^(g/40)`` convention; ignored for notch/allpass), ``q`` the
    quality factor (shelves use the Q parameterization of the shelf
    slope; ``q = _Q_DEFAULT`` gives the classic slope-1 shelf).

    **Coupled-form domain clip:** the cascade kernels factor each biquad
    into a scaled rotation, which requires a *complex* pole pair.  RBJ
    responses with very low Q (a peaking cut needs ``2·Q·A > 1``, the
    others ``Q > 0.5``) have real poles; those denominators are clipped to
    the nearest complex-pair denominator (``a2`` in ``[1e-12, 1 - 1e-9]``,
    ``|a1| <= 2·sqrt(a2)·(1 - 1e-10)``) — the numerator is kept, so the
    response stays finite and stable.  Musical settings never hit the
    clip.
    """
    w0 = math.pi * wn
    cw = xp.cos(w0)
    sw = xp.sin(w0)
    alpha = sw / (2.0 * q)
    one = xp.ones_like(cw)
    if btype == PEAK:
        A = 10.0 ** (gain_db / 40.0)
        b0, b1, b2 = 1.0 + alpha * A, -2.0 * cw, 1.0 - alpha * A
        a0, a1, a2 = 1.0 + alpha / A, -2.0 * cw, 1.0 - alpha / A
    elif btype == NOTCH:
        b0, b1, b2 = one, -2.0 * cw, one
        a0, a1, a2 = 1.0 + alpha, -2.0 * cw, 1.0 - alpha
    elif btype == ALLPASS:
        b0, b1, b2 = 1.0 - alpha, -2.0 * cw, 1.0 + alpha
        a0, a1, a2 = 1.0 + alpha, -2.0 * cw, 1.0 - alpha
    else:
        A = 10.0 ** (gain_db / 40.0)
        sqA = xp.sqrt(A)
        t = 2.0 * sqA * alpha
        if btype == LOWSHELF:
            b0 = A * ((A + 1.0) - (A - 1.0) * cw + t)
            b1 = 2.0 * A * ((A - 1.0) - (A + 1.0) * cw)
            b2 = A * ((A + 1.0) - (A - 1.0) * cw - t)
            a0 = (A + 1.0) + (A - 1.0) * cw + t
            a1 = -2.0 * ((A - 1.0) + (A + 1.0) * cw)
            a2 = (A + 1.0) + (A - 1.0) * cw - t
        elif btype == HIGHSHELF:
            b0 = A * ((A + 1.0) + (A - 1.0) * cw + t)
            b1 = -2.0 * A * ((A - 1.0) + (A + 1.0) * cw)
            b2 = A * ((A + 1.0) + (A - 1.0) * cw - t)
            a0 = (A + 1.0) - (A - 1.0) * cw + t
            a1 = 2.0 * ((A - 1.0) - (A + 1.0) * cw)
            a2 = (A + 1.0) - (A - 1.0) * cw - t
        else:
            raise ValueError(btype)
    b0, b1, b2 = b0 / a0, b1 / a0, b2 / a0
    a1, a2 = a1 / a0, a2 / a0
    # complex-pole-pair domain: a2 = pole radius² in (0, 1), |a1| <
    # 2·sqrt(a2) with a relative margin far below sin²(w0_min), so valid
    # designs — near-DC shelves included — never bind
    a2 = xp.clip(a2, 1e-12, 1.0 - 1e-9)
    bound = 2.0 * xp.sqrt(a2) * (1.0 - 1e-10)
    a1 = xp.clip(a1, -bound, bound)
    return xp.stack([b0, b1, b2, one, a1, a2], axis=-1)[None]  # (1, ch, 6)


def _design64(xp, btype: str, crits, nyquist):
    """Crit normalization + per-type dispatch in float64: SOS
    ``(nsec, ch, 6)``.  Cutoffs clip to the open interval (0, 1) of
    Nyquist (the reference clips to the closed one and then crashes in
    scipy); crits broadcast to a common channel count.  EQ types take
    ``crits`` = (freq_hz, gain_db, q), or (freq_hz, q) for notch and
    allpass."""
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
    if btype in _EQ_TYPES:
        if btype in _EQ_GAIN_TYPES:
            freq, gain_db, q = crits64
            gain_db = xp.clip(gain_db, -_GAIN_DB_MAX, _GAIN_DB_MAX)
        else:
            freq, q = crits64
            gain_db = xp.zeros_like(freq)
        wn = xp.clip(freq / nyq, _WN_MIN, _WN_MAX)
        # q <= 0 (an unconnected port reads as zero) means "default Q"
        q = xp.where(q <= 0.0, _Q_DEFAULT, q)
        q = xp.clip(q, _Q_MIN, _Q_MAX)
        return _design_eq(xp, btype, wn, gain_db, q)
    raise ValueError(btype)


def design_coupled(xp, btype: str, crits, nyquist):
    """Design order-2 sections, vectorized over channels.

    ``crits``: one (lp/hp) or two (bp/bs) cutoff arrays in hertz, each
    ``(1, ch)``, or an EQ type's (freq, gain_db, q) / (freq, q);
    ``nyquist``: rate/2.
    Returns float32 ``(nsec, ch, 11)``: ``[b0 b1 b2 1 a1 a2 | rc rs d0 d1
    d2]`` — the b/a form for reference implementations plus the
    **coupled-form** parameters the cascade kernels run on.
    """
    return xp.astype(coupled64(xp, _design64(xp, btype, crits, nyquist)),
                     xp.float32)


def coupled64(xp, sos):
    """The 11-column rows of :func:`design_coupled` from float64 SOS
    ``(nsec, ch, 6)``, still in float64 (the coupled taps' cancellation is
    taken there); :func:`design_coupled` rounds them to float32 once."""
    b0, b1, b2 = sos[..., 0], sos[..., 1], sos[..., 2]
    a1, a2 = sos[..., 4], sos[..., 5]
    rc = -0.5 * a1
    rs = xp.sqrt(xp.maximum(a2 - 0.25 * a1 * a1, 1e-300))
    d0 = b0
    d1 = b1 - a1 * b0
    d2 = (b2 - a2 * b0 + rc * d1) / rs
    return xp.concatenate(
        [sos, xp.stack([rc, rs, d0, d1, d2], axis=-1)], axis=-1)


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


def sosfilt_stream_vjp_plain(coeffs, x, zi, gy, gzf=None):
    """The analytic adjoint of :func:`sosfilt_stream_scan` in plain PyTorch
    (``signals_tpu.compiler.filters``' custom VJP of the cascade, in stream
    form): the cotangents ``(gcoeffs (nsec, ch, 11), gx (n, ch), gzi (nsec,
    2, ch))`` of the inputs, in the order of the backward kernels' entries,
    from ``gy`` ``(n, ch)``, the output's cotangent, and ``gzf`` ``(nsec, 2,
    ch)`` (None: zero), the end state's.

    Per section, with ``R = [[rc, -rs], [rs, rc]]``, the lagged state
    ``s_{t-1}`` and the section's input ``v_t``: the adjoint state ``λ_t``
    (the cotangent of the state after row ``t``) starts at ``gzf`` and runs
    backwards, ``λ_{t-1} = Rᵀ λ_t + (d1, d2) ȳ_t``; ``v̄_t = d0 ȳ_t + λ1_t``
    is the cotangent of the section's input, the previous section's ``ȳ``;
    ``r̄c = Σ λ1_t s1_{t-1} + λ2_t s2_{t-1}``, ``r̄s = Σ λ2_t s1_{t-1} -
    λ1_t s2_{t-1}``, ``d̄k = Σ ȳ_t (v_t, s1_{t-1}, s2_{t-1})``; the state
    left after row 0 is ``gzi``.  Columns 0-5 of ``gcoeffs`` (the b/a form,
    which no kernel reads) stay zero.  A loop over frames, forward to
    record the states and backward for ``λ``: the plain version every
    backward kernel is held to."""
    nsec, n = coeffs.shape[0], x.shape[0]
    ch = max(coeffs.shape[1], x.shape[1], zi.shape[-1], gy.shape[-1])
    dev = x.device
    v = torch.broadcast_to(x, (n, ch))
    ins, lagged = [], []
    for s in range(nsec):
        rc, rs, d0, d1, d2 = (torch.broadcast_to(p, (ch,))
                              for p in _coupled_params(coeffs, s))
        s1 = torch.broadcast_to(zi[s, 0], (ch,))
        s2 = torch.broadcast_to(zi[s, 1], (ch,))
        ys, p1, p2 = [], [], []
        for t in range(n):
            p1.append(s1)
            p2.append(s2)
            ys.append(d0 * v[t] + d1 * s1 + d2 * s2)
            s1, s2 = rc * s1 - rs * s2 + v[t], rs * s1 + rc * s2
        ins.append(v)
        lagged.append((torch.stack(p1), torch.stack(p2)) if n else (v, v))
        v = torch.stack(ys) if n else v
    g = torch.broadcast_to(gy, (n, ch))
    gco = torch.zeros((nsec, ch, 11), dtype=torch.float32, device=dev)
    gzi = torch.zeros((nsec, 2, ch), dtype=torch.float32, device=dev)
    for s in range(nsec - 1, -1, -1):
        rc, rs, d0, d1, d2 = (torch.broadcast_to(p, (ch,))
                              for p in _coupled_params(coeffs, s))
        if gzf is None:
            l1 = l2 = torch.zeros((ch,), dtype=torch.float32, device=dev)
        else:
            l1 = torch.broadcast_to(gzf[s, 0], (ch,))
            l2 = torch.broadcast_to(gzf[s, 1], (ch,))
        i1, i2 = d1 * g, d2 * g
        lam1, lam2 = [None] * n, [None] * n
        for t in range(n - 1, -1, -1):
            lam1[t], lam2[t] = l1, l2
            l1, l2 = rc * l1 + rs * l2 + i1[t], rc * l2 - rs * l1 + i2[t]
        gzi[s, 0], gzi[s, 1] = l1, l2
        if not n:
            continue
        L1, L2 = torch.stack(lam1), torch.stack(lam2)
        S1, S2 = lagged[s]
        gco[s, :, 6] = (L1 * S1 + L2 * S2).sum(0)
        gco[s, :, 7] = (L2 * S1 - L1 * S2).sum(0)
        gco[s, :, 8] = (g * ins[s]).sum(0)
        gco[s, :, 9] = (g * S1).sum(0)
        gco[s, :, 10] = (g * S2).sum(0)
        g = d0 * g + L1
    return gco, g, gzi


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
