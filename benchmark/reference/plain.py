"""Plain PyTorch building blocks of the references: the sawtooth, the
order-2 Butterworth low-pass in coupled form, the gated ADSR, note
allocation and the sequencer tracks, the spectral loss and Adam over
leaves.

Written from the documented semantics of the synthesizer (oscillator phase
as ``frac(frame * f32(1/rate) * hz)`` in float32, filter coefficients per
block from the cutoff sampled at the block's first frame, a state that
restarts from zero at each segment and warms up over the context window,
the envelope's gate sampled once a block).  The signal path runs in
``dtype``: float64 for the reference, a lower precision for the control.
Nothing here imports the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F32 = torch.float32


def inv_rate(rate: int) -> float:
    """``1/rate`` rounded to float32 once, on the host (a float32 tensor
    times it rounds each product to float32)."""
    return float(np.float32(1.0 / rate))


def frac(x):
    return x - torch.floor(x)


def saw(frames: torch.Tensor, hz: torch.Tensor, rate: int) -> torch.Tensor:
    """The sawtooth at integer ``frames`` (any shape broadcasting with
    ``hz``), float32, zero at negative frames: ``2 frac(t - 1/2) - 1`` with
    ``t = frac(frac(frame * f32(1/rate) * hz))``, every operation rounded
    to float32 in this order."""
    f = frames.to(F32)
    t = frac(frac(f * inv_rate(rate) * hz))
    y = 2.0 * frac(t - 0.5) - 1.0
    return torch.where(frames >= 0, y, torch.zeros((), device=y.device))


def phase_f32(frames: torch.Tensor, hz: float, rate: int) -> torch.Tensor:
    """``frac(frame * f32(1/rate) * hz)`` in float32 (an LFO's or a gate's
    phase at the blocks' first frames)."""
    f = frames.to(F32)
    return frac(frac(f * inv_rate(rate) * float(np.float32(hz))))


def lowpass_coupled(cutoff: torch.Tensor, rate: int, dtype) -> torch.Tensor:
    """Order-2 Butterworth low-pass by the bilinear transform, designed in
    float64 from ``cutoff`` (Hz, any shape; clipped to (1e-5, 1 - 1e-5) of
    Nyquist): ``(..., 5)`` coupled-form taps ``(rc, rs, d0, d1, d2)`` in
    ``dtype``.  ``y = d0 x + d1 s1 + d2 s2``, ``s1' = rc s1 - rs s2 + x``,
    ``s2' = rs s1 + rc s2`` realises ``(b0 + b1/z + b2/z^2) / (1 + a1/z +
    a2/z^2)``."""
    nyq = float(np.float32(rate) * np.float32(0.5))
    wn = torch.clamp(cutoff.to(torch.float64) / nyq, 1e-5, 1.0 - 1e-5)
    c = torch.tan((math.pi / 2) * wn)
    c2 = c * c
    d = 1.0 + math.sqrt(2.0) * c + c2
    a1 = 2.0 * (c2 - 1.0) / d
    a2 = (1.0 - math.sqrt(2.0) * c + c2) / d
    b0 = c2 / d
    b1 = 2.0 * b0
    b2 = b0
    rc = -0.5 * a1
    rs = torch.sqrt(torch.clamp(a2 - 0.25 * a1 * a1, min=1e-300))
    d1 = b1 - a1 * b0
    d2 = (b2 - a2 * b0 + rc * d1) / rs
    return torch.stack([rc, rs, b0, d1, d2], dim=-1).to(dtype)


def adsr_params(attack, decay, sustain, release, rate: int):
    """The envelope's stage lengths in frames, as float32 products floored
    at one frame, and the sustain level."""
    def frames(s):
        return max(float(np.float32(s) * np.float32(rate)), 1.0)
    return frames(attack), frames(decay), float(np.float32(sustain)), \
        frames(release)


def adsr_states(gate: np.ndarray, block_frames: int, first_block: int,
                adsr) -> dict:
    """The envelope's edge state for each block: ``gate`` ``(nb, L)`` bool,
    the gate at the first frame of blocks ``first_block ..``.  A rising
    edge restarts the attack from the envelope's level at the block's
    first frame, a falling edge starts the release from it.  Starts with
    the gate off and no edge seen.  Returns float64 numpy ``(nb, L)``
    arrays ``gate``, ``t_on``, ``t_off``, ``lv_on``, ``lv_off``."""
    nb, lanes = gate.shape
    prev = np.zeros(lanes, bool)
    t_on = np.full(lanes, -1e9)
    t_off = np.full(lanes, -1e9)
    lv_on = np.zeros(lanes)
    lv_off = np.zeros(lanes)
    out = {k: np.empty((nb, lanes)) for k in
           ('gate', 't_on', 't_off', 'lv_on', 'lv_off')}
    for i in range(nb):
        pos = float((first_block + i) * block_frames)
        g = gate[i]
        now = _adsr_value(np, pos, prev, t_on, t_off, lv_on, lv_off, *adsr)
        rise, fall = g & ~prev, ~g & prev
        t_on = np.where(rise, pos, t_on)
        lv_on = np.where(rise, now, lv_on)
        t_off = np.where(fall, pos, t_off)
        lv_off = np.where(fall, now, lv_off)
        prev = g
        for k, v in (('gate', g), ('t_on', t_on), ('t_off', t_off),
                     ('lv_on', lv_on), ('lv_off', lv_off)):
            out[k][i] = v
    return out


def _adsr_value(xp, t, on, t_on, t_off, lv_on, lv_off, A, D, S, R):
    dt = t - t_on
    attack = lv_on + (1.0 - lv_on) * (dt / A)
    decay = 1.0 - (1.0 - S) * ((dt - A) / D)
    on_v = xp.where(dt < A, attack, xp.where(dt < A + D, decay, S))
    off_v = lv_off * xp.maximum(0.0 * t, 1.0 - (t - t_off) / R)
    return xp.where(on, on_v, off_v)


def adsr_frames(states: dict, blocks: slice, block_frames: int,
                first_block: int, adsr, device, dtype) -> torch.Tensor:
    """The envelope at every frame of ``blocks`` (indices into ``states``):
    ``(n * F, L)`` in ``dtype``."""
    st = {k: torch.as_tensor(v[blocks], dtype=torch.float64, device=device)
          for k, v in states.items()}
    n = st['gate'].shape[0]
    b0 = first_block + (blocks.start or 0)
    t = ((b0 * block_frames + torch.arange(n * block_frames, device=device,
                                           dtype=torch.float64))
         .reshape(n, block_frames, 1))
    env = _adsr_value(torch, t, st['gate'][:, None] > 0.5,
                      st['t_on'][:, None], st['t_off'][:, None],
                      st['lv_on'][:, None], st['lv_off'][:, None], *adsr)
    return env.reshape(n * block_frames, -1).to(dtype)


def allocate(notes, n_voices: int, release: float) -> list:
    """Greedy voice allocation of ``(start_s, dur_s, hz, velocity)`` notes:
    notes in order of start then pitch; a voice is busy until its note's
    end plus ``release``; the idle voice freed last takes the next note,
    and with none idle the voice that frees first is taken, its held note
    cut at the new start (kept at least 1e-6 s)."""
    voices = [[] for _ in range(n_voices)]
    free = [float('-inf')] * n_voices
    for note in sorted(notes, key=lambda n: (n[0], n[2])):
        start, dur = note[0], note[1]
        idle = [i for i in range(n_voices) if free[i] <= start]
        if idle:
            i = max(idle, key=lambda j: free[j])
        else:
            i = min(range(n_voices), key=lambda j: free[j])
            last = voices[i][-1]
            if last[0] + last[1] > start:
                voices[i][-1] = (last[0], max(start - last[0], 1e-6),
                                 last[2], last[3])
        voices[i].append(note)
        free[i] = start + dur + release
    return voices


def held_values(starts: torch.Tensor, values: torch.Tensor,
                first: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
    """Sample and hold: per voice the value of the latest note started at
    or before each frame (the first of notes that start together),
    ``first`` before any: ``starts`` ``(V, E)``
    sorted (pad +inf), ``values`` ``(V, E)``, ``first`` ``(V,)``,
    ``frames`` ``(V, T)`` float32; returns ``(V, T)``."""
    k = torch.searchsorted(starts, frames.contiguous(), right=True)
    last = torch.gather(starts, 1, torch.clamp(k - 1, min=0))
    tie = torch.searchsorted(starts, last.contiguous())   # first of equals
    got = torch.gather(values, 1, tie)
    return torch.where(k > 0, got, first[:, None])


def spectral_loss(pred: torch.Tensor, target: torch.Tensor,
                  fft_sizes=(256, 1024)) -> torch.Tensor:
    """Mean squared error plus, for each size ``n``, the mean absolute
    difference of the magnitude spectra of Hann-windowed (symmetric)
    frames at hop ``n / 2``, averaged over the sizes.  1-D inputs; a
    precision below float32 is raised to it (there is no FFT in it)."""
    if pred.dtype in (torch.bfloat16, torch.float16):
        pred, target = pred.float(), target.float()
    loss = torch.mean((pred - target) ** 2)
    for n in fft_sizes:
        if pred.shape[0] < n:
            continue
        win = torch.as_tensor(np.hanning(n), dtype=pred.dtype,
                              device=pred.device)
        ps = torch.fft.rfft(pred.unfold(0, n, n // 2) * win, dim=-1).abs()
        ts = torch.fft.rfft(target.unfold(0, n, n // 2) * win, dim=-1).abs()
        loss = loss + torch.mean(torch.abs(ps - ts)) / len(fft_sizes)
    return loss


def adam(p0: dict, grad_at, steps: int, learning_rate: float,
         relative: bool) -> tuple[list, list]:
    """``steps`` Adam steps of the leaves ``p0`` (``{name: float64
    array}``; b1 0.9, b2 0.999, eps 1e-8, bias-corrected; each element's
    step scaled by ``max(|p0|, 0.01)`` when ``relative``): ``(params
    visited, including the last; gradients)``.  ``grad_at(p)`` gives the
    gradient as leaves of the same names."""
    p = {k: np.asarray(v, np.float64) for k, v in p0.items()}
    scale = {k: np.maximum(np.abs(v), 0.01) if relative else np.ones_like(v)
             for k, v in p.items()}
    mu = {k: np.zeros_like(v) for k, v in p.items()}
    nu = {k: np.zeros_like(v) for k, v in p.items()}
    ps, gs = [p], []
    for count in range(1, steps + 1):
        g = {k: np.asarray(v, np.float64) for k, v in grad_at(p).items()}
        gs.append(g)
        nxt = {}
        for k in p:
            mu[k] = 0.1 * g[k] + 0.9 * mu[k]
            nu[k] = 0.001 * g[k] * g[k] + 0.999 * nu[k]
            u = (mu[k] / (1 - 0.9 ** count)) / (
                np.sqrt(nu[k] / (1 - 0.999 ** count)) + 1e-8)
            nxt[k] = p[k] - learning_rate * u * scale[k]
        p = nxt
        ps.append(p)
    return ps, gs
