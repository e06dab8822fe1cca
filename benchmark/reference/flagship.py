"""Plain reference of the ``flagship`` configuration's mix.

Each voice: a sawtooth at its own pitch into an order-2 Butterworth
low-pass whose cutoff ``0.5 (depth sin(2 pi lfo t)) + 0.5 centre`` is
sampled at each block's first frame; the state restarts from zero at every
``carry_blocks``-block segment (segments on absolute multiples), warms up
over the ``context`` frames before it under the segment's first block's
coefficients, then runs the segment's blocks, each under its own; times a
linear ADSR gated by a square wave (on while it is positive, sampled a
block); times ``1 / voices``; summed over the voices.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import plain

#: blocks of envelope history run before the first rendered block
ENV_LEAD = 128


def cutoffs(cfg: dict, blocks: torch.Tensor) -> torch.Tensor:
    """The cutoff (Hz, float64) at the first frame of each block."""
    F, rate = cfg['block_frames'], cfg['rate']
    t = plain.phase_f32(blocks * F, cfg['lfo_hz'], rate).to(torch.float64)
    lfo = torch.sin(2.0 * np.pi * t)
    return 0.5 * (cfg['depth_hz'] * lfo) + 0.5 * cfg['cutoff_hz']


def envelope(cfg: dict, b0: int, n: int, device, dtype) -> torch.Tensor:
    """The envelope at every frame of blocks ``b0 .. b0 + n - 1``: ``(n F,
    1)``."""
    F, rate = cfg['block_frames'], cfg['rate']
    first = max(0, b0 - ENV_LEAD)
    blocks = torch.arange(first, b0 + n, dtype=torch.int64)
    ph = plain.phase_f32(blocks * F, cfg['gate_hz'], rate)
    gate = (torch.sign(0.5 - ph) > 0.5).numpy()[:, None]
    adsr = plain.adsr_params(*cfg['adsr'], rate)
    states = plain.adsr_states(gate, F, first, adsr)
    return plain.adsr_frames(states, slice(b0 - first, None), F, first, adsr,
                             device, dtype)


def mix(cfg: dict, inputs: dict, position: int, n_blocks: int, device,
        dtype=torch.float64) -> torch.Tensor:
    """The mix of blocks ``position / F ..`` (``n_blocks`` of them, both on
    the segment grid): ``(n_blocks F,)`` in ``dtype``.  ``inputs['hz']``:
    the voices' pitches (float32)."""
    F, C, M = cfg['block_frames'], cfg['context'], cfg['carry_blocks']
    rate = cfg['rate']
    b0 = position // F
    if position % F or b0 % M or n_blocks % M:
        raise ValueError('the reference renders whole carry segments')
    hz = torch.as_tensor(np.asarray(inputs['hz'], np.float32),
                         device=device)[None, :]               # (1, V)
    V = hz.shape[1]
    S = n_blocks // M
    blocks = torch.arange(b0, b0 + n_blocks, dtype=torch.int64)
    co = plain.lowpass_coupled(cutoffs(cfg, blocks), rate, dtype).to(device)
    co = co.reshape(S, M, 5)
    seg0 = (b0 + M * torch.arange(S, device=device)) * F       # (S,)
    s1 = torch.zeros((S, V), dtype=dtype, device=device)
    s2 = torch.zeros_like(s1)
    out = torch.empty((S, M * F), dtype=dtype, device=device)
    for t in range(C + M * F):
        k = max(0, t - C) // F
        rc, rs, d0, d1, d2 = (co[:, k, j:j + 1] for j in range(5))
        x = plain.saw((seg0 + (t - C))[:, None], hz, rate).to(dtype)
        y = d0 * x + d1 * s1 + d2 * s2
        s1, s2 = rc * s1 - rs * s2 + x, rs * s1 + rc * s2
        if t >= C:
            out[:, t - C] = y.sum(dim=1)
    env = envelope(cfg, b0, n_blocks, device, dtype)[:, 0]
    return out.reshape(-1) * env / V
