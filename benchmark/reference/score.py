"""Plain reference of the ``score`` configuration: its mix, and the loss
and the cutoff's gradient of a fit of that mix.

Notes arrive as ``(start_s, dur_s, hz, velocity)``, as the program gets
them; the reference allocates the voices itself.  Each voice: a sawtooth at the
voice's pitch (the latest note started at the block's first frame) into
an order-2 Butterworth low-pass at a fixed cutoff, each block filtered
from zero state over its ``context`` frames before it; times a linear ADSR
gated by the voice's notes (sampled a block); times the velocity of the
latest note started at each frame; summed over the voices.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import plain

#: blocks of envelope history run before the first rendered block
ENV_LEAD = 128
#: blocks filtered together (bounds the reference's memory)
CHUNK = 1024


def tracks(cfg: dict, notes) -> dict:
    """The voices' notes as padded float32 arrays ``(V, E)``: ``starts``,
    ``ends`` (frames; pads at +inf), ``hz``, ``vel``, and each voice's first
    ``hz`` / ``vel`` (0 for a silent voice)."""
    rate = cfg['rate']
    voices = plain.allocate(notes, cfg['voices'], cfg['release'])
    E = max(1, max(len(v) for v in voices))
    V = len(voices)
    out = {k: np.full((V, E), np.inf if k in ('starts', 'ends') else 0.0,
                      np.float32) for k in ('starts', 'ends', 'hz', 'vel')}
    first = {'hz': np.zeros(V, np.float32), 'vel': np.zeros(V, np.float32)}
    for i, voice in enumerate(voices):
        for j, (start, dur, hz, vel) in enumerate(voice):
            out['starts'][i, j] = start * rate
            out['ends'][i, j] = (start + dur) * rate
            out['hz'][i, j] = hz
            out['vel'][i, j] = vel
        if voice:
            first['hz'][i], first['vel'][i] = voice[0][2], voice[0][3]
    out['first_hz'], out['first_vel'] = first['hz'], first['vel']
    return out


def _gates(tr: dict, frames: np.ndarray) -> np.ndarray:
    """``(len(frames), V)`` bool: a note of the voice holds the frame
    (``start <= n < end``; a note with ``end <= start`` never does)."""
    n = frames.astype(np.float32)[:, None, None]
    s, e = tr['starts'][None], tr['ends'][None]
    return ((n >= s) & (n < e) & (e > s)).any(axis=2)


def mix(cfg: dict, inputs: dict, position: int, n_blocks: int, device,
        dtype=torch.float64, cutoffs=None) -> torch.Tensor:
    """The mix of blocks ``position / F ..`` (``n_blocks`` of them):
    ``(n_blocks F,)`` in ``dtype``; with ``cutoffs`` (a list of Hz) one mix
    per cutoff, ``(len(cutoffs), n_blocks F)``, the configuration's cutoff
    otherwise."""
    F, C, rate = cfg['block_frames'], cfg['context'], cfg['rate']
    tr = inputs.get('tracks') or tracks(cfg, inputs['notes'])
    inputs['tracks'] = tr
    cuts = [cfg['cutoff_hz']] if cutoffs is None else list(cutoffs)
    b0 = position // F
    V = tr['starts'].shape[0]
    dev = torch.device(device)
    co = plain.lowpass_coupled(torch.tensor(cuts), rate, dtype).to(dev)
    rc, rs, d0, d1, d2 = (co[:, j].reshape(-1, 1, 1) for j in range(5))
    # pitch at each block's first frame, from the first block a context
    # window reaches back to
    back = -(-C // F)
    lo = b0 - back
    starts = torch.as_tensor(tr['starts'], device=dev)
    pitch = plain.held_values(
        starts, torch.as_tensor(tr['hz'], device=dev),
        torch.as_tensor(tr['first_hz'], device=dev),
        (torch.arange(lo, b0 + n_blocks, device=dev, dtype=torch.float32)
         * F).expand(V, -1))                                  # (V, nbt)
    # envelope edge state per block, from well before the first block
    first = max(0, b0 - ENV_LEAD)
    gate = _gates(tr, np.arange(first, b0 + n_blocks) * F)
    adsr = plain.adsr_params(*cfg['adsr'], rate)
    states = plain.adsr_states(gate, F, first, adsr)
    out = torch.empty((len(cuts), n_blocks * F), dtype=dtype, device=dev)
    for c0 in range(0, n_blocks, CHUNK):
        nb = min(CHUNK, n_blocks - c0)
        blocks = torch.arange(b0 + c0, b0 + c0 + nb, device=dev)
        env = plain.adsr_frames(states, slice(b0 + c0 - first,
                                              b0 + c0 + nb - first),
                                F, first, adsr, dev, dtype)   # (nb F, V)
        frames = (blocks * F).reshape(-1, 1) + torch.arange(F, device=dev)
        vel = plain.held_values(
            starts, torch.as_tensor(tr['vel'], device=dev),
            torch.as_tensor(tr['first_vel'], device=dev),
            frames.reshape(1, -1).to(torch.float32).expand(V, -1))
        w = (env.T * vel.to(dtype)).reshape(V, nb, F)         # (V, nb, F)
        s1 = torch.zeros((len(cuts), V, nb), dtype=dtype, device=dev)
        s2 = torch.zeros_like(s1)
        y_out = torch.empty((len(cuts), nb, F), dtype=dtype, device=dev)
        for t in range(C + F):
            f = blocks * F + (t - C)                          # (nb,)
            hz = pitch[:, torch.clamp(f // F - lo, min=0)]    # (V, nb)
            x = plain.saw(f[None, :], hz, rate).to(dtype)
            y = d0 * x + d1 * s1 + d2 * s2
            s1, s2 = rc * s1 - rs * s2 + x, rs * s1 + rc * s2
            if t >= C:
                y_out[:, :, t - C] = (y * w[None, :, :, t - C]).sum(dim=1)
        out[:, c0 * F:(c0 + nb) * F] = y_out.reshape(len(cuts), -1)
    return out[0] if cutoffs is None else out


#: the name of the fitted leaf, the shared cutoff
LEAF = 'cutoff'


def loss_and_grad(cfg: dict, inputs: dict, p: dict, n_blocks: int,
                  target: torch.Tensor, device, dtype=torch.float64,
                  rel_step: float = 1e-4) -> tuple[float, dict]:
    """The spectral loss of the mix at the cutoff ``p[LEAF]`` (one
    element) against ``target`` (the reference's own mix at the target
    cutoff) over blocks ``0 .. n_blocks - 1``, and its derivative in the
    cutoff by a central difference of ``rel_step`` of the cutoff."""
    cutoff = float(np.asarray(p[LEAF]).reshape(-1)[0])
    h = rel_step * abs(cutoff)
    m = mix(cfg, inputs, 0, n_blocks, device, dtype,
            cutoffs=[cutoff, cutoff - h, cutoff + h])
    tgt = target.to(dtype)
    lo, mid, hi = (float(plain.spectral_loss(m[i], tgt)) for i in (1, 0, 2))
    return mid, {LEAF: np.array([(hi - lo) / (2 * h)])}


def fit_problem(cfg: dict, inputs: dict, traffic: dict, device,
                dtype=torch.float64) -> tuple[dict, torch.Tensor]:
    """The fit's start, ``{LEAF: [start_hz]}``, and its target: the mix at
    ``target_hz`` over the traffic's blocks."""
    target = mix(cfg, inputs, 0, traffic['blocks'], device, dtype,
                 cutoffs=[traffic['target_hz']])[0]
    return {LEAF: np.array([traffic['start_hz']], np.float64)}, target


def fit_reference(cfg: dict, inputs: dict, traffic: dict, p0: dict,
                  at: list, device, dtype=torch.float64) -> dict:
    """What the reference makes of the fit: ``first_steps`` Adam steps
    from ``p0`` (their losses, gradients and the parameters visited) and
    the loss and gradient at each parameters in ``at``."""
    n = traffic['blocks']
    _, target = fit_problem(cfg, inputs, traffic, device, dtype)
    cache = {}

    def lg(p):
        key = tuple((k, np.asarray(v, np.float64).tobytes())
                    for k, v in sorted(p.items()))
        if key not in cache:
            cache[key] = loss_and_grad(cfg, inputs, p, n, target, device,
                                       dtype)
        return cache[key]

    ps, gs = plain.adam(p0, lambda p: lg(p)[1], traffic['first_steps'],
                        traffic['learning_rate'], traffic['relative_lr'])
    return {'params': ps, 'grads': gs,
            'losses': [lg(p)[0] for p in ps[:-1]],
            'at': [lg(p) for p in at]}
