"""Plain reference of the ``stems`` configuration: the voices' stems, and
the per-channel spectral loss of a fit of them and its gradient in every
voice's hertz, cutoff and gain.

Each voice (``bench.py:549-651``): two sines at its hertz times each of
``partials``, their phase ``frac(frame * f32(1/rate) * hz)`` in float32 (the
partial's hertz a float32 product), zero at frames before 0; crossfaded
``mix * first + (1 - mix) * second`` (the weights rounded to float32);
an order-2 Butterworth low-pass at the voice's cutoff, each block filtered
from zero state over the ``context`` frames before it; times the voice's
gain.  The loss: for each FFT size ``n``, the mean absolute difference of
the magnitude spectra of Hann-windowed (symmetric) frames at hop ``n / 2``
of every channel, plus that of their logarithms (``log(|X| + log_eps)``),
averaged over the sizes, plus ``waveform`` times the mean squared error.

Where it departs from the configuration as the program runs it:

* the sine is ``sin(2 pi phase)`` in ``dtype``; the program evaluates
  ``sin2pi``'s polynomial in float64 (within ~1e-9 of the sine) and casts
  its result to float32;
* the filter restarts from zero state at every block: the program's
  static-cutoff segments hold one block each at the cell's 517 blocks
  (no count from 2 to 8 divides it); at a block count that one does, the
  program warms up once a segment of that many blocks, which this
  reference does not model;
* the target is the reference's own stems at the target values; the
  program fits against its own float32 render of them.

The loss's value is given in the configuration's ``precision``
(float32): the stems rounded to it and the loss computed in it.  Float32's
rounding of the stems and of the FFT moves ``log(|X| + log_eps)`` in the
bins far below the partials, which raises the loss by ~0.5% at 12 s, the
size of a 1% fault; that rise is the configured loss's own, and float64's
value lacks it.  The gradient is ``torch.autograd``'s through the graph in
``dtype`` (float64 for the reference), the phase's derivative in a hertz
taken exactly (``frame * f32(1/rate)`` times the partial), not a central
difference as the score's reference takes: that would cost two renders of
all the voices a trainable, 384 here.  The stems are computed in chunks of
:data:`CHUNK` blocks, first without a graph for the loss's cotangent, then
again chunk by chunk to carry it back to the values, so the memory held is
a chunk's.

The check's leaves are the rows in units of the start's values,
``max(|start|, 0.01)`` an element, and a gradient leaf the gradient in
those units (the value's gradient times the unit); the Adam steps of
:func:`fit_reference` are taken on the values, as the program takes them.
Nothing here imports the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import plain

#: blocks filtered together (bounds the reference's memory)
CHUNK = 128
#: the fit's leaves, ``voices`` elements each
ROWS = ('hz', 'cutoff', 'gain')
#: the least unit of a leaf's element
FLOOR = 0.01


def units(inputs: dict) -> dict:
    """Each element's unit in the leaves, ``max(|start|, FLOOR)``."""
    return {r: np.maximum(np.abs(np.asarray(inputs['start'][r],
                                            np.float64)), FLOOR)
            for r in ROWS}


def leaves(values: dict, unit: dict) -> dict:
    """The values ``{row: (V,)}`` as float64 leaves of the same names, in
    ``unit``."""
    return {r: np.asarray(values[r], np.float64).reshape(-1) / unit[r]
            for r in ROWS}


def values_of(p: dict, unit: dict) -> dict:
    """The values of the leaves ``p``."""
    return {r: np.asarray(p[r], np.float64) * unit[r] for r in ROWS}


def _f32(x: float) -> float:
    return float(np.float32(x))


def source(cfg: dict, hz: torch.Tensor, frames: torch.Tensor,
           dtype) -> torch.Tensor:
    """The crossfaded partials at integer ``frames`` ``(T,)`` for the
    hertz ``hz`` ``(V,)`` (float64, may require grad): ``(T, V)`` in
    ``dtype``, zero at frames before 0.  The phase's value is float32's;
    its derivative in ``hz`` is ``partial * f32(frame * f32(1/rate))``."""
    t32 = (frames.to(plain.F32) * plain.inv_rate(cfg['rate']))[:, None]
    t64 = t32.to(torch.float64)
    w = _f32(cfg['mix'])
    weights = (w, _f32(np.float32(1.0) - np.float32(cfg['mix'])))
    x = 0.0
    for k, wk in zip(cfg['partials'], weights):
        hz32 = hz.detach().to(plain.F32) * _f32(k)
        phase = plain.frac(plain.frac(t32 * hz32)).to(torch.float64)
        phase = phase + (hz - hz.detach()) * (k * t64)
        x = x + wk * torch.sin(2.0 * math.pi * phase.to(dtype))
    return torch.where(frames[:, None] >= 0, x,
                       torch.zeros((), dtype=dtype, device=x.device))


def stems(cfg: dict, rows: dict, first: int, n_blocks: int, device,
          dtype=torch.float64) -> torch.Tensor:
    """Blocks ``first .. first + n_blocks - 1`` of every voice's stem at
    the values ``rows`` (``{row: float64 tensor (V,)}``, which may require
    grad): ``(n_blocks F, V)`` in ``dtype``."""
    F, C = cfg['block_frames'], cfg['context']
    dev = torch.device(device)
    frames = torch.arange(first * F - C, (first + n_blocks) * F, device=dev)
    x = source(cfg, rows['hz'], frames, dtype)            # (C + nF, V)
    # each block's window of C + F frames, one (V, nb) slice a row
    xw = x.unfold(0, C + F, F).permute(2, 1, 0).unbind(0)
    rc, rs, d0, d1, d2 = (c[:, None] for c in plain.lowpass_coupled(
        rows['cutoff'], cfg['rate'], dtype).unbind(-1))
    s1 = torch.zeros((x.shape[1], n_blocks), dtype=dtype, device=dev)
    s2 = torch.zeros_like(s1)
    out = []
    for t in range(C + F):
        xt = xw[t]
        if t >= C:
            out.append(d0 * xt + d1 * s1 + d2 * s2)
        s1, s2 = rc * s1 - rs * s2 + xt, rs * s1 + rc * s2
    y = torch.stack(out, dim=2)                           # (V, nb, F)
    y = y * rows['gain'].to(dtype)[:, None, None]
    return y.permute(1, 2, 0).reshape(n_blocks * F, -1)


def mix(cfg: dict, inputs: dict, position: int, n_blocks: int, device,
        dtype=torch.float64, rows=None) -> torch.Tensor:
    """The stems of blocks ``position / F ..`` (``n_blocks``) at ``rows``
    (default: the inputs' target values), ``(n_blocks F, V)`` in
    ``dtype``, computed in chunks without a graph."""
    rows = inputs['target'] if rows is None else rows
    dev = torch.device(device)
    r = {k: torch.as_tensor(v, dtype=torch.float64, device=dev)
         for k, v in rows.items()}
    b0 = position // cfg['block_frames']
    with torch.no_grad():
        return torch.cat([stems(cfg, r, b0 + c0, min(CHUNK, n_blocks - c0),
                                dev, dtype)
                          for c0 in range(0, n_blocks, CHUNK)])


def spectral_loss(cfg: dict, pred: torch.Tensor,
                  target: torch.Tensor) -> torch.Tensor:
    """The configuration's per-channel loss of ``pred`` against ``target``
    (``(T, V)``); a precision below float32 is raised to it (there is no
    FFT in it)."""
    c = cfg['loss']
    if pred.dtype in (torch.bfloat16, torch.float16):
        pred, target = pred.float(), target.float()
    loss = c['waveform'] * torch.mean((pred - target) ** 2)
    for n in c['fft_sizes']:
        if pred.shape[0] < n:
            continue
        win = torch.as_tensor(np.hanning(n), dtype=pred.dtype,
                              device=pred.device)[None, :, None]

        def mags(x):
            frames = x.unfold(0, n, n // 2).permute(0, 2, 1)  # (nfr, n, V)
            return torch.fft.rfft(frames * win, dim=1).abs()

        ps, ts = mags(pred), mags(target)
        eps = c['log_eps']
        loss = loss + (torch.mean(torch.abs(ps - ts))
                       + torch.mean(torch.abs(torch.log(ps + eps)
                                              - torch.log(ts + eps)))
                       ) / len(c['fft_sizes'])
    return loss


def value_and_grad(cfg: dict, inputs: dict, values: dict, n_blocks: int,
                   target: torch.Tensor, device,
                   dtype=torch.float64) -> tuple[float, dict]:
    """The loss of the stems at ``values`` (``{row: (V,)}``) against
    ``target`` over blocks ``0 .. n_blocks - 1``, in the configuration's
    precision, and its gradient in the values, ``{row: float64 (V,)}``
    (``torch.autograd`` in ``dtype``; see the module's text)."""
    dev = torch.device(device)
    F = cfg['block_frames']
    rows = {k: torch.as_tensor(np.asarray(values[k], np.float64),
                               device=dev).requires_grad_() for k in ROWS}
    pred = mix(cfg, inputs, 0, n_blocks, dev, dtype, rows).requires_grad_()
    precision = getattr(torch, cfg['precision'])
    with torch.no_grad():
        value = spectral_loss(cfg, pred.to(precision), target.to(precision))
    (gy,) = torch.autograd.grad(
        spectral_loss(cfg, pred, target.to(pred.dtype)), pred)
    grads = {k: torch.zeros_like(v) for k, v in rows.items()}
    for c0 in range(0, n_blocks, CHUNK):
        nb = min(CHUNK, n_blocks - c0)
        y = stems(cfg, rows, c0, nb, dev, dtype)
        got = torch.autograd.grad(y, list(rows.values()),
                                  grad_outputs=gy[c0 * F:(c0 + nb) * F])
        for k, g in zip(rows, got):
            grads[k] += g
    return float(value), {k: g.cpu().numpy() for k, g in grads.items()}


def loss_and_grad(cfg: dict, inputs: dict, p: dict, n_blocks: int,
                  target: torch.Tensor, device,
                  dtype=torch.float64) -> tuple[float, dict]:
    """:func:`value_and_grad` at the leaves ``p``, the gradient as leaves
    of the same names (in the leaves' units)."""
    unit = units(inputs)
    value, g = value_and_grad(cfg, inputs, values_of(p, unit), n_blocks,
                              target, device, dtype)
    return value, {k: g[k] * unit[k] for k in ROWS}


def fit_problem(cfg: dict, inputs: dict, traffic: dict, device,
                dtype=torch.float64) -> tuple[dict, torch.Tensor]:
    """The fit's start (the inputs' start values as leaves) and its
    target: the stems at the inputs' target values over the traffic's
    blocks."""
    target = mix(cfg, inputs, 0, traffic['blocks'], device, dtype)
    return leaves(inputs['start'], units(inputs)), target


def fit_reference(cfg: dict, inputs: dict, traffic: dict, p0: dict,
                  at: list, device, dtype=torch.float64) -> dict:
    """What the reference makes of the fit: ``first_steps`` Adam steps
    from the leaves ``p0``, taken on the values (their losses, the
    gradients and the parameters visited, as leaves) and the loss and
    gradient at each leaves in ``at``."""
    n = traffic['blocks']
    unit = units(inputs)
    _, target = fit_problem(cfg, inputs, traffic, device, dtype)
    cache = {}

    def vg(v):
        key = tuple((k, np.asarray(v[k], np.float64).tobytes())
                    for k in ROWS)
        if key not in cache:
            cache[key] = value_and_grad(cfg, inputs, v, n, target, device,
                                        dtype)
        return cache[key]

    vs, gs = plain.adam(values_of(p0, unit), lambda v: vg(v)[1],
                        traffic['first_steps'], traffic['learning_rate'],
                        traffic['relative_lr'])

    def grad_leaves(g):
        return {k: g[k] * unit[k] for k in ROWS}

    return {'params': [leaves(v, unit) for v in vs],
            'grads': [grad_leaves(g) for g in gs],
            'losses': [vg(v)[0] for v in vs[:-1]],
            'at': [(vg(v)[0], grad_leaves(vg(v)[1]))
                   for v in (values_of(p, unit) for p in at)]}
