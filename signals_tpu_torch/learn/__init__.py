"""Differentiable synthesis: fit patch parameters to target audio
(``signals_tpu.learn``).

The rendered audio is differentiable with respect to every float traced
parameter (oscillator frequencies, constants, envelope times, filter
cutoffs through the closed-form Butterworth design and the cascade): each
kernel entry of :mod:`signals_tpu_torch.compiler.kernels` runs as a
``torch.autograd.Function`` whose backward is the analytic adjoint of the
cascade (on a GPU the hand-written kernels of ``csrc/adjoint.cu``), and
every other step of a render is a PyTorch operation autograd records.
:func:`fit` runs Adam on selected parameters against a target waveform.

The JAX package jits ``K`` optimizer steps into one ``lax.scan`` dispatch
and caches the compiled chunk across calls.  Eager PyTorch compiles
nothing, so here a chunk of ``K`` steps is a Python loop whose losses stay
on the device and are copied off once per chunk, and there is no chunk
cache.
"""

from __future__ import annotations

import functools
import typing

import numpy as np
import torch

from signals_tpu_torch.compiler import CompiledPatch, compile_node
from signals_tpu_torch.graph import Emitter

F32 = np.float32

#: Adam's constants (``optax.adam``'s defaults) as float32: the JAX
#: package injects them as f32 hyperparameters, so ``1 - b1`` and ``b1 **
#: count`` round in f32 (and the first step is exactly ``-lr``)
B1, B2, EPS = F32(0.9), F32(0.999), F32(1e-8)
#: the floor of a parameter's magnitude under ``relative_lr``
REL_FLOOR = 0.01


@functools.lru_cache(maxsize=None)
def _hanning(n: int, device: str) -> torch.Tensor:
    """numpy's symmetric Hann window (``jnp.hanning``): ``0.5 - 0.5 cos(2 pi
    k / (n - 1))``, computed in float64 and rounded once, on ``device``.
    (``torch.hann_window`` defaults to the periodic window.)"""
    return torch.as_tensor(np.hanning(n).astype(F32), device=device)


def _frames_half_hop(x, n: int):
    """Frame a 1-D signal into ``(frames, n)`` windows at hop ``n // 2``
    without a gather: the even-offset windows are one reshape, the
    odd-offset windows one shifted reshape.  The frames come evens then
    odds (the JAX package's order); every consumer reduces over frames, so
    only the order of the f32 sums depends on it."""
    T = x.shape[0]
    hop = n // 2
    n_even = (T - n) // n + 1
    even = x[:n_even * n].reshape(n_even, n)
    if T - hop >= n:
        n_odd = (T - hop - n) // n + 1
        odd = x[hop:hop + n_odd * n].reshape(n_odd, n)
        return torch.cat([even, odd], dim=0)
    return even


def spectral_loss(pred, target, *, fft_sizes=(256, 1024), waveform=1.0):
    """Multi-resolution magnitude-spectrum L1 plus waveform L2.  A
    multichannel signal contributes its channel mean (the mono mix) to the
    spectral term; the waveform L2 stays per channel.  For frequency
    estimation set ``waveform`` to 0 (``functools.partial(spectral_loss,
    waveform=0.0)`` as ``fit``'s ``loss``): a detuned oscillator's
    waveform-L2 gradient oscillates with the beat phase."""
    loss = waveform * torch.mean((pred - target) ** 2)
    pm = pred.mean(dim=1)
    tm = target.mean(dim=1)
    for n in fft_sizes:
        if pred.shape[0] < n:
            continue
        win = _hanning(n, str(pred.device))
        ps = torch.fft.rfft(_frames_half_hop(pm, n) * win, dim=-1).abs()
        ts = torch.fft.rfft(_frames_half_hop(tm, n) * win, dim=-1).abs()
        loss = loss + torch.mean(torch.abs(ps - ts)) / len(fft_sizes)
    return loss


def per_channel_spectral_loss(pred, target, *, fft_sizes=(1024, 4096),
                              waveform: float = 0.0,
                              log_eps: float = 1e-4):
    """Multi-resolution magnitude and log-magnitude spectral L1 computed per
    channel: the stem-matching loss for per-voice parameter recovery (the
    mix spectrum of :func:`spectral_loss` cannot separate voices).  Keep
    ``waveform`` at 0 when frequencies are trainable.

    The frames (hop ``n // 2``, in order) are an ``unfold`` view: the JAX
    package gathers them, and a gather's backward on a GPU accumulates with
    atomics, whose order (and so whose bits) changes from run to run."""
    loss = (waveform * torch.mean((pred - target) ** 2)
            if waveform else 0.0)
    for n in fft_sizes:
        if pred.shape[0] < n:
            continue
        win = _hanning(n, str(pred.device))[None, :, None]
        hop = n // 2

        def frames(x):
            return x.unfold(0, n, hop).permute(0, 2, 1)    # (nfr, n, ch)

        ps = torch.fft.rfft(frames(pred) * win, dim=1).abs()
        ts = torch.fft.rfft(frames(target) * win, dim=1).abs()
        loss = loss + (torch.mean(torch.abs(ps - ts))
                       + torch.mean(torch.abs(torch.log(ps + log_eps)
                                              - torch.log(ts + log_eps)))
                       ) / len(fft_sizes)
    return loss


class FitResult(typing.NamedTuple):
    params: dict
    losses: np.ndarray

    def value_of(self, compiled: CompiledPatch, node: Emitter, pname: str):
        uid = compiled.index.info(node).uid
        return self.params[uid][pname].detach().cpu().numpy()


def make_loss_core(compiled: CompiledPatch, n_blocks: int, *,
                   position: int = 0,
                   loss: typing.Callable = None):
    """``loss_fn(params, target) -> scalar tensor`` rendering the patch for
    ``n_blocks`` blocks from ``position`` on the plan :meth:`~signals_tpu_
    torch.compiler.CompiledPatch.render_core` picks (the same as a render:
    an echo patch differentiates through its segments, not ``n_blocks``
    steps), from the patch's initial carry."""
    F = compiled.block_frames
    loss = spectral_loss if loss is None else loss
    compiled.check_position(position, n_blocks)
    many = compiled.render_core(n_blocks)
    carry0 = compiled.carry0

    def loss_fn(params, target):
        blocks, _, _ = many(params, carry0, position)
        audio = blocks.reshape(n_blocks * F, compiled.channels)
        return loss(audio, target)

    return loss_fn


def _conform_target(target, F: int, device):
    """Trim to whole blocks, make it a float32 2-D tensor on ``device``;
    returns ``(target, n_blocks)``.  A target shorter than one block
    raises: the render is a whole number of blocks."""
    if target.shape[0] < F:
        raise ValueError(
            f'target has {target.shape[0]} frames; fitting needs at '
            f'least one whole {F}-frame block (pad the audio or lower '
            'block_frames)')
    n_blocks = target.shape[0] // F
    target = torch.as_tensor(target[:n_blocks * F], dtype=torch.float32,
                             device=device)
    if target.dim() == 1:
        target = target[:, None]
    return target, n_blocks


def make_loss_fn(compiled: CompiledPatch, target, *, position: int = 0,
                 loss: typing.Callable = None):
    """``loss_fn(params) -> scalar tensor`` rendering the patch over the
    target's duration."""
    target, n_blocks = _conform_target(target, compiled.block_frames,
                                       compiled.device)
    core = make_loss_core(compiled, n_blocks, position=position, loss=loss)
    return lambda params: core(params, target)


def resolve_steps_per_dispatch(steps: int,
                               steps_per_dispatch: int = None) -> int:
    """The chunk length ``K``: ``min(16, steps)`` by default."""
    if steps_per_dispatch is None:
        return max(1, min(16, int(steps)))
    return max(1, int(steps_per_dispatch))


def _leaves(tree: dict, like: dict = None) -> list:
    """The leaves of ``tree`` (``uid -> name -> value``) in the order of
    ``like``'s (default: its own)."""
    like = tree if like is None else like
    return [tree[uid][p] for uid in like for p in like[uid]]


def fused_descent(loss_fn, train, *, steps: int, learning_rate: float,
                  steps_per_dispatch: int = None, loss_args=(),
                  lr_scale=None):
    """Adam on ``loss_fn(train, *loss_args) -> scalar``; returns ``(train',
    losses)``.  ``train`` is ``uid -> name -> tensor`` (leaves that require
    grad, updated in place).  Each step is ``optax.adam``'s update in its
    order of operations (``b1`` 0.9, ``b2`` 0.999, ``eps`` 1e-8,
    bias-corrected moments) scaled by ``-learning_rate``, then by the leaf's
    ``lr_scale`` (``uid -> name -> tensor`` of per-leaf multipliers, or
    None), then added.  The losses stay on the device and are copied off
    once per chunk of ``steps_per_dispatch`` steps (one synchronisation a
    chunk)."""
    leaves = _leaves(train)
    scale = None if lr_scale is None else _leaves(lr_scale, train)
    mu = [torch.zeros_like(p) for p in leaves]
    nu = [torch.zeros_like(p) for p in leaves]
    step_size = -F32(learning_rate)
    K = resolve_steps_per_dispatch(steps, steps_per_dispatch)
    losses: list = []
    count = 0
    remaining = steps
    while remaining > 0:
        k = min(K, remaining)
        values = []
        for _ in range(k):
            value = loss_fn(train, *loss_args)
            grads = torch.autograd.grad(value, leaves, allow_unused=True,
                                        materialize_grads=True)
            count += 1
            bc1 = float(F32(1.0) - B1 ** F32(count))
            bc2 = float(F32(1.0) - B2 ** F32(count))
            with torch.no_grad():
                for i, (p, g) in enumerate(zip(leaves, grads)):
                    mu[i] = float(F32(1.0) - B1) * g + float(B1) * mu[i]
                    nu[i] = float(F32(1.0) - B2) * g ** 2 + float(B2) * nu[i]
                    u = (mu[i] / bc1) / (torch.sqrt(nu[i] / bc2) + float(EPS))
                    u = u * float(step_size)
                    if scale is not None:
                        u = u * scale[i]
                    p.add_(u)
            values.append(value.detach())
        losses.extend(torch.stack(values).cpu().tolist())
        remaining -= k
    return train, losses


def _split_train(params, train_keys):
    """The trainable sub-dict of ``params``: fresh float32 leaves that
    require grad (the frozen leaves include bools and ints such as
    ``enabled``, which are never trainable)."""
    train: dict = {}
    for uid, p in train_keys:
        v = params[uid][p]
        if not torch.is_floating_point(v):
            raise ValueError(f'{uid}.{p} is {v.dtype}: only float params '
                             f'are trainable')
        train.setdefault(uid, {})[p] = (
            v.detach().to(torch.float32).clone().requires_grad_())
    return train


def _merge_train(params, train_params):
    """The full params dict with the trainable leaves overlaid."""
    out = {uid: dict(leaves) for uid, leaves in params.items()}
    for uid, leaves in train_params.items():
        for p, v in leaves.items():
            out[uid][p] = v
    return out


def _relative_scale(train):
    """``relative_lr``'s per-leaf step multipliers ``max(|p0|, 0.01)``."""
    return {uid: {p: torch.clamp(v.detach().abs(), min=REL_FLOOR)
                  for p, v in leaves.items()}
            for uid, leaves in train.items()}


def write_back(node: Emitter, pname: str, fitted) -> None:
    """Write a fitted value into a live node's state, in the type the state
    holds."""
    fitted = fitted.detach().cpu().numpy()
    state = node.get_state()
    current = getattr(state, pname)
    if isinstance(current, np.ndarray):
        setattr(state, pname, fitted.astype(current.dtype))
    else:
        setattr(state, pname, float(fitted))


def fit(root: Emitter,
        target,
        trainable: typing.Collection[tuple[Emitter, str]],
        *,
        rate: int = 44100,
        block_frames: int = 1024,
        steps: int = 200,
        learning_rate: float = 0.02,
        loss: typing.Callable = None,
        apply: bool = True,
        steps_per_dispatch: int = None,
        relative_lr: bool = False,
        device='cuda') -> FitResult:
    """Gradient-fit the ``(node, param)`` pairs in ``trainable`` so that the
    patch rendered at ``root`` on ``device`` matches ``target`` (numpy or a
    tensor, ``(frames,)`` or ``(frames, ch)``).

    With ``apply=True`` the fitted values are written back into the live
    nodes' states.  ``steps_per_dispatch`` is the number of steps whose
    losses are copied off the device together (default ``min(16,
    steps)``); the steps are the same whatever it is.  ``relative_lr=True``
    makes ``learning_rate`` a relative step: each parameter steps
    ``learning_rate * max(|p0|, 0.01)`` per update, so one rate serves
    parameters of any scale (a 0.8 gain and a 2000 Hz cutoff)."""
    compiled = compile_node(root, block_frames=block_frames, rate=rate,
                            device=device)
    target, n_blocks = _conform_target(target, compiled.block_frames,
                                       compiled.device)
    core = make_loss_core(compiled, n_blocks, loss=loss)
    params = compiled.params()
    index = compiled.index
    train_keys = {(index.info(node).uid, pname)
                  for node, pname in trainable}
    train = _split_train(params, train_keys)

    def loss_train(tp, target, full_params):
        return core(_merge_train(full_params, tp), target)

    train, losses = fused_descent(
        loss_train, train, steps=steps, learning_rate=learning_rate,
        steps_per_dispatch=steps_per_dispatch, loss_args=(target, params),
        lr_scale=_relative_scale(train) if relative_lr else None)

    final = _merge_train(params, train)
    if apply:
        for node, pname in trainable:
            write_back(node, pname, final[index.info(node).uid][pname])
    return FitResult(params=final, losses=np.asarray(losses))
