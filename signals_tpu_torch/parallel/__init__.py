"""Polyphony (``signals_tpu.parallel``).

A :class:`PolyPatch` renders one voice patch as ``n_voices`` parallel
instances, in one of the JAX package's two layouts:

* ``'channels'`` — the voices ride the **channel axis**: per-voice
  overrides of scalar parameters become ``(1, V)`` rows, every kernel
  processes all voices as one wide block, and the master mix is the sum
  over channels;
* ``'vmap'`` — a leading voice axis through ``torch.func.vmap``: the
  one-voice patch's own plan (:meth:`~signals_tpu_torch.compiler.
  CompiledPatch.render_core`) is vmapped over the voices with the
  overridden params and the carry batched on dim 0, and the mix is the sum
  over that axis.  Any per-voice param and multichannel voices work.  The
  kernels (the cascades, the reverb's network) meet batched tensors
  through their ``vmap`` rule, which folds the voices into the lanes: one
  launch for all voices (:mod:`signals_tpu_torch.compiler.kernels`).

Beyond one device the voice axis is sharded over a 1-D
:class:`~torch.distributed.device_mesh.DeviceMesh` (:func:`voice_mesh`):
one process a device on ``torch.distributed`` (NCCL for ``'cuda'``, gloo
for ``'cpu'``) where the JAX package runs one SPMD program over a
``jax.sharding.Mesh``.  Each rank renders its contiguous shard of the
voices through the plan it would use without a mesh, and the master mix is
summed over the ranks (one ``all_reduce`` of the mixed blocks, the only
traffic between devices).  Carried state stays on its rank.
"""

from __future__ import annotations

import typing
import warnings

import numpy as np
import torch

from signals_tpu_torch.compiler import CompiledPatch, check_device, \
    compile_node
from signals_tpu_torch.core.xp import to_device
from signals_tpu_torch.graph import Emitter
from signals_tpu_torch.utils import span

F32 = np.float32


class PolyPatch:
    """A patch rendered as ``n_voices`` parallel instances on ``device``.

    ``overrides`` maps ``(node, param_name)`` to a per-voice array whose
    leading dimension is ``n_voices``.  ``layout`` (None: ``'channels'``,
    the JAX package's default without a mesh):

    * ``'channels'``: a 1-D array puts one scalar per voice into a ``(1,
      V)`` row, a 2-D array puts per-voice rows into a ``(V, E)`` array;
      the overridden values are installed into the live nodes' states (the
      patch *becomes* V-channel).  Requires a mono voice.
    * ``'vmap'``: the patch compiles as one voice; :meth:`params` stacks
      each overridden leaf to ``(V, *leaf)`` (a 1-D array is one scalar per
      voice) and :meth:`render` vmaps the voice's plan over them.  The live
      nodes keep their one-voice state.

    ``mix_epilogue`` (None = on for a CUDA device; channels layout only)
    folds the voice sum into the filter kernel when the patch allows it
    (:meth:`~signals_tpu_torch.compiler.CompiledPatch.mega_mix`); otherwise
    the plain plan renders every voice and sums them.

    ``mesh`` (a 1-D ``DeviceMesh`` from :func:`voice_mesh`, of ``device``'s
    type, its dimension named ``axis_name``; ``layout`` then defaults to
    ``'vmap'``) shards the voices: this
    process's rank ``r`` of ``W`` compiles and renders voices ``r * V / W``
    to ``(r + 1) * V / W`` (``n_voices % W`` must be 0).  :meth:`params`,
    :meth:`init_carry` and the live nodes' states hold the rank's slices
    (shared leaves whole); :meth:`set_override` takes all ``V`` values and
    keeps the rank's.  :meth:`render` sums the ranks' mixes, so every rank
    returns the whole mix, and :meth:`fit` sums a shared trainable's
    gradient over the ranks.  Every rank of the mesh makes the same calls.

    >>> # poly = PolyPatch(root, n_voices=64,
    >>> #                  overrides={(hz_node, 'value'): freqs},
    >>> #                  device='cuda')
    >>> # audio = poly.render(n_blocks=256)
    """

    def __init__(self,
                 root: Emitter,
                 *,
                 n_voices: int,
                 overrides: dict,
                 block_frames: int = 1024,
                 rate: int = 44100,
                 channels: typing.Optional[int] = None,
                 layout: typing.Optional[str] = None,
                 mix_epilogue: typing.Optional[bool] = None,
                 mesh=None,
                 axis_name: str = 'voices',
                 device='cuda'):
        if layout is None:
            layout = 'vmap' if mesh is not None else 'channels'
        if layout not in ('channels', 'vmap'):
            raise ValueError(layout)
        self.device = check_device(device)
        if mix_epilogue is None:
            mix_epilogue = self.device.type == 'cuda'
        self.layout = layout
        self.n_voices = n_voices
        self.mesh = mesh
        self.axis_name = axis_name
        self._mix_epilogue = mix_epilogue and layout == 'channels'
        self._render_cache: dict[int, typing.Any] = {}
        self._shard_mesh(mesh)
        if layout == 'vmap':
            self._build_vmap(root, overrides, block_frames, rate, channels)
            return
        #: (node, pname, voice_axis, stacked array)
        self._channel_overrides: list[tuple] = []
        for (node, pname), values in overrides.items():
            arr = self._voice_array(pname, values)
            state = node.get_state()
            old = getattr(state, pname)
            # an already-stacked row count is accepted too: a second
            # PolyPatch over the same root re-installs the same layout
            if not (isinstance(old, np.ndarray)
                    and old.shape[0] in (1, n_voices)):
                raise ValueError(
                    f'channel layout requires single-row array params; '
                    f'{pname!r} is {old!r} — use layout="vmap"')
            if arr.ndim == 1:
                stacked, axis = arr.reshape(1, n_voices), 1
            else:
                stacked = np.ascontiguousarray(np.broadcast_to(
                    arr.reshape(n_voices, -1), (n_voices, old.shape[1])))
                axis = 0
            setattr(state, pname, self._local(stacked, axis))
            self._channel_overrides.append((node, pname, axis, stacked))
        n_local = self._n_local
        if root.channels != n_local:
            raise ValueError(
                f'patch does not propagate the voice channel axis: root '
                f'has {root.channels} channels, expected {n_local}; use '
                f'layout="vmap"')
        self._check_explicit_channels(root, n_local)
        self.compiled: CompiledPatch = compile_node(
            root, block_frames=block_frames, rate=rate, channels=n_local,
            device=self.device)
        self._out_channels = 1 if channels is None else channels

    def _shard_mesh(self, mesh) -> None:
        """This rank's shard of the voices: ``_n_local`` voices from
        ``_first``, and the mesh's process group (None without a mesh)."""
        self._group = None
        self._n_local, self._first = self.n_voices, 0
        if mesh is None:
            return
        if mesh.ndim != 1:
            raise ValueError(f'a voice mesh is 1-D, got {mesh.ndim} dims')
        if mesh.device_type != self.device.type:
            raise ValueError(f'a {mesh.device_type!r} mesh cannot shard a '
                             f'PolyPatch on {self.device}')
        if mesh.get_coordinate() is None:
            raise ValueError('this process is not a rank of the mesh')
        n_dev = mesh.size()
        if n_dev > 1 and self.n_voices < n_dev * \
                MIN_EFFICIENT_VOICES_PER_DEVICE:
            _warn_narrow_shard(self.n_voices, n_dev, 'PolyPatch')
        if self.n_voices % n_dev:
            raise ValueError(f'n_voices={self.n_voices} not divisible by '
                             f'the {n_dev}-device mesh')
        self._group = mesh.get_group(self.axis_name)
        self._n_local = self.n_voices // n_dev
        self._first = mesh.get_local_rank(self.axis_name) * self._n_local

    def _local(self, stacked: np.ndarray, axis: int) -> np.ndarray:
        """The rank's slice of a stacked override (voices on ``axis``)."""
        if self.mesh is None:
            return stacked
        cut = slice(self._first, self._first + self._n_local)
        return np.ascontiguousarray(stacked[:, cut] if axis == 1
                                    else stacked[cut])

    def _voice_array(self, pname: str, values) -> np.ndarray:
        arr = np.asarray(values, dtype=F32)
        if arr.shape[0] != self.n_voices:
            raise ValueError(
                f'override for {pname!r} has leading dim {arr.shape[0]}, '
                f'expected n_voices={self.n_voices}')
        return arr

    def _build_vmap(self, root, overrides, block_frames, rate, channels):
        self.compiled = compile_node(root, block_frames=block_frames,
                                     rate=rate, channels=channels,
                                     device=self.device)
        self._out_channels = self.compiled.channels
        index = self.compiled.index
        #: (uid, pname) -> per-voice array, leading dim n_voices
        self._overrides = {
            (index.info(node).uid, pname): self._voice_array(pname, values)
            for (node, pname), values in overrides.items()}
        #: a (V, 0) tensor vmapped on dim 0: the voice count of every
        #: vmap (the rank's under a mesh), whatever else is batched
        self._voices = torch.empty((self._n_local, 0), device=self.device)

    @staticmethod
    def _check_explicit_channels(root: Emitter, n_voices: int) -> None:
        """Interior explicit-channel nodes (a ``Delay``) must carry the
        voice lanes too when their INPUT does — the root check alone misses
        them when a widened path reconverges (an osc -> mix dry path makes
        the root V-wide while the feedback delay stays mono and fails in a
        broadcast at lowering time).  A genuinely mono explicit-channel
        node (a noise source, a sidechain: every input at most as wide as
        its declared channels) broadcasts only at its consumer and is
        legal."""
        from signals_tpu_torch.graph import ExplicitChannels
        stack, visited = [root], set()
        while stack:
            n = stack.pop()
            if id(n) in visited:
                continue
            visited.add(id(n))
            ports = getattr(n, '_ports', {})
            if isinstance(n, ExplicitChannels) and n.channels != n_voices:
                for p in ports.values():
                    if p.sig is None:
                        continue
                    try:
                        w = p.sig.channels
                    except Exception:
                        continue
                    if w > n.channels:
                        raise ValueError(
                            f'channels layout: {n.cls_name()} declares '
                            f'{n.channels} explicit channel(s) but its '
                            f'input is {w} wide (voices ride the channel '
                            f'axis) — set its channels to {n_voices} '
                            f'(voices per device) or use layout="vmap"')
            stack.extend(p.sig for p in ports.values() if p.sig is not None)

    def set_override(self, node, pname: str, values) -> None:
        """Update a per-voice override's values live (no recompilation):
        ``values`` holds all ``n_voices``; under a mesh the live node state
        takes the rank's slice, so per-voice edits of the channels layout
        go through here."""
        arr = self._voice_array(pname, values)
        if self.layout == 'vmap':
            key = (self.compiled.index.info(node).uid, pname)
            if key not in self._overrides:
                raise KeyError((node, pname))
            self._overrides[key] = arr
            return
        for i, (n, p, axis, stacked) in enumerate(self._channel_overrides):
            if n is node and p == pname:
                new = (arr.reshape(1, self.n_voices) if axis == 1
                       else np.ascontiguousarray(np.broadcast_to(
                           arr.reshape(self.n_voices, -1), stacked.shape)))
                self._channel_overrides[i] = (n, p, axis, new)
                setattr(node.get_state(), pname, self._local(new, axis))
                return
        raise KeyError((node, pname))

    def params(self) -> tuple[dict, typing.Optional[dict]]:
        """``(params, in_axes)``: the params dict ``uid -> name -> tensor``
        on the device and, for the vmap layout, the in-axes tree of the
        same structure (0 on the overridden leaves, stacked ``(V,
        *leaf)``; None on the shared ones), as the JAX package's
        ``PolyPatch.params``; None for the channels layout.  Under a mesh
        the overridden leaves hold the rank's voices."""
        with span('poly.params'):
            base = self.compiled.params()
            if self.layout == 'channels':
                return base, None
            n = self._n_local
            for (uid, pname), arr in self._overrides.items():
                leaf = base[uid][pname]
                arr = arr[self._first:self._first + n]
                if arr.ndim == 1:          # (V,) scalars -> (V, 1, 1, ...)
                    arr = arr.reshape((n,) + (1,) * leaf.dim())
                stacked = np.broadcast_to(arr, (n, *leaf.shape))
                base[uid][pname] = to_device(np.array(stacked), self.device,
                                             leaf.dtype)
            return base, self._params_axes(base)

    def init_carry(self) -> dict:
        """The initial carry: the compiled patch's ``carry0``, with each
        leaf stacked per voice ``(V, ...)`` in the vmap layout (the channels
        layout's stateful nodes already carry V channels); the rank's
        voices under a mesh."""
        carry0 = self.compiled.carry0
        if self.layout == 'channels':
            return carry0
        return {uid: {k: v.expand((self._n_local,) + v.shape).clone()
                      for k, v in leaves.items()}
                for uid, leaves in carry0.items()}

    def _params_axes(self, params: dict) -> dict:
        """The in-axes of a params dict given to the vmap layout: 0 on an
        overridden leaf, None elsewhere."""
        return {uid: {k: 0 if (uid, k) in self._overrides else None
                      for k in leaves}
                for uid, leaves in params.items()}

    def render_fn(self, n_blocks: int):
        """``(params, carry, position0, host=None) -> (mix (n_blocks, F,
        out_ch), carry')``, cached per batch size.

        Channels layout: the mix-epilogue plan when enabled and eligible
        (a carry-free patch without host inputs: the carry passes through),
        else the plan :meth:`~signals_tpu_torch.compiler.CompiledPatch.
        render_core` picks, summed over the voices.  Vmap layout: the
        voice's ``render_core(n_blocks)`` under ``torch.func.vmap`` over
        the overridden params and the carry (dim 0; the position and the
        host inputs are shared), summed over the voice axis.  ``host``: the
        render's staged host inputs (:meth:`~signals_tpu_torch.compiler.
        CompiledPatch.host_inputs`).  Taps are neither returned nor
        delivered, as in the JAX package's ``PolyPatch``.  Under a mesh
        each rank renders its voices this way and the mix is summed over
        the ranks (:class:`_MixSum`).  A call is the span ``poly.plan``:
        the plan's enqueue."""
        if n_blocks in self._render_cache:
            return self._render_cache[n_blocks]
        compiled = self.compiled
        F = compiled.block_frames
        out_ch = self._out_channels
        mixplan = compiled.mega_mix(n_blocks) if self._mix_epilogue else None
        if self.layout == 'vmap':
            whole = compiled.render_core(n_blocks)

            def plan(params, carry, position0, host=None):
                def voice(p, c, _voice):
                    blocks, c2, _taps = whole(p, c, position0, host)
                    return blocks, c2

                blocks, carry2 = torch.func.vmap(
                    voice, in_dims=(self._params_axes(params), 0, 0))(
                        params, carry, self._voices)
                return self._mix_sum(blocks.sum(dim=0)), carry2
        elif mixplan is not None:
            def plan(params, carry, position0, host=None):
                mix = self._mix_sum(mixplan(params, position0))  # (n, F, 1)
                return torch.broadcast_to(mix, (n_blocks, F, out_ch)), carry
        else:
            whole = compiled.render_core(n_blocks)

            def plan(params, carry, position0, host=None):
                blocks, carry2, _taps = whole(params, carry, position0,
                                              host)
                mix = self._mix_sum(blocks.sum(dim=2, keepdim=True))
                return (torch.broadcast_to(mix, (n_blocks, F, out_ch)),
                        carry2)

        def render(params, carry, position0, host=None):
            with span('poly.plan'):
                return plan(params, carry, position0, host)

        self._render_cache[n_blocks] = render
        return render

    def _mix_sum(self, mix):
        """The rank's mix summed over the mesh's ranks (unchanged without
        a mesh)."""
        if self._group is None:
            return mix
        return _MixSum.apply(mix, self._group)

    def render(self, *, position: int = 0, n_blocks: int = 1,
               params: typing.Optional[dict] = None,
               carry: typing.Optional[dict] = None):
        """Render the master mix: ``(audio (n*F, out_ch), carry')`` on the
        device (``out_ch``: ``channels``, default 1, in the channels layout;
        the voice's channels in the vmap layout).  ``params`` defaults to
        :meth:`params`; pass e.g. :func:`signals_tpu_torch.interop.
        params_from_jax` output to replay another engine's values.
        ``carry`` defaults to :meth:`init_carry` (empty for a carry-free
        voice); pass a returned carry to continue a render.  A call is the
        span ``poly.render``, the root of its spans."""
        with span('poly.render'):
            self.compiled.check_position(position, n_blocks)
            if params is None:
                params, _ = self.params()
            if carry is None:
                carry = self.init_carry()
            host = self.compiled.host_inputs(position, n_blocks)
            mix, carry2 = self.render_fn(n_blocks)(params, carry, position,
                                                   host)
            F = self.compiled.block_frames
            return mix.reshape(n_blocks * F, self._out_channels), carry2

    def fit(self, target, trainable, *, steps: int = 200,
            learning_rate: float = 0.02, loss=None,
            steps_per_dispatch: int = None, position: int = 0,
            apply: bool = True, relative_lr: bool = False):
        """Gradient-fit parameters of the poly patch against target MIX
        audio (``(frames,)`` or ``(frames, out_ch)``).

        ``trainable``: ``(node, pname)`` pairs; a pair naming a per-voice
        override trains the whole per-voice row (channels layout) or the
        stacked ``(V, *leaf)`` array (vmap layout): e.g. 64 per-voice gains
        fit together against one mixed target.  The loss renders through
        the same plan as :meth:`render` (the mix-epilogue plan where the
        patch allows it: the backward of the in-kernel voice sum hands each
        lane its group's cotangent; under vmap each kernel's backward runs
        once on the folded lanes).  ``loss`` defaults to
        :func:`signals_tpu_torch.learn.spectral_loss`;
        ``steps_per_dispatch`` and ``relative_lr`` as in
        :func:`signals_tpu_torch.learn.fit`.  With ``apply=True`` fitted
        overrides are written back through :meth:`set_override` and fitted
        shared params into the live node states.  Returns a
        :class:`signals_tpu_torch.learn.FitResult`.

        Under a mesh each rank trains its voices' slice of a per-voice
        override (its Adam moments stay with it) and differentiates the
        summed mix: every rank computes the same loss, and the sum's
        backward hands each rank's mix the loss's cotangent once.  A
        shared trainable's gradient is summed over the ranks inside the
        backward (:class:`_GradSum`: one ``all_reduce`` of the shared
        gradients, flattened, a step), so every rank takes the same step.
        ``apply`` gathers the per-voice slices, so every rank writes back
        all the voices.
        The result's params are the rank's (its voices' slices).

        A call is the span ``poly.fit``: ``fit.prepare`` (the target, params,
        carry and host inputs), the steps' spans of :func:`signals_tpu_torch.
        learn.fused_descent` (each ``fit.forward`` holds the render's
        ``poly.plan`` and the loss's ``fit.loss``), then ``fit.apply`` (the
        write-back)."""
        from signals_tpu_torch import learn
        with span('poly.fit'):
            with span('fit.prepare'):
                compiled = self.compiled
                F = compiled.block_frames
                target, n_blocks = learn._conform_target(target, F,
                                                         self.device)
                compiled.check_position(position, n_blocks)
                render = self.render_fn(n_blocks)
                params, _ = self.params()
                carry0 = self.init_carry()
                index = compiled.index
                keys = [(index.info(node).uid, pname)
                        for node, pname in trainable]
                #: (uid, pname) of a per-voice trainable -> the voice axis
                #: of its leaf
                if self.layout == 'vmap':
                    voice_axis = {k: 0 for k in keys if k in self._overrides}
                else:
                    voice_axis = {(index.info(n).uid, p): axis
                                  for n, p, axis, _ in self._channel_overrides}
                train = learn._split_train(params, set(keys))
                lr_scale = (learn._relative_scale(train) if relative_lr
                            else None)
                host = compiled.host_inputs(position, n_blocks)
            loss = learn.spectral_loss if loss is None else loss
            shared = [(uid, p) for uid in train for p in train[uid]
                      if (uid, p) not in voice_axis]
            if self._group is None:
                shared = []

            def loss_fn(tp, target, host, full_params):
                if shared:
                    summed = _GradSum.apply(
                        self._group, *(tp[uid][p] for uid, p in shared))
                    tp = {uid: dict(leaves) for uid, leaves in tp.items()}
                    for (uid, p), leaf in zip(shared, summed):
                        tp[uid][p] = leaf
                mix, _ = render(learn._merge_train(full_params, tp), carry0,
                                position, host)
                with span('fit.loss'):
                    return loss(mix.reshape(n_blocks * F,
                                            self._out_channels), target)

            train, losses = learn.fused_descent(
                loss_fn, train, steps=steps, learning_rate=learning_rate,
                steps_per_dispatch=steps_per_dispatch,
                loss_args=(target, host, params), lr_scale=lr_scale)

            with span('fit.apply'):
                final = learn._merge_train(params, train)
                if apply:
                    for node, pname in trainable:
                        key = (index.info(node).uid, pname)
                        fitted = final[key[0]][pname].detach()
                        axis = voice_axis.get(key)
                        if axis is None:
                            learn.write_back(node, pname, fitted)
                            continue
                        if self._group is not None:
                            fitted = self._gather_voices(fitted, axis)
                        fitted = fitted.cpu().numpy()
                        self.set_override(node, pname,
                                          fitted[0] if axis == 1 else fitted)
            return learn.FitResult(params=final, losses=np.asarray(losses))

    def _gather_voices(self, local, axis: int):
        """The ranks' slices of a per-voice leaf joined on its voice
        ``axis``, in rank order."""
        import torch.distributed as dist
        parts = [torch.empty_like(local) for _ in range(self.mesh.size())]
        dist.all_gather(parts, local.contiguous(), group=self._group)
        return torch.cat(parts, dim=axis)


class _GradSum(torch.autograd.Function):
    """The identity forward on the shared trainables; backward, their
    gradients summed over the ranks (one ``all_reduce`` of them flattened).
    Each rank's gradient of a shared leaf holds only its voices' term, so
    without the sum every rank would take a different step."""

    @staticmethod
    def forward(ctx, group, *leaves):
        ctx.group = group
        return tuple(leaf.view_as(leaf) for leaf in leaves)

    @staticmethod
    def backward(ctx, *grads):
        import torch.distributed as dist
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=ctx.group)
        out, at = [], 0
        for g in grads:
            out.append(flat[at:at + g.numel()].reshape(g.shape))
            at += g.numel()
        return (None, *out)


class _MixSum(torch.autograd.Function):
    """The ranks' mixes summed (``all_reduce``, SUM) forward; the identity
    backward.  Every rank computes the same loss from the same summed mix,
    so the cotangent each rank's own mix needs is the loss's cotangent of
    the sum, once: summing the cotangents over the ranks again (the
    backward of ``torch.distributed.nn.functional.all_reduce``) would
    scale every gradient by the world size."""

    @staticmethod
    def forward(ctx, mix, group):
        import torch.distributed as dist
        out = mix.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


#: The voices a device below which sharding is declined by
#: :func:`voice_mesh` and warned about by :class:`PolyPatch`: the JAX
#: package's policy, kept so that both packages decline the same meshes.
#: Its knee was measured on another chip (narrow shards leave its vector
#: lanes mostly empty); the H100's is unmeasured.
MIN_EFFICIENT_VOICES_PER_DEVICE = 64


def efficient_device_count(n_voices: int, available: int) -> int:
    """Largest device count (>= 1, <= available) keeping voices/device
    at or above :data:`MIN_EFFICIENT_VOICES_PER_DEVICE`."""
    return max(1, min(available,
                      n_voices // MIN_EFFICIENT_VOICES_PER_DEVICE))


def _warn_narrow_shard(n_voices: int, n_devices: int, where: str) -> None:
    per = n_voices / max(n_devices, 1)
    warnings.warn(
        f'{where}: {n_voices} voices over {n_devices} devices = '
        f'{per:.0f} voices/device, below the lane-efficiency knee of the '
        f'sharding policy ({MIN_EFFICIENT_VOICES_PER_DEVICE} voices/device; '
        f'measured on another chip, unmeasured on this one) — use '
        f'voice_mesh(n_voices={n_voices}) (caps at '
        f'{efficient_device_count(n_voices, n_devices)} device(s) here) or '
        f'fewer devices', RuntimeWarning, stacklevel=3)


def voice_mesh(n_devices: typing.Optional[int] = None,
               axis_name: str = 'voices',
               device=None,
               n_voices: typing.Optional[int] = None):
    """A 1-D :class:`~torch.distributed.device_mesh.DeviceMesh` over the
    voice axis: ranks ``0 .. n - 1`` of the initialised process group (all
    of them by default), ``mesh_dim_names=(axis_name,)``, on ``device``'s
    type (default ``'cuda'``: one process a GPU on NCCL; ``'cpu'`` on
    gloo).  Every rank of the group calls it; a rank outside the mesh gets
    a mesh it is no rank of.

    ``n_voices`` engages the efficiency policy: with ``n_devices`` not
    pinned, the mesh is capped at :func:`efficient_device_count` so every
    shard keeps at least :data:`MIN_EFFICIENT_VOICES_PER_DEVICE` voices;
    with ``n_devices`` pinned below the knee, a ``RuntimeWarning`` says
    so."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError('voice_mesh needs an initialised process group '
                           '(torch.distributed.init_process_group)')
    device_type = torch.device('cuda' if device is None else device).type
    world = dist.get_world_size()
    if n_devices is not None:
        if world < n_devices:
            raise ValueError(f'need {n_devices} ranks, the process group '
                             f'has {world}')
        if (n_voices is not None and n_devices > 1
                and n_voices < n_devices * MIN_EFFICIENT_VOICES_PER_DEVICE):
            _warn_narrow_shard(n_voices, n_devices, 'voice_mesh')
        size = n_devices
    elif n_voices is not None:
        size = efficient_device_count(n_voices, world)
    else:
        size = world
    return DeviceMesh(device_type, list(range(size)),
                      mesh_dim_names=(axis_name,))
