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

No device mesh is ported.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from signals_tpu_torch.compiler import CompiledPatch, check_device, \
    compile_node
from signals_tpu_torch.graph import Emitter

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
                 device='cuda'):
        layout = 'channels' if layout is None else layout
        if layout not in ('channels', 'vmap'):
            raise ValueError(layout)
        self.device = check_device(device)
        if mix_epilogue is None:
            mix_epilogue = self.device.type == 'cuda'
        self.layout = layout
        self.n_voices = n_voices
        self._mix_epilogue = mix_epilogue and layout == 'channels'
        self._render_cache: dict[int, typing.Any] = {}
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
            setattr(state, pname, stacked)
            self._channel_overrides.append((node, pname, axis, stacked))
        if root.channels != n_voices:
            raise ValueError(
                f'patch does not propagate the voice channel axis: root '
                f'has {root.channels} channels, expected {n_voices}; use '
                f'layout="vmap"')
        self._check_explicit_channels(root, n_voices)
        self.compiled: CompiledPatch = compile_node(
            root, block_frames=block_frames, rate=rate, channels=n_voices,
            device=self.device)
        self._out_channels = 1 if channels is None else channels

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
        #: vmap, whatever else is batched
        self._voices = torch.empty((self.n_voices, 0), device=self.device)

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
        """Update a per-voice override's values live (no recompilation)."""
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
                setattr(node.get_state(), pname, new)
                return
        raise KeyError((node, pname))

    def params(self) -> tuple[dict, typing.Optional[dict]]:
        """``(params, in_axes)``: the params dict ``uid -> name -> tensor``
        on the device and, for the vmap layout, the in-axes tree of the
        same structure (0 on the overridden leaves, stacked ``(V,
        *leaf)``; None on the shared ones), as the JAX package's
        ``PolyPatch.params``; None for the channels layout."""
        base = self.compiled.params()
        if self.layout == 'channels':
            return base, None
        for (uid, pname), arr in self._overrides.items():
            leaf = base[uid][pname]
            if arr.ndim == 1:          # (V,) scalars -> (V, 1, 1, ...)
                arr = arr.reshape((self.n_voices,) + (1,) * leaf.dim())
            stacked = np.broadcast_to(arr, (self.n_voices, *leaf.shape))
            base[uid][pname] = torch.as_tensor(
                np.array(stacked), dtype=leaf.dtype, device=self.device)
        return base, self._params_axes(base)

    def init_carry(self) -> dict:
        """The initial carry: the compiled patch's ``carry0``, with each
        leaf stacked per voice ``(V, ...)`` in the vmap layout (the channels
        layout's stateful nodes already carry V channels)."""
        carry0 = self.compiled.carry0
        if self.layout == 'channels':
            return carry0
        return {uid: {k: v.expand((self.n_voices,) + v.shape).clone()
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
        delivered, as in the JAX package's ``PolyPatch``."""
        if n_blocks in self._render_cache:
            return self._render_cache[n_blocks]
        compiled = self.compiled
        F = compiled.block_frames
        out_ch = self._out_channels
        mixplan = compiled.mega_mix(n_blocks) if self._mix_epilogue else None
        if self.layout == 'vmap':
            whole = compiled.render_core(n_blocks)

            def render(params, carry, position0, host=None):
                def voice(p, c, _voice):
                    blocks, c2, _taps = whole(p, c, position0, host)
                    return blocks, c2

                blocks, carry2 = torch.func.vmap(
                    voice, in_dims=(self._params_axes(params), 0, 0))(
                        params, carry, self._voices)
                return blocks.sum(dim=0), carry2
        elif mixplan is not None:
            def render(params, carry, position0, host=None):
                mix = mixplan(params, position0)            # (n, F, 1)
                return torch.broadcast_to(mix, (n_blocks, F, out_ch)), carry
        else:
            whole = compiled.render_core(n_blocks)

            def render(params, carry, position0, host=None):
                blocks, carry2, _taps = whole(params, carry, position0,
                                              host)
                mix = blocks.sum(dim=2, keepdim=True)
                return (torch.broadcast_to(mix, (n_blocks, F, out_ch)),
                        carry2)

        self._render_cache[n_blocks] = render
        return render

    def render(self, *, position: int = 0, n_blocks: int = 1,
               params: typing.Optional[dict] = None,
               carry: typing.Optional[dict] = None):
        """Render the master mix: ``(audio (n*F, out_ch), carry')`` on the
        device (``out_ch``: ``channels``, default 1, in the channels layout;
        the voice's channels in the vmap layout).  ``params`` defaults to
        :meth:`params`; pass e.g. :func:`signals_tpu_torch.interop.
        params_from_jax` output to replay another engine's values.
        ``carry`` defaults to :meth:`init_carry` (empty for a carry-free
        voice); pass a returned carry to continue a render."""
        self.compiled.check_position(position, n_blocks)
        if params is None:
            params, _ = self.params()
        if carry is None:
            carry = self.init_carry()
        host = self.compiled.host_inputs(position, n_blocks)
        mix, carry2 = self.render_fn(n_blocks)(params, carry, position, host)
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
        :class:`signals_tpu_torch.learn.FitResult`."""
        from signals_tpu_torch import learn
        compiled = self.compiled
        F = compiled.block_frames
        target, n_blocks = learn._conform_target(target, F, self.device)
        compiled.check_position(position, n_blocks)
        loss = learn.spectral_loss if loss is None else loss
        render = self.render_fn(n_blocks)
        params, _ = self.params()
        carry0 = self.init_carry()
        index = compiled.index
        train = learn._split_train(params, {(index.info(node).uid, pname)
                                            for node, pname in trainable})

        def loss_fn(tp, target, host, full_params):
            mix, _ = render(learn._merge_train(full_params, tp), carry0,
                            position, host)
            return loss(mix.reshape(n_blocks * F, self._out_channels),
                        target)

        host = compiled.host_inputs(position, n_blocks)
        train, losses = learn.fused_descent(
            loss_fn, train, steps=steps, learning_rate=learning_rate,
            steps_per_dispatch=steps_per_dispatch,
            loss_args=(target, host, params),
            lr_scale=learn._relative_scale(train) if relative_lr else None)

        final = learn._merge_train(params, train)
        if apply:
            if self.layout == 'vmap':
                axes = {(id(n), p): 0 for n, p in trainable
                        if (index.info(n).uid, p) in self._overrides}
            else:
                axes = {(id(n), p): axis
                        for n, p, axis, _ in self._channel_overrides}
            for node, pname in trainable:
                fitted = final[index.info(node).uid][pname]
                axis = axes.get((id(node), pname))
                if axis is None:
                    learn.write_back(node, pname, fitted)
                else:
                    fitted = fitted.detach().cpu().numpy()
                    self.set_override(node, pname,
                                      fitted[0] if axis == 1 else fitted)
        return learn.FitResult(params=final, losses=np.asarray(losses))
