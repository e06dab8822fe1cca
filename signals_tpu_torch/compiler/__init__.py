"""The patch compiler (``signals_tpu.compiler``), in eager PyTorch.

The JAX package traces a patch once into a fused XLA program.  This port
keeps its lowering design — node kernels evaluated against a lowering
context, memoized per ``(node, window)`` so fan-out is shared — but runs it
eagerly: a render lowers the whole batch as ONE multi-block window on the
target device, with the filter cascade in the hand-written segment kernels
(:mod:`signals_tpu_torch.compiler.kernels`).  A per-block step
(:meth:`CompiledPatch.step`) lowers one block the same way.

* **Windows.**  A request is a static ``Window(offset, frames, stride)``
  relative to the render position: the main window spans the batch,
  block-rate control inputs lower as a strided grid (one sample per
  block), filter context is the pair ``(offset-C, C)`` + ``(offset, F)``.
* **Start-of-timeline.**  Context frames before position 0 are zero —
  identical through any zero-initial-state causal filter.
* **Traced vs structural state.**  Traced params (constants' values,
  ``enabled``, envelope times) are parameter tensors, editable without
  recompiling; structural state is keyed by the canonical graph hash.

* **Carry segments.**  Swept-cutoff filters carry state across segments
  of ``m`` blocks aligned to absolute multiples of ``m`` blocks; a window
  that starts inside a segment is widened back to the segment's start by
  the filter itself (:meth:`~signals_tpu_torch.nodes.fx.CritFilter.
  _family_compute`), so a render may start at any block.

Ported so far: carry-free patches (no delays, host sources, taps or
stateful nodes other than the grid-lowered ADSR), rendered through three
plans — the per-block step (:meth:`CompiledPatch.step`), the plain
whole-window plan (:meth:`CompiledPatch.mega_core`) and the mix-epilogue
plan (:meth:`CompiledPatch.mega_mix`).
"""

from __future__ import annotations

import hashlib
import typing

import numpy as np
import torch

from signals_tpu_torch import PortName, SignalFlags
from signals_tpu_torch.core import ChainLayerError
from signals_tpu_torch.core.xp import NP, TorchXP
from signals_tpu_torch.graph import (
    Emitter,
    KernelCtx,
    Receiver,
    StatefulEmitter,
)

F32 = np.float32


class CompileError(ChainLayerError):
    pass


class Window(typing.NamedTuple):
    """A static request window relative to the current render position.

    ``stride`` > 1 makes it a *grid window*: ``frames`` one-frame samples
    spaced ``stride`` apart (frame k at ``offset + k*stride``) — how
    block-rate control signals lower under a multi-block window.
    """
    offset: int
    frames: int
    stride: int = 1

    @property
    def end(self) -> int:
        return self.offset + (self.frames - 1) * self.stride + 1


class _NodeInfo:
    """Per-node compile-time record."""

    def __init__(self, node: Emitter, uid: str):
        self.node = node
        self.uid = uid


def _is_grid_stateless(node) -> bool:
    """Node offering a carry-free grid-history lowering (``grid_kernel``)."""
    return getattr(node, 'is_grid_stateless', False)


def _is_stateful(node) -> bool:
    return isinstance(node, StatefulEmitter) and node.is_stateful()


def check_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a GPU
    raises instead of running somewhere else."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device} requested but torch sees no '
                           f'CUDA GPU')
    if device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {device}')
    return device


def _downstream(node) -> dict:
    """``id -> node`` for ``node`` and every node whose output depends on
    it."""
    seen = {id(node): node}
    frontier = [node]
    while frontier:
        for _pname, recv in frontier.pop()._outputs:
            if id(recv) not in seen:
                seen[id(recv)] = recv
                frontier.append(recv)
    return seen


def _voice_linear_to_root(filt, root) -> bool:
    """Soundness proof for the mix epilogue (:meth:`CompiledPatch.
    mega_mix`): every path from ``filt``'s output to ``root`` is *linear in
    the filter output* with *voice-broadcast* (channels == 1)
    multiplicative coefficients, so the voice sum commutes with the whole
    post-filter chain: ``sum_v root_v = A * sum_v y_v + sum_v root_v|_{y:=0}``
    with ``A`` voice-constant.

    Allowed path node types: ``Mix`` (the ``mix`` weight non-descended and
    mono), ``RingMod`` (exactly one side descended, the other mono),
    ``Gain`` (descended through ``left`` only, ``right`` mono).  ``enabled``
    gating preserves linearity.  Anything else rejects.
    """
    from signals_tpu_torch.nodes.fx import Gain, Mix, RingMod
    desc = _downstream(filt)
    if id(root) not in desc:
        return False
    for n in desc.values():
        if n is filt:
            continue
        t = type(n)
        if t is Mix:
            msig = n._ports['mix'].sig
            if msig is not None and (id(msig) in desc
                                     or msig.channels != 1):
                return False
        elif t in (Gain, RingMod):
            dports = [p for p in ('left', 'right')
                      if (s := n._ports[p].sig) is not None
                      and id(s) in desc]
            if t is Gain and dports != ['left']:
                return False
            if t is RingMod and len(dports) != 1:
                return False
            other = 'right' if dports == ['left'] else 'left'
            osig = n._ports[other].sig
            if osig is not None and osig.channels != 1:
                return False
        else:
            return False
    return True


class _GraphIndex:
    """Stable node numbering + the canonical structural hash.  The uid
    scheme (depth-first from the root, ports in name order) is the JAX
    package's, so both packages name the nodes of one patch alike."""

    def __init__(self, root: Emitter, block_frames: int, rate: int,
                 channels: int, device: torch.device):
        from signals_tpu_torch.compiler import filters as _filters
        self.block_frames = block_frames
        self.rate = rate
        self.channels = channels
        self.device = device
        #: SEG_SOURCE_GEN / SEG_CARRY_BLOCKS snapshots: read here, where the
        #: graph hash is computed, and nowhere later
        self.seg_source_gen = _filters.resolve_seg_source_gen(device)
        self.seg_carry_blocks = _filters.resolve_seg_carry_blocks()
        self.infos: dict[int, _NodeInfo] = {}
        self.order: list[Emitter] = []
        self._walk(root)

    def _walk(self, node: Emitter) -> None:
        if id(node) in self.infos:
            return
        uid = f'n{len(self.order)}'
        self.infos[id(node)] = _NodeInfo(node, uid)
        self.order.append(node)
        if isinstance(node, Receiver):
            for name in node.port_names():
                inp = node._ports[name].sig
                if inp is not None:
                    self._walk(inp)

    def info(self, node: Emitter) -> _NodeInfo:
        return self.infos[id(node)]

    def graph_hash(self) -> str:
        h = hashlib.sha3_256()
        h.update(f'F={self.block_frames};R={self.rate};C={self.channels};'
                 f'D={self.device};G={self.seg_source_gen};'
                 f'B={self.seg_carry_blocks}'.encode())
        for node in self.order:
            info = self.info(node)
            h.update(f'|{info.uid}:{node.cls_name()}'.encode())
            state = node.get_state()
            for name in sorted(type(state).param_names()):
                param = type(state)._params[name]
                if param.traced:
                    # traced values are inputs; only array *shape* is
                    # structural (channel inference reads it)
                    v = getattr(state, name)
                    if isinstance(v, np.ndarray):
                        h.update(f';{name}@{v.shape}'.encode())
                else:
                    h.update(f';{name}={getattr(state, name)!r}'.encode())
            if isinstance(node, Receiver):
                for pname in node.port_names():
                    inp = node._ports[pname].sig
                    if inp is not None:
                        h.update(f';{pname}<-{self.info(inp).uid}'.encode())
        return h.hexdigest()


# --- window-collection pass (dry run with dummy numpy blocks) ---------------


class _CollectCtx(KernelCtx):
    """Runs kernels on zero-filled numpy blocks to walk the windows each
    node requests of its inputs — rejecting, at compile time, windows past
    the block end and nodes this port cannot lower."""

    xp = NP

    def __init__(self, compiler: '_Compiler', node: Emitter, window: Window):
        self.compiler = compiler
        self.node = node
        self.window = window
        self.rate = compiler.rate
        self.nframes = window.frames

    @property
    def frame_range(self):
        return np.zeros((self.nframes, 1), dtype=F32)

    @property
    def frame_range_int(self):
        return np.zeros((self.nframes, 1), dtype=np.int32)

    def _input(self, name: PortName) -> typing.Optional[Emitter]:
        return self.node._ports[name].sig

    def _dummy(self, inp: typing.Optional[Emitter], frames: int):
        ch = 1 if inp is None else inp.channels
        return np.zeros((frames, ch), dtype=F32)

    def in_(self, name: PortName):
        inp = self._input(name)
        if inp is not None:
            self.compiler.collect(inp, self.window)
        return self._dummy(inp, self.nframes)

    def in_block_rate(self, name: PortName):
        inp = self._input(name)
        if inp is not None:
            self.compiler.collect(inp, Window(self.window.offset, 1))
        return self._dummy(inp, 1)

    def in_context(self, name: PortName, context_frames: int):
        inp = self._input(name)
        if inp is not None:
            self.compiler.collect(
                inp, Window(self.window.offset - context_frames,
                            context_frames))
            self.compiler.collect(inp, self.window)
        return self._dummy(inp, context_frames + self.nframes)

    def in_channels(self, name: PortName) -> typing.Optional[int]:
        inp = self._input(name)
        return None if inp is None else inp.channels

    def param(self, name: str):
        return getattr(self.node._state, name)

    def sosfilt(self, coeffs, x):
        coeffs = np.asarray(coeffs)
        ch = max(coeffs.shape[1], x.shape[1])
        return np.zeros((x.shape[0], ch), dtype=F32)


# --- lowering pass -----------------------------------------------------------


class LowerCtx(KernelCtx):
    """Evaluates node kernels eagerly in PyTorch on the compiler's device."""

    def __init__(self, compiler: '_Compiler', node: Emitter, window: Window):
        self.xp = compiler.xp
        self.compiler = compiler
        self.node = node
        self.window = window
        self.rate = compiler.rate
        self.nframes = window.frames

    @property
    def block_grid(self):
        """``(block_frames, n_blocks)`` when this window is a contiguous run
        of more than one whole block (a multi-block render window), else
        None — as in the JAX package, a one-block window (the per-block
        step) is not a grid.  Kernels with block-rate internals (filters)
        branch on it."""
        w = self.window
        F = self.compiler.block_frames
        if (w.stride == 1 and w.frames > F and w.frames % F == 0
                and w.offset % F == 0):
            return F, w.frames // F
        return None

    def at_window(self, offset: int, frames: int) -> 'LowerCtx':
        """A sibling ctx for the same node at another window (window
        coordinates) — how a filter widens its window back to a carry
        segment's start."""
        return LowerCtx(self.compiler, self.node, Window(offset, frames))

    @property
    def _frame_ints(self):
        w = self.window
        first = self.compiler.position + w.offset
        return (first + w.stride * torch.arange(
            w.frames, dtype=torch.int32,
            device=self.compiler.device)).reshape(-1, 1)

    @property
    def frame_range(self):
        return self._frame_ints.to(torch.float32)

    @property
    def frame_range_int(self):
        return self._frame_ints

    def _input(self, name: PortName) -> typing.Optional[Emitter]:
        return self.node._ports[name].sig

    def _zeros(self, frames: int):
        return torch.zeros((frames, 1), dtype=torch.float32,
                           device=self.compiler.device)

    def in_(self, name: PortName):
        inp = self._input(name)
        if inp is None:
            return self._zeros(1)
        return self.compiler.lower(inp, self.window)

    def in_block_rate(self, name: PortName):
        inp = self._input(name)
        if inp is None:
            return self._zeros(1)
        grid = self.block_grid
        if grid is not None:
            # one sample per block, upsampled piecewise-constant —
            # identical per-frame values to per-block rendering
            F, _ = grid
            g = self.in_block_rate_grid(name)
            return torch.repeat_interleave(g, F, dim=0)
        if self.window.stride > 1:
            # this node is itself sampled on a grid: sample its block-rate
            # inputs on the SAME grid, one value per grid position
            return self.compiler.lower(inp, self.window)
        return self.compiler.lower(inp, Window(self.window.offset, 1))

    def in_block_rate_grid(self, name: PortName):
        """Raw per-block control samples ``(n_blocks, ch)`` of a window of
        whole blocks (for kernels that consume block-rate values
        structurally, e.g. filter coefficient design)."""
        inp = self._input(name)
        F = self.compiler.block_frames
        n_blocks = self.window.frames // F
        if inp is None:
            return self._zeros(n_blocks)
        g = self.compiler.lower(
            inp, Window(self.window.offset, n_blocks, stride=F))
        return torch.broadcast_to(g, (n_blocks, inp.channels))

    def in_grid_samples(self, name: PortName, stride: int, count: int,
                        ahead: int = 0):
        inp = self._input(name)
        if inp is None:
            return self._zeros(count)
        # render positions are block-aligned, so the absolute grid maps to
        # static window offsets; one strided window covers all samples
        anchor_off = stride * (self.window.offset // stride)
        start = anchor_off - (count - 1 - ahead) * stride
        g = self.compiler.lower(inp, Window(start, count, stride=stride))
        g = torch.broadcast_to(g, (count, inp.channels))
        first = self.compiler.position + start
        idx = first + stride * torch.arange(
            count, device=self.compiler.device).reshape(-1, 1)
        return torch.where(idx >= 0, g, torch.zeros((), device=g.device))

    def in_context(self, name: PortName, context_frames: int):
        inp = self._input(name)
        n, frames = context_frames, self.nframes
        if inp is None:
            return self._zeros(n + frames)
        ch = inp.channels
        before = self.compiler.lower(inp, Window(self.window.offset - n, n))
        main = self.compiler.lower(inp, self.window)
        x = torch.cat([torch.broadcast_to(before, (n, ch)),
                       torch.broadcast_to(main, (frames, ch))], dim=0)
        # zero frames before the start of the timeline
        first = self.compiler.position + self.window.offset - n
        idx = first + torch.arange(n + frames,
                                   device=x.device).reshape(-1, 1)
        return torch.where(idx >= 0, x, torch.zeros((), device=x.device))

    def in_channels(self, name: PortName) -> typing.Optional[int]:
        inp = self._input(name)
        return None if inp is None else inp.channels

    def param(self, name: str):
        return self.compiler.node_param(self.node, name)

    def sosfilt(self, coeffs, x):
        from signals_tpu_torch.compiler import filters as _filters
        return _filters.sosfilt(coeffs, x)


class _Compiler:
    """One lowering of one patch at one (block_frames, rate, channels)."""

    def __init__(self, index: _GraphIndex):
        self.index = index
        self.rate = index.rate
        self.block_frames = index.block_frames
        self.device = index.device
        self.xp = TorchXP(index.device)
        # set per render:
        self.position: int = 0
        self.params = None
        self._memo: dict[tuple[int, Window], typing.Any] = {}
        self._collected: set[tuple[int, Window]] = set()
        #: id(node) -> float: substitute the node's lowered output with a
        #: constant — the linear-coefficient traces of the mix epilogue
        #: (:meth:`CompiledPatch.mega_mix`)
        self.node_const: dict[int, float] = {}

    # -- window collection --------------------------------------------------

    def collect(self, node: Emitter, window: Window) -> None:
        key = (id(node), window)
        if key in self._collected:
            return
        self._collected.add(key)
        if window.end > self.block_frames:
            raise CompileError(
                f'window {window} of {node.cls_name()} extends past the '
                f'block end')
        if getattr(node, 'is_host_source', False) \
                or node.flags() & (SignalFlags.CYCLIC | SignalFlags.VIS
                                   | SignalFlags.RECORDER):
            raise CompileError(f'{node.cls_name()} is not ported yet')
        if _is_grid_stateless(node):
            for pname, stride, count in node.grid_windows(
                    self.block_frames, self.rate):
                inp = node._ports[pname].sig
                if inp is None:
                    continue
                anchor_off = stride * (window.offset // stride)
                nb = max(1, 1 + (window.end - 1 - anchor_off) // stride)
                start = anchor_off - (count - 1) * stride
                self.collect(inp, Window(start, count + nb - 1,
                                         stride=stride))
            return
        if _is_stateful(node):
            raise CompileError(f'{node.cls_name()} carries state across '
                               f'blocks; the port lowers carry-free '
                               f'patches only so far')
        node.kernel(_CollectCtx(self, node, window))

    # -- params ---------------------------------------------------------------

    def node_param(self, node: Emitter, name: str):
        uid = self.index.info(node).uid
        return self.params[uid][name]

    @staticmethod
    def extract_params(index: _GraphIndex) -> dict:
        """Read traced param values off the live graph into the params
        dict ``uid -> name -> tensor`` on the index's device (called before
        every render, so edits take effect without recompiling)."""
        params: dict[str, dict[str, torch.Tensor]] = {}
        for node in index.order:
            state = node.get_state()
            leaves = {}
            for pname, param in type(state)._params.items():
                if param.traced:
                    v = getattr(state, pname)
                    if isinstance(v, bool):
                        arr = np.asarray(v)
                    elif isinstance(v, (int, np.integer)):
                        arr = np.asarray(v, dtype=np.int32)
                    else:
                        arr = np.asarray(v, dtype=F32)
                    leaves[pname] = torch.as_tensor(arr, device=index.device)
            if leaves:
                params[index.info(node).uid] = leaves
        return params

    # -- lowering -------------------------------------------------------------

    def lower(self, node: Emitter, window: Window):
        key = (id(node), window)
        if key in self._memo:
            return self._memo[key]
        const = self.node_const.get(id(node))
        if const is not None:
            return torch.full((1, 1), const, dtype=torch.float32,
                              device=self.device)
        # (stateful nodes never get here: collect() rejected them)
        ctx = LowerCtx(self, node, window)
        if _is_grid_stateless(node):
            result = node.grid_kernel(ctx, self.block_frames)
        else:
            result = node.kernel(ctx)
        result = torch.as_tensor(result, dtype=torch.float32,
                                 device=self.device)
        enabled = self.node_param(node, 'enabled')
        result = torch.where(enabled, result,
                             torch.zeros((), device=self.device))
        self._memo[key] = result
        return result


class CompiledPatch:
    """A patch compiled at fixed (block_frames, rate, channels, device).

    ``step(params, position)`` renders one block, ``render_core(n_blocks)``
    returns the multi-block render callable; ``params()`` re-reads traced
    state off the live graph, so node edits apply without recompiling.
    """

    def __init__(self, root: Emitter, *, block_frames: int, rate: int,
                 channels: int, device='cuda'):
        self.root = root
        self.block_frames = block_frames
        self.rate = rate
        self.channels = channels
        self.device = check_device(device)
        self.index = _GraphIndex(root, block_frames, rate, channels,
                                 self.device)
        self.graph_hash = self.index.graph_hash()
        # window discovery over one block: also rejects what the port
        # cannot lower yet, at compile time
        _Compiler(self.index).collect(root, Window(0, block_frames))
        #: carried state: empty for every patch this port lowers so far
        self.carry0: dict = {}
        self._render_cache: dict[int, typing.Any] = {}

    # -- public API -----------------------------------------------------------

    def params(self) -> dict:
        return _Compiler.extract_params(self.index)

    @property
    def carry_seg_align(self) -> int:
        """Blocks per carry segment of the patch's SWEPT-carry filters (1 =
        none): the lcm of every filter's ``swept_carry_m``.  A render that
        starts off a multiple of this many blocks widens each swept filter's
        window back to its segment start (at most ``align - 1`` extra
        blocks); :class:`~signals_tpu_torch.runtime.Transport` re-aligns
        its batches after such a seek."""
        import math as _math
        from signals_tpu_torch.compiler import filters as _filters
        from signals_tpu_torch.nodes.fx import CritFilter
        if self.block_frames != _filters.CARRY_GRID_FRAMES:
            return 1
        m = 1
        for n in self.index.order:
            if isinstance(n, CritFilter):
                mm = n.swept_carry_m(self.index.seg_carry_blocks)
                m = m * mm // _math.gcd(m, mm)
        return m

    def _compiler(self, params, position: int) -> _Compiler:
        comp = _Compiler(self.index)
        comp.params = params
        comp.position = position
        return comp

    def step(self, params, position: int):
        """One block at ``position`` (any block multiple), lowered at
        ``Window(0, F)``: returns ``(F, ch)`` on the patch's device.  Every
        patch the port lowers is carry-free, so there is no carry in or out.
        Filters take their per-block paths: zero-state replay of each
        block's context (:func:`~signals_tpu_torch.compiler.kernels.
        sosfilt_timeline`), or, for swept cutoffs, one segment-kernel call
        over the block's carry segment up to it."""
        F = self.block_frames
        block = self._compiler(params, position).lower(self.root,
                                                       Window(0, F))
        return torch.broadcast_to(block, (F, self.channels))

    def mega_core(self, n_blocks: int):
        """The plain plan ``(params, position0) -> blocks (n, F, ch)``: the
        whole batch lowers as ONE window — controls as per-block grid
        samples, each filter as one kernel call writing ``(n_blocks, F,
        V)``, the downstream nodes elementwise."""
        F = self.block_frames

        def many(params, position0: int):
            comp = self._compiler(params, position0)
            block = comp.lower(self.root, Window(0, n_blocks * F))
            block = torch.broadcast_to(block, (n_blocks * F, self.channels))
            return block.reshape(n_blocks, F, self.channels)

        return many

    def mega_mix(self, n_blocks: int):
        """The mix-epilogue plan: the VOICE SUM ``sum_ch root`` with the
        reduction folded into the filter kernel — the counterpart of the JAX
        package's ``packed_mega_mix`` with the stream count at 1 — or
        ``None`` when ineligible.

        Eligible when the patch has exactly one ``CritFilter``, V voices
        wide (V >= 2), and every path from it to the root is
        voice-broadcast-linear (:func:`_voice_linear_to_root`).  Then::

            sum_v root_v = A * ysum + S0
            A    = (S1 - S0) / V        (voice-constant by the proof)
            S0   = sum_v root_v | y := 0
            S1   = sum_v root_v | y := 1
            ysum = the in-kernel lane sum of the filter output

        ``S0``/``S1`` are constant-substitution lowerings (the filter output
        replaced by a constant); the nodes that do not depend on the filter
        (the envelope, the controls) are lowered once and shared by both,
        as the JAX package's XLA program shares them by CSE.  Returns
        ``many(params, position0) -> mix (n_blocks, F, 1)``.  The voice sum
        is reassociated, so results match the plain plan to f32
        reassociation, not bit-exactly.
        """
        from signals_tpu_torch.nodes.fx import CritFilter
        V = self.channels
        filters = [n for n in self.index.order if isinstance(n, CritFilter)]
        if V < 2 or len(filters) != 1:
            return None
        f = filters[0]
        if f.channels != V or not _voice_linear_to_root(f, self.root):
            return None
        F = self.block_frames
        main = Window(0, n_blocks * F)
        inv_v = F32(1.0 / V)
        dependent = _downstream(f)

        def many_mix(params, position0: int):
            comp = self._compiler(params, position0)
            ysum = f.family_sum(LowerCtx(comp, f, main), (F, n_blocks))
            ys = torch.where(comp.node_param(f, 'enabled'),
                             ysum.reshape(n_blocks * F, 1),
                             torch.zeros((), device=self.device))
            shared: dict = {}

            def sub_sum(const):
                sub = self._compiler(params, position0)
                sub.node_const = {id(f): const}
                sub._memo.update(shared)
                r = sub.lower(self.root, main)
                shared.update((k, v) for k, v in sub._memo.items()
                              if k[0] not in dependent)
                if r.shape[1] == 1:          # voice-constant: V equal terms
                    return r * F32(V)
                return r.sum(dim=1, keepdim=True)

            s0 = sub_sum(0.0)
            s1 = sub_sum(1.0)
            mix = (s1 - s0) * (ys * inv_v) + s0
            return mix.reshape(n_blocks, F, 1)

        return many_mix

    def render_core(self, n_blocks: int):
        """``(params, position0) -> blocks (n, F, ch)`` (the plain plan,
        cached per batch size)."""
        if n_blocks not in self._render_cache:
            self._render_cache[n_blocks] = self.mega_core(n_blocks)
        return self._render_cache[n_blocks]

    def check_position(self, position: int, n_blocks: int) -> None:
        """Render starts must be whole blocks, and every frame a render
        touches (up to the end of its last carry segment, plus one block)
        must stay addressable by an int32 frame index.  Any block may
        start a render: swept filters widen their windows back to the
        segment start themselves."""
        F = self.block_frames
        if position % F:
            raise ValueError(f'position {position} is not a multiple of the '
                             f'block size {F}')
        align = self.carry_seg_align
        last = -(-(position // F + n_blocks) // align) * align
        if (last + 1) * F > np.iinfo(np.int32).max:
            raise ValueError(f'frames past {np.iinfo(np.int32).max} are not '
                             f'addressable (int32 frame index)')

    def render(self, *, position: int = 0, n_blocks: int = 1):
        """Render ``n_blocks`` blocks from ``position`` (any block
        multiple; one block goes through :meth:`step`); returns audio
        ``(n*F, ch)`` on the patch's device.  The output equals the
        oracle's absolute-aligned semantics at any start."""
        self.check_position(position, n_blocks)
        if n_blocks == 1:
            return self.step(self.params(), position)
        blocks = self.render_core(n_blocks)(self.params(), position)
        return blocks.reshape(n_blocks * self.block_frames, self.channels)


_compile_cache: dict[str, CompiledPatch] = {}
_COMPILE_CACHE_MAX = 32


def compile_node(root: Emitter, *, block_frames: int, rate: int,
                 channels: typing.Optional[int] = None,
                 device='cuda') -> CompiledPatch:
    """Compile (with caching keyed on the canonical graph hash, which
    includes the device) the patch rooted at ``root``."""
    if channels is None:
        channels = root.channels
    device = check_device(device)
    index = _GraphIndex(root, block_frames, rate, channels, device)
    key = index.graph_hash()
    cached = _compile_cache.get(key)
    if cached is not None and cached.root is root:
        return cached
    compiled = CompiledPatch(root, block_frames=block_frames, rate=rate,
                             channels=channels, device=device)
    if len(_compile_cache) >= _COMPILE_CACHE_MAX:
        _compile_cache.pop(next(iter(_compile_cache)))
    _compile_cache[key] = compiled
    return compiled
