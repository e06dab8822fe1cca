"""The patch compiler (``signals_tpu.compiler``), in eager PyTorch.

The JAX package traces a patch once into a fused XLA program.  This port
keeps its lowering design — node kernels evaluated against a lowering
context, memoized per ``(node, window)`` so fan-out is shared — but runs it
eagerly: a render lowers the whole batch as ONE multi-block window on the
target device where the patch allows it, with the filter cascade in the
hand-written kernels (:mod:`signals_tpu_torch.compiler.kernels`).  A
per-block step (:meth:`CompiledPatch.step`) lowers one block the same way.

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
  _family_compute`), so a render may start at any block.  The filter
  reads its input and crits over one fixed window reaching ``m - 1``
  blocks (plus its context) behind the window it renders, and ending
  where that window ends: the collect pass registers it, so history rings
  and host inputs serve it whatever the start's phase in its segment.

* **Carried state.**  Stateful nodes (delay lines, streaming filters)
  thread a carry — a plain dict ``uid -> name -> tensor`` on the patch's
  device — through :meth:`CompiledPatch.step` and :meth:`CompiledPatch.
  render`; each also keeps an output-history ring in it so that windows
  reaching *before* the current one are served from history.  A delay's
  output is a read of its input-history buffer, which cuts feedback cycles:
  the delay's input is lowered after everything that reads its output.

Plans, chosen by :meth:`CompiledPatch.render_core` in the JAX package's
order: the whole-window plan (:meth:`CompiledPatch.mega_core`; stateful
nodes ``mega_step``), the loop-free delay solver (:meth:`CompiledPatch.
delay_mega_core`), the segmented feedback scan (:meth:`CompiledPatch.
segment_scan_core`), the per-block loop; and, for carry-free polyphony, the
mix-epilogue plan (:meth:`CompiledPatch.mega_mix`).

* **Taps.**  Visualization nodes (``SignalFlags.VIS``) and recorders
  (``SignalFlags.RECORDER``: a ``FileWriter``) lower as pass-throughs and
  register their output over the main window as an extra render output:
  every plan returns ``taps`` (``uid -> (n_blocks, F, ch)`` on the device),
  :meth:`CompiledPatch.render` hands each enabled tap its blocks on the
  host, :meth:`CompiledPatch.render_vis` reduces them to display summaries
  on the device and copies only those.

* **Encoded output.**  :meth:`CompiledPatch.render_encoded` and
  :meth:`CompiledPatch.render_encoded_stream` encode the rendered audio on
  the device (:func:`signals_tpu_torch.runtime.codecs.device_encode`:
  PCM16, G.711, IMA ADPCM, SLAC) and copy only the payload off it; the
  stream copies each batch on a side stream while the next batch renders.

* **Host inputs.**  A host source (a ``FileReader``) is not lowered: every
  window the collect pass saw requested of it is a staged input
  (:meth:`CompiledPatch.stage_host`), read on the host as numpy ``(n_blocks,
  frames, ch)`` per window once per render, copied to the device in one
  transfer and sliced per block there.  A host-fed patch renders per block
  (``plan() == 'blocks'``), as in the JAX package.

Not ported: lane packing.
"""

from __future__ import annotations

import collections
import hashlib
import typing

import numpy as np
import torch

from signals_tpu_torch import PortName, SignalFlags
from signals_tpu_torch.core import ChainLayerError
from signals_tpu_torch.core.xp import NP, TorchXP, to_device
from signals_tpu_torch.graph import (
    Emitter,
    KernelCtx,
    Receiver,
    StatefulEmitter,
    Wiring,
    frozen_wiring,
)
from signals_tpu_torch.utils import span

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
        #: every window the collect pass saw requested of this node
        self.windows: set[Window] = set()

    @property
    def min_offset(self) -> int:
        return min((w.offset for w in self.windows), default=0)


def _is_delay(node) -> bool:
    from signals_tpu_torch.nodes.delay import Delay
    return isinstance(node, Delay)


def _is_grid_stateless(node) -> bool:
    """Node offering a carry-free grid-history lowering (``grid_kernel``)."""
    return getattr(node, 'is_grid_stateless', False)


def _is_stateful(node) -> bool:
    return isinstance(node, StatefulEmitter) and node.is_stateful()


def _is_tap(node) -> bool:
    return bool(node.flags() & (SignalFlags.VIS | SignalFlags.RECORDER))


def _is_host_source(node) -> bool:
    return getattr(node, 'is_host_source', False)


def _host_key(uid: str, w: Window) -> str:
    """Stable name of a host-staged input window (stride disambiguates a
    strided control-grid window from a contiguous one at the same span) —
    the JAX package's key."""
    suffix = f',{w.stride}' if w.stride != 1 else ''
    return f'{uid}@{w.offset},{w.frames}{suffix}'


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
    it.  A node with no outputs (a sink: a ``Receiver`` that is not an
    ``Emitter``) ends its branch of the walk."""
    seen = {id(node): node}
    frontier = [node]
    while frontier:
        n = frontier.pop()
        if not isinstance(n, Emitter):
            continue
        for _pname, recv in n.outputs_with_ports:
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
        #: the connections as hashed: every lowering of the patch reads
        #: the graph through them (``CompiledPatch._frozen``), so a
        #: structural edit of the live graph does not reach a compiled
        #: program
        self.wiring = Wiring(self.order)

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
            extra = getattr(node, 'structural_extra', None)
            if extra is not None:
                # node-defined structural identity beyond its params (a
                # Convolve's IR file mtime and taps: an edit on disk
                # recompiles instead of serving the cached spectrum)
                h.update(f';X={extra()}'.encode())
            if isinstance(node, Receiver):
                for pname in node.port_names():
                    inp = node._ports[pname].sig
                    if inp is not None:
                        h.update(f';{pname}<-{self.info(inp).uid}'.encode())
        return h.hexdigest()


# --- window-collection pass (dry run with dummy numpy blocks) ---------------


class _CollectCtx(KernelCtx):
    """Runs kernels on zero-filled numpy blocks to walk the windows each
    node requests of its inputs (and so how much history stateful nodes
    must retain) — rejecting, at compile time, windows past the block end
    and nodes this port cannot lower."""

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
            if self.window.stride > 1:
                # mirrors LowerCtx.in_block_rate: a grid-sampled node
                # samples its block-rate inputs at the same grid
                self.compiler.collect(inp, self.window)
            else:
                self.compiler.collect(inp, Window(self.window.offset, 1))
        return self._dummy(inp, 1 if self.window.stride == 1
                           else self.window.frames)

    def in_context(self, name: PortName, context_frames: int):
        inp = self._input(name)
        if inp is not None:
            self.compiler.collect(
                inp, Window(self.window.offset - context_frames,
                            context_frames))
            self.compiler.collect(inp, self.window)
        return self._dummy(inp, context_frames + self.nframes)

    def in_grid_samples(self, name: PortName, stride: int, count: int,
                        ahead: int = 0):
        # mirrors LowerCtx.in_grid_samples: one strided window
        inp = self._input(name)
        if inp is not None:
            anchor_off = stride * (self.window.offset // stride)
            start = anchor_off - (count - 1 - ahead) * stride
            self.compiler.collect(inp, Window(start, count, stride=stride))
        return self._dummy(inp, count)

    def in_channels(self, name: PortName) -> typing.Optional[int]:
        inp = self._input(name)
        return None if inp is None else inp.channels

    def param(self, name: str):
        return getattr(self.node._state, name)

    def sosfilt(self, coeffs, x):
        coeffs = np.asarray(coeffs)
        ch = max(coeffs.shape[1], x.shape[1])
        return np.zeros((x.shape[0], ch), dtype=F32)

    def sosfilt_stream(self, coeffs, x, zi):
        coeffs = np.asarray(coeffs)
        ch = max(coeffs.shape[1], x.shape[1], np.asarray(zi).shape[-1])
        return (np.zeros((x.shape[0], ch), dtype=F32),
                np.zeros_like(np.asarray(zi)))


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

    def sosfilt_stream(self, coeffs, x, zi):
        from signals_tpu_torch.compiler import filters as _filters
        return _filters.sosfilt_stream(coeffs, x, zi)


class _Compiler:
    """One lowering of one patch at one (block_frames, rate, channels)."""

    def __init__(self, index: _GraphIndex):
        self.index = index
        self.rate = index.rate
        self.block_frames = index.block_frames
        self.device = index.device
        self.xp = TorchXP(index.device)
        # set per lowering:
        self.position: int = 0
        self.params = None
        #: carried state in (``uid -> name -> tensor``) and out
        self.carry_in: dict = {}
        self.carry_out: dict = {}
        #: the window stateful nodes advance over in this lowering: one
        #: block for a step, the whole batch or segment otherwise
        self.main = Window(0, index.block_frames)
        self._memo: dict[tuple[int, Window], typing.Any] = {}
        self._collected: set[tuple[int, Window]] = set()
        self._stateful_done: set[int] = set()
        #: uid -> a tap node's output over the main window ``(frames, ch)``
        self.taps: dict[str, typing.Any] = {}
        #: host key -> this lowering's staged host input ``(frames, ch)``
        #: on the device (:func:`_host_key`)
        self.host: dict[str, torch.Tensor] = {}
        #: id(delay) -> full input timeline ``cat(buf, u)`` covering
        #: frames [-B, total) — set by the delay solver
        #: (CompiledPatch.delay_mega_core); _lower_delay serves windows
        #: from it instead of the carry read
        self.delay_solved: dict[int, typing.Any] = {}
        #: id(delay) -> float: substitute this delay's output with a
        #: constant (the g/h extraction traces of the affine loop solver)
        self.delay_const: dict[int, float] = {}
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
        self.index.info(node).windows.add(window)
        if window.end > self.block_frames:
            raise CompileError(
                f'window {window} of {node.cls_name()} extends past the '
                f'block end')
        if _is_host_source(node):
            return                      # staged: CompiledPatch.stage_host
        if _is_delay(node):
            # delay output comes from history; its input is pulled at the
            # main window each step
            inp = node._ports['input'].sig
            if inp is not None:
                self.collect(inp, Window(0, self.block_frames))
            return
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
            # stateful nodes step once per block at the main window
            ctx = _CollectCtx(self, node, Window(0, self.block_frames))
            carry = node.init_carry(channels=node.channels, rate=self.rate,
                                    block_frames=self.block_frames)
            node.step(ctx, carry)
            return
        m = self.carry_seg_blocks(node)
        F = self.block_frames
        if m > 1 and window.offset % F == 0 and window.frames % F == 0:
            self._collect_swept(node, window, m)
            return
        node.kernel(_CollectCtx(self, node, window))

    def _collect_swept(self, node, window: Window, m: int) -> None:
        """The windows a swept filter with ``m``-block carry segments reads
        at a window of whole blocks (:meth:`~signals_tpu_torch.nodes.fx.
        CritFilter._family_compute`): its input from ``m - 1`` blocks and
        its context before the window up to the window's end, its crits on
        the block grid over the same blocks.  The lookback sizes the
        history a delay or a stateful producer keeps; a host source is
        staged at exactly these windows."""
        F = self.block_frames
        back = (m - 1) * F
        w0 = window.offset - back
        C = node.context_frames()
        inp = node._ports['input'].sig
        if inp is not None:
            self.collect(inp, Window(w0 - C, C))
            self.collect(inp, Window(w0, back + window.frames))
        nb = (back + window.frames) // F
        for pname in node.port_names():
            sig = node._ports[pname].sig
            if pname != 'input' and sig is not None:
                self.collect(sig, Window(w0, nb, stride=F))

    def carry_seg_blocks(self, node) -> int:
        """Blocks per carry segment ``node`` engages at this block size (1:
        none, or not a filter)."""
        from signals_tpu_torch.compiler import filters as _filters
        if (not hasattr(node, 'swept_carry_m')
                or self.block_frames != _filters.CARRY_GRID_FRAMES):
            return 1
        return node.swept_carry_m(self.index.seg_carry_blocks)

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
                    leaves[pname] = to_device(arr, index.device)
            if leaves:
                params[index.info(node).uid] = leaves
        return params

    def init_carry(self) -> dict:
        """The initial carry ``uid -> name -> tensor`` on the device: each
        stateful node's own state, a delay's input line (its length plus
        the history its consumers look back), and a ``hist`` output ring
        for a stateful node that is read before the current window."""
        carry: dict[str, dict[str, torch.Tensor]] = {}
        for node in self.index.order:
            info = self.index.info(node)
            hist = max(0, -info.min_offset)
            if _is_grid_stateless(node):
                continue            # lowered carry-free
            if _is_delay(node):
                c = node.init_carry(
                    channels=node.channels, rate=self.rate,
                    block_frames=self.block_frames, history=hist)
            elif _is_stateful(node):
                c = node.init_carry(channels=node.channels, rate=self.rate,
                                    block_frames=self.block_frames)
                if hist > 0:
                    c['hist'] = np.zeros((hist, node.channels), dtype=F32)
            else:
                continue
            carry[info.uid] = {k: to_device(v, self.device)
                               for k, v in c.items()}
        return carry

    # -- lowering -------------------------------------------------------------

    def _zero(self):
        return torch.zeros((), dtype=torch.float32, device=self.device)

    def _const(self, value: float):
        return torch.full((1, 1), value, dtype=torch.float32,
                          device=self.device)

    def lower(self, node: Emitter, window: Window):
        key = (id(node), window)
        if key in self._memo:
            # a result shared in from another trace still registers its tap
            return self._note_tap(node, window, self._memo[key])
        const = self.node_const.get(id(node))
        if const is not None:
            return self._const(const)
        with span('lower.', type(node).__name__):
            if _is_host_source(node):
                # a disabled reader is silent, as in the pull oracle
                result = torch.where(
                    self.node_param(node, 'enabled'),
                    self.host[_host_key(self.index.info(node).uid, window)],
                    self._zero())
            elif _is_delay(node):
                result = self._lower_delay(node, window)
            elif _is_grid_stateless(node):
                ctx = LowerCtx(self, node, window)
                result = to_device(node.grid_kernel(ctx, self.block_frames),
                                   self.device, torch.float32)
                result = torch.where(self.node_param(node, 'enabled'),
                                     result, self._zero())
            elif _is_stateful(node):
                result = self._lower_stateful(node, window)
            else:
                ctx = LowerCtx(self, node, window)
                result = to_device(node.kernel(ctx), self.device,
                                   torch.float32)
                result = self._apply_enabled(node, window, result)
        self._memo[key] = result
        return self._note_tap(node, window, result)

    def _note_tap(self, node: Emitter, window: Window, result):
        """Taps register their output at the main window only; returns
        ``result``."""
        if window == self.main and _is_tap(node):
            self.taps[self.index.info(node).uid] = torch.broadcast_to(
                result, (window.frames, node.channels))
        return result

    def _apply_enabled(self, node: Emitter, window: Window, result):
        enabled = self.node_param(node, 'enabled')
        if node.flags() & SignalFlags.PASSTHRU:
            # a disabled side-effect node forwards its input unchanged
            inp = node._ports['input'].sig
            alt = (self._const(0.0) if inp is None
                   else self.lower(inp, window))
            result, alt = torch.broadcast_tensors(result, alt)
            return torch.where(enabled, result, alt)
        return torch.where(enabled, result, self._zero())

    def _serve_history(self, node: Emitter, window: Window, current):
        """Serve any sub-window of [-H, M) from the node's ``hist`` ring +
        its output over the main window (M frames)."""
        uid = self.index.info(node).uid
        hist = self.carry_in.get(uid, {}).get('hist')
        cur = torch.broadcast_to(current, (self.main.frames, node.channels))
        if hist is None:
            full, base = cur, 0
        else:
            full, base = torch.cat([hist, cur]), hist.shape[0]
        start = base + window.offset
        span = (window.frames - 1) * window.stride + 1
        if start < 0 or start + span > full.shape[0]:
            raise CompileError(
                f'{node.cls_name()} history too short for window {window}')
        return full[start:start + span:window.stride]

    def _lower_stateful(self, node: StatefulEmitter, window: Window):
        """One main-window step (``mega_step`` over a window of several
        blocks, ``step`` over one block), memoized; any other requested
        window — context lookbacks, block-rate samples, all non-future by
        the collect pass — is served from the node's ``hist`` carry ring +
        the main block via :meth:`_serve_history`."""
        uid = self.index.info(node).uid
        main = self.main
        mkey = (id(node), main)
        if id(node) not in self._stateful_done:
            self._stateful_done.add(id(node))
            ctx = LowerCtx(self, node, main)
            carry_in = self.carry_in[uid]
            carry = {k: v for k, v in carry_in.items() if k != 'hist'}
            step = (node.mega_step if main.frames > self.block_frames
                    else node.step)
            block, new_carry = step(ctx, carry)
            block = to_device(block, self.device, torch.float32)
            block = torch.broadcast_to(block, (main.frames, node.channels))
            block = torch.where(self.node_param(node, 'enabled'), block,
                                self._zero())
            out_carry = dict(new_carry)
            if 'hist' in carry_in:
                h = carry_in['hist'].shape[0]
                out_carry['hist'] = torch.cat([carry_in['hist'], block])[-h:]
            self.carry_out[uid] = out_carry
            self._memo[mkey] = block
        current = self._memo[mkey]
        if window == main:
            return current
        return self._serve_history(node, window, current)

    def _lower_delay(self, node, window: Window):
        """Delay output is a pure read of the input-history buffer; the
        input itself is lowered afterwards at the main window
        (:meth:`finalize_delays`) — that is what breaks feedback cycles.

        Two more modes serve the loop-free delay solver
        (:meth:`CompiledPatch.delay_mega_core`): a *substituted* delay
        lowers to a constant (the affine g/h extraction traces), and a
        *solved* delay serves any window as a slice of its precomputed
        full input timeline."""
        const = self.delay_const.get(id(node))
        if const is not None:
            return self._const(const)
        D = node.delay_frames(self.rate)
        span = (window.frames - 1) * window.stride + 1
        enabled = self.node_param(node, 'enabled')
        solved = self.delay_solved.get(id(node))
        if solved is not None:
            # solved covers input frames [-B, total); output[t] = input[t-D]
            B = solved.shape[0] - self.main.frames
            start = B - D + window.offset
            if start < 0:
                raise CompileError(
                    f'{node.cls_name()}: delay history too short for '
                    f'{window}')
            out = solved[start:start + span:window.stride]
            return torch.where(enabled, out, self._zero())
        buf = self.carry_in[self.index.info(node).uid]['buf']
        B = buf.shape[0]             # (B, ch): frames [pos-B, pos)
        if D < window.end:
            raise CompileError(
                f'{node.cls_name()}: delay of {D} frames is shorter than '
                f'the {window.end} frames read ahead of it; feedback delays '
                f'must be at least one block long')
        start = B + window.offset - D
        if start < 0:
            raise CompileError(
                f'{node.cls_name()}: delay buffer too short for {window}')
        out = buf[start:start + span:window.stride]
        return torch.where(enabled, out, self._zero())

    def finalize_delays(self) -> None:
        """After the root is lowered, lower every delay's input at the main
        window and emit its buffer update.  Lowering one delay's input may
        read other delays' outputs (their reads come from the carry, so
        there is no cycle); every delay in the index gets its buffer
        advanced."""
        main = self.main
        for node in self.index.order:
            if not _is_delay(node):
                continue
            uid = self.index.info(node).uid
            buf = self.carry_in[uid]['buf']
            B = buf.shape[0]
            inp = node._ports['input'].sig
            if inp is None:
                block = torch.zeros((main.frames, node.channels),
                                    dtype=torch.float32, device=self.device)
            else:
                block = torch.broadcast_to(self.lower(inp, main),
                                           (main.frames, node.channels))
            self.carry_out[uid] = {'buf': torch.cat([buf, block])[-B:]}

    def passthrough_carry(self) -> None:
        """Any carry entries not produced during lowering pass through."""
        for uid, c in self.carry_in.items():
            if uid not in self.carry_out:
                self.carry_out[uid] = c


class CompiledPatch:
    """A patch compiled at fixed (block_frames, rate, channels, device).

    ``step(params, carry, position)`` renders one block and returns it with
    the new carry, ``render_core(n_blocks)`` returns the multi-block render
    callable; ``params()`` re-reads traced state off the live graph, so
    node edits apply without recompiling.  ``carry0`` is the initial carry
    (empty for a carry-free patch); carries are never modified in place.
    """

    #: whole-window and segmented plans (False forces the per-block loop)
    enable_mega = True

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
        # window discovery over one block: sizes the history rings and
        # rejects what the port cannot lower yet, at compile time
        compiler = _Compiler(self.index)
        compiler.collect(root, Window(0, block_frames))
        #: the initial carried state, ``uid -> name -> tensor``
        self.carry0: dict = compiler.init_carry()
        #: ``(node, window, key)`` of every host-staged input
        self._host_spec = self._collect_host_spec()
        #: uid -> tap node (visualization, recorder), in graph order
        self.tap_nodes: dict[str, Emitter] = {
            self.index.info(n).uid: n for n in self.index.order
            if _is_tap(n)}
        self._render_cache: dict[int, typing.Any] = {}
        self._encoded_cache: dict[tuple, typing.Any] = {}

    def _frozen(self):
        """The context every lowering of this patch runs in: the graph read
        through the wiring it was compiled from (:func:`~signals_tpu_torch.
        graph.frozen_wiring`)."""
        return frozen_wiring(self.index.wiring)

    def _collect_host_spec(self) -> list[tuple]:
        """``(node, window, key)`` for every host-fed input window the
        collect pass discovered, in graph order."""
        spec = []
        for node in self.index.order:
            if _is_host_source(node):
                uid = self.index.info(node).uid
                spec.extend((node, w, _host_key(uid, w))
                            for w in sorted(self.index.info(node).windows))
        return spec

    # -- public API -----------------------------------------------------------

    def params(self) -> dict:
        return _Compiler.extract_params(self.index)

    def stage_host(self, position: int, n_blocks: int = 1) -> dict:
        """Read every host-fed input for ``n_blocks`` blocks from
        ``position`` on the host: ``key -> (n_blocks, frames, ch)`` float32
        numpy arrays (the JAX package's staging, as it does it)."""
        F = self.block_frames
        out = {}
        for node, w, key in self._host_spec:
            if w.stride == 1:
                out[key] = np.stack(
                    [node.host_read(position + i * F + w.offset, w.frames,
                                    self.rate) for i in range(n_blocks)],
                    axis=0)
                continue
            # strided control-grid window: one frame per grid step.
            # Consecutive blocks share all but `step` grid points, so read
            # each unique point once and assemble the blocks by slicing.
            step, rem = divmod(F, w.stride)
            if rem == 0:
                base0 = position + w.offset
                n_uniq = w.frames + (n_blocks - 1) * step
                uniq = np.concatenate(
                    [node.host_read(base0 + j * w.stride, 1, self.rate)
                     for j in range(n_uniq)], axis=0)
                out[key] = np.stack(
                    [uniq[i * step:i * step + w.frames]
                     for i in range(n_blocks)], axis=0)
                continue
            out[key] = np.stack(
                [np.concatenate(
                    [node.host_read(position + i * F + w.offset
                                    + k * w.stride, 1, self.rate)
                     for k in range(w.frames)], axis=0)
                 for i in range(n_blocks)], axis=0)
        return out

    def host_inputs(self, position: int, n_blocks: int = 1) -> dict:
        """:meth:`stage_host` on the patch's device: ``key -> (n_blocks,
        frames, ch)`` tensors, copied in ONE host-to-device transfer (from
        pinned memory, not blocking the host, on a GPU); ``{}`` for a patch
        without host inputs."""
        with span('patch.host_inputs'):
            staged = self.stage_host(position, n_blocks)
            if not staged:
                return {}
            flat = np.concatenate([np.asarray(a, dtype=F32).reshape(-1)
                                   for a in staged.values()])
            buf = torch.from_numpy(flat)
            if self.device.type == 'cuda':
                buf = to_device(buf.pin_memory(), self.device,
                                non_blocking=True)
            out, at = {}, 0
            for key, a in staged.items():
                out[key] = buf[at:at + a.size].reshape(a.shape)
                at += a.size
            return out

    @staticmethod
    def _host_slice(host: dict, i: int) -> dict:
        """Block ``i``'s host inputs ``key -> (frames, ch)`` (views)."""
        return {k: v[i] for k, v in host.items()}

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

    def _compiler(self, params, position: int, carry=None,
                  n_blocks: int = 1, host=None) -> _Compiler:
        """A lowering of ``n_blocks`` blocks from ``position``; ``host`` is
        its staged host inputs ``key -> (frames, ch)`` (one block)."""
        comp = _Compiler(self.index)
        comp.params = params
        comp.position = position
        comp.carry_in = {} if carry is None else carry
        comp.main = Window(0, n_blocks * self.block_frames)
        comp.host = {} if host is None else host
        return comp

    def _window(self, params, carry, position: int, n_blocks: int,
                host=None):
        """Lower ``n_blocks`` blocks from ``position`` as one window whose
        delay reads all come from the carry: ``(blocks (n, F, ch), carry',
        taps)``.  The body of :meth:`step`, :meth:`mega_core` and the
        segments of :meth:`segment_scan_core`."""
        F = self.block_frames
        comp = self._compiler(params, position, carry, n_blocks, host)
        block = comp.lower(self.root, comp.main)
        block = torch.broadcast_to(block, (n_blocks * F, self.channels))
        comp.finalize_delays()
        comp.passthrough_carry()
        return (block.reshape(n_blocks, F, self.channels), comp.carry_out,
                self._block_taps(comp, n_blocks))

    def _block_taps(self, comp: _Compiler, n_blocks: int) -> dict:
        """The taps a lowering registered, ``uid -> (n_blocks, F, ch)``."""
        return {uid: t.reshape(n_blocks, self.block_frames, -1)
                for uid, t in comp.taps.items()}

    def step(self, params, carry, position: int, host=None):
        """One block at ``position`` (any block multiple), lowered at
        ``Window(0, F)``: returns ``(block (F, ch), carry')`` on the
        patch's device (pass ``carry0``, or ``{}`` for a carry-free patch,
        to start).  ``host`` is the block's host inputs, ``key -> (F', ch)``
        tensors on the device (``host_inputs(position)`` sliced at block
        0); None stages them here.  Filters take their per-block paths:
        zero-state replay of each block's context (:func:`~signals_tpu_torch.
        compiler.kernels.sosfilt_timeline`); for swept cutoffs, one
        segment-kernel call over the block's carry segment up to it; for
        streaming filters, the carried-state kernel
        (:func:`~signals_tpu_torch.compiler.kernels.sosfilt_stream`)."""
        if host is None:
            host = self._host_slice(self.host_inputs(position), 0)
        with self._frozen():
            blocks, carry2, _taps = self._window(params, carry, position, 1,
                                                 host)
        return blocks[0], carry2

    @property
    def mega_compatible(self) -> bool:
        """Whether the patch can render a whole batch as one window: no
        delays (feedback is sequential), no host sources (their inputs are
        staged per block), and any stateful node offers
        either a carry-free grid lowering or a whole-window ``mega_step``
        (streaming filters).  Consumers may read a mega-stepped node at any
        non-future window: the collect pass sizes a ``hist`` carry ring and
        :meth:`_Compiler._serve_history` serves those windows."""
        for node in self.index.order:
            if _is_delay(node) or _is_host_source(node):
                return False
            if _is_stateful(node) and not _is_grid_stateless(node):
                if not getattr(node, 'supports_mega_step', False):
                    return False
        return True

    @property
    def _use_mega(self) -> bool:
        """The whole-window plan whenever the patch allows it.  (The JAX
        package also weighs the channel width against its per-block
        ``vmap`` path and lane packing, neither of which the port has.)"""
        return self.enable_mega and self.mega_compatible

    def mega_core(self, n_blocks: int):
        """The plain plan ``(params, carry, position0) -> (blocks (n, F,
        ch), carry', taps)``: the whole batch lowers as ONE window —
        controls as per-block grid samples, each filter as one kernel call
        writing ``(n_blocks, F, V)``, streaming filters through
        ``mega_step``, the downstream nodes elementwise.  Requires
        :attr:`mega_compatible`."""
        def many(params, carry, position0: int):
            return self._window(params, carry, position0, n_blocks)

        return many

    def delay_mega_plan(self):
        """The patch's :class:`~signals_tpu_torch.compiler.feedback.
        DelayPlan` (cached), or None when its delay feedback cannot be
        solved loop-free."""
        if not self.enable_mega:
            return None
        if not hasattr(self, '_delay_plan'):
            from signals_tpu_torch.compiler import feedback
            self._delay_plan = feedback.plan_delays(
                self.index, self.block_frames, self.rate)
        return self._delay_plan

    def delay_mega_core(self, n_blocks: int, plan):
        """Loop-free render of a delay/feedback patch: the whole batch is
        ONE window; each delay line is *solved* up front — out-of-cycle
        delays read their (already lowered) input timeline shifted,
        in-cycle delays solve the affine recurrence ``u[t] = g[t] u[t-D] +
        h[t]`` with one log-step scan over D-frame segments (``g``/``h``
        extracted by lowering the loop expression with the delay output
        substituted by 0 and 1 — sound because :func:`~signals_tpu_torch.
        compiler.feedback.plan_delays` proved the loop frame-local affine).
        Everything downstream then lowers exactly like :meth:`mega_core`.

        Semantics preserved from the per-block engine: block-quantized
        feedback (delay >= one block), buffer carry-in/out, ``enabled``
        gating on the delay output (the buffer still advances while
        disabled), zero pre-timeline context.
        """
        index = self.index
        F = self.block_frames
        total = n_blocks * F
        main = Window(0, total)

        def sub_trace(comp, inp, delay, const, dependent):
            """Lower ``inp`` at the main window with ``delay``'s output
            substituted by ``const``.  Nothing lowered so far depends on
            this delay, so the memo is shared in; what the trace adds off
            the delay's downstream closure is shared back (eager PyTorch
            has no common-subexpression pass to do it)."""
            sub = self._compiler(comp.params, comp.position, comp.carry_in,
                                 n_blocks)
            sub.carry_out = comp.carry_out
            sub._stateful_done = comp._stateful_done
            sub.delay_solved = comp.delay_solved
            sub.delay_const = {id(delay): const}
            sub._memo.update(comp._memo)
            out = sub.lower(inp, main)
            comp._memo.update((k, v) for k, v in sub._memo.items()
                              if k[0] not in dependent)
            return out

        def many(params, carry, position0: int):
            comp = self._compiler(params, position0, carry, n_blocks)
            zero = comp._zero()
            for node in plan.order:
                uid = index.info(node).uid
                inp = node._ports['input'].sig
                D = node.delay_frames(self.rate)
                buf = carry[uid]['buf']
                B = buf.shape[0]
                ch = node.channels
                if inp is None:
                    u = torch.zeros((total, ch), dtype=torch.float32,
                                    device=self.device)
                elif not plan.cyclic[id(node)]:
                    u = torch.broadcast_to(comp.lower(inp, main),
                                           (total, ch))
                else:
                    dependent = _downstream(node)
                    h = torch.broadcast_to(
                        sub_trace(comp, inp, node, 0.0, dependent),
                        (total, ch))
                    g = torch.broadcast_to(
                        sub_trace(comp, inp, node, 1.0, dependent),
                        (total, ch)) - h
                    # a disabled delay outputs zeros (g drops out) but its
                    # buffer still advances with the input
                    g = torch.where(comp.node_param(node, 'enabled'), g,
                                    zero)
                    pre = buf[B - D:]              # last D input frames
                    n_seg = -(-total // D)
                    pad = (0, 0, 0, n_seg * D - total)
                    A, Bc = _segment_scan(
                        torch.nn.functional.pad(g, pad).reshape(n_seg, D, ch),
                        torch.nn.functional.pad(h, pad).reshape(n_seg, D, ch))
                    u = (A * pre[None] + Bc).reshape(n_seg * D, ch)[:total]
                    if inp.channels == ch:
                        # downstream consumers of the loop node reuse the
                        # solved timeline instead of recomputing it
                        comp._memo[(id(inp), main)] = u
                in_full = torch.cat([buf, u])
                comp.delay_solved[id(node)] = in_full
                comp.carry_out[uid] = {'buf': in_full[-B:]}
            block = comp.lower(self.root, main)
            block = torch.broadcast_to(block, (total, self.channels))
            # memo injection can cut taps and stateful nodes off the root
            # walk — force them so that tap feeds and carries are produced
            for node in index.order:
                if _is_tap(node) or (
                        _is_stateful(node) and not _is_grid_stateless(node)
                        and not _is_delay(node)):
                    comp.lower(node, main)
            comp.passthrough_carry()
            return (block.reshape(n_blocks, F, self.channels),
                    comp.carry_out, self._block_taps(comp, n_blocks))

        return many

    def segment_scan_core(self, n_blocks: int):
        """Segmented feedback scan, or None: the general fast path for
        delay feedback the closed-form solver rejects (nonlinear saturated
        loops, mutually-coupled ping-pong pairs, longer dependency cycles).

        Inside a window of ``S`` blocks with ``S * F <= D`` for every
        delay, every delay read is served entirely from the carried buffer
        — there is NO cycle within the window, whatever the loop topology —
        so the window lowers exactly like a mega window (stateful nodes
        ``mega_step``, producers lower once over ``S*F`` frames) and a host
        loop chains the segments: the lowering's host cost is paid once per
        ``S`` blocks instead of per block.

        ``S`` is the largest divisor of ``n_blocks`` within the delay bound
        when that divisor is near the bound; otherwise ``S`` is the bound
        itself and the remainder renders as one shorter *tail* window
        (e.g. a prime ``n_blocks = 13`` with ``S_max = 5`` runs 2
        five-block segments + a 3-block tail).  Semantics are identical to
        the per-block loop.
        """
        if not self.enable_mega or n_blocks < 2:
            return None
        if not hasattr(self, '_segment_S'):
            from signals_tpu_torch.compiler import feedback
            self._segment_S = feedback.segment_blocks(
                self.index, self.block_frames, self.rate)
        s_max = min(self._segment_S, n_blocks)
        if s_max < 2:
            return None
        S = max((s for s in range(1, s_max + 1) if n_blocks % s == 0),
                default=1)
        if S < max(2, s_max // 2):
            S = s_max                    # a tail window for wide segments
        n_seg, rem = divmod(n_blocks, S)
        F = self.block_frames

        def many(params, carry, position0: int):
            out, tap_parts = [], []
            for i, nb in enumerate([S] * n_seg + ([rem] if rem else [])):
                blocks, carry, taps = self._window(params, carry,
                                                   position0 + i * S * F, nb)
                out.append(blocks)
                tap_parts.append(taps)
            return torch.cat(out), carry, _cat_taps(tap_parts)

        return many

    def mega_mix(self, n_blocks: int):
        """The mix-epilogue plan: the VOICE SUM ``sum_ch root`` with the
        reduction folded into the filter kernel — the counterpart of the JAX
        package's ``packed_mega_mix`` with the stream count at 1 — or
        ``None`` when ineligible.

        Eligible when the patch carries no state, reads no host input,
        holds no tap (the plan
        lowers no node of the filter's downstream at full width, so it has
        no tap feed to return: such a patch takes the plain plan, which
        delivers its taps) and has exactly one ``CritFilter``, V voices
        wide (V >= 2), and every path from it to the root is
        voice-broadcast-linear (:func:`_voice_linear_to_root`).
        Then::

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
        if (V < 2 or len(filters) != 1 or self.carry0 or self.tap_nodes
                or self._host_spec):
            return None
        f = filters[0]
        with self._frozen():
            if f.channels != V or not _voice_linear_to_root(f, self.root):
                return None
            dependent = _downstream(f)
        F = self.block_frames
        main = Window(0, n_blocks * F)
        inv_v = F32(1.0 / V)

        def many_mix(params, position0: int):
            with self._frozen():
                return mix(params, position0)

        def mix(params, position0: int):
            comp = self._compiler(params, position0, None, n_blocks)
            with span('lower.', type(f).__name__):
                ysum = f.family_sum(LowerCtx(comp, f, main), (F, n_blocks))
            ys = torch.where(comp.node_param(f, 'enabled'),
                             ysum.reshape(n_blocks * F, 1),
                             torch.zeros((), device=self.device))
            shared: dict = {}

            def sub_sum(const):
                sub = self._compiler(params, position0, None, n_blocks)
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

    @property
    def stateless_batchable(self) -> bool:
        """Whether a batch may take the ``'stateless'`` plan: the patch
        carries no state (``carry0`` empty) and is kept off the whole-window
        plan only by a host source, and no swept filter engages its carry
        segments (their lowering reads the segment phase off the render
        position as a host integer, which a batched position is not)."""
        return (self.enable_mega and not self.carry0 and bool(self._host_spec)
                and self.carry_seg_align == 1)

    def stateless_core(self, n_blocks: int):
        """The reference's plan for a carry-free batch, ``(params, carry,
        position0, host) -> (blocks (n, F, ch), carry, taps)``: the
        one-block lowering of :meth:`step` under ``torch.func.vmap`` over
        the blocks' positions (an int32 tensor: every read of the position
        in a lowering is tensor arithmetic) and their staged host inputs
        ``(n_blocks, F', ch)``.  The blocks are independent, so the batch
        is one lowering: what does not depend on the position (a static
        filter's coefficients) is computed once, and each kernel entry's
        ``vmap`` rule folds the blocks into its lanes — one launch a batch
        where the per-block plan makes one a block."""
        F = self.block_frames

        def one(params, position, host):
            blocks, _, taps = self._window(params, {}, position, 1, host)
            return blocks[0], {uid: t[0] for uid, t in taps.items()}

        def many(params, carry, position0: int, host):
            positions = position0 + F * torch.arange(
                n_blocks, dtype=torch.int32, device=self.device)
            blocks, taps = torch.func.vmap(one, in_dims=(None, 0, 0))(
                params, positions, host)
            return blocks, carry, taps

        return many

    def plan(self, n_blocks: int) -> str:
        """The plan :meth:`render_core` picks for a batch of ``n_blocks``,
        in the JAX package's order (its lane-packed plan aside): ``'mega'``
        (:meth:`mega_core`), ``'delay_mega'`` (:meth:`delay_mega_core`),
        ``'segment_scan'`` (:meth:`segment_scan_core`), ``'stateless'``
        (:meth:`stateless_core`) or ``'blocks'`` (one :meth:`step` per
        block)."""
        if n_blocks > 1:
            if self._use_mega:
                return 'mega'
            with self._frozen():
                if self.delay_mega_plan() is not None:
                    return 'delay_mega'
                if self.segment_scan_core(n_blocks) is not None:
                    return 'segment_scan'
            if self.stateless_batchable:
                return 'stateless'
        return 'blocks'

    def render_core(self, n_blocks: int):
        """``(params, carry, position0, host=None) -> (blocks (n, F, ch),
        carry', taps)`` on the plan :meth:`plan` names (cached per batch
        size).  ``host`` is the render's staged host inputs on the device
        (:meth:`host_inputs` at ``position0`` for ``n_blocks``); None
        stages them in the call.  Only the stateless and per-block plans
        read them: a host source keeps a patch off the others."""
        if n_blocks in self._render_cache:
            return self._render_cache[n_blocks]
        plan = self.plan(n_blocks)
        F = self.block_frames

        def per_block(params, carry, position0, host):
            out, tap_parts = [], []
            for i in range(n_blocks):
                blocks, carry, taps = self._window(
                    params, carry, position0 + i * F, 1,
                    self._host_slice(host, i))
                out.append(blocks)
                tap_parts.append(taps)
            return torch.cat(out), carry, _cat_taps(tap_parts)

        if plan == 'mega':
            core = self.mega_core(n_blocks)
        elif plan == 'delay_mega':
            core = self.delay_mega_core(n_blocks, self.delay_mega_plan())
        elif plan == 'segment_scan':
            core = self.segment_scan_core(n_blocks)
        elif plan == 'stateless':
            core = self.stateless_core(n_blocks)
        else:
            core = per_block
        reads_host = plan in ('stateless', 'blocks')

        def many(params, carry, position0: int, host=None):
            if not reads_host:
                with self._frozen():
                    return core(params, carry, position0)
            if host is None:
                host = self.host_inputs(position0, n_blocks)
            with self._frozen():
                return core(params, carry, position0, host)

        self._render_cache[n_blocks] = many
        return many

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

    def render(self, *, position: int = 0, n_blocks: int = 1,
               carry: typing.Optional[dict] = None,
               deliver_taps: bool = True):
        """Render ``n_blocks`` blocks from ``position`` (any block
        multiple; one block goes through :meth:`step`); returns ``(audio
        (n*F, ch), carry')`` on the patch's device.  ``carry`` defaults to
        :attr:`carry0` (a start from silence); pass the carry a render
        returned to continue it.  For a carry-free patch the output equals
        the oracle's absolute-aligned semantics at any start.

        With ``deliver_taps`` each enabled tap's blocks are copied to the
        host and handed to its ``consume_tap`` one block at a time, with
        their positions; a disabled tap forwards its audio and is handed
        nothing (the reference's PASSTHRU semantics)."""
        with span('patch.render'):
            self.check_position(position, n_blocks)
            if carry is None:
                carry = self.carry0
            blocks, carry2, taps = self.render_core(n_blocks)(
                self.params(), carry, position)
            if deliver_taps:
                self._deliver_taps(taps, position, n_blocks)
            return (blocks.reshape(n_blocks * self.block_frames,
                                   self.channels), carry2)

    def _deliver_taps(self, taps: dict, position: int, n_blocks: int) -> None:
        """Copy each enabled tap's blocks to the host and hand them to its
        ``consume_tap`` one block at a time, with their positions."""
        F = self.block_frames
        for uid, node in self.tap_nodes.items():
            if uid in taps and node.get_state().enabled:
                arr = taps[uid].cpu().numpy()
                for i in range(n_blocks):
                    node.consume_tap(arr[i], position + i * F, self.rate)

    def render_vis(self, *, position: int = 0, n_blocks: int = 1,
                   carry: typing.Optional[dict] = None):
        """Render on the device and copy off it ONLY the visualization
        taps' decimated display summaries (``Vis.tap_summary``: Wave =
        per-pixel min/max envelope, Spec = FFT band magnitudes) — ~1500
        points per tap instead of full-rate f32 audio; the full-rate tap
        array never leaves the device.  A disabled tap computes and copies
        nothing.

        Returns ``({uid: np.ndarray summary}, carry')`` and delivers each
        summary to its node's ``consume_summary`` (plots pick them up via
        ``Vis.render`` when no full-rate blocks are queued)."""
        from signals_tpu_torch.nodes.vis import Vis
        self.check_position(position, n_blocks)
        if carry is None:
            carry = self.carry0
        _blocks, carry2, taps = self.render_core(n_blocks)(
            self.params(), carry, position)
        frames = n_blocks * self.block_frames
        xp = TorchXP(self.device)
        summaries = {}
        for uid, node in self.tap_nodes.items():
            if (uid in taps and isinstance(node, Vis)
                    and node.get_state().enabled):
                arr = node.tap_summary(xp, taps[uid].reshape(frames, -1),
                                       self.rate).cpu().numpy()
                summaries[uid] = arr
                node.consume_summary(arr, frames, position, self.rate)
        return summaries, carry2

    def _encoded_fn(self, n_blocks: int, subtype: str):
        """``(params, carry, position, host=None) -> (payload, carry',
        taps)``: :meth:`render_core` with the mix encoded on the device
        (cached per ``(n_blocks, subtype)``); the payload is a tensor, or
        ``(buf, total)`` for ``'slac'``."""
        from signals_tpu_torch.runtime import codecs
        key = (n_blocks, subtype)
        if key in self._encoded_cache:
            return self._encoded_cache[key]
        if subtype not in codecs.DEVICE_SUBTYPES:
            raise ValueError(f'unsupported device encoding {subtype!r}')
        inner = self.render_core(n_blocks)
        frames = n_blocks * self.block_frames

        def run(params, carry, position: int, host=None):
            blocks, carry2, taps = inner(params, carry, position, host)
            mix = blocks.reshape(frames, self.channels)
            return codecs.device_encode(mix, subtype), carry2, taps

        self._encoded_cache[key] = run
        return run

    def render_encoded(self, *, position: int = 0, n_blocks: int = 1,
                       carry: typing.Optional[dict] = None,
                       subtype: str = 'mulaw', deliver_taps: bool = True):
        """Like :meth:`render`, but the sample encoding runs **on the
        device** and only payload bytes are copied off it: 1 byte a sample
        (mu-law / A-law), 2 (PCM16), ~0.5 (IMA ADPCM) or ~0.4-1.5
        **lossless** (``'slac'``: Rice-coded PCM16, SLAC v2) instead of 4
        for float32.  Starts at any block, as :meth:`render` does, with the
        same audio.

        Returns ``(payload: np.ndarray, frames, carry')``: uint8 (int16
        for ``'pcm16'``) in exactly the WAV ``data``-chunk layout of the
        subtype (:mod:`signals_tpu_torch.runtime.codecs`); for ``'slac'``
        the live length is copied off first (8 bytes), then that many
        payload bytes."""
        self.check_position(position, n_blocks)
        if carry is None:
            carry = self.carry0
        payload, carry2, taps = self._encoded_fn(n_blocks, subtype)(
            self.params(), carry, position)
        if subtype == 'slac':
            buf, total = payload
            payload = buf[:int(total)]
        if deliver_taps:
            self._deliver_taps(taps, position, n_blocks)
        return payload.cpu().numpy(), n_blocks * self.block_frames, carry2

    #: streaming-copy granularity for the SLAC live length: the worst-case
    #: device buffer is ~4.5 bytes a sample, typical payloads ~0.4; the
    #: stream copies a slice of a fixed length (started before the host
    #: knows the live length, so the copy overlaps the next batch's
    #: render) sized from the previous batch's observed length, rounded up
    #: to this step.
    STREAM_CAP_STEP = 1 << 18
    #: initial cap guess, bytes per sample (SLAC's typical rate + margin)
    STREAM_CAP_GUESS = 0.6

    def render_encoded_stream(self, *, position: int = 0, n_blocks: int,
                              batch_blocks: int, subtype: str = 'slac',
                              carry: typing.Optional[dict] = None,
                              deliver_taps: bool = True):
        """Pipelined batched :meth:`render_encoded`: an iterator of
        ``(payload, frames)``, one a batch, with batch ``k+1`` queued on
        the device before batch ``k``'s payload is waited for.

        On a GPU each payload is copied off on a side stream, into pinned
        host memory, after an event recorded at the end of its batch; the
        payload's memory is marked in use by that stream
        (``record_stream``).  A copy on the render stream would queue
        behind the next batch's kernels and serialize the pipeline.  For
        ``'slac'`` the live length is known only on the device, so a slice
        of a fixed cap is copied at once with the length; the rare
        overshoot (cap below the live length) copies the rest after.  The
        cap starts at :attr:`STREAM_CAP_GUESS` bytes a sample and follows
        1.25x the last observed length, rounded up to
        :attr:`STREAM_CAP_STEP`.

        Batches are rounded up to :attr:`carry_seg_align` blocks; each
        encodes from fresh codec state, so every payload decodes alone and
        the ``.slac`` v3 container (``runtime/sndfile.SlacWriter``) joins
        them losslessly.  ``position`` is checked here, at the call."""
        self.check_position(position, n_blocks)
        align = self.carry_seg_align
        if align > 1:
            batch_blocks = -(-batch_blocks // align) * align
        return self._encoded_stream(position, n_blocks, batch_blocks,
                                    subtype,
                                    self.carry0 if carry is None else carry,
                                    deliver_taps)

    def _encoded_stream(self, position, n_blocks, batch_blocks, subtype,
                        carry, deliver_taps):
        params = self.params()
        F = self.block_frames
        cuda = self.device.type == 'cuda'
        copier = torch.cuda.Stream(self.device) if cuda else None
        worst = cap = None
        if subtype == 'slac':
            step = self.STREAM_CAP_STEP
            worst = int(batch_blocks * F * self.channels * 2.25)
            cap = min(worst, -(-int(batch_blocks * F * self.channels
                                    * self.STREAM_CAP_GUESS) // step) * step)

        def copy_off(tensors):
            """Start copying ``tensors`` to the host; ``(host tensors,
            event or None)``."""
            if not cuda:
                return list(tensors), None
            ready = torch.cuda.Event()
            ready.record()
            with torch.cuda.stream(copier):
                copier.wait_event(ready)
                host = []
                for t in tensors:
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    h.copy_(t, non_blocking=True)
                    t.record_stream(copier)
                    host.append(h)
                done_ev = torch.cuda.Event()
                done_ev.record(copier)
            return host, done_ev

        pending = collections.deque()
        pos, done = position, 0

        def dispatch():
            nonlocal carry, pos, done
            nb = min(batch_blocks, n_blocks - done)
            payload, carry, taps = self._encoded_fn(nb, subtype)(
                params, carry, pos)
            if subtype == 'slac':
                buf, total = payload
                head = buf[:cap] if cap < worst else buf
                pending.append((copy_off((head, total)), buf, nb, pos, taps))
            else:
                pending.append((copy_off((payload,)), None, nb, pos, taps))
            pos += nb * F
            done += nb

        while done < n_blocks and len(pending) < 2:
            dispatch()
        while pending:
            (host, ev), buf, nb, p0, taps = pending.popleft()
            if done < n_blocks:
                dispatch()
            if ev is not None:
                ev.synchronize()
            if subtype == 'slac':
                head, total = host
                n = int(total)
                if n <= head.shape[0]:
                    out = head[:n].numpy()
                else:
                    out = np.concatenate([head.numpy(),
                                          buf[head.shape[0]:n].cpu().numpy()])
                want = -(-int(n * 1.25) // self.STREAM_CAP_STEP) \
                    * self.STREAM_CAP_STEP
                cap = max(min(worst, want), self.STREAM_CAP_STEP)
            else:
                out = host[0].numpy()
            if deliver_taps:
                self._deliver_taps(taps, p0, nb)
            yield out, nb * F


def _cat_taps(parts: list) -> dict:
    """The taps of consecutive windows joined along the block axis."""
    return {uid: torch.cat([p[uid] for p in parts]) for uid in parts[0]}


def _segment_scan(a, b):
    """Inclusive scan along axis 0 of the elementwise affine maps ``u -> a
    u + b`` (row ``i`` of the result composes maps ``0..i``, newest applied
    last), in log2(n) Hillis-Steele steps — the counterpart of the JAX
    package's ``associative_scan`` over a feedback loop's D-frame segments
    (another association order: equal to f32 rounding)."""
    n = a.shape[0]
    d = 1
    while d < n:
        b = torch.cat([b[:d], a[d:] * b[:-d] + b[d:]])
        a = torch.cat([a[:d], a[d:] * a[:-d]])
        d *= 2
    return a, b


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
