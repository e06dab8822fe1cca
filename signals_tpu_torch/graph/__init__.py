"""The chain runtime: signal nodes, ports, and the pull interpreter
(``signals_tpu.graph``).

Emitters answer block requests, receivers own named ports, connection is
``setattr(node, port, input)``.  A node's DSP is a **kernel** written
against a :class:`KernelCtx` with two implementations:

* :class:`PullCtx` here — numpy, pull-style recursion with per-node dispatch
  and block caching: the reference evaluation semantics and the parity
  oracle (it needs no JAX and no GPU);
* ``LowerCtx`` in :mod:`signals_tpu_torch.compiler` — evaluates the same
  kernels eagerly in PyTorch over whole multi-block windows.

The compiler lowers a patch again at every render, reading the graph as it
goes.  So that a compiled patch keeps rendering the structure it was
compiled from while the live graph is rewired (a structural edit during
playback, swapped in by the ``Transport`` once the new program is warm),
it renders inside :func:`frozen_wiring`: on that thread every port reads,
and every emitter lists, the connections of the :class:`Wiring` snapshot
taken at compile time.
"""

from __future__ import annotations

import abc
import collections
import contextlib
import enum
import threading
import typing

import numpy as np

from signals_tpu_torch import PortName, SignalFlags
from signals_tpu_torch.core import (
    BadShape,
    BlockLoc,
    ChainLayerError,
    Request,
    Shape,
)
from signals_tpu_torch.core.state import (
    BadStateSchema,
    BadStateValue,   # noqa: F401  (re-exported via __all__)
    Param,
    State,
    all_of,
    ge,
    instance_of,
)
from signals_tpu_torch import registry as _registry
from signals_tpu_torch.core.xp import NP

__all__ = [
    'Signal', 'Emitter', 'Receiver', 'port', 'RequestRate',
    'ExplicitChannels', 'ExplicitChannelsEmitter', 'ImplicitChannels', 'PassThroughResult',
    'BlockCachingEmitter', 'StatefulEmitter', 'KernelCtx', 'PullCtx',
    'CycleError', 'BadChannels', 'Param', 'State', 'BadStateValue',
    'BadStateSchema', 'Wiring', 'frozen_wiring',
]

FLOAT = np.float32  # every engine computes audio in float32

#: the :class:`Wiring` the current thread reads the graph through (unset:
#: the live graph)
_FROZEN = threading.local()


class Wiring:
    """A snapshot of the connections of the nodes reachable from a root:
    each port's input and each emitter's outputs, as they were when it was
    taken."""

    def __init__(self, nodes: typing.Iterable['Signal']):
        #: id(bound port) -> its input
        self.inputs: dict[int, typing.Optional['Emitter']] = {}
        #: id(emitter) -> its (port name, receiver) outputs
        self.outputs: dict[int, frozenset] = {}
        for node in nodes:
            if isinstance(node, Receiver):
                for bp in node._ports.values():
                    self.inputs[id(bp)] = bp.sig
            if isinstance(node, Emitter):
                self.outputs[id(node)] = frozenset(node.outputs_with_ports)


@contextlib.contextmanager
def frozen_wiring(wiring: Wiring):
    """Read the graph through ``wiring`` on this thread (nestable); ports
    and emitters outside the snapshot read live."""
    prev = getattr(_FROZEN, 'wiring', None)
    _FROZEN.wiring = wiring
    try:
        yield
    finally:
        _FROZEN.wiring = prev


class CycleError(ChainLayerError):

    def __init__(self):
        super().__init__('Cycle detected: patch cycles must pass through a '
                         'CYCLIC node (e.g. a Delay)')


class BadChannels(ChainLayerError):

    def __init__(self, node, counts):
        super().__init__(f'{node.cls_name()!r} cannot infer channel count '
                         f'from inputs with channels {sorted(counts)}')


class RequestRate(enum.Enum):
    """Classification of the last request an emitter served, for UI display
    (reference ``chain/__init__.py:173-177, 227-238``)."""
    UNKNOWN = enum.auto()
    BLOCK = enum.auto()
    FRAME = enum.auto()
    UNUSED_FRAME = enum.auto()


class _Port(property):
    """Marker property subclass so port descriptors are discoverable by class
    scan (reference ``chain/__init__.py:169-170, 331-337``)."""


def port(name: PortName) -> _Port:
    """Port descriptor factory: get → BoundPort, set → connect, del →
    disconnect (reference ``chain/__init__.py:367-377``)."""

    def fget(self: 'Receiver') -> 'Receiver.BoundPort':
        return self._ports[name]

    def fdel(self: 'Receiver') -> None:
        self._ports[name].expel()

    def fset(self: 'Receiver', input_: 'Emitter') -> None:
        self._ports[name].assign(input_)

    return _Port(fget=fget, fset=fset, fdel=fdel)


class Signal(abc.ABC):
    """Base of every node (reference ``chain/__init__.py:183-209``)."""

    class State(State):
        pass

    def __init__(self):
        self._state = self.State()

    @classmethod
    def cls_name(cls) -> str:
        return _registry.registry.canonical_name(cls)

    @classmethod
    @abc.abstractmethod
    def flags(cls) -> SignalFlags:
        return SignalFlags(0)

    @classmethod
    def state_attrs(cls) -> typing.AbstractSet[str]:
        return cls.State.param_names()

    def get_state(self) -> State:
        return self._state

    def set_state(self, new_state: State) -> None:
        if not isinstance(new_state, self.State):
            raise BadStateSchema(self, new_state)
        self._state = new_state

    def destroy(self) -> None:
        pass


class KernelCtx(abc.ABC):
    """Abstract evaluation context a node kernel runs against.

    ``xp`` is the array namespace (:data:`~signals_tpu_torch.core.xp.NP` in
    the pull engine, a :class:`~signals_tpu_torch.core.xp.TorchXP` when
    compiling); everything a kernel may touch goes through this interface
    so one kernel definition serves both engines.
    """

    #: array namespace
    xp: typing.Any
    #: sample rate (static int)
    rate: int
    #: number of frames in the current window (static int)
    nframes: int

    @property
    def rate_f32(self):
        """The sample rate as an f32 scalar (kernels divide by this, so
        both engines round the same f32 division)."""
        return np.float32(self.rate)

    @property
    def inv_rate_f32(self):
        """``1/rate`` as an f32 scalar, computed on the host.

        Phase-critical kernels *multiply* by this rather than divide by the
        rate: a one-ulp phase difference flips an oscillator's wrap into a
        full-amplitude spike, and multiplication by this host constant
        rounds identically in every engine and in the CUDA generator.
        """
        return np.float32(1.0 / self.rate)

    @property
    @abc.abstractmethod
    def frame_range(self):
        """Absolute frame indices for the current window, shape
        ``(nframes, 1)``, float32 — the oscillator time base
        (reference ``chain/__init__.py:121-125``)."""

    @property
    @abc.abstractmethod
    def frame_range_int(self):
        """Absolute frame indices as int32 ``(nframes, 1)`` — the counter
        base for stateless RNG and integer-exact addressing."""

    @abc.abstractmethod
    def in_(self, name: PortName):
        """Input block at the current window (reference ``forward``,
        ``chain/__init__.py:302-303``).  Broadcastable shape."""

    def in_full(self, name: PortName):
        """Input at the current window, requested at the *input's* own
        channel count (the reference's ``loc.reslice`` pattern) — for nodes
        whose own channel count differs from their inputs' (``Pan``)."""
        return self.in_(name)

    @abc.abstractmethod
    def in_block_rate(self, name: PortName):
        """Input sampled once at the window start — how control inputs are
        sampled per block (reference ``forward_at_block_rate``,
        ``chain/__init__.py:305-306``).  Shape ``(1, ch)``."""

    def in_grid_samples(self, name: PortName, stride: int, count: int,
                        ahead: int = 0):
        """``count`` one-frame input samples taken on the absolute
        ``stride``-aligned grid, oldest first — shape ``(count, ch)``.
        The newest sample sits ``ahead`` grid steps after the grid point
        at-or-before this window's start (``ahead=0``: pure history).

        This is the bounded-memory control-history primitive: a stateless
        node can reconstruct "what happened recently" (gate edges, held
        values) from a fixed number of grid samples, exactly like filters
        reconstruct their state from a bounded context window.  Grid
        alignment makes the result identical no matter which window the
        node is evaluated in.  Requires block-aligned rendering positions
        (the renderer's invariant; ``stride`` should equal the block size).
        """
        raise NotImplementedError

    @abc.abstractmethod
    def in_context(self, name: PortName, context_frames: int):
        """Input over ``[window_start - context, window_end)`` for stateless
        context-windowed filtering (reference ``forward_with_context``,
        ``chain/__init__.py:308-315`` — minus the trailing context, which a
        causal filter discards anyway).  Frames before position 0 are zero;
        in the pull engine they are simply absent (reference clamping) —
        equivalent through a zero-initial-state filter."""

    @abc.abstractmethod
    def in_channels(self, name: PortName) -> typing.Optional[int]:
        """Static channel count of the connected input (None if unplugged)."""

    @abc.abstractmethod
    def param(self, name: str):
        """Value of a traced state param."""

    def sosfilt_stream(self, coeffs, x, zi):
        """Stateful SOS cascade in the coupled form: continue from state
        ``zi`` (nsec, 2, ch), returning ``(y, zi')``."""
        raise NotImplementedError

    @abc.abstractmethod
    def sosfilt(self, coeffs, x):
        """Causal second-order-section cascade from zero initial state.

        ``coeffs``: array ``(nsec, ch, 6)`` of [b0 b1 b2 a0 a1 a2] per section
        per channel; ``x``: ``(N, ch)``.  The pull engine delegates to
        ``scipy.signal.sosfilt`` (an independent implementation).
        """


class Emitter(Signal, abc.ABC):
    """Output-capable node (reference ``chain/__init__.py:212-263``)."""

    class State(Signal.State):
        enabled: bool = Param(True, validate=instance_of(bool), traced=True)

    #: Extra frames of upstream context this node's kernel requests via
    #: ``in_context`` (filters override).  Used by the compiler's window pass.
    def context_frames(self) -> int:
        return 0

    def __init__(self):
        super().__init__()
        self._outputs: set[tuple[PortName, 'Receiver']] = set()
        #: the newest pull request (a spectrum plot reads its rate)
        self._last_request: typing.Optional[Request] = None

    @property
    def outputs_with_ports(self) -> typing.AbstractSet[tuple[PortName, 'Receiver']]:
        wiring = getattr(_FROZEN, 'wiring', None)
        if wiring is not None:
            return wiring.outputs.get(id(self), self._outputs)
        return self._outputs

    @property
    def rate(self) -> RequestRate:
        if self._last_request is None:
            return RequestRate.UNKNOWN
        frames = self._last_request.loc.shape.frames
        if frames <= 0:
            return RequestRate.UNKNOWN
        elif frames == 1:
            return RequestRate.BLOCK
        else:
            return RequestRate.FRAME

    @property
    @abc.abstractmethod
    def channels(self) -> int:
        raise NotImplementedError

    @abc.abstractmethod
    def kernel(self, ctx: KernelCtx):
        """Pure block computation for the ctx's window."""
        raise NotImplementedError

    @classmethod
    def empty_result(cls) -> np.ndarray:
        return np.zeros(Shape.unit(), dtype=FLOAT)

    # --- pull engine -----------------------------------------------------

    def _eval(self, request: Request) -> np.ndarray:
        return np.asarray(self.kernel(PullCtx(self, request)), dtype=FLOAT)

    def _get_result(self, request: Request) -> np.ndarray:
        return self._eval(request) if self._state.enabled else self.empty_result()

    def respond(self, request: Request) -> np.ndarray:
        self._last_request = request
        return self._get_result(request)

    def destroy(self) -> None:
        super().destroy()
        for port_name, receiver in tuple(self.outputs_with_ports):
            delattr(receiver, port_name)


class Receiver(Signal, abc.ABC):
    """Input-capable node (reference ``chain/__init__.py:266-364``)."""

    class BoundPort:

        def __init__(self, parent: 'Receiver', name: PortName,
                     emitter: typing.Optional[Emitter] = None):
            self.name = name
            self.parent = parent
            self._sig = emitter

        @property
        def sig(self) -> typing.Optional[Emitter]:
            """The connected input: live, or the one of the thread's
            :func:`frozen_wiring` snapshot."""
            wiring = getattr(_FROZEN, 'wiring', None)
            if wiring is not None:
                return wiring.inputs.get(id(self), self._sig)
            return self._sig

        @sig.setter
        def sig(self, emitter: typing.Optional[Emitter]) -> None:
            self._sig = emitter

        def expel(self) -> None:
            self.sig._outputs.remove((self.name, self.parent))
            self.sig = None

        def assign(self, input_: Emitter) -> None:
            if self.sig is not None:
                self.expel()
            self.sig = input_
            self.sig._outputs.add((self.name, self.parent))

        def __bool__(self) -> bool:
            return self.sig is not None

        def _make_request(self, loc: BlockLoc) -> Request:
            return Request(requestor=self.parent, port=self.name, loc=loc)

        def _do_request(self, request: Request) -> np.ndarray:
            block = self.sig.respond(request)
            if not (Shape.of_array(block) <= request.loc.shape):
                raise BadShape(self.sig, block.shape, request.loc.shape)
            return block

        def request(self, loc: BlockLoc) -> np.ndarray:
            if self.sig is None:
                return Emitter.empty_result()
            return self._do_request(self._make_request(loc))

        def forward(self, request: Request) -> np.ndarray:
            return self.request(request.loc)

        def forward_at_block_rate(self, request: Request) -> np.ndarray:
            return self.request(request.loc.resize(1))

        def forward_with_context(self, request: Request, context_frames: int) -> np.ndarray:
            blocks = []
            loc = request.loc
            if loc.position > 0:
                blocks.append(self.request(loc.before(context_frames)))
            blocks.append(self.forward(request))
            return np.concatenate(blocks)

        @property
        def channels(self) -> typing.Optional[int]:
            return None if self.sig is None else self.sig.channels

    def __init__(self):
        super().__init__()
        self._ports = {
            name: self.BoundPort(parent=self, name=name)
            for name in self.port_names()
        }

    @classmethod
    def port_names(cls) -> list[PortName]:
        return [k for k in dir(cls) if isinstance(getattr(cls, k), _Port)]

    @property
    def inputs_by_port(self) -> dict[PortName, Emitter]:
        return {p.name: p.sig for p in self._ports.values() if p}

    def upstream(self) -> typing.Sequence[Emitter]:
        """Topological order of this node's transitive inputs, self last.

        Unlike the reference (``chain/__init__.py:347-358``, plain assert),
        cycles raise :class:`CycleError` unless broken by a CYCLIC node,
        whose inputs are not traversed (its state edge is a block delay).
        """
        order: collections.deque = collections.deque()
        done: set[int] = set()
        on_path: set[int] = set()

        def visit(node: Signal) -> None:
            if id(node) in done:
                return
            if id(node) in on_path:
                raise CycleError
            on_path.add(id(node))
            if isinstance(node, Receiver) and not (node.flags() & SignalFlags.CYCLIC):
                for inp in node.inputs_by_port.values():
                    visit(inp)
            on_path.discard(id(node))
            done.add(id(node))
            order.append(node)

        visit(self)
        return order

    def destroy(self) -> None:
        super().destroy()
        for port_name, bound_port in tuple(self._ports.items()):
            if bound_port:
                delattr(self, port_name)


# --- channel policy ----------------------------------------------------------


class ExplicitChannels(Signal, abc.ABC):
    """Channel count held in the node's state (a delay line: channel
    inference through a feedback cycle would not terminate)."""

    class State(Signal.State):
        channels: int = Param(1, validate=all_of(instance_of(int), ge(1)))


class ExplicitChannelsEmitter(ExplicitChannels, Emitter, abc.ABC):
    """An emitter whose width is its ``channels`` state (noise sources)."""

    class State(ExplicitChannels.State, Emitter.State):
        pass

    @property
    def channels(self) -> int:
        return self._state.channels


class ImplicitChannels(Receiver, Emitter, abc.ABC):
    """Channel count inferred from inputs: the set of input channel counts,
    broadcast-1 discarded, must be a singleton
    (reference ``chain/__init__.py:396-406``)."""

    @property
    def channels(self) -> int:
        counts = {inp.channels for inp in self.inputs_by_port.values()}
        if len(counts) > 1:
            counts.discard(1)
        if len(counts) != 1:
            raise BadChannels(self, counts)
        return next(iter(counts))


class PassThroughResult(ImplicitChannels, abc.ABC):
    """Side-effect nodes: when disabled, forward the input unchanged instead
    of going silent (reference ``chain/__init__.py:409-417``)."""

    input: Receiver.BoundPort = port('input')

    @classmethod
    def flags(cls) -> SignalFlags:
        return super().flags() | SignalFlags.PASSTHRU

    def _get_result(self, request: Request) -> np.ndarray:
        if self._state.enabled:
            return super()._get_result(request)
        return self.input.forward(request)


# --- block cache (reference ``chain/__init__.py:420-457``) ------------------


class NotCached(RuntimeError):
    pass


class BlockCachingEmitter(Emitter, abc.ABC):
    """Per-node FIFO cache of recent blocks, serving exact or sub-window hits.

    In the pull engine this deduplicates fan-out exactly like the reference;
    the compiler memoizes per (node, window) instead, so it only
    participates in pull evaluation.
    """

    _max_cached_blocks = 16

    def __init__(self):
        super().__init__()
        self._block_cache: dict[BlockLoc, np.ndarray] = {}

    def _read_block_cache(self, request: Request) -> np.ndarray:
        try:
            return self._block_cache[request.loc]
        except KeyError:
            for loc, block in self._block_cache.items():
                if request.loc <= loc:
                    start = request.loc.position - loc.position
                    result = block[start:start + request.loc.shape.frames,
                                   :request.loc.shape.channels]
                    assert Shape.of_array(result) == request.loc.shape
                    return result
            raise NotCached

    def _write_block_cache(self, block: np.ndarray, request: Request) -> None:
        loc = request.loc._replace(shape=Shape.of_array(block))
        self._block_cache[loc] = block
        if len(self._block_cache) > self._max_cached_blocks:
            self._block_cache.pop(next(iter(self._block_cache)))

    def respond(self, request: Request) -> np.ndarray:
        try:
            return self._read_block_cache(request)
        except NotCached:
            result = super().respond(request)
            self._write_block_cache(result, request)
            return result


class StatefulEmitter(BlockCachingEmitter, abc.ABC):
    """Node with carried state stepped once per main block (delay lines,
    envelopes, streaming filters).

    The reference has no stateful nodes (its filters recompute state from
    context); these are new capability.  Protocol: ``init_carry`` builds the
    state pytree; ``step(ctx, carry) -> (block, carry)`` advances one block.
    In the pull engine, blocks must be requested in monotonic order (the
    block cache serves re-requests and context sub-windows); the compiler
    threads the carry through its renders as a dict of tensors.
    """

    def is_stateful(self) -> bool:
        """Nodes may be conditionally stateful (e.g. filters only in
        streaming mode); when False, both engines use the plain stateless
        kernel path."""
        return True

    @abc.abstractmethod
    def init_carry(self, *, channels: int, rate: int,
                   block_frames: int) -> dict[str, np.ndarray]:
        raise NotImplementedError

    @abc.abstractmethod
    def step(self, ctx: KernelCtx, carry: dict) -> tuple[typing.Any, dict]:
        raise NotImplementedError

    def kernel(self, ctx: KernelCtx):
        raise TypeError(f'{self.cls_name()} is stateful; use step()')

    # --- pull engine -----------------------------------------------------

    #: initial output-history retention, in blocks (adapts upward on
    #: demand — see :meth:`_read_out_history`)
    _hist_keep_blocks = 16

    def __init__(self):
        super().__init__()
        self._carry: typing.Optional[dict] = None
        self._carry_position: typing.Optional[int] = None
        self._out_hist: typing.Optional[np.ndarray] = None
        self._hist_keep: int = 0
        self._start_pos: int = 0

    def reset(self) -> None:
        self._carry = None
        self._carry_position = None
        self._out_hist = None
        self._hist_keep = 0
        self._block_cache.clear()

    def _eval(self, request: Request) -> np.ndarray:
        if not self.is_stateful():
            return np.asarray(self.kernel(PullCtx(self, request)),
                              dtype=FLOAT)
        loc = request.loc
        if (self._carry is not None
                and loc.end_position <= self._carry_position):
            # read-only history request (a context lookback pulls
            # past-then-current): served from retained output WITHOUT
            # touching the carry, so context consumers read the frames
            # that were actually emitted.
            retained = (0 if self._out_hist is None
                        else self._out_hist.shape[0])
            s0 = max(loc.position, self._start_pos)
            if self._carry_position - s0 <= retained:
                return self._read_out_history(loc)
            if loc.position > self._start_pos:
                raise ChainLayerError(
                    f'{self.cls_name()} output history of {retained} '
                    f'frames cannot serve a context read '
                    f'{self._carry_position - s0} frames back; the '
                    f'consumer was attached mid-stream')
            # a re-pull from the stream start deeper than retention is a
            # *restart*, not a lookback (a context consumer's clamped
            # early reads grow retention in lockstep, so they never land
            # here): fall through to re-initialize and re-render
        if self._carry is None or loc.position < (self._carry_position or 0):
            self._carry = self.init_carry(channels=self.channels,
                                          rate=loc.rate,
                                          block_frames=loc.shape.frames)
            self._carry_position = loc.position
            self._start_pos = loc.position
            self._out_hist = None
            self._hist_keep = self._hist_keep_blocks * loc.shape.frames
        if loc.position != self._carry_position:
            raise ChainLayerError(
                f'{self.cls_name()} is stateful: pull evaluation must be '
                f'block-monotonic (expected position {self._carry_position}, '
                f'got {loc.position})')
        block, self._carry = self.step(PullCtx(self, request), self._carry)
        self._carry_position = loc.end_position
        out = np.asarray(block, dtype=FLOAT)
        full = np.broadcast_to(
            out, (loc.shape.frames, self.channels)).astype(FLOAT)
        if self._out_hist is None:
            self._out_hist = full
        else:
            self._out_hist = np.concatenate(
                [self._out_hist, full], axis=0)[-self._hist_keep:]
        return out

    def _read_out_history(self, loc) -> np.ndarray:
        """Serve an output window lying entirely behind the carry position
        from the retained output blocks (frames before the stream start
        are silence).

        Retention adapts: a context consumer's lookback repeats every
        block and deepens by at most one block per step (clamped at the
        stream start early on), so raising the keep target on each read
        stays ahead of trimming; a lookback beyond what was retained
        (a consumer attached mid-stream) is an error, not silence."""
        cp = self._carry_position
        hist = self._out_hist
        retained = 0 if hist is None else hist.shape[0]
        q0, q1 = loc.position, loc.end_position
        ch = self.channels
        out = np.zeros((loc.shape.frames, ch), dtype=FLOAT)
        s0 = max(q0, self._start_pos)     # pre-stream frames: silence
        self._hist_keep = max(self._hist_keep,
                              (cp - q0) + 2 * loc.shape.frames)
        if s0 < q1:
            need = cp - s0                # lookback into retained output
            if need > retained:
                raise ChainLayerError(
                    f'{self.cls_name()} output history of {retained} '
                    f'frames cannot serve a context read {need} frames '
                    f'back; the consumer was attached mid-stream')
            i0 = s0 - (cp - retained)
            out[s0 - q0:q1 - q0] = hist[i0:i0 + (q1 - s0)]
        return out


# --- the pull evaluation context --------------------------------------------


class PullCtx(KernelCtx):
    """Reference-semantics evaluation: recursive pull over live node objects
    (the call stack of reference ``chain/dev.py:167-179`` →
    ``chain/__init__.py:296-315``)."""

    xp = NP

    def __init__(self, node: Emitter, request: Request):
        self.node = node
        self.request = request
        self.rate = request.loc.rate
        self.nframes = request.loc.shape.frames

    @property
    def frame_range(self) -> np.ndarray:
        return self.request.loc.frame_range.astype(FLOAT)

    @property
    def frame_range_int(self) -> np.ndarray:
        return self.request.loc.frame_range.astype(np.int32)

    def _port(self, name: PortName) -> Receiver.BoundPort:
        return self.node._ports[name]

    def in_(self, name: PortName) -> np.ndarray:
        return self._port(name).forward(self.request)

    def in_full(self, name: PortName) -> np.ndarray:
        port_ = self._port(name)
        if not port_:
            return Emitter.empty_result()
        return port_.request(self.request.loc.reslice(port_.channels))

    def in_block_rate(self, name: PortName) -> np.ndarray:
        return self._port(name).forward_at_block_rate(self.request)

    def in_context(self, name: PortName, context_frames: int) -> np.ndarray:
        # Like BoundPort.forward_with_context, but broadcast-shaped sub-blocks
        # (e.g. (1,1) constants) are expanded to their loc's full frame count
        # before concatenation — the reference crashes on those
        # (``fx.py:94-105`` assumes full blocks); we define the sensible
        # extension.
        port_ = self._port(name)
        loc = self.request.loc
        blocks = []
        if loc.position > 0:
            bloc = loc.before(context_frames)
            b = port_.request(bloc)
            blocks.append(np.broadcast_to(b, (bloc.shape.frames, b.shape[1])))
        m = port_.forward(self.request)
        blocks.append(np.broadcast_to(m, (loc.shape.frames, m.shape[1])))
        ch = max(b.shape[1] for b in blocks)
        blocks = [np.broadcast_to(b, (b.shape[0], ch)) for b in blocks]
        return np.concatenate(blocks, axis=0)

    def in_channels(self, name: PortName) -> typing.Optional[int]:
        return self._port(name).channels

    def param(self, name: str):
        return getattr(self.node._state, name)

    def sosfilt(self, coeffs, x):
        # float64 internally, like the reference (whose numpy arrays default
        # to float64); cast to f32 at the boundary.  This makes the pull
        # engine the high-precision oracle the compiled scan is tested
        # against.
        import scipy.signal
        coeffs = np.asarray(coeffs, dtype=np.float64)[:, :, :6]
        x64 = np.asarray(x, dtype=np.float64)
        nsec, ch, _ = coeffs.shape
        ch = max(ch, x64.shape[1])
        x64 = np.broadcast_to(x64, (x64.shape[0], ch))
        out = np.empty_like(x64)
        for c in range(ch):
            sos = np.ascontiguousarray(coeffs[:, min(c, coeffs.shape[1] - 1), :])
            out[:, c] = scipy.signal.sosfilt(sos, x64[:, c], axis=0)
        return out.astype(FLOAT)

    def sosfilt_stream(self, coeffs, x, zi):
        """Stateful SOS cascade in the COUPLED form, float64.

        The state convention matters beyond numerics: carrying state
        across a per-block COEFFICIENT change is realization-dependent
        (a TDF2 ``zi`` and a coupled-form ``(s1, s2)`` encode the past
        differently, so the continuation under new coefficients
        differs at first order in the coefficient step).  Every
        compiled path — ``filters.sosfilt_stream`` and the CUDA segment
        kernels — carries the coupled state, so the oracle threads the
        SAME state variables.

        Requires the 11-column :func:`~signals_tpu_torch.compiler.filters.
        design_coupled` layout; the coupled taps are used as designed
        (f32-rounded — bit-identical to the compiled engine's) with the
        recurrence run in f64.
        """
        co = np.asarray(coeffs, dtype=np.float64)
        x64 = np.asarray(x, dtype=np.float64)
        nsec, chc = co.shape[0], co.shape[1]
        ch = max(chc, x64.shape[1], zi.shape[-1])
        x64 = np.broadcast_to(x64, (x64.shape[0], ch)).copy()
        zi = np.broadcast_to(np.asarray(zi, dtype=np.float64),
                             (nsec, 2, ch))
        zf = np.empty((nsec, 2, ch))
        if co.shape[-1] >= 11:
            params = [tuple(np.broadcast_to(co[s, :, 6 + k], (ch,))
                            for k in range(5)) for s in range(nsec)]
        else:
            params = []
            for s in range(nsec):
                b0, b1, b2 = co[s, :, 0], co[s, :, 1], co[s, :, 2]
                a1, a2 = co[s, :, 4], co[s, :, 5]
                rc = -0.5 * a1
                rs = np.sqrt(np.maximum(a2 - 0.25 * a1 * a1, 1e-300))
                d0 = b0
                d1 = b1 - a1 * b0
                d2 = (b2 - a2 * b0 + rc * d1) / rs
                params.append(tuple(np.broadcast_to(p, (ch,))
                                    for p in (rc, rs, d0, d1, d2)))
        n = x64.shape[0]
        for s in range(nsec):
            rc, rs, d0, d1, d2 = params[s]
            s1 = zi[s, 0].copy()
            s2 = zi[s, 1].copy()
            for t in range(n):
                xt = x64[t].copy()
                x64[t] = d0 * xt + d1 * s1 + d2 * s2
                s1, s2 = rc * s1 - rs * s2 + xt, rs * s1 + rc * s2
            zf[s, 0] = s1
            zf[s, 1] = s2
        return x64.astype(FLOAT), zf.astype(FLOAT)
