"""The map layer: the mutable patch document
(reference ``src/signals/map/__init__.py``).

A ``Map`` is a bijection from spreadsheet-style grid coordinates (row number
+ bijective base-26 column letters, e.g. ``"3b"``) to live signal nodes,
with undoable operations ``add/rm/edit/mv/connect/disconnect/playback`` and
iteration in canonical dump order.  The serializable descriptors
(``MappedSigInfo``/``ConnectionInfo``/``SigState``/``PortInfo``) and the
error taxonomy carry the ``.sigs`` text format.

The reference depends on an external ``bijection`` package
(``map/__init__.py:408``); :class:`Bijection` here is a minimal two-dict
implementation.

A ``Map`` holds the compute device its sink and source nodes render on
(``Map(device='cuda')``, the default; ``'cpu'`` runs the plain PyTorch
path); it hands it to :meth:`MappedDevInfo.create` as ``torch_device``,
since :attr:`MappedDevInfo.device` is the rack's record of the audio
device.  Node classes are named as a ``.sigs`` file names them
(:func:`signals_tpu_torch.registry.patch_name`), so a patch dumps to the
same text as in the JAX package.
"""

from __future__ import annotations

import json
import re
import string
import typing

import numpy as np

from signals_tpu_torch import PortName, SigStateValue, SignalsError
from signals_tpu_torch.core.state import BadStateValue
from signals_tpu_torch.graph import Emitter, Receiver, Signal
from signals_tpu_torch import registry as _registry
import signals_tpu_torch.nodes.dev as dev
import signals_tpu_torch.nodes.vis as vis_mod

CoordinateRow = int


def _name(signal) -> str:
    """A live node's class as a ``.sigs`` file names it."""
    return _registry.patch_name(type(signal))


class CoordinateColumn(int):
    """Bijective base-26 column index: a=1 … z=26, aa=27 …
    (reference ``map/__init__.py:32-51``)."""

    def __new__(cls, value: int | str):
        if isinstance(value, str):
            i = 0
            for c in value:
                i = i * 26 + (ord(c) - ord('a') + 1)
            value = i
        if value <= 0:
            raise ValueError(value)
        return super().__new__(cls, value)

    def __str__(self) -> str:
        i = int(self)
        digits = []
        while i:
            i, d = divmod(i - 1, 26)
            digits.append(string.ascii_lowercase[d])
        return ''.join(reversed(digits))


class Coordinates(typing.NamedTuple):
    """Grid position, ordered row-major.

    >>> str(Coordinates(row=1, col=CoordinateColumn(1)))
    '1a'
    >>> str(Coordinates(row=1, col=CoordinateColumn(26)))
    '1z'
    >>> str(Coordinates(row=1, col=CoordinateColumn(27)))
    '1aa'
    >>> str(Coordinates(row=1, col=CoordinateColumn(52)))
    '1az'
    >>> str(Coordinates(row=1, col=CoordinateColumn(702)))
    '1zz'
    >>> str(Coordinates(row=1234, col=CoordinateColumn(1234)))
    '1234aul'
    >>> Coordinates.parse('1a')
    Coordinates(row=1, col=1)
    >>> Coordinates.parse('1z')
    Coordinates(row=1, col=26)
    >>> Coordinates.parse('1aa')
    Coordinates(row=1, col=27)
    >>> Coordinates.parse('1234aul')
    Coordinates(row=1234, col=1234)
    >>> Coordinates.parse('1aa') == Coordinates.parse('1aa')
    True
    """

    row: CoordinateRow
    col: CoordinateColumn

    def __str__(self) -> str:
        return f'{self.row}{self.col}'

    _coord_re = re.compile(r'(\d+)([a-z]+)')

    @classmethod
    def parse(cls, s: str) -> 'Coordinates':
        match = re.fullmatch(cls._coord_re, s)
        if not match:
            raise ValueError(s)
        row, col = match.groups()
        if int(row) < 1:
            raise ValueError(s)
        return cls(row=int(row), col=CoordinateColumn(col))


class SigStateItem(typing.NamedTuple):
    """One ``key=value`` item of the text state format
    (reference ``map/__init__.py:104-148``).

    >>> s = SigStateItem.parse('foo=1')
    >>> s
    SigStateItem(k='foo', v=1)
    >>> str(s)
    'foo=1'
    >>> s = SigStateItem.parse('bar=[[1, 2, 3]]')
    >>> s
    SigStateItem(k='bar', v=array([[1, 2, 3]]))
    >>> str(s)
    'bar=[[1,2,3]]'
    """

    k: str
    v: SigStateValue

    @classmethod
    def parse(cls, item: str) -> 'SigStateItem':
        k, _, v = item.partition('=')
        return cls(k=k, v=cls.parse_value(v))

    def __str__(self) -> str:
        return f'{self.k}={self.dump_value(self.v)}'

    @classmethod
    def parse_value(cls, v: str) -> SigStateValue:
        try:
            parsed = json.loads(v)
        except ValueError:
            return v
        if isinstance(parsed, list):
            return np.array(parsed)
        return parsed

    @classmethod
    def dump_value(cls, v: SigStateValue) -> str:
        if isinstance(v, str):
            return v
        if isinstance(v, np.ndarray):
            v = v.tolist()
        elif isinstance(v, (np.floating, np.integer, np.bool_)):
            v = v.item()
        # compact separators: the line parser is shlex-based, so values must
        # not contain spaces (the reference emits ", " and cannot re-parse
        # its own multi-element arrays — a latent bug there)
        return json.dumps(v, separators=(',', ':'))


class SigState(dict):
    """A signal state as a plain ordered mapping with text round-trip."""

    def items_text(self) -> str:
        return ' '.join(str(SigStateItem(k=k, v=v))
                        for k, v in sorted(self.items()))

    @classmethod
    def from_signal(cls, signal: Signal) -> 'SigState':
        return cls(signal.get_state().asdict())

    def __str__(self) -> str:
        return self.items_text()


class MapLayerError(SignalsError):
    pass


class MapError(MapLayerError):

    def __init__(self, at: Coordinates, *args: str):
        super().__init__(f'at {at}:', *args)


class Empty(MapError):

    def __init__(self, at: Coordinates):
        super().__init__(at, 'Coordinates are empty')


class NonEmpty(MapError):

    def __init__(self, at: Coordinates):
        super().__init__(at, 'Coordinates are not empty')


class NotConnected(MapError):

    def __init__(self, port: 'PortInfo'):
        super().__init__(port.at, f'Port {port.port!r} has no input.')


class AlreadyConnected(MapError):

    def __init__(self, connection: 'ConnectionInfo'):
        port = connection.output
        super().__init__(port.at, f'Port {port.port!r} already has input at '
                                  f'{connection.input_at}')


class BadSignal(MapError):

    def __init__(self, at: Coordinates, signal: str, reason: str):
        super().__init__(at, f'Failed to load "{signal}":', reason)


class BadName(MapError):
    """A name lookup failed; the message lists the valid options
    (reference ``map/__init__.py:363-382``)."""

    def __init__(self, at: Coordinates, what: str, options=()):
        super().__init__(at, what, 'Valid options are:',
                         ', '.join(sorted(map(repr, options))))


class BadPort(BadName):

    def __init__(self, port: 'PortInfo', signal: Receiver):
        super().__init__(port.at,
                         f'{_name(signal)} has no port {port.port!r}.',
                         options=signal.port_names())


class BadProperty(BadName):

    def __init__(self, at: Coordinates, signal: Signal, prop: str):
        super().__init__(at,
                         f'{_name(signal)} has no property {prop!r}.',
                         options=signal.state_attrs())


class BadPropertyValue(MapError):
    """A state value rejected by the param's validator, surfaced as a map
    layer error so the REPL prints it cleanly."""

    def __init__(self, at: Coordinates, cause: BadStateValue):
        super().__init__(at, str(cause))


class BadSignalClass(MapError):

    def __init__(self, at: Coordinates, signal: Signal, expected: type):
        super().__init__(at, f'{_name(signal)!r} is not a '
                             f'{expected.__name__}')


class BadReceiver(BadSignalClass):

    def __init__(self, at: Coordinates, signal: Signal):
        super().__init__(at, signal, Receiver)


class BadPlaybackTarget(BadSignalClass):

    def __init__(self, at: Coordinates, signal: Signal):
        super().__init__(at, signal, dev.SinkDevice)


class BadVis(BadSignalClass):

    def __init__(self, at: Coordinates, signal: Signal):
        super().__init__(at, signal, vis_mod.Vis)


class MappedSigInfo:
    """Serializable node descriptor: coordinates + class name + state
    (reference ``map/__init__.py:171-211``).  Missing state keys are filled
    from the schema defaults."""

    def __init__(self, *, at: Coordinates, cls_name: str, state: SigState):
        self.at = at
        self.cls_name = cls_name
        self.state = SigState(state)
        try:
            self._sig_cls = _registry.load_signal(cls_name)
        except _registry.BadSignal as e:
            raise BadSignal(at, cls_name, e.args[0] if e.args else '')
        defaults = self._sig_cls.State()
        for k in self.state_attr_names() - self.state.keys():
            self.state[k] = getattr(defaults, k)
        for k in self.state.keys() - self.state_attr_names():
            raise BadName(self.at, f'{cls_name} has no property {k!r}.',
                          options=self.state_attr_names())

    def port_names(self) -> list[PortName]:
        if issubclass(self._sig_cls, Receiver):
            return self._sig_cls.port_names()
        return []

    def state_attr_names(self) -> typing.AbstractSet[str]:
        return self._sig_cls.state_attrs()

    @property
    def flags(self):
        return self._sig_cls.flags()

    def create(self, torch_device=None) -> Signal:
        """A new node of the class with default state (``torch_device``
        is read by device nodes only)."""
        return self._sig_cls()

    def sort_key(self):
        return (str(self.at.row).rjust(12), str(self.at.col), self.cls_name)

    def __lt__(self, other):
        return (self.at.row, self.at.col) < (other.at.row, other.at.col)

    def __eq__(self, other):
        return (isinstance(other, MappedSigInfo)
                and self.at == other.at and self.cls_name == other.cls_name)


class PortInfo(typing.NamedTuple):
    """``"3b.cutoff"`` — a node's named input port
    (reference ``map/__init__.py:214-225``)."""

    at: Coordinates
    port: PortName

    @classmethod
    def parse(cls, s: str) -> 'PortInfo':
        node_at, _, port = s.partition('.')
        return cls(at=Coordinates.parse(node_at), port=port)

    def __str__(self) -> str:
        return f'{self.at}.{self.port}'


class ConnectionInfo(typing.NamedTuple):
    input_at: Coordinates
    output: PortInfo


class LinkedSigInfo(MappedSigInfo):
    """A removed node's descriptor plus the connections it had, for undo
    (reference ``map/__init__.py:234-242``)."""

    def __init__(self, *, at, cls_name, state,
                 links_in: typing.Collection[ConnectionInfo],
                 links_out: typing.Collection[ConnectionInfo]):
        super().__init__(at=at, cls_name=cls_name, state=state)
        self.links_in = tuple(links_in)
        self.links_out = tuple(links_out)

    @property
    def links(self) -> typing.Iterator[ConnectionInfo]:
        yield from self.links_in
        yield from self.links_out


class MappedDevInfo(MappedSigInfo):
    """Descriptor for a device node, carrying its rack record
    (reference ``map/__init__.py:245-277``): ``device`` is the rack's
    :class:`~signals_tpu_torch.nodes.dev.DeviceInfo`; the compute device
    the node renders on is given to :meth:`create` as ``torch_device``."""

    _source_cls_name = _registry.patch_name(dev.SourceDevice)
    _sink_cls_name = _registry.patch_name(dev.SinkDevice)

    def __init__(self, *, at, cls_name, state, device: dev.DeviceInfo):
        self.device = device
        self.at = at
        self.cls_name = cls_name
        self._sig_cls = (dev.SourceDevice
                         if cls_name == self._source_cls_name
                         else dev.SinkDevice)
        self.state = SigState(state or {})

    @classmethod
    def for_source(cls, *, device: dev.DeviceInfo, at: Coordinates,
                   state: SigState = None) -> 'MappedDevInfo':
        return cls(cls_name=cls._source_cls_name, at=at,
                   state=SigState() if state is None else state,
                   device=device)

    @classmethod
    def for_sink(cls, *, device: dev.DeviceInfo, at: Coordinates,
                 state: SigState = None) -> 'MappedDevInfo':
        return cls(cls_name=cls._sink_cls_name, at=at,
                   state=SigState() if state is None else state,
                   device=device)

    def state_attr_names(self):
        return self._sig_cls.State.param_names()

    def create(self, torch_device='cuda') -> Signal:
        return self._sig_cls(self.device, device=torch_device)


class LinkedDevInfo(MappedDevInfo):

    def __init__(self, *, at, cls_name, state, device, links_in=(),
                 links_out=()):
        super().__init__(at=at, cls_name=cls_name, state=state,
                         device=device)
        self.links_in = tuple(links_in)
        self.links_out = tuple(links_out)

    @property
    def links(self) -> typing.Iterator[ConnectionInfo]:
        yield from self.links_in
        yield from self.links_out

    @classmethod
    def for_linked_source(cls, *, device, at, state=None, links_out=()):
        return cls(cls_name=cls._source_cls_name, device=device, at=at,
                   state=state, links_out=links_out, links_in=())

    @classmethod
    def for_linked_sink(cls, *, device, at, state=None, links_in=()):
        return cls(cls_name=cls._sink_cls_name, device=device, at=at,
                   state=state, links_out=(), links_in=links_in)


class PlaybackState(typing.NamedTuple):
    position: typing.Optional[int]
    active: typing.Optional[bool]


class Bijection:
    """Minimal invertible dict (replaces the reference's external
    ``bijection`` dependency)."""

    def __init__(self):
        self._fwd: dict = {}
        self._inv: dict[int, typing.Any] = {}   # id(value) -> key

    def __getitem__(self, key):
        return self._fwd[key]

    def __setitem__(self, key, value) -> None:
        if key in self._fwd:
            old = self._fwd[key]
            del self._inv[id(old)]
        self._fwd[key] = value
        self._inv[id(value)] = key

    def __contains__(self, key) -> bool:
        return key in self._fwd

    def get(self, key, default=None):
        return self._fwd.get(key, default)

    def pop(self, key, *default):
        try:
            value = self._fwd.pop(key)
        except KeyError:
            if default:
                return default[0]
            raise
        del self._inv[id(value)]
        return value

    def key_of(self, value):
        return self._inv[id(value)]

    def pop_value(self, value):
        key = self._inv.pop(id(value))
        del self._fwd[key]
        return key

    def setdefault(self, key, value):
        if key in self._fwd:
            return self._fwd[key]
        self[key] = value
        return value

    def items(self):
        return self._fwd.items()

    def __len__(self) -> int:
        return len(self._fwd)


class Map:
    """The live patch document (reference ``map/__init__.py:405-580``).
    ``device`` is where its sink and source nodes compile and render the
    patch: the GPU unless asked otherwise (a device node added where torch
    sees no GPU raises)."""

    def __init__(self, device='cuda'):
        self._map = Bijection()
        self.device = device

    def add(self, info: MappedSigInfo) -> None:
        sig = info.create(torch_device=self.device)
        self._apply_state(info.at, sig, info.state)
        if self._map.setdefault(info.at, sig) is not sig:
            raise NonEmpty(info.at)

    def rm(self, at: Coordinates) -> LinkedSigInfo:
        sig = self._find(at)
        state = SigState.from_signal(sig)
        inputs: list[ConnectionInfo] = []
        outputs: list[ConnectionInfo] = []
        if isinstance(sig, Emitter):
            for port_name, receiver in tuple(sig.outputs_with_ports):
                output_at = self._map.key_of(receiver)
                port_info = PortInfo(at=output_at, port=port_name)
                self.disconnect(port_info)
                outputs.append(ConnectionInfo(input_at=at, output=port_info))
        if isinstance(sig, Receiver):
            for port_name, input_sig in tuple(sig.inputs_by_port.items()):
                port_info = PortInfo(at=at, port=port_name)
                self.disconnect(port_info)
                input_at = self._map.key_of(input_sig)
                inputs.append(ConnectionInfo(input_at=input_at,
                                             output=port_info))
        sig.destroy()
        self._map.pop_value(sig)

        if isinstance(sig, dev.SourceDevice):
            return LinkedDevInfo.for_linked_source(
                at=at, state=state, links_out=outputs, device=sig.info)
        elif isinstance(sig, dev.SinkDevice):
            return LinkedDevInfo.for_linked_sink(
                at=at, state=state, links_in=inputs, device=sig.info)
        return LinkedSigInfo(at=at, cls_name=_name(sig), state=state,
                             links_in=inputs, links_out=outputs)

    def edit(self, at: Coordinates, state: SigState) -> SigState:
        sig = self._find(at)
        old_state = SigState.from_signal(sig)
        self._apply_state(at, sig, state)
        return old_state

    def mv(self, at1: Coordinates, at2: Coordinates) -> None:
        v1 = self._pop(at1)
        if (v2 := self._map.pop(at2, None)) is not None:
            self._map[at1] = v2
        self._map[at2] = v1

    def connect(self, info: ConnectionInfo) -> typing.Optional[Coordinates]:
        """Connect; returns the displaced old input's coordinates (for
        undo), None if the port was free."""
        input_sig = self._find(info.input_at)
        output_sig = self._find(info.output.at)
        if not isinstance(output_sig, Receiver):
            raise BadReceiver(info.output.at, output_sig)
        if info.output.port not in output_sig.port_names():
            raise BadPort(info.output, output_sig)
        old_port = getattr(output_sig, info.output.port)
        old_input_at = (self._map.key_of(old_port.sig) if old_port else None)
        if old_input_at == info.input_at:
            raise AlreadyConnected(info)
        setattr(output_sig, info.output.port, input_sig)
        return old_input_at

    def disconnect(self, info: PortInfo) -> Coordinates:
        output = self._find(info.at)
        if not isinstance(output, Receiver):
            raise BadReceiver(info.at, output)
        if info.port not in output.port_names():
            raise BadPort(info, output)
        input_sig = getattr(output, info.port).sig
        if input_sig is None:
            raise NotConnected(info)
        input_at = self._map.key_of(input_sig)
        delattr(output, info.port)
        return input_at

    def playback(self, at: Coordinates, state: PlaybackState) -> None:
        sink = self._find(at)
        if not isinstance(sink, dev.SinkDevice):
            raise BadPlaybackTarget(at, sink)
        if state.position is not None:
            sink.seek(state.position)
        if state.active is not None:
            if state.active:
                sink.start()
            elif sink.is_active:
                sink.stop()

    def iter_signals(self) -> typing.Iterator[MappedSigInfo]:
        for at, sig in self._map.items():
            if not isinstance(sig, dev.Device):
                yield MappedSigInfo(at=at, cls_name=_name(sig),
                                    state=SigState.from_signal(sig))

    def iter_connections(self) -> typing.Iterator[ConnectionInfo]:
        for at, sig in self._map.items():
            if isinstance(sig, Receiver):
                for port_name, input_sig in sig.inputs_by_port.items():
                    yield ConnectionInfo(
                        input_at=self._map.key_of(input_sig),
                        output=PortInfo(at=at, port=port_name))

    def iter_sources(self) -> typing.Iterator[MappedDevInfo]:
        for at, sig in self._map.items():
            if isinstance(sig, dev.SourceDevice):
                yield MappedDevInfo.for_source(
                    at=at, device=sig.info, state=SigState.from_signal(sig))

    def iter_sinks(self) -> typing.Iterator[MappedDevInfo]:
        for at, sig in self._map.items():
            if isinstance(sig, dev.SinkDevice):
                yield MappedDevInfo.for_sink(
                    at=at, device=sig.info, state=SigState.from_signal(sig))

    def render(self, at: Coordinates, ax, frames: int) -> list:
        sig = self._find(at)
        if not isinstance(sig, vis_mod.Vis):
            raise BadVis(at, sig)
        return sig.render(ax, frames)

    def find(self, at: Coordinates) -> Signal:
        return self._find(at)

    def get(self, at: Coordinates) -> typing.Optional[Signal]:
        """The signal at ``at``, or None (non-raising lookup for UIs)."""
        return self._map.get(at)

    def _find(self, at: Coordinates) -> Signal:
        try:
            return self._map[at]
        except KeyError:
            raise Empty(at)

    def _pop(self, at: Coordinates) -> Signal:
        try:
            return self._map.pop(at)
        except KeyError:
            raise Empty(at)

    def _apply_state(self, at: Coordinates, signal: Signal,
                     state: SigState) -> None:
        new_state = signal.get_state().copy()
        for k, v in state.items():
            if k not in type(new_state).param_names():
                raise BadProperty(at, signal, k)
            try:
                setattr(new_state, k, v)
            except BadStateValue as e:
                raise BadPropertyValue(at, e) from e
        signal.set_state(new_state)
