"""The control layer: command language, undo/redo, persistence
(reference ``src/signals/map/control.py``).

A ``Controller`` drives a :class:`signals_tpu_torch.map.Map` through a set of
``LineCommand`` s, each with a long name and (for the frequent ones) a
symbol — ``+ - * = > >/ << >>`` — a bounded undo/redo history, atomic batch
commands with rollback, text serialization of the whole patch (the ``.sigs``
format, identical to the reference's so its patch files load unchanged), and
a SHA3-256 state hash.  It doubles as the ``cmd.Cmd`` headless REPL.

One reference bug is fixed rather than kept: the reference nests its
``seek`` command class *inside* ``StopCommand`` so it never registers
(``control.py:688-702``); here ``Seek`` is a first-class command.

The commands that render (``bounce``, ``fit``, ``plot``, ``play``) run on
the controller's compute device, ``Controller(device='cuda')`` by default:
where torch sees no GPU they raise rather than run on the CPU.
``Controller(device='cpu')`` runs the plain PyTorch path.  The same command
lines give the same dump, hash, printed text and errors as the JAX
package's controller.
"""

from __future__ import annotations

import abc
import argparse
import cmd
import collections
import hashlib
import itertools
import pathlib
import shlex
import sys
import traceback
import typing

from signals_tpu_torch import registry as _registry
import signals_tpu_torch.nodes.dev as dev
from signals_tpu_torch.map import (
    ConnectionInfo,
    Coordinates,
    LinkedSigInfo,
    Map,
    MapLayerError,
    MappedDevInfo,
    MappedSigInfo,
    PlaybackState,
    PortInfo,
    SigState,
    SigStateItem,
)


class NonExitingArgumentParser(argparse.ArgumentParser):
    """argparse exits the process on error by default; raise instead
    (reference ``control.py:36-40``)."""

    def error(self, message: str) -> typing.NoReturn:
        raise argparse.ArgumentError(argument=None, message=message)


class CommandError(MapLayerError):
    pass


class BadCommandSyntax(CommandError):
    pass


class BadCommand(CommandError):

    def __init__(self, cmd_: str, cmds: typing.Iterable[str]):
        super().__init__(cmd_, 'Valid options are:',
                         ', '.join(sorted(cmds)))


class BadHistory(CommandError):
    pass


class BadUndo(BadHistory):

    def __init__(self):
        super().__init__('Cannot undo any further')


class BadRedo(BadHistory):

    def __init__(self):
        super().__init__('Cannot redo any further')


def _engine_shape_for(sig_map: Map, node) -> tuple[int, int]:
    """``(block_frames, rate)`` of the sink whose patch CONTAINS
    ``node`` — the engine shape playback would actually use.  Falls
    back to the first sink's shape (single-sink maps where the node
    hangs off-sink), then engine defaults: with several sinks at
    different rates, taking "the first sink" would render the plotted
    patch at the wrong rate (pitches shift, Spec bands mislabel)."""
    first = None
    for dinfo in sig_map.iter_sinks():
        sink = sig_map.get(dinfo.at)
        if sink is None:
            continue
        if first is None:
            first = sink
        inp = getattr(sink, 'input', None)
        if not inp:
            continue
        stack = [inp.sig]
        seen: set[int] = set()
        while stack:
            n = stack.pop()
            if n is None or id(n) in seen:
                continue
            seen.add(id(n))
            if n is node:
                return (getattr(sink, 'block_frames', None) or 1024,
                        getattr(sink, 'rate', None) or 44100)
            ports = getattr(n, '_ports', None)
            if ports:
                stack.extend(p.sig for p in ports.values()
                             if p.sig is not None)
    if first is not None:
        return (getattr(first, 'block_frames', None) or 1024,
                getattr(first, 'rate', None) or 44100)
    return 1024, 44100


class Command(abc.ABC):

    @abc.abstractmethod
    def affect(self, controller: 'Controller') -> None:
        raise NotImplementedError


class LineCommand(Command, abc.ABC):
    """A command parseable from one text line: name/symbol + argparse."""

    @classmethod
    def symbol(cls) -> typing.Optional[str]:
        return None

    @classmethod
    @abc.abstractmethod
    def name(cls) -> str:
        raise NotImplementedError

    @classmethod
    def parser(cls) -> argparse.ArgumentParser:
        parser = NonExitingArgumentParser(prog=cls.name(), add_help=False)
        cls.add_arguments(parser)
        return parser

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> None:
        pass

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> 'LineCommand':
        return cls(**vars(args))

    def __init__(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)


class StackCommand(Command, abc.ABC):
    """Undoable command: ``affect`` pushes onto the history."""

    def affect(self, controller: 'Controller') -> None:
        controller.push(self)

    @abc.abstractmethod
    def do(self, controller: 'Controller') -> None:
        raise NotImplementedError

    @abc.abstractmethod
    def undo(self, controller: 'Controller') -> None:
        raise NotImplementedError


class SerializingCommand(Command, abc.ABC):

    @abc.abstractmethod
    def serialize(self) -> str:
        raise NotImplementedError


class LossyCommand(Command, abc.ABC):
    """Command whose ``do`` captures data its ``undo`` needs
    (reference ``control.py:73-81``).  The stash is created lazily so
    cooperative ``__init__`` chaining is not required of subclasses."""

    @property
    def _stash_list(self) -> list:
        stash = getattr(self, '_stash', None)
        if stash is None:
            stash = self._stash = []
        return stash

    def pop_stash(self):
        return self._stash_list.pop()

    def push_stash(self, value) -> None:
        self._stash_list.append(value)


class BatchStackCommand(StackCommand):
    """Atomic multi-command: failure mid-batch rolls back the completed
    prefix in reverse (reference ``control.py:105-129``)."""

    def __init__(self, *, cmds: typing.Sequence[StackCommand], label: str):
        self.cmds = list(cmds)
        self.label = label

    def do(self, controller: 'Controller') -> None:
        for i, cmd_ in enumerate(self.cmds):
            try:
                cmd_.do(controller)
            except Exception:
                self._rollback(controller, self.cmds[:i])
                raise

    def undo(self, controller: 'Controller') -> None:
        self._rollback(controller, self.cmds)

    @staticmethod
    def _rollback(controller: 'Controller',
                  cmds: typing.Reversible[StackCommand]) -> None:
        # an undo failure here means corrupted state: let it propagate
        for cmd_ in reversed(cmds):
            cmd_.undo(controller)


class PlaybackCommand(LineCommand, abc.ABC):
    """Transport command applying to named sinks, or all sinks when no
    target given (reference ``control.py:207-231``)."""

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> None:
        parser.add_argument('at', type=Coordinates.parse, nargs='*')

    @abc.abstractmethod
    def target_state(self) -> PlaybackState:
        raise NotImplementedError

    def affect(self, controller: 'Controller') -> None:
        state = self.target_state()
        for at in self._targets(controller.map):
            controller.map.playback(at, state)

    def _targets(self, sig_map: Map) -> typing.Iterable[Coordinates]:
        if self.at:
            yield from self.at
        else:
            for sink in sig_map.iter_sinks():
                yield sink.at


class CommandSet:
    """Auto-registers its nested concrete LineCommands by name and symbol
    (reference ``control.py:263-289``)."""

    def __init__(self):
        self._commands_by_alias: dict[str, type[LineCommand]] = {}
        for cmd_cls in vars(type(self)).values():
            if _registry.is_concrete_subclass(cmd_cls, LineCommand):
                self._commands_by_alias[cmd_cls.name()] = cmd_cls
                symbol = cmd_cls.symbol()
                if symbol is not None:
                    self._commands_by_alias[symbol] = cmd_cls

    @property
    def names(self) -> typing.AbstractSet[str]:
        return self._commands_by_alias.keys()

    def parse(self, alias: str,
              args: typing.Sequence[str]) -> LineCommand:
        try:
            cmd_cls = self._commands_by_alias[alias]
        except KeyError:
            raise BadCommand(alias, cmds=self._commands_by_alias)
        try:
            namespace = cmd_cls.parser().parse_args(args)
        except argparse.ArgumentError as e:
            raise BadCommandSyntax(e.message)
        return cmd_cls.from_args(namespace)

    # --- patch-mutating commands -------------------------------------------

    class Add(LineCommand, StackCommand, SerializingCommand):
        signal: MappedSigInfo

        @classmethod
        def symbol(cls) -> str:
            return '+'

        @classmethod
        def name(cls) -> str:
            return 'add'

        @classmethod
        def add_arguments(cls, parser) -> None:
            parser.add_argument('at', type=Coordinates.parse)
            parser.add_argument('sig_cls', type=str)
            parser.add_argument('sig_state', type=SigStateItem.parse,
                                nargs='*')

        @classmethod
        def from_args(cls, args) -> 'CommandSet.Add':
            return cls(signal=MappedSigInfo(at=args.at,
                                            cls_name=args.sig_cls,
                                            state=SigState(args.sig_state)))

        def serialize(self) -> str:
            return ' '.join((self.symbol(), str(self.signal.at),
                             self.signal.cls_name, str(self.signal.state)))

        def do(self, controller: 'Controller') -> None:
            controller.map.add(self.signal)

        def undo(self, controller: 'Controller') -> None:
            controller.map.rm(self.signal.at)

    class Remove(LineCommand, StackCommand, LossyCommand):
        at: Coordinates

        @classmethod
        def symbol(cls) -> str:
            return '-'

        @classmethod
        def name(cls) -> str:
            return 'rm'

        @classmethod
        def add_arguments(cls, parser) -> None:
            parser.add_argument('at', type=Coordinates.parse)

        def do(self, controller: 'Controller') -> None:
            self.push_stash(controller.map.rm(self.at))

        def undo(self, controller: 'Controller') -> None:
            stash: LinkedSigInfo = self.pop_stash()
            controller.map.add(stash)
            for connection in stash.links:
                controller.map.connect(connection)

    class Edit(LineCommand, StackCommand, LossyCommand):
        at: Coordinates
        state: SigState

        @classmethod
        def symbol(cls) -> str:
            return '*'

        @classmethod
        def name(cls) -> str:
            return 'ed'

        @classmethod
        def add_arguments(cls, parser) -> None:
            parser.add_argument('at', type=Coordinates.parse)
            parser.add_argument('sig_state', type=SigStateItem.parse,
                                nargs='+')

        @classmethod
        def from_args(cls, args) -> 'CommandSet.Edit':
            return cls(at=args.at, state=SigState(args.sig_state))

        def do(self, controller: 'Controller') -> None:
            self.push_stash(controller.map.edit(at=self.at,
                                                state=self.state))

        def undo(self, controller: 'Controller') -> None:
            controller.map.edit(self.at, self.pop_stash())

    class Move(LineCommand, StackCommand):
        at1: Coordinates
        at2: Coordinates

        @classmethod
        def symbol(cls) -> str:
            return '='

        @classmethod
        def name(cls) -> str:
            return 'mv'

        @classmethod
        def add_arguments(cls, parser) -> None:
            parser.add_argument('at1', type=Coordinates.parse)
            parser.add_argument('at2', type=Coordinates.parse)

        def do(self, controller: 'Controller') -> None:
            controller.map.mv(self.at1, self.at2)

        def undo(self, controller: 'Controller') -> None:
            controller.map.mv(self.at2, self.at1)

    class Connect(LineCommand, StackCommand, SerializingCommand,
                  LossyCommand):
        connection: ConnectionInfo

        @classmethod
        def symbol(cls) -> str:
            return '>'

        @classmethod
        def name(cls) -> str:
            return 'con'

        @classmethod
        def add_arguments(cls, parser) -> None:
            parser.add_argument('input_at', type=Coordinates.parse)
            parser.add_argument('output', type=PortInfo.parse)

        @classmethod
        def from_args(cls, args) -> 'CommandSet.Connect':
            return cls(connection=ConnectionInfo(input_at=args.input_at,
                                                 output=args.output))

        def serialize(self) -> str:
            return ' '.join((self.symbol(), str(self.connection.input_at),
                             str(self.connection.output)))

        def do(self, controller: 'Controller') -> None:
            old_input_at = controller.map.connect(self.connection)
            self.push_stash(
                None if old_input_at is None else
                ConnectionInfo(input_at=old_input_at,
                               output=self.connection.output))

        def undo(self, controller: 'Controller') -> None:
            controller.map.disconnect(self.connection.output)
            stash = self.pop_stash()
            if stash is not None:
                controller.map.connect(stash)

    class Disconnect(LineCommand, StackCommand, LossyCommand):
        port: PortInfo

        @classmethod
        def symbol(cls) -> str:
            return '>/'

        @classmethod
        def name(cls) -> str:
            return 'discon'

        @classmethod
        def add_arguments(cls, parser) -> None:
            parser.add_argument('port', type=PortInfo.parse)

        def do(self, controller: 'Controller') -> None:
            input_at = controller.map.disconnect(info=self.port)
            self.push_stash(ConnectionInfo(input_at=input_at,
                                           output=self.port))

        def undo(self, controller: 'Controller') -> None:
            controller.map.connect(self.pop_stash())

    # --- device association -------------------------------------------------

    class _DeviceCommand(LineCommand, StackCommand, SerializingCommand,
                         abc.ABC):
        at: Coordinates
        device_name: str

        @classmethod
        def add_arguments(cls, parser) -> None:
            parser.add_argument('at', type=Coordinates.parse)
            parser.add_argument('device_name')

        def serialize(self) -> str:
            return ' '.join((self.name(), str(self.at), self.device_name))

        def do(self, controller: 'Controller') -> None:
            controller.map.add(self._get_device(controller))

        def undo(self, controller: 'Controller') -> None:
            controller.map.rm(self.at)

        @abc.abstractmethod
        def _get_device(self, controller: 'Controller') -> MappedDevInfo:
            raise NotImplementedError

    class Source(_DeviceCommand):

        @classmethod
        def name(cls) -> str:
            return 'source'

        def _get_device(self, controller: 'Controller') -> MappedDevInfo:
            return MappedDevInfo.for_source(
                at=self.at,
                device=controller.rack.get_source(self.device_name))

    class Sink(_DeviceCommand):

        @classmethod
        def name(cls) -> str:
            return 'sink'

        def _get_device(self, controller: 'Controller') -> MappedDevInfo:
            return MappedDevInfo.for_sink(
                at=self.at,
                device=controller.rack.get_sink(self.device_name))

    class Sources(LineCommand):

        @classmethod
        def name(cls) -> str:
            return 'sources'

        def affect(self, controller: 'Controller') -> None:
            for device in controller.rack.sources():
                print(device.describe(), file=controller.stdout)

    class Sinks(LineCommand):

        @classmethod
        def name(cls) -> str:
            return 'sinks'

        def affect(self, controller: 'Controller') -> None:
            for device in controller.rack.sinks():
                print(device.describe(), file=controller.stdout)

    # --- history ------------------------------------------------------------

    class Undo(LineCommand):
        times: int

        @classmethod
        def symbol(cls) -> str:
            return '<<'

        @classmethod
        def name(cls) -> str:
            return 'undo'

        @classmethod
        def add_arguments(cls, parser) -> None:
            parser.add_argument('times', type=int, nargs='?', default=1)

        def affect(self, controller: 'Controller') -> None:
            for _ in range(self.times):
                controller.undo()

    class Redo(LineCommand):
        times: int

        @classmethod
        def symbol(cls) -> str:
            return '>>'

        @classmethod
        def name(cls) -> str:
            return 'redo'

        @classmethod
        def add_arguments(cls, parser) -> None:
            parser.add_argument('times', type=int, nargs='?', default=1)

        def affect(self, controller: 'Controller') -> None:
            for _ in range(self.times):
                controller.redo()

    # --- whole-patch --------------------------------------------------------

    class Init(LineCommand):

        @classmethod
        def name(cls) -> str:
            return 'init'

        def affect(self, controller: 'Controller') -> None:
            controller.push(self.batch_clear(controller))

        @classmethod
        def batch_clear(cls, controller: 'Controller') -> BatchStackCommand:
            cmds: list[StackCommand] = []
            for connection in controller.map.iter_connections():
                cmds.append(CommandSet.Disconnect(port=connection.output))
            for signal in itertools.chain(controller.map.iter_sinks(),
                                          controller.map.iter_sources(),
                                          controller.map.iter_signals()):
                cmds.append(CommandSet.Remove(at=signal.at))
            return BatchStackCommand(cmds=cmds, label=cls.name())

    class Save(LineCommand):
        path: pathlib.Path

        @classmethod
        def name(cls) -> str:
            return 'save'

        @classmethod
        def add_arguments(cls, parser) -> None:
            parser.add_argument('path', type=pathlib.Path)

        def affect(self, controller: 'Controller') -> None:
            with open(self.path, 'w') as f:
                for line in controller.dump():
                    f.write(line + '\n')

    class Load(LineCommand):
        path: pathlib.Path

        @classmethod
        def name(cls) -> str:
            return 'load'

        @classmethod
        def add_arguments(cls, parser) -> None:
            parser.add_argument('path', type=pathlib.Path)

        def affect(self, controller: 'Controller') -> None:
            controller.push(self.batch_load(self.path, controller))

        @classmethod
        def batch_load(cls, path: pathlib.Path,
                       controller: 'Controller') -> BatchStackCommand:
            clear = CommandSet.Init.batch_clear(controller)
            cmds = list(clear.cmds)
            allowed = {'add', 'con', 'source', 'sink'}
            with open(path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    cmd_ = controller.parse_line(line)
                    if cmd_.name() in allowed:
                        assert isinstance(cmd_, StackCommand), cmd_
                        cmds.append(cmd_)
                    else:
                        raise BadCommand(line, allowed)
            return BatchStackCommand(cmds=cmds, label=cls.name())

    class Show(LineCommand):

        @classmethod
        def name(cls) -> str:
            return 'show'

        def affect(self, controller: 'Controller') -> None:
            for line in controller.dump():
                print(line, file=controller.stdout)

    class Bounce(LineCommand):
        """Offline render: ``bounce <sink_at> <path.wav> [seconds]
        [subtype]`` — renders the patch feeding a sink deterministically
        through the compiled engine and writes a WAV (no reference
        counterpart; the reference can only record in real time via
        FileWriter).  ``subtype`` in {float32, pcm16, mulaw, alaw, adpcm,
        slac} picks the sample encoding; the non-float32 encodings run
        **on the sink's device** and only the encoded payload is copied
        to the host (2-8x fewer bytes).  A float32 bounce copies the
        rendered audio to the host once, after the render.  ``slac`` is
        the *lossless* device encoding
        (bit-exact PCM16, typically 2-4x smaller) and writes the native
        ``.slac`` container."""

        at: Coordinates
        path: pathlib.Path
        seconds: float
        subtype: str

        @classmethod
        def name(cls) -> str:
            return 'bounce'

        @classmethod
        def add_arguments(cls, parser) -> None:
            parser.add_argument('at', type=Coordinates.parse)
            parser.add_argument('path', type=pathlib.Path)
            parser.add_argument('seconds', type=float, nargs='?',
                                default=1.0)
            parser.add_argument(
                'subtype', nargs='?', default='float32',
                choices=['float32', 'pcm16', 'mulaw', 'alaw', 'adpcm',
                         'slac'])

        def affect(self, controller: 'Controller') -> None:
            from signals_tpu_torch.runtime.wavio import write_wav
            sink = controller.map.find(self.at)
            if not isinstance(sink, dev.SinkDevice):
                from signals_tpu_torch.map import BadPlaybackTarget
                raise BadPlaybackTarget(self.at, sink)
            if self.subtype != 'float32':
                from signals_tpu_torch.runtime import sndfile
                if self.subtype == 'adpcm':
                    # ADPCM batches pad their final codec block, so batch
                    # payloads don't concatenate exactly: single-shot
                    payload, frames = sink.render_offline_encoded(
                        seconds=self.seconds, subtype=self.subtype)
                    w = sndfile.open_writer(
                        self.path, rate=sink.rate,
                        channels=sink.get_state().channels,
                        subtype=self.subtype)
                    try:
                        w.write_encoded(payload, frames)
                    finally:
                        w.close()
                    print(f'wrote {self.path}: {frames} frames '
                          f'({self.subtype}, device-encoded)',
                          file=controller.stdout)
                    return
                w = sndfile.open_writer(
                    self.path, rate=sink.rate,
                    channels=sink.get_state().channels,
                    subtype=self.subtype)
                total = 0
                try:
                    # pipelined streaming bounce: batch k+1 renders on
                    # device while batch k's payload crosses the host
                    # link and lands in the file
                    for payload, frames in \
                            sink.render_offline_encoded_stream(
                                seconds=self.seconds,
                                subtype=self.subtype):
                        w.write_encoded(payload, frames)
                        total += frames
                finally:
                    w.close()
                print(f'wrote {self.path}: {total} frames '
                      f'({self.subtype}, device-encoded, streamed)',
                      file=controller.stdout)
                return
            audio = sink.render_offline(seconds=self.seconds).cpu().numpy()
            write_wav(self.path, audio, sink.rate)
            print(f'wrote {self.path}: {audio.shape[0]} frames '
                  f'({audio.shape[1]} ch)', file=controller.stdout)

    class Plot(LineCommand):
        """Render a Vis node's queued blocks to an image:
        ``plot <vis_at> <path.png> [frames]``.  With data queued (after
        playback or ``bounce``) the full-rate blocks draw as in the
        reference's vis dock (``ui/vis.py``); with nothing queued the
        patch renders ON DEVICE and only the tap's decimated display
        summary is fetched (``CompiledPatch.render_vis`` — Wave fetches
        a ~1500-point min/max envelope, Spec its FFT band magnitudes,
        never full-rate audio)."""

        at: Coordinates
        path: pathlib.Path
        frames: int

        @classmethod
        def name(cls) -> str:
            return 'plot'

        @classmethod
        def add_arguments(cls, parser) -> None:
            parser.add_argument('at', type=Coordinates.parse)
            parser.add_argument('path', type=pathlib.Path)
            parser.add_argument('frames', type=int, nargs='?', default=1500)

        def affect(self, controller: 'Controller') -> None:
            import matplotlib
            matplotlib.use('Agg')
            import matplotlib.pyplot as plt
            node = controller.map.find(self.at)
            from signals_tpu_torch.nodes.vis import Vis
            if (isinstance(node, Vis) and node.q.empty()
                    and node.summary_q.empty()):
                # nothing queued: one-shot device render of the tap's
                # upstream patch, fetching only the display summary.
                # Engine shape follows the sink whose patch CONTAINS
                # this vis node (the rate playback would run at),
                # engine defaults otherwise.
                from signals_tpu_torch.compiler import compile_node
                bf, rate = _engine_shape_for(controller.map, node)
                compiled = compile_node(node, block_frames=bf, rate=rate,
                                        device=controller.device)
                compiled.render_vis(
                    n_blocks=max(1, -(-self.frames // bf)))
            fig, ax = plt.subplots(figsize=(6, 3))
            controller.map.render(self.at, ax, self.frames)
            fig.savefig(self.path)
            plt.close(fig)
            print(f'wrote {self.path}', file=controller.stdout)

    class Fit(LineCommand):
        """Gradient-fit patch parameters to target audio:
        ``fit <root_at> <target.wav> <at.param> [<at.param> ...]
        [--steps N] [--lr X] [--seconds S]``.

        The differentiable-synthesis flagship as a patcher command (no
        reference counterpart): the patch feeding ``root_at`` (a sink,
        or any signal) is rendered through the compiled engine,
        compared to the target audio by the multi-scale spectral loss
        (:func:`signals_tpu_torch.learn.spectral_loss`), and the named
        parameters gradient-descend on the controller's device — the
        same plans renders use, differentiated through each kernel's
        analytic adjoint.  Fitted values are applied as ONE undoable
        batch of ``ed`` commands: ``undo`` restores every pre-fit value
        atomically, and ``dump``/``save`` serialize the fitted patch.

        Parameter references are ``<coords>.<name>`` (e.g.
        ``1a.value``, ``3b.cutoff``); the parameter must be one the
        compiler traces (numeric state the program takes as input —
        anything ``ed`` can set without a recompile).

        ``--lr`` is a RELATIVE step (``learn.fit(relative_lr=True)``):
        each parameter moves ``lr * max(|initial|, 0.01)`` per Adam
        update, so the 0.05 default serves a unit-scale gain and a
        kHz-scale cutoff in the same fit."""

        at: Coordinates
        path: pathlib.Path
        params: typing.Sequence[tuple[Coordinates, str]]
        steps: int
        lr: float
        seconds: typing.Optional[float]

        @classmethod
        def name(cls) -> str:
            return 'fit'

        @staticmethod
        def _parse_param(token: str) -> tuple[Coordinates, str]:
            at_s, sep, pname = token.partition('.')
            if not sep or not pname:
                raise ValueError(token)
            return Coordinates.parse(at_s), pname

        @classmethod
        def add_arguments(cls, parser) -> None:
            parser.add_argument('at', type=Coordinates.parse)
            parser.add_argument('path', type=pathlib.Path)
            parser.add_argument('params', type=cls._parse_param,
                                nargs='+')
            parser.add_argument('--steps', type=int, default=200)
            parser.add_argument('--lr', type=float, default=0.05)
            parser.add_argument('--seconds', type=float, default=None)

        def affect(self, controller: 'Controller') -> None:
            import numpy as np
            from signals_tpu_torch import learn
            from signals_tpu_torch.compiler import compile_node
            from signals_tpu_torch.runtime.wavio import read_wav

            if self.steps < 1:
                raise BadCommandSyntax('--steps must be >= 1')
            node = controller.map.find(self.at)
            block_frames, rate = 1024, 44100
            if isinstance(node, dev.SinkDevice):
                if not node.input:
                    raise CommandError(
                        f'at {self.at}:', 'The sink has no input to fit')
                root = node.input.sig
                block_frames = node.block_frames
                rate = node.rate
            else:
                root = node

            target, target_rate = read_wav(self.path)
            resampled = ''
            if target_rate != rate:
                from signals_tpu_torch.core.resample import resample
                target = resample(target, target_rate, rate)
                resampled = f' (target resampled {target_rate} -> {rate} Hz)'
            if self.seconds is not None:
                target = target[:max(1, int(self.seconds * rate))]
            if target.shape[0] < block_frames:
                raise CommandError(
                    f'{self.path}: {target.shape[0]} frames of target '
                    f'audio; fitting needs at least one whole '
                    f'{block_frames}-frame block')

            # resolve + validate the trainables against the params the
            # compiled program actually takes as input, so a typo'd or
            # structural (non-traced) name errors before the descent
            compiled = compile_node(root, block_frames=block_frames,
                                    rate=rate, device=controller.device)
            traced = compiled.params()
            trainable = []
            for pat, pname in self.params:
                pnode = controller.map.find(pat)
                try:
                    uid = compiled.index.info(pnode).uid
                except KeyError:
                    raise CommandError(
                        f'at {pat}:', 'The node does not feed the patch '
                        f'rendered at {self.at}, so its parameters '
                        'cannot affect the loss')
                if pname not in traced.get(uid, {}):
                    raise CommandError(
                        f'at {pat}:', f'{pname!r} is not a fittable '
                        'parameter of this node.', 'Fittable here:',
                        ', '.join(sorted(traced.get(uid, {}))) or '(none)')
                trainable.append((pat, pnode, pname))

            result = learn.fit(
                root, target, [(n, p) for _, n, p in trainable],
                rate=rate, block_frames=block_frames, steps=self.steps,
                learning_rate=self.lr, apply=False, relative_lr=True,
                device=controller.device)

            # apply as one atomic, undoable batch of edits
            edits = []
            report = []
            for pat, pnode, pname in trainable:
                fitted = result.value_of(compiled, pnode, pname)
                current = getattr(pnode.get_state(), pname)
                if isinstance(current, np.ndarray):
                    value = fitted.astype(current.dtype)
                else:
                    value = float(fitted.ravel()[0])
                edits.append(CommandSet.Edit(
                    at=pat, state=SigState([(pname, value)])))
                shown = (float(np.asarray(value).ravel()[0])
                         if np.asarray(value).size == 1 else value)
                report.append(f'{pat}.{pname}={shown:.6g}'
                              if isinstance(shown, float)
                              else f'{pat}.{pname}={shown}')
            controller.push(BatchStackCommand(
                cmds=edits, label=f'fit {self.path.name}'))
            losses = result.losses
            print(f'fit {self.path.name}: loss {losses[0]:.4g} -> '
                  f'{losses[-1]:.4g} over {self.steps} steps; '
                  + ' '.join(report) + resampled, file=controller.stdout)

    class Export(LineCommand):
        """Export the patch diagram as SVG: ``export <path.svg> [layout]``."""

        path: pathlib.Path
        layout: str

        @classmethod
        def name(cls) -> str:
            return 'export'

        @classmethod
        def add_arguments(cls, parser) -> None:
            parser.add_argument('path', type=pathlib.Path)
            parser.add_argument('layout', nargs='?', default='layout')

        def affect(self, controller: 'Controller') -> None:
            from signals_tpu_torch.ui.svg import save_svg
            save_svg(controller.map, self.path,
                     use_layout=(self.layout == 'layout'))
            print(f'wrote {self.path}', file=controller.stdout)

    class Stats(LineCommand):
        """Render statistics per sink: block latency percentiles, realtime
        headroom, underruns."""

        @classmethod
        def name(cls) -> str:
            return 'stats'

        def affect(self, controller: 'Controller') -> None:
            for info in controller.map.iter_sinks():
                sink = controller.map.find(info.at)
                line = f'{info.at} {info.device.name}:'
                transport = sink._transport
                if transport is None:
                    line += ' (closed)'
                else:
                    s = transport.stats.summary(sink.block_frames,
                                                sink.rate)
                    line += (f' blocks={s["blocks"]}'
                             f' p50={s["p50_ms"]:.2f}ms'
                             f' p95={s["p95_ms"]:.2f}ms'
                             f' x_realtime={s["x_realtime_p50"]:.0f}'
                             f' underruns={sink.underruns}')
                print(line, file=controller.stdout)

    class View(LineCommand):
        """ASCII patcher view — the headless counterpart of the GUI grid
        surface.  ``view layout`` uses the layered auto-layout."""

        layout: str

        @classmethod
        def name(cls) -> str:
            return 'view'

        @classmethod
        def add_arguments(cls, parser) -> None:
            parser.add_argument('layout', nargs='?', default='')

        def affect(self, controller: 'Controller') -> None:
            from signals_tpu_torch.ui.ascii import render_map
            print(render_map(controller.map,
                             use_layout=(self.layout == 'layout')),
                  file=controller.stdout)

    class Hash(LineCommand):

        @classmethod
        def name(cls) -> str:
            return 'hash'

        def affect(self, controller: 'Controller') -> None:
            print(controller.hash(), file=controller.stdout)

    class Exit(LineCommand):

        @classmethod
        def name(cls) -> str:
            return 'exit'

        def affect(self, controller: 'Controller') -> None:
            controller.exit = True

    class Grep(LineCommand):
        pattern: str

        @classmethod
        def name(cls) -> str:
            return 'grep'

        @classmethod
        def add_arguments(cls, parser) -> None:
            parser.add_argument('pattern')

        def affect(self, controller: 'Controller') -> None:
            for name in controller.grep(self.pattern):
                print(name, file=controller.stdout)

    # --- playback -----------------------------------------------------------

    class Play(PlaybackCommand):

        @classmethod
        def name(cls) -> str:
            return 'play'

        def target_state(self) -> PlaybackState:
            return PlaybackState(position=None, active=True)

    class Pause(PlaybackCommand):

        @classmethod
        def name(cls) -> str:
            return 'pause'

        def target_state(self) -> PlaybackState:
            return PlaybackState(position=None, active=False)

    class Stop(PlaybackCommand):

        @classmethod
        def name(cls) -> str:
            return 'stop'

        def target_state(self) -> PlaybackState:
            return PlaybackState(position=0, active=False)

    class Seek(PlaybackCommand):
        """First-class here; unreachable in the reference (mis-nested
        inside its stop command, ``control.py:688-702``)."""

        position: int

        @classmethod
        def name(cls) -> str:
            return 'seek'

        @classmethod
        def add_arguments(cls, parser) -> None:
            parser.add_argument('position', type=int)
            PlaybackCommand.add_arguments(parser)

        def target_state(self) -> PlaybackState:
            return PlaybackState(position=self.position, active=None)


class Controller(cmd.Cmd):
    """Owns the Map, the Library, the Rack and the history; parses and
    applies command lines (reference ``control.py:705-837``).  ``device``
    is where the patch compiles and renders (the GPU unless asked
    otherwise); a given ``map`` keeps its own."""

    def __init__(self,
                 *,
                 interactive: bool,
                 command_set: typing.Optional[CommandSet] = None,
                 map: typing.Optional[Map] = None,
                 modules: typing.Iterable[str] = (),
                 history_limit: int = 100,
                 stdin=None,
                 stdout=None,
                 device='cuda'):
        super().__init__(stdin=stdin, stdout=stdout)
        self.use_rawinput = False
        self.modcount = 0
        self.last_error: typing.Optional[str] = None
        self.interactive = interactive
        self.map = Map(device) if map is None else map
        #: the compute device of every render the commands start
        self.device = self.map.device
        self.command_set = CommandSet() if command_set is None else command_set
        self.library = _registry.Library(modules)
        self.library.scan()
        self.rack = dev.Rack()
        self.rack.scan()
        self.history: collections.deque[StackCommand] = collections.deque(
            maxlen=history_limit)
        self.history_index: typing.Optional[int] = None
        self.exit = False

    @property
    def prompt(self) -> str:
        return 'signals: ' if self.interactive else ''

    def emptyline(self) -> bool:
        return False

    def default(self, line: str) -> bool:
        #: str when the last command failed, None when it succeeded —
        #: how non-console frontends (the GUI presenter) distinguish a
        #: printed error from command output
        self.last_error = None
        if line == 'EOF':
            self.exit = True
        else:
            try:
                cmd_ = self.parse_line(line)
                cmd_.affect(self)
            except MapLayerError as e:
                self.last_error = str(e)
                if self.interactive:
                    print(str(e), file=self.stdout)
                else:
                    raise
            except OSError as e:
                # e.g. bounce/save/export to an unwritable path — a clean
                # one-liner, not an internal error
                self.last_error = f'IO error: {e}'
                if self.interactive:
                    print(f'IO error: {e}', file=self.stdout)
                else:
                    raise
            except Exception:
                self.last_error = traceback.format_exc()
                print('Unexpected error:', file=self.stdout)
                print(traceback.format_exc(), file=self.stdout)
                if not self.interactive:
                    raise
        return self.exit

    # --- history ------------------------------------------------------------

    def push(self, cmd_: StackCommand) -> None:
        cmd_.do(self)
        self.modcount += 1
        if self.history_index is not None:
            while len(self.history) > self.history_index + 1:
                self.history.pop()
        self.history.append(cmd_)
        self.history_index = len(self.history) - 1

    def undo(self) -> None:
        if self.history_index is None:
            raise BadUndo
        cmd_ = self.history[self.history_index]
        cmd_.undo(self)
        self.modcount -= 1
        self.history_index -= 1
        if self.history_index < 0:
            self.history_index = None

    def redo(self) -> None:
        target = 0 if self.history_index is None else self.history_index + 1
        if target >= len(self.history):
            raise BadRedo
        self.history[target].do(self)
        self.modcount += 1
        self.history_index = target

    def reset_history(self) -> None:
        self.history.clear()
        self.history_index = None
        self.modcount = 0

    # --- serialization ------------------------------------------------------

    def dump(self) -> typing.Iterator[str]:
        """Canonical text form: sources, sinks, adds, connects, each sorted
        (reference ``control.py:807-823``)."""
        for source in sorted(self.map.iter_sources(),
                             key=lambda i: tuple(i.at)):
            yield CommandSet.Source(at=source.at,
                                    device_name=source.device.name
                                    ).serialize()
        for sink in sorted(self.map.iter_sinks(), key=lambda i: tuple(i.at)):
            yield CommandSet.Sink(at=sink.at,
                                  device_name=sink.device.name).serialize()
        for signal in sorted(self.map.iter_signals(),
                             key=lambda i: tuple(i.at)):
            yield CommandSet.Add(signal=signal).serialize()
        for connection in sorted(self.map.iter_connections(),
                                 key=lambda c: (tuple(c.output.at),
                                                c.output.port)):
            yield CommandSet.Connect(connection=connection).serialize()

    def grep(self, pattern: str) -> list[str]:
        return self.library.grep(pattern)

    def parse_line(self, line: str) -> LineCommand:
        alias, *args = shlex.split(line)
        return self.command_set.parse(alias, args)

    def hash(self) -> str:
        state_hash = hashlib.sha3_256()
        for line in self.dump():
            state_hash.update(line.encode())
        return state_hash.hexdigest()


def main(argv: typing.Sequence[str] = (), *, device='cuda') -> None:
    """The REPL on ``device``; ``argv`` names extra library modules."""
    Controller(interactive=True, modules=list(argv),
               device=device).cmdloop()


if __name__ == '__main__':
    main(sys.argv[1:])
