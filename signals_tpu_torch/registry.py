"""Signal class registry (``signals_tpu.registry``).

Explicit decorator registration with dotted qualified names, ``grep``-style
library search and ``load_signal(qualname)`` resolution.  For ``.sigs``
patch-file compatibility every node registers the reference's qualified name
(``signals.chain.osc.Sine`` …) as an alias — the same aliases the JAX
package registers, so a patch resolves to the counterpart class in either
package.
"""

from __future__ import annotations

import fnmatch
import importlib
import inspect
import typing

from signals_tpu_torch import SignalFlags, SignalsError


class DiscoveryError(SignalsError):
    pass


class BadSignal(DiscoveryError):
    pass


class BadSyntax(BadSignal):

    def __init__(self, cls_qualname: str):
        super().__init__(f'{cls_qualname!r} is not a valid signal name')


class BadPath(BadSignal):

    def __init__(self, cls_qualname: str, reason: str):
        super().__init__(f'Failed to load {cls_qualname!r}: {reason}')


class InvalidObject(BadSignal):

    def __init__(self, cls_qualname: str, o: object):
        super().__init__(f'Python object {cls_qualname}={o!r} is not a signal')


def qualname(type_: type) -> str:
    return f'{type_.__module__}.{type_.__qualname__}'


def is_concrete_subclass(o, superclass: type, *, allow_abstract: bool = False) -> bool:
    return (isinstance(o, type) and issubclass(o, superclass)
            and (allow_abstract or not inspect.isabstract(o)))


class Registry:
    """Maps qualified names (and aliases) to Signal classes."""

    def __init__(self):
        self._by_name: dict[str, type] = {}
        self._canonical: dict[type, str] = {}

    def register(self, cls: type, *, aliases: typing.Sequence[str] = ()) -> type:
        name = qualname(cls)
        self._by_name[name] = cls
        self._canonical.setdefault(cls, name)
        for alias in aliases:
            self._by_name[alias] = cls
        return cls

    def canonical_name(self, cls: type) -> str:
        try:
            return self._canonical[cls]
        except KeyError:
            return qualname(cls)

    def resolve(self, name: str) -> type:
        return self._by_name[name]

    def names(self, *, include_aliases: bool = True, devices: bool = False) -> list[str]:
        out = []
        for name, cls in self._by_name.items():
            if not include_aliases and name != self._canonical.get(cls):
                continue
            if not devices and (cls.flags() & SignalFlags.DEVICE):
                continue
            out.append(name)
        return sorted(out)


registry = Registry()

#: Node modules imported on first library access, so decorator registration
#: runs without requiring the user to import each node module by hand.
_NODE_MODULES = (
    'signals_tpu_torch.nodes.osc',
    'signals_tpu_torch.nodes.fx',
    'signals_tpu_torch.nodes.fixed',
    'signals_tpu_torch.nodes.env',
    'signals_tpu_torch.nodes.delay',
    'signals_tpu_torch.nodes.noise',
    'signals_tpu_torch.nodes.reverb',
    'signals_tpu_torch.nodes.dyn',
    'signals_tpu_torch.nodes.vis',
    'signals_tpu_torch.nodes.wavetable',
    'signals_tpu_torch.nodes.files',
    'signals_tpu_torch.nodes.shape',
    'signals_tpu_torch.nodes.seq',
    'signals_tpu_torch.nodes.moddelay',
    'signals_tpu_torch.nodes.phaser',
    'signals_tpu_torch.nodes.conv',
)

_loaded = False


def ensure_loaded() -> None:
    global _loaded
    if not _loaded:
        _loaded = True
        for mod in _NODE_MODULES:
            importlib.import_module(mod)


def register(*aliases: str):
    """Class decorator: register a concrete Signal with optional alias names
    (aliases are typically reference-framework qualnames for ``.sigs``
    compatibility)."""
    def deco(cls: type) -> type:
        return registry.register(cls, aliases=aliases)
    return deco


def load_signal(name: str) -> type:
    """Resolve a dotted signal name to its class.

    Registry first (covers all built-in nodes and reference-name aliases);
    falls back to a real dotted import for user-supplied classes — keeping the
    reference's ability to reference any importable Signal subclass
    (``chain/discovery.py:129-140``).
    """
    import signals_tpu_torch.graph as graph
    ensure_loaded()
    try:
        cls = registry.resolve(name)
    except KeyError:
        if '.' not in name:
            raise BadSyntax(name)
        module_name, _, cls_name = name.rpartition('.')
        try:
            module = importlib.import_module(module_name)
        except ImportError as e:
            raise BadPath(name, str(e.args[0] if e.args else e))
        try:
            cls = module
            for part in cls_name.split('.'):
                cls = getattr(cls, part)
        except AttributeError as e:
            raise BadPath(name, str(e.args[0] if e.args else e))
    if is_concrete_subclass(cls, graph.Signal):
        return cls
    raise InvalidObject(name, cls)


class Library:
    """The searchable catalogue of available (non-device) signal classes
    (reference ``chain/discovery.py:71-93``).

    ``paths``/``modules`` let users add their own node modules; any concrete
    Signal subclass defined in them is picked up, registered or not.
    """

    def __init__(self, modules: typing.Iterable[str] = ()):
        self._extra_modules = list(modules)
        self.names: list[str] = []

    def scan(self) -> None:
        import signals_tpu_torch.graph as graph
        ensure_loaded()
        names = set(registry.names(include_aliases=False, devices=False))
        for mod_name in self._extra_modules:
            module = importlib.import_module(mod_name)
            for k, v in vars(module).items():
                if (not k.startswith('_')
                        and getattr(v, '__module__', None) == module.__name__
                        and is_concrete_subclass(v, graph.Signal)
                        and not (v.flags() & SignalFlags.DEVICE)):
                    names.add(qualname(v))
        self.names = sorted(names)

    def grep(self, pattern: str) -> list[str]:
        return sorted(fnmatch.filter(self.names, pattern))
