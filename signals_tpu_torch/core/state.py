"""Declarative node-state schemas (``signals_tpu.core.state``).

Every ``Signal`` class carries a nested ``State`` class whose fields are
validated on assignment.  Each field declares whether it is **traced** (a
value fed to the compiled patch as a parameter tensor, editable without
recompiling: e.g. a constant's array) or **structural** (fixed when the patch
is compiled, so editing it changes the graph hash and recompiles: e.g. a
filter's context length).
"""

from __future__ import annotations

import typing

import numpy as np

from signals_tpu_torch import SigStateValue
from signals_tpu_torch.core import ChainLayerError


class BadStateSchema(ChainLayerError):
    """A signal was handed a state object of the wrong schema
    (reference ``chain/__init__.py:94-97``)."""

    def __init__(self, sig, state):
        super().__init__(f'Signal {sig.cls_name()!r} cannot accept state of '
                         f'type {type(state).__qualname__!r}')


class BadStateValue(ChainLayerError):
    """A state property was assigned an invalid value
    (reference ``chain/__init__.py:100-104``)."""

    def __init__(self, state, key: str, value, reason=None):
        reason = '' if reason is None else f': ({reason})'
        super().__init__(f'Value {value!r} is invalid for property {key!r} '
                         f'in schema {type(state).__qualname__!r}{reason}')


Validator = typing.Callable[[typing.Any], typing.Optional[str]]
"""Returns an error string for invalid values, None for valid ones."""


def instance_of(*types: type) -> Validator:
    def check(v):
        if not isinstance(v, types):
            return f'must be an instance of {types}'
        # bool is an int subclass; require exact bool when bool is demanded
        if bool not in types and isinstance(v, bool) and int in types:
            return 'must not be a bool'
    return check


def ge(bound) -> Validator:
    def check(v):
        try:
            ok = v >= bound
        except TypeError:
            return f'must be a number >= {bound}'
        if not ok:
            return f'must be >= {bound}'
    return check


def in_range(lo, hi) -> Validator:
    """Inclusive range check (used by device channel validators)."""
    def check(v):
        try:
            ok = lo <= v <= hi
        except TypeError:
            return f'must be a number in [{lo}, {hi}]'
        if not ok:
            return f'must be in [{lo}, {hi}]'
    return check


def array_2d(v) -> typing.Optional[str]:
    if not (isinstance(v, np.ndarray) and v.ndim == 2):
        return 'must be a 2D array'
    return None


def all_of(*validators: Validator) -> Validator:
    def check(v):
        for val in validators:
            err = val(v)
            if err is not None:
                return err
    return check


class Param:
    """One declared state field.

    ``traced=True`` marks fields whose values flow into the compiled program
    as inputs (editable per-step without recompiling); structural fields are
    compile-time constants and participate in the compile-cache key.
    """

    __slots__ = ('name', 'default', 'validate', 'convert', 'traced')

    def __init__(self,
                 default: SigStateValue | typing.Callable[[], SigStateValue],
                 *,
                 validate: typing.Optional[Validator] = None,
                 convert: typing.Optional[typing.Callable] = None,
                 traced: bool = False):
        self.name: str = '?'
        self.default = default
        self.validate = validate
        self.convert = convert
        self.traced = traced

    def make_default(self) -> SigStateValue:
        d = self.default
        return d() if callable(d) else d


class State:
    """Base of all node state schemas.

    Subclasses declare fields as ``Param`` class attributes; fields are merged
    down the inheritance chain.  Assignment validates
    (raising :class:`BadStateValue`), matching the reference's
    attrs-with-validators behavior.
    """

    _params: typing.ClassVar[dict[str, Param]] = {}
    _own_params: typing.ClassVar[dict[str, Param]] = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        own: dict[str, Param] = {}
        for k, v in list(vars(cls).items()):
            if isinstance(v, Param):
                v.name = k
                own[k] = v
                # Instance values are stored in __dict__; a leftover Param
                # class attr would only confuse introspection, so remove it.
                delattr(cls, k)
        cls._own_params = own
        merged: dict[str, Param] = {}
        for base in reversed(cls.__mro__):
            merged.update(base.__dict__.get('_own_params', {}))
        cls._params = merged

    def __init__(self, **kwargs):
        for name, param in self._params.items():
            value = kwargs.pop(name) if name in kwargs else param.make_default()
            setattr(self, name, value)
        if kwargs:
            raise BadStateValue(self, next(iter(kwargs)),
                                kwargs[next(iter(kwargs))],
                                'unknown property')

    def __setattr__(self, key: str, value) -> None:
        param = self._params.get(key)
        if param is None:
            if key.startswith('_'):
                object.__setattr__(self, key, value)
                return
            raise AttributeError(key)
        if param.convert is not None:
            value = param.convert(value)
        if param.validate is not None:
            err = param.validate(value)
            if err is not None:
                raise BadStateValue(self, key, value, err)
        object.__setattr__(self, key, value)

    @classmethod
    def param_names(cls) -> typing.AbstractSet[str]:
        return cls._params.keys()

    def asdict(self) -> dict[str, SigStateValue]:
        return {k: getattr(self, k) for k in self._params}

    def copy(self) -> 'State':
        new = type(self).__new__(type(self))
        for k in self._params:
            object.__setattr__(new, k, getattr(self, k))
        return new

    def __eq__(self, other) -> bool:
        if type(self) is not type(other):
            return NotImplemented
        for k in self._params:
            a, b = getattr(self, k), getattr(other, k)
            if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
                if not (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                        and a.shape == b.shape and np.array_equal(a, b)):
                    return False
            elif a != b:
                return False
        return True

    def __repr__(self) -> str:
        items = ', '.join(f'{k}={getattr(self, k)!r}' for k in self._params)
        return f'{type(self).__qualname__}({items})'
