"""Core value types of the chain runtime (``signals_tpu.core``).

``Shape`` and ``BlockLoc`` define the block-addressed timeline all evaluation
is expressed in: a block is a ``(frames, channels)`` array located at an
absolute sample ``position`` in a timeline running at ``rate`` frames per
second.  A node may answer a request with 1 frame and/or 1 channel, meaning
"constant along that axis" — the broadcast partial order on shapes.
"""

from __future__ import annotations

import typing

import numpy as np

from signals_tpu_torch import SignalsError


class ChainLayerError(SignalsError):
    pass


class Shape(typing.NamedTuple):
    """Block shape with the broadcast partial order: ``s <= t`` iff each
    dim of ``s`` is 1 or equals the corresponding dim of ``t``.

    >>> s = Shape(frames=10, channels=2)
    >>> (1, 1) <= Shape(frames=1, channels=s.channels) <= s
    True
    >>> Shape(frames=3, channels=2) <= s
    False
    """

    frames: int
    channels: int

    @classmethod
    def unit(cls) -> 'Shape':
        return Shape(frames=1, channels=1)

    def __le__(self, other: tuple) -> bool:
        return (self[0] in (1, other[0])) and (self[1] in (1, other[1]))

    def __ge__(self, other: tuple) -> bool:
        return (other[0] in (1, self[0])) and (other[1] in (1, self[1]))

    @classmethod
    def of_array(cls, array) -> 'Shape':
        if len(array.shape) != 2:
            raise ValueError(f'blocks must be 2-D, got shape {array.shape}')
        return cls(*array.shape)


class BadShape(ChainLayerError):
    """A node answered a request with an incompatible block shape."""

    def __init__(self, source, shape: tuple, constraint: tuple):
        super().__init__(
            f'Invalid response from {source.cls_name()!r}: '
            f'block with shape {tuple(shape)} incompatible with requested '
            f'shape {tuple(constraint)}')


class BlockLoc(typing.NamedTuple):
    """Where in the global sample timeline a block lives: ``position`` is
    the absolute index of its first frame, ``rate`` the sample rate."""

    position: int
    rate: int
    shape: Shape

    @property
    def end_position(self) -> int:
        return self.position + self.shape.frames

    @property
    def timestamp(self) -> float:
        return self.position / self.rate

    @property
    def frame_range(self) -> np.ndarray:
        """Absolute frame indices as a column vector — the time base every
        oscillator evaluates against."""
        return np.arange(self.position, self.end_position).reshape(-1, 1)

    def resize(self, new_frames: int) -> 'BlockLoc':
        if new_frames == self.shape.frames:
            return self
        return self._replace(shape=Shape(frames=new_frames,
                                         channels=self.shape.channels))

    def reslice(self, new_channels: int) -> 'BlockLoc':
        if new_channels == self.shape.channels:
            return self
        return self._replace(shape=Shape(frames=self.shape.frames,
                                         channels=new_channels))

    def __le__(self, other: 'BlockLoc') -> bool:
        """Containment: ``self`` is a sub-block of ``other`` (block cache)."""
        return (
            self.rate == other.rate
            and self.position >= other.position
            and self.end_position <= other.end_position
            and self.shape.channels <= other.shape.channels
        )

    def __ge__(self, other: 'BlockLoc') -> bool:
        return other.__le__(self)

    def before(self, frames: int) -> 'BlockLoc':
        """Up to ``frames`` frames of context immediately before this
        block, clamped at the start of the timeline."""
        return self._replace(
            position=max(self.position - frames, 0),
            shape=Shape(frames=min(frames, self.position),
                        channels=self.shape.channels))

    def after(self, frames: int) -> 'BlockLoc':
        return self._replace(
            position=self.end_position,
            shape=Shape(frames=frames, channels=self.shape.channels))


class Request(typing.NamedTuple):
    """A pull request for a block."""

    requestor: typing.Any  # Receiver
    port: 'str'
    loc: BlockLoc
