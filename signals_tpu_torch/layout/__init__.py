"""Layered DAG layout (reference ``src/signals/layout/__init__.py``).

Sugiyama-style pipeline for drawing a patch graph: longest-path layering,
dummy-vertex bridging of multi-layer edges, and iterative barycenter
crossing reduction.  Pure algorithm, no UI dependency; the patcher UI and
any headless exporter consume the computed ``(x, y)`` grid positions.
(The reference ships the same capability but never calls it —
``ui/scene.py:13`` imports it unused; here it is wired into
:func:`layout_patch` for maps.)
"""

from __future__ import annotations

import math
import typing

V = typing.TypeVar('V')

#: grid width of a bridging (edge pass-through) vertex
EDGE_WIDTH = 0.25


class Vertex(typing.Generic[V]):
    """A node being laid out; ``value`` carries the caller's payload
    (None for bridge dummies)."""

    __slots__ = ('inputs', 'outputs', 'x', 'y', 'w', 'value')

    def __init__(self, *, value: typing.Optional[V] = None, w: float = 1.0):
        self.inputs: list['Vertex[V]'] = []
        self.outputs: list['Vertex[V]'] = []
        self.x: typing.Optional[float] = None
        self.y: typing.Optional[int] = None
        self.w = w
        self.value = value

    @property
    def is_bridge(self) -> bool:
        return self.value is None

    @property
    def is_placed(self) -> bool:
        return self.x is not None and self.y is not None

    def link(self, output: 'Vertex[V]') -> None:
        self.outputs.append(output)
        output.inputs.append(self)

    def _replace(self, attr: str, old: 'Vertex[V]',
                 new: 'Vertex[V]') -> None:
        lst: list = getattr(self, attr)
        lst[lst.index(old)] = new


class LayoutCycle(Exception):
    pass


class Subgraph(set):
    """An improper subset of a graph; edges may cross the boundary."""

    def components(self) -> list['Subgraph']:
        """Connected components, ignoring boundary-crossing edges."""
        remaining = set(self)
        components: list[Subgraph] = []
        while remaining:
            frontier = [next(iter(remaining))]
            comp = Subgraph()
            while frontier:
                v = frontier.pop()
                if v in comp or v not in self:
                    continue
                comp.add(v)
                frontier.extend(v.inputs)
                frontier.extend(v.outputs)
            remaining -= comp
            components.append(comp)
        return components

    def strata(self) -> list['Subgraph']:
        """Partition by longest-path depth from the in-degree-0 frontier."""
        vertices = Subgraph(self)
        layers: list[Subgraph] = []
        while vertices:
            layer = Subgraph(
                v for v in vertices
                if vertices.isdisjoint(v.inputs))
            if not layer:
                raise LayoutCycle
            vertices -= layer
            layers.append(layer)
        return layers

    @staticmethod
    def bridge(strata: list['Subgraph']) -> None:
        """Insert dummy vertices so every edge spans exactly one layer.

        Deepest layer first: a bridge inserted into layer ``i-1`` becomes a
        vertex of that layer, and its own (still long) input edge is
        bridged again when layer ``i-1`` is processed — long edges unroll
        into chains of dummies.
        """
        for i in range(len(strata) - 1, 0, -1):
            layer = strata[i]
            above = strata[i - 1]
            for v in list(layer):
                for inp in list(v.inputs):
                    if inp not in above:
                        bridge = Vertex(w=EDGE_WIDTH)
                        v._replace('inputs', inp, bridge)
                        inp._replace('outputs', v, bridge)
                        bridge.inputs.append(inp)
                        bridge.outputs.append(v)
                        above.add(bridge)

    def untangle(self, neighbor_attr: str) -> None:
        """One barycenter pass: order this layer by mean neighbor x."""
        ordered = []
        for v in self:
            xs = [n.x for n in getattr(v, neighbor_attr) if n.x is not None]
            bary = sum(xs) / len(xs) if xs else math.inf
            ordered.append((bary, id(v), v))
        x = 0.0
        for _, _, v in sorted(ordered, key=lambda t: (t[0], t[1])):
            v.x = x
            x += math.ceil(v.w)

    @staticmethod
    def untangle_strata(strata: list['Subgraph'],
                        max_passes: int = 10) -> None:
        """Alternating down/up barycenter sweeps until stable (crossing
        minimization is NP-complete; this is the standard heuristic)."""
        prev = None
        for _ in range(max_passes):
            for layer in strata:
                layer.untangle('inputs')
            for layer in reversed(strata):
                layer.untangle('outputs')
            xs = {id(v): v.x for layer in strata for v in layer}
            if xs == prev:
                break
            prev = xs

    def layout(self) -> list['Subgraph']:
        """Full pipeline; returns the strata (including bridges added to
        ``self``).  Every vertex ends placed."""
        strata = self.strata()
        self.bridge(strata)
        self.untangle_strata(strata)
        for y, layer in enumerate(strata):
            self.update(layer)
            for v in layer:
                v.y = y
        assert all(v.is_placed for v in self)
        return strata


def layout_patch(sig_map) -> dict:
    """Lay out a :class:`signals_tpu_torch.map.Map`: returns
    ``{coordinates: (x, y)}`` grid positions for every mapped node."""
    by_at = {}
    graph = Subgraph()
    for at, sig in sig_map._map.items():
        v = Vertex(value=at)
        by_at[str(at)] = v
        graph.add(v)
    for con in sig_map.iter_connections():
        by_at[str(con.input_at)].link(by_at[str(con.output.at)])
    graph.layout()
    return {v.value: (v.x, v.y) for v in graph if not v.is_bridge}
