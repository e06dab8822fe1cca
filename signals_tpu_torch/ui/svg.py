"""SVG patch-diagram export.

The reference draws nodes, ports and patch cables as Qt graphics items
(``src/signals/ui/graph.py``: circle glyphs, tribar cables, theme
palettes).  This renders the same visual language — themed node glyphs laid
out by the layered layout engine, right-angled tribar cables between them —
into a standalone SVG, headlessly.  Useful for docs, patch sharing, and as
the reference rendering for any interactive frontend.
"""

from __future__ import annotations

import html
import typing

from signals_tpu_torch import SignalFlags
from signals_tpu_torch.layout import layout_patch
from signals_tpu_torch.ui import geometry
from signals_tpu_torch.ui import theme as theme_mod

CELL_W = 150
CELL_H = 90
NODE_R = 22


def _node_color(flags: SignalFlags, th: theme_mod.Theme) -> str:
    if flags & SignalFlags.DEVICE:
        return th['highlight'].hex()
    if flags & SignalFlags.GENERATOR:
        return th['node_active'].hex()
    if flags & SignalFlags.VIS or flags & SignalFlags.RECORDER:
        return th['port'].hex()
    return th['node'].hex()


def _poly_points(points) -> str:
    return ' '.join(f'{x:.1f},{y:.1f}' for x, y in points)


def render_svg(sig_map, *, theme: typing.Optional[theme_mod.Theme] = None,
               use_layout: bool = True) -> str:
    """Render a :class:`signals_tpu_torch.map.Map` to an SVG document string."""
    th = theme or theme_mod.controller.theme
    entries = list(sig_map._map.items())
    if use_layout and entries:
        positions = {at: (int(x), int(y))
                     for at, (x, y) in layout_patch(sig_map).items()}
    else:
        positions = {at: (int(at.col) - 1, at.row - 1) for at, _ in entries}

    def center(at):
        x, y = positions[at]
        return ((x + 0.5) * CELL_W, (y + 0.5) * CELL_H)

    width = (max((x for x, _ in positions.values()), default=0) + 1) * CELL_W
    height = (max((y for _, y in positions.values()), default=0) + 1) * CELL_H

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" viewBox="0 0 {width} {height}">',
        f'<rect width="100%" height="100%" fill="{th["window"].hex()}"/>',
    ]

    # cables first (under the nodes): tribar routing, like the reference
    for con in sig_map.iter_connections():
        x0, y0 = center(con.input_at)
        x1, y1 = center(con.output.at)
        line = geometry.tribar_polyline((x0, y0 + NODE_R),
                                        (x1, y1 - NODE_R))
        parts.append(
            f'<polyline points="{_poly_points(line)}" fill="none" '
            f'stroke="{th["cable"].hex()}" stroke-width="3" '
            f'stroke-linejoin="round"/>')
        # port label at the destination
        parts.append(
            f'<text x="{x1 + NODE_R + 4:.1f}" y="{y1 - NODE_R:.1f}" '
            f'font-size="10" fill="{th["dim_text"].hex()}">'
            f'{html.escape(con.output.port)}</text>')

    for at, sig in entries:
        cx, cy = center(at)
        color = _node_color(sig.flags(), th)
        flags = sig.flags()
        if flags & SignalFlags.SINK_DEVICE:
            pts = geometry.regular_polygon((cx, cy), NODE_R, 4,
                                           rotation=0.785398)
            parts.append(f'<polygon points="{_poly_points(pts)}" '
                         f'fill="{color}"/>')
        elif flags & SignalFlags.GENERATOR:
            pts = geometry.regular_polygon((cx, cy), NODE_R, 3,
                                           rotation=-1.570796)
            parts.append(f'<polygon points="{_poly_points(pts)}" '
                         f'fill="{color}"/>')
        else:
            parts.append(f'<circle cx="{cx:.1f}" cy="{cy:.1f}" r="{NODE_R}" '
                         f'fill="{color}"/>')
        label = type(sig).__name__
        parts.append(
            f'<text x="{cx:.1f}" y="{cy + NODE_R + 14:.1f}" '
            f'text-anchor="middle" font-size="12" font-family="monospace" '
            f'fill="{th["text"].hex()}">{html.escape(str(at))}:'
            f'{html.escape(label)}</text>')
        if not getattr(sig.get_state(), 'enabled', True):
            parts.append(
                f'<line x1="{cx - NODE_R}" y1="{cy - NODE_R}" '
                f'x2="{cx + NODE_R}" y2="{cy + NODE_R}" '
                f'stroke="{th["warning"].hex()}" stroke-width="3"/>')

    parts.append('</svg>')
    return '\n'.join(parts)


def save_svg(sig_map, path, **kwargs) -> None:
    with open(path, 'w') as f:
        f.write(render_svg(sig_map, **kwargs))
