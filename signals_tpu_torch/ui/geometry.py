"""Geometry helpers for patcher frontends
(reference ``src/signals/ui/geometry.py``).

Pure numpy point math (the reference returns Qt point lists): regular
polygons and circle sampling for node glyphs, chevrons for port arrows, and
the three-segment right-angled "tribar" polyline used to route patch cables
between grid cells.  All functions return ``(n, 2)`` float arrays any
frontend can consume.
"""

from __future__ import annotations

import numpy as np


def circle(center, radius: float, n: int = 32) -> np.ndarray:
    """``n`` points around a circle (closed: first point repeated last)."""
    t = np.linspace(0.0, 2 * np.pi, n + 1)
    cx, cy = center
    return np.stack([cx + radius * np.cos(t), cy + radius * np.sin(t)],
                    axis=1)


def regular_polygon(center, radius: float, sides: int,
                    rotation: float = 0.0) -> np.ndarray:
    t = rotation + np.linspace(0.0, 2 * np.pi, sides, endpoint=False)
    cx, cy = center
    return np.stack([cx + radius * np.cos(t), cy + radius * np.sin(t)],
                    axis=1)


def inset_chevron(rect, *, inset: float = 0.25,
                  pointing: str = 'down') -> np.ndarray:
    """Port-arrow glyph inside ``rect = (x, y, w, h)``."""
    x, y, w, h = rect
    ix, iy = w * inset, h * inset
    if pointing == 'down':
        pts = [(x + ix, y + iy), (x + w / 2, y + h - iy),
               (x + w - ix, y + iy)]
    elif pointing == 'up':
        pts = [(x + ix, y + h - iy), (x + w / 2, y + iy),
               (x + w - ix, y + h - iy)]
    elif pointing == 'right':
        pts = [(x + ix, y + iy), (x + w - ix, y + h / 2),
               (x + ix, y + h - iy)]
    else:
        pts = [(x + w - ix, y + iy), (x + ix, y + h / 2),
               (x + w - ix, y + h - iy)]
    return np.asarray(pts, dtype=float)


def tribar_polyline(start, end, *, split: float = 0.5) -> np.ndarray:
    """Three-segment right-angled cable route from ``start`` down/over/down
    to ``end`` (reference ``geometry.py:42-73``): vertical to the split
    height, horizontal across, vertical to the end."""
    x0, y0 = start
    x1, y1 = end
    ym = y0 + (y1 - y0) * split
    return np.asarray([(x0, y0), (x0, ym), (x1, ym), (x1, y1)], dtype=float)


def tribar_polygon(start, end, *, width: float = 2.0,
                   split: float = 0.5) -> np.ndarray:
    """The tribar polyline thickened into a closed polygon (for hit-testing
    and filled rendering)."""
    line = tribar_polyline(start, end, split=split)
    half = width / 2
    up, down = [], []
    for i, (x, y) in enumerate(line):
        prev_v = line[i] - line[i - 1] if i > 0 else line[1] - line[0]
        nxt_v = line[i + 1] - line[i] if i < len(line) - 1 else prev_v
        d = prev_v + nxt_v
        n = np.array([-d[1], d[0]], dtype=float)
        norm = np.hypot(*n)
        n = n / norm * half if norm else np.array([half, 0.0])
        up.append(line[i] + n)
        down.append(line[i] - n)
    return np.asarray(up + down[::-1], dtype=float)


def scale_rect(rect, factor: float) -> tuple:
    """Scale ``(x, y, w, h)`` about its center."""
    x, y, w, h = rect
    cx, cy = x + w / 2, y + h / 2
    nw, nh = w * factor, h * factor
    return (cx - nw / 2, cy - nh / 2, nw, nh)


def rect_containing_points(points) -> tuple:
    pts = np.asarray(points, dtype=float)
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    return (lo[0], lo[1], hi[0] - lo[0], hi[1] - lo[1])


def clip_to_rect(point, rect) -> tuple:
    x, y, w, h = rect
    px, py = point
    return (min(max(px, x), x + w), min(max(py, y), y + h))
