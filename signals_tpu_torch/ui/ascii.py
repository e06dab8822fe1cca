"""ASCII patcher view: the grid surface rendered to text.

The reference's patcher surface is a QGraphicsScene grid of node containers
with routed cables (``src/signals/ui/patcher/__init__.py``, ``ui/graph.py``).
This renderer draws the same information — nodes on the grid with their
coordinates and flags, connections listed per port — into a terminal, using
the layered layout when asked.  It is the headless counterpart of the GUI
surface (and what the REPL's ``view`` command prints).
"""

from __future__ import annotations

from signals_tpu_torch import SignalFlags
from signals_tpu_torch.layout import layout_patch

CELL_W = 14


def _glyph(flags: SignalFlags) -> str:
    if flags & SignalFlags.SINK_DEVICE:
        return ')))'
    if flags & SignalFlags.SOURCE_DEVICE:
        return '((('
    if flags & SignalFlags.VIS:
        return '~~~'
    if flags & SignalFlags.RECORDER:
        return '(o)'
    if flags & SignalFlags.GENERATOR:
        return '>>>'
    if flags & SignalFlags.EFFECT:
        return '[=]'
    return '***'


def _short_name(cls_name: str) -> str:
    return cls_name.rsplit('.', 1)[-1]


def cell_span(at) -> tuple:
    """(text_row, x_start, x_end) of a coordinate's cell in the grid text
    rendered with ``pad_to`` (empty rows kept, so positions are fixed)."""
    x0 = 2 + (int(at.col) - 1) * (CELL_W + 3)
    return at.row - 1, x0, x0 + CELL_W


def render_map(sig_map, *, use_layout: bool = False, pad_to=None) -> str:
    """Draw the patch as a text grid.

    ``use_layout=False`` places nodes at their own map coordinates (what the
    user typed); ``use_layout=True`` uses the layered auto-layout instead.
    ``pad_to`` (a Coordinates) keeps empty rows and extends the grid to
    cover that cell — fixed geometry for cursor overlays (``cell_span``).
    """
    cells: dict[tuple[int, int], str] = {}
    entries = list(sig_map._map.items())
    if not entries and pad_to is None:
        return '(empty patch)\n'

    if use_layout:
        positions = layout_patch(sig_map)
        coords = {at: (int(x), int(y)) for at, (x, y) in positions.items()}
    else:
        coords = {at: (int(at.col) - 1, at.row - 1) for at, _ in entries}

    for at, sig in entries:
        x, y = coords[at]
        label = f'{at}:{_short_name(type(sig).__name__)}'
        cells[(x, y)] = f'{_glyph(sig.flags())} {label}'

    max_x = max(x for x, _ in cells) if cells else 0
    max_y = max(y for _, y in cells) if cells else 0
    if pad_to is not None:
        max_x = max(max_x, int(pad_to.col) - 1)
        max_y = max(max_y, pad_to.row - 1)
    lines = []
    for y in range(max_y + 1):
        row = []
        for x in range(max_x + 1):
            row.append(cells.get((x, y), '')[:CELL_W].ljust(CELL_W))
        populated = any(cells.get((x, y)) for x in range(max_x + 1))
        lines.append('| ' + ' | '.join(row).rstrip() + ' |'
                     if populated or pad_to is not None else '')
    grid = '\n'.join(line for line in lines
                     if line or pad_to is not None)

    cons = []
    for con in sig_map.iter_connections():
        cons.append(f'  {con.input_at} --> {con.output.at}.{con.output.port}')
    if cons:
        grid += '\n\ncables:\n' + '\n'.join(sorted(cons))
    return grid + '\n'
