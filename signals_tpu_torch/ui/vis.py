"""Visualization rack (reference ``src/signals/ui/vis.py``).

The reference embeds matplotlib canvases in Qt docks updated by a 30 ms
``FuncAnimation`` pulling 1500 frames per tick (``ui/vis.py:16-52``).  Here
the rack is frontend-neutral: it owns a matplotlib Figure with one axes per
registered Vis node, re-renders on demand (``update()``), can save to file
(headless operation), and supports the same live animation when an
interactive backend is present.  Rendering cost stays on the host — taps
are extra outputs of the compiled program, so the GPU never waits on a plot.
"""

from __future__ import annotations

import typing

from signals_tpu_torch.nodes.vis import Vis
from signals_tpu_torch.ui import theme as theme_mod

#: reference cadence: 30 ms refresh, 1500 frames per refresh
REFRESH_MS = 30
FRAMES_PER_REFRESH = 1500


class VisRack:
    """A horizontal rack of visualization canvases."""

    def __init__(self, *, frames: int = FRAMES_PER_REFRESH,
                 theme: typing.Optional[theme_mod.Theme] = None):
        self.frames = frames
        self.theme = theme or theme_mod.controller.theme
        self._entries: list[tuple[str, Vis]] = []
        self._figure = None
        self._axes: list = []
        self._frozen: set[int] = set()
        self._plt_manager = None    # adopted interactive-backend manager

    def add(self, name: str, node: Vis) -> None:
        if not isinstance(node, Vis):
            raise TypeError(f'{node!r} is not a Vis node')
        self._entries.append((name, node))
        self._figure = None     # relayout on next draw

    def remove(self, node: Vis) -> None:
        self._entries = [(n, v) for n, v in self._entries if v is not node]
        self._figure = None

    def freeze(self, index: int, frozen: bool = True) -> None:
        """Pause one canvas (reference FreezeButton, ``ui/vis.py:55-85``)."""
        if frozen:
            self._frozen.add(index)
        else:
            self._frozen.discard(index)

    def __len__(self) -> int:
        return len(self._entries)

    # --- rendering ----------------------------------------------------------

    def _ensure_figure(self):
        # a bare Figure, NOT pyplot: pyplot binds the process-global GUI
        # backend (and would try to drive tkinter itself), while an
        # embedding host — the Tk patcher dock, a headless save — must
        # own the canvas.  Figure.savefig attaches an Agg canvas on
        # demand, so headless operation is unchanged.
        import matplotlib
        from matplotlib.figure import Figure
        if self._figure is not None:
            return self._figure
        n = max(len(self._entries), 1)
        with matplotlib.rc_context(self.theme.matplotlib_rc()):
            self._figure = Figure(figsize=(4 * n, 3))
            self._axes = [self._figure.add_subplot(1, n, i + 1)
                          for i in range(n)]
        for (name, _), ax in zip(self._entries, self._axes):
            ax.set_title(name, color=self.theme['text'].hex())
        return self._figure

    def update(self) -> list:
        """Drain every node's queue and redraw its axes; returns artists."""
        self._ensure_figure()
        artists = []
        for i, ((name, node), ax) in enumerate(
                zip(self._entries, self._axes)):
            if i in self._frozen:
                continue
            artists.extend(node.render(ax, self.frames))
            ax.set_title(name, color=self.theme['text'].hex())
        return artists

    def save(self, path) -> None:
        """Headless: render current queues to an image file."""
        self.update()
        self._ensure_figure().savefig(path)

    def animate(self, interval_ms: int = REFRESH_MS):
        """Live view.  The figure has no GUI canvas of its own (see
        ``_ensure_figure``); adopt it into pyplot's interactive backend
        first, so the animation has a real event source."""
        import matplotlib.pyplot as plt
        from matplotlib.animation import FuncAnimation
        fig = self._ensure_figure()
        if getattr(fig.canvas, 'manager', None) is None:
            # attach the interactive backend's canvas/manager.  The
            # manager is created once via a throwaway pyplot figure and
            # cached: re-animating after the rack relayouts re-points the
            # SAME manager at the new Figure, so Gcf never accumulates
            # orphaned managers/figures across animate() calls.
            if self._plt_manager is None:
                self._plt_manager = plt.figure().canvas.manager
            mgr = self._plt_manager
            mgr.canvas.figure = fig
            fig.set_canvas(mgr.canvas)
        return FuncAnimation(fig, lambda _frame: self.update(),
                             interval=interval_ms, cache_frame_data=False)
