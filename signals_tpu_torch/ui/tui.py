"""Interactive terminal patcher (the reference's Qt patcher window,
``src/signals/ui/patcher/window.py``, re-imagined for a terminal).

A curses application composing the same pieces the Qt window does:
the grid surface (ASCII renderer), the embedded command console wired to
the :class:`~signals_tpu_torch.map.control.Controller` (the reference embeds a
PyQtCmd console, ``window.py:68-82``), dirty tracking via modcount + state
hash (``window.py:217-230``), keyboard shortcuts for undo/redo — and
**grid mode**, the terminal analogue of the Qt scene's mouse gestures
(``ui/graph.py:300-397``: clicking an emitter spawns a placing cable):
a cell cursor with cable drag, port picking, node delete and move.  Every
gesture routes through Controller commands, so it is undoable and lands
in the same history as typed commands.

Run: ``python -m signals_tpu_torch.ui.tui [patch.sigs]``
Keys: Esc toggles command/grid mode.  In grid mode: arrows/hjkl move,
Enter starts/completes a cable (then a digit picks the input port),
``a`` fuzzy add-picker (the reference's add-signal dialog,
``ui/patcher/dialog.py:118-169``), ``A`` raw add command, ``d`` delete,
``m`` move, ``x`` disconnect, ``y``/``c``/``p`` copy/cut/paste the node
under the cursor (the reference's clipboard actions,
``ui/patcher/window.py:159-178`` — payload is the node's class + state,
re-added through the undoable command stack), ``u``/``r`` undo/redo.
"""

from __future__ import annotations

import io
import sys
import typing

from signals_tpu_torch.graph import Receiver
from signals_tpu_torch.map import Coordinates, CoordinateColumn
from signals_tpu_torch.map.control import Controller
from signals_tpu_torch.ui.ascii import render_map

ESC = '\x1b'

# curses key constants, importable headlessly (tests drive handle_key
# without a terminal)
try:
    import curses
    _KEY_UP, _KEY_DOWN = curses.KEY_UP, curses.KEY_DOWN
    _KEY_LEFT, _KEY_RIGHT = curses.KEY_LEFT, curses.KEY_RIGHT
    _KEY_ENTER, _KEY_BACKSPACE = curses.KEY_ENTER, curses.KEY_BACKSPACE
    _KEY_F2, _KEY_F3 = curses.KEY_F2, curses.KEY_F3
except ImportError:                                   # pragma: no cover
    curses = None
    _KEY_UP = _KEY_DOWN = _KEY_LEFT = _KEY_RIGHT = object()
    _KEY_ENTER = _KEY_BACKSPACE = _KEY_F2 = _KEY_F3 = object()


class PatcherTUI:

    def __init__(self, controller: typing.Optional[Controller] = None):
        self.out = io.StringIO()
        self.controller = controller or Controller(interactive=True,
                                                   stdout=self.out)
        self.history: list[str] = []
        self.hist_pos = 0
        self.line = ''
        self.mode = 'cmd'                  # 'cmd' | 'grid'
        self.cursor = Coordinates(row=1, col=CoordinateColumn(1))
        self.pending: typing.Optional[tuple[str, Coordinates]] = None
        self.port_menu: typing.Optional[tuple[str, Coordinates,
                                              list[str]]] = None
        #: clipboard payload: ``(cls_name, state_text)`` of a copied node
        self.clipboard: typing.Optional[tuple[str, str]] = None
        #: fuzzy add-picker state: ``{'query': str, 'sel': int}``
        self.picker: typing.Optional[dict] = None
        self.message = "Esc: grid mode; commands: " \
                       "'+ 1a signals.chain.osc.Sine', 'view', 'undo', " \
                       "'exit'; F2 undo, F3 redo"
        self.saved_hash = self.controller.hash()

    # --- command handling ---------------------------------------------------

    def run_line(self, line: str) -> None:
        if not line.strip():
            return
        self.history.append(line)
        self.hist_pos = len(self.history)
        self.out.truncate(0)
        self.out.seek(0)
        self.controller.default(line)
        self.message = self.out.getvalue().strip() or 'ok'

    @property
    def dirty(self) -> bool:
        return self.controller.hash() != self.saved_hash

    # --- grid-mode gestures ---------------------------------------------------

    def _at(self) -> Coordinates:
        return self.cursor

    def _sig(self, at: Coordinates):
        return self.controller.map.get(at)

    def _move_cursor(self, dr: int, dc: int) -> None:
        row = min(64, max(1, self.cursor.row + dr))
        col = min(64, max(1, int(self.cursor.col) + dc))
        self.cursor = Coordinates(row=row, col=CoordinateColumn(col))

    def _start_or_complete(self) -> None:
        at = self._at()
        sig = self._sig(at)
        if self.pending is None:
            if sig is None:
                self.message = f'{at}: empty — move onto a node first'
                return
            kind = 'cable'
            self.pending = (kind, at)
            self.message = (f'cable from {at} — move to the target and '
                            f'press Enter')
            return
        kind, src = self.pending
        if kind == 'move':
            self.pending = None
            self.run_line(f'= {src} {at}')
            return
        # cable completion: pick the target input port
        if sig is None or not isinstance(sig, Receiver):
            self.message = f'{at}: not a receiver — Esc cancels'
            return
        ports = sorted(sig.port_names())
        if len(ports) == 1:
            self.pending = None
            self.run_line(f'> {src} {at}.{ports[0]}')
            return
        self.port_menu = ('connect', at, ports)
        self.message = ('port: ' + '  '.join(
            f'{i + 1}){p}' for i, p in enumerate(ports)))

    def _disconnect(self) -> None:
        at = self._at()
        sig = self._sig(at)
        if sig is None or not isinstance(sig, Receiver):
            self.message = f'{at}: nothing to disconnect'
            return
        ports = sorted(sig.inputs_by_port)
        if not ports:
            self.message = f'{at}: no connected inputs'
            return
        if len(ports) == 1:
            self.run_line(f'>/ {at}.{ports[0]}')
            return
        self.port_menu = ('disconnect', at, ports)
        self.message = ('disconnect: ' + '  '.join(
            f'{i + 1}){p}' for i, p in enumerate(ports)))

    # --- clipboard (reference window.py:159-178) ----------------------------

    def _info_at(self, at: Coordinates):
        for info in self.controller.map.iter_signals():
            if info.at == at:
                return info
        return None

    def copy(self) -> bool:
        from signals_tpu_torch.ui.actions import clip_payload
        at = self._at()
        payload = clip_payload(self.controller, at)
        if payload is None:
            self.message = f'{at}: nothing to copy'
            return False
        self.clipboard = payload
        self.message = f'copied {payload[0].rsplit(".", 1)[-1]} from {at}'
        return True

    def cut(self) -> None:
        if self.copy():
            self.run_line(f'- {self._at()}')

    def paste(self) -> None:
        from signals_tpu_torch.ui.actions import paste_line
        if self.clipboard is None:
            self.message = 'clipboard empty'
            return
        self.run_line(paste_line(self._at(), self.clipboard))

    # --- fuzzy add-picker (reference dialog.py:118-169) ---------------------

    def picker_matches(self, query: str) -> list[str]:
        from signals_tpu_torch.ui.actions import fuzzy_rank
        return fuzzy_rank(self.controller.library.names, query)

    def _open_picker(self) -> None:
        self.picker = {'query': '', 'sel': 0}
        self._picker_message()

    def _picker_message(self) -> None:
        query = self.picker['query']
        matches = self.picker_matches(query)[:6]
        sel = min(self.picker['sel'], max(0, len(matches) - 1))
        self.picker['sel'] = sel
        parts = [(f'[{m.rsplit(".", 1)[-1]}]' if i == sel
                  else m.rsplit('.', 1)[-1])
                 for i, m in enumerate(matches)]
        self.message = (f'add@{self._at()}: {query}_  '
                        + ('  '.join(parts) if parts else '(no match)'))

    def handle_picker_key(self, ch) -> None:
        query = self.picker['query']
        matches = self.picker_matches(query)[:6]
        if ch == ESC:
            self.picker = None
            self.message = 'cancelled'
            return
        if ch in ('\n', '\r', _KEY_ENTER):
            sel = self.picker['sel']
            self.picker = None
            if not matches:
                self.message = 'no match'
                return
            self.run_line(
                f'+ {self._at()} {matches[min(max(sel, 0), len(matches) - 1)]}')
            return
        if ch in ('\x7f', '\b', _KEY_BACKSPACE):
            self.picker['query'] = query[:-1]
        elif ch in (_KEY_LEFT, _KEY_UP):
            self.picker['sel'] = max(0, self.picker['sel'] - 1)
        elif ch in (_KEY_RIGHT, _KEY_DOWN, '\t'):
            self.picker['sel'] = max(0, min(len(matches) - 1,
                                            self.picker['sel'] + 1))
        elif isinstance(ch, str) and ch.isprintable():
            self.picker['query'] = query + ch
            self.picker['sel'] = 0
        self._picker_message()

    def _pick_port(self, idx: int) -> None:
        action, at, ports = self.port_menu
        self.port_menu = None
        if not 0 <= idx < len(ports):
            self.message = 'no such port'
            return
        if action == 'connect':
            _, src = self.pending
            self.pending = None
            self.run_line(f'> {src} {at}.{ports[idx]}')
        else:
            self.run_line(f'>/ {at}.{ports[idx]}')

    def handle_grid_key(self, ch) -> None:
        if self.picker is not None:
            self.handle_picker_key(ch)
            return
        if self.port_menu is not None:
            if isinstance(ch, str) and ch.isdigit():
                self._pick_port(int(ch) - 1)
            elif ch == ESC:
                self.port_menu = None
                self.pending = None
                self.message = 'cancelled'
            return
        if ch in (_KEY_UP, 'k'):
            self._move_cursor(-1, 0)
        elif ch in (_KEY_DOWN, 'j'):
            self._move_cursor(1, 0)
        elif ch in (_KEY_LEFT, 'h'):
            self._move_cursor(0, -1)
        elif ch in (_KEY_RIGHT, 'l'):
            self._move_cursor(0, 1)
        elif ch in ('\n', '\r', _KEY_ENTER):
            self._start_or_complete()
        elif ch == 'a':
            self._open_picker()
        elif ch == 'A':
            self.mode = 'cmd'
            self.line = f'+ {self._at()} '
            self.message = 'complete the add command'
        elif ch == 'y':
            self.copy()
        elif ch == 'c':
            self.cut()
        elif ch == 'p':
            self.paste()
        elif ch == 'd':
            self.run_line(f'- {self._at()}')
        elif ch == 'm':
            if self._sig(self._at()) is None:
                self.message = f'{self._at()}: empty'
            else:
                self.pending = ('move', self._at())
                self.message = (f'moving {self._at()} — Enter on the '
                                f'destination')
        elif ch == 'x':
            self._disconnect()
        elif ch == 'u':
            self.run_line('undo')
        elif ch == 'r':
            self.run_line('redo')
        elif ch == ESC:
            if self.pending is not None:
                self.pending = None
                self.message = 'cancelled'
            else:
                self.mode = 'cmd'
                self.message = 'command mode'

    def handle_key(self, ch) -> None:
        """One keypress (curses ``get_wch`` value); headlessly testable."""
        if self.mode == 'grid':
            self.handle_grid_key(ch)
            return
        if ch == ESC:
            self.mode = 'grid'
            self.message = ('grid mode — arrows move, Enter cables, '
                            'a add-picker, d delete, m move, x disconnect, '
                            'y/c/p copy/cut/paste, Esc back')
        elif isinstance(ch, str) and ch.isprintable():
            self.line += ch
        elif ch in ('\n', _KEY_ENTER, '\r'):
            line, self.line = self.line, ''
            self.run_line(line)
        elif ch in ('\x7f', '\b', _KEY_BACKSPACE):
            self.line = self.line[:-1]
        elif ch == _KEY_UP and self.history:
            self.hist_pos = max(0, self.hist_pos - 1)
            self.line = self.history[self.hist_pos]
        elif ch == _KEY_DOWN and self.history:
            self.hist_pos = min(len(self.history), self.hist_pos + 1)
            self.line = (self.history[self.hist_pos]
                         if self.hist_pos < len(self.history) else '')
        elif ch == _KEY_F2:
            self.run_line('undo')
        elif ch == _KEY_F3:
            self.run_line('redo')

    # --- drawing -----------------------------------------------------------

    def draw(self, scr) -> None:
        scr.erase()
        max_y, max_x = scr.getmaxyx()
        title = (' signals_tpu_torch patcher '
                 + (f'[grid {self.cursor}] ' if self.mode == 'grid' else ''))
        status = f" {'*' if self.dirty else ' '} " \
                 f"mods:{self.controller.modcount} "
        scr.addnstr(0, 0, title.ljust(max_x - len(status)) + status,
                    max_x - 1, curses.A_REVERSE)

        pad = (self.cursor if self.mode == 'grid' else None)
        grid = render_map(self.controller.map, pad_to=pad).splitlines()
        body_rows = max_y - 4
        for i, row in enumerate(grid[:body_rows]):
            scr.addnstr(1 + i, 0, row, max_x - 1)
        if self.mode == 'grid':
            from signals_tpu_torch.ui.ascii import cell_span
            y, x0, x1 = cell_span(self.cursor)
            if 1 + y < max_y - 3 and x0 < max_x - 1:
                scr.chgat(1 + y, x0, min(x1, max_x - 1) - x0,
                          curses.A_REVERSE)

        msg_lines = self.message.splitlines() or ['']
        scr.addnstr(max_y - 3, 0, msg_lines[-1][:max_x - 1], max_x - 1,
                    curses.A_DIM)
        scr.addnstr(max_y - 2, 0, '-' * (max_x - 1), max_x - 1)
        prompt = (f'signals: {self.line}' if self.mode == 'cmd'
                  else f'[grid] {self.cursor}')
        scr.addnstr(max_y - 1, 0, prompt[:max_x - 1], max_x - 1)
        scr.move(max_y - 1, min(len(prompt), max_x - 1))
        scr.refresh()

    # --- main loop ---------------------------------------------------------

    def main(self, scr) -> None:
        curses.use_default_colors()
        scr.keypad(True)
        while not self.controller.exit:
            self.draw(scr)
            ch = scr.get_wch()
            if ch == '\x03':            # Ctrl-C
                break
            self.handle_key(ch)


def main(argv: typing.Sequence[str] = ()) -> None:
    tui = PatcherTUI()
    if argv:
        tui.run_line(f'load {argv[0]}')
    curses.wrapper(tui.main)


if __name__ == '__main__':
    main(sys.argv[1:])
