"""Graphical patcher (the reference's Qt window/scene/dialog stack,
``src/signals/ui/{graph,scene,patcher/*}.py``, rebuilt on tkinter).

Architecture is presenter/view:

* :class:`PatcherPresenter` — all patcher logic with **no toolkit
  dependency**: scene construction (node boxes on the grid, ports, tribar
  cables from :mod:`signals_tpu_torch.ui.geometry`), hit testing, the mouse
  gesture state machine (cable drag from an output dot, node move,
  selection), port-choice menus, clipboard, the fuzzy add picker and the
  state editor — every mutation emitted as a Controller command line, so
  the GUI shares undo/redo, dirty-hash tracking and ``.sigs`` persistence
  with the REPL and the TUI.  Fully unit-testable headlessly.
* :class:`TkPatcherView` — a thin tkinter canvas/menu/console shell over
  the presenter (tkinter ships with CPython; no display is needed until
  ``main()`` runs).

Run: ``python -m signals_tpu_torch.ui.gui [patch.sigs]``
"""

from __future__ import annotations

import io
import sys
import typing

from signals_tpu_torch.graph import Emitter, Receiver
from signals_tpu_torch.map import Coordinates, CoordinateColumn
from signals_tpu_torch.map.control import Controller
from signals_tpu_torch.ui import actions, geometry, theme

# scene metrics (pixels)
MARGIN = 48
CELL_W, CELL_H = 120, 84
NODE_W, NODE_H = 96, 48
PORT_R = 5


class PatcherPresenter:
    """Toolkit-free patcher logic over a Controller."""

    def __init__(self, controller: typing.Optional[Controller] = None):
        self.out = io.StringIO()
        self.controller = controller or Controller(interactive=True,
                                                   stdout=self.out)
        # the presenter owns the console surface: command feedback must
        # land in self.out even for an injected controller
        self.controller.stdout = self.out
        self.selected: typing.Optional[Coordinates] = None
        #: gesture: None | ('cable', src_at, (x, y)) | ('move', src_at, (x, y))
        self.drag: typing.Optional[tuple] = None
        #: pending port menu: (src_at, dst_at, [port names])
        self.port_menu: typing.Optional[tuple] = None
        self.message = ''
        self.saved_hash = self.controller.hash()
        #: current .sigs file (Save reuses it; Revert reloads it)
        self.path: typing.Optional[str] = None

    # --- command plumbing ----------------------------------------------------

    def run(self, line: str) -> bool:
        """Execute one command line; True on success, False when the
        controller reported an error (the message shows it either way)."""
        self.out.truncate(0)
        self.out.seek(0)
        self.controller.default(line)
        self.message = self.out.getvalue().strip() or 'ok'
        return getattr(self.controller, 'last_error', None) is None

    @property
    def dirty(self) -> bool:
        return self.controller.hash() != self.saved_hash

    def mark_saved(self) -> None:
        self.saved_hash = self.controller.hash()

    # --- file actions (reference window.py:39-66: New/Open/Revert/Save/
    # SaveAs) ---------------------------------------------------------------

    def save(self, path: typing.Optional[str] = None) -> bool:
        """Save to ``path`` or the current file; False if no path known
        (the view should then prompt, i.e. behave as Save-As).

        A FAILED save (unwritable path) must not adopt the path or clear
        the dirty flag: the title keeps its '*' and later Ctrl-S retries
        — silently 'succeeding' against a bad path loses the patch."""
        path = path or self.path
        if path is None:
            return False
        if self.run(f'save {path}'):
            self.path = path
            self.mark_saved()
        return True

    def load(self, path: str) -> None:
        if self.run(f'load {path}'):
            self.path = path
            self.mark_saved()

    def revert(self) -> None:
        """Discard edits and reload the current file
        (reference window.py:44,249-252)."""
        if self.path is None:
            self.message = 'no file to revert to'
            return
        self.load(self.path)

    # --- geometry -------------------------------------------------------------

    @staticmethod
    def cell_origin(at: Coordinates) -> tuple[float, float]:
        return (MARGIN + (int(at.col) - 1) * CELL_W,
                MARGIN + (at.row - 1) * CELL_H)

    @classmethod
    def node_box(cls, at: Coordinates) -> tuple[float, float, float, float]:
        x, y = cls.cell_origin(at)
        return (x, y, x + NODE_W, y + NODE_H)

    @classmethod
    def out_dot(cls, at: Coordinates) -> tuple[float, float]:
        x0, y0, x1, y1 = cls.node_box(at)
        return ((x0 + x1) / 2, y1)

    @classmethod
    def in_dot(cls, at: Coordinates, idx: int, n: int) -> tuple[float, float]:
        x0, y0, x1, _ = cls.node_box(at)
        step = (x1 - x0) / (n + 1)
        return (x0 + step * (idx + 1), y0)

    @classmethod
    def power_dot(cls, at: Coordinates) -> tuple[float, float]:
        """The per-node power toggle glyph (reference PowerToggle,
        ``ui/graph.py:149-164,210-265``): top-left inside the box."""
        x0, y0, _, _ = cls.node_box(at)
        return (x0 + 2 * PORT_R, y0 + 2 * PORT_R)

    @staticmethod
    def px_to_grid(x: float, y: float) -> Coordinates:
        col = max(1, 1 + int((x - MARGIN) // CELL_W))
        row = max(1, 1 + int((y - MARGIN) // CELL_H))
        return Coordinates(row=min(row, 702), col=CoordinateColumn(
            min(col, 702)))

    # --- scene ------------------------------------------------------------------

    def _all_infos(self) -> list:
        """Signal AND device infos — devices are first-class patcher
        nodes (reference draws SinkNode/EmitterNode glyphs for them,
        ``ui/graph.py:103-147``) even though the map iterates them
        separately."""
        m = self.controller.map
        return (list(m.iter_signals()) + list(m.iter_sources())
                + list(m.iter_sinks()))

    def scene(self) -> dict:
        """Draw list: nodes, ports, cables, pending gesture."""
        nodes, ports, cables = [], [], []
        infos = {tuple(i.at): i for i in self._all_infos()}
        for info in infos.values():
            at = info.at
            sig = self.controller.map.get(at)
            label = info.cls_name.rsplit('.', 1)[-1]
            if hasattr(info, 'device'):
                label = info.device.name
            enabled = bool(getattr(sig.get_state(), 'enabled', True)) \
                if sig is not None else True
            nodes.append({'at': at, 'box': self.node_box(at), 'label': label,
                          'selected': at == self.selected,
                          'enabled': enabled,
                          'power': self.power_dot(at),
                          'is_emitter': isinstance(sig, Emitter)})
            if isinstance(sig, Emitter):
                ports.append({'at': at, 'kind': 'out', 'name': 'out',
                              'pos': self.out_dot(at)})
            if isinstance(sig, Receiver):
                names = sorted(sig.port_names())
                for i, name in enumerate(names):
                    ports.append({'at': at, 'kind': 'in', 'name': name,
                                  'pos': self.in_dot(at, i, len(names))})
        for conn in self.controller.map.iter_connections():
            dst_sig = self.controller.map.get(conn.output.at)
            names = sorted(dst_sig.port_names()) if dst_sig is not None \
                else [conn.output.port]
            idx = names.index(conn.output.port) if conn.output.port in names \
                else 0
            start = self.out_dot(conn.input_at)
            end = self.in_dot(conn.output.at, idx, len(names))
            pts = geometry.tribar_polyline(start, end)
            cables.append({'points': [tuple(p) for p in pts],
                           'src': conn.input_at, 'dst': conn.output.at,
                           'port': conn.output.port})
        pending = None
        if self.drag is not None and self.drag[0] == 'cable':
            _, src, pos = self.drag
            pts = geometry.tribar_polyline(self.out_dot(src), pos)
            pending = [tuple(p) for p in pts]
        return {'nodes': nodes, 'ports': ports, 'cables': cables,
                'pending': pending, 'drag': self.drag,
                'port_menu': self.port_menu}

    # --- hit testing -------------------------------------------------------------

    def node_hit(self, x: float, y: float) -> typing.Optional[Coordinates]:
        at = self.px_to_grid(x, y)
        x0, y0, x1, y1 = self.node_box(at)
        if x0 <= x <= x1 and y0 <= y <= y1 \
                and self.controller.map.get(at) is not None:
            return at
        return None

    def out_dot_hit(self, x: float, y: float) -> typing.Optional[Coordinates]:
        at = self.px_to_grid(x, y)
        sig = self.controller.map.get(at)
        if not isinstance(sig, Emitter):
            return None
        dx, dy = self.out_dot(at)
        if (x - dx) ** 2 + (y - dy) ** 2 <= (3 * PORT_R) ** 2:
            return at
        return None

    def power_hit(self, x: float, y: float) -> typing.Optional[Coordinates]:
        at = self.px_to_grid(x, y)
        if self.controller.map.get(at) is None:
            return None
        dx, dy = self.power_dot(at)
        if (x - dx) ** 2 + (y - dy) ** 2 <= (2 * PORT_R) ** 2:
            return at
        return None

    def toggle_power(self, at: Coordinates) -> None:
        """Flip a node's ``enabled`` flag as an undoable edit command."""
        sig = self.controller.map.get(at)
        if sig is None:
            return
        cur = bool(getattr(sig.get_state(), 'enabled', True))
        self.run(f'* {at} enabled={"false" if cur else "true"}')

    # --- mouse gesture state machine (reference ui/graph.py:300-397) -----------

    def press(self, x: float, y: float) -> None:
        self.port_menu = None
        power = self.power_hit(x, y)
        if power is not None:
            self.toggle_power(power)
            self.drag = None
            return
        src = self.out_dot_hit(x, y)
        if src is not None:
            self.drag = ('cable', src, (x, y))
            self.message = f'cable from {src}'
            return
        at = self.node_hit(x, y)
        if at is not None:
            self.selected = at
            self.drag = ('move', at, (x, y))
            self.message = f'selected {at}'
            return
        self.selected = None
        self.drag = None

    def motion(self, x: float, y: float) -> None:
        if self.drag is not None:
            kind, src, _ = self.drag
            self.drag = (kind, src, (x, y))

    def release(self, x: float, y: float) -> None:
        if self.drag is None:
            return
        kind, src, _ = self.drag
        self.drag = None
        dst = self.px_to_grid(x, y)
        if kind == 'move':
            if dst != src and self.node_hit(x, y) != src:
                self.run(f'= {src} {dst}')
                self.selected = dst
            return
        sig = self.controller.map.get(dst)
        if not isinstance(sig, Receiver):
            self.message = f'{dst}: not a receiver'
            return
        names = sorted(sig.port_names())
        if len(names) == 1:
            self.run(f'> {src} {dst}.{names[0]}')
            return
        self.port_menu = (src, dst, names)
        self.message = 'choose an input port'

    def choose_port(self, idx: int) -> None:
        if self.port_menu is None:
            return
        src, dst, names = self.port_menu
        self.port_menu = None
        if 0 <= idx < len(names):
            self.run(f'> {src} {dst}.{names[idx]}')

    # --- edit actions (all undoable command lines) -----------------------------

    def add(self, cls_name: str,
            at: typing.Optional[Coordinates] = None) -> None:
        at = at or self.free_cell()
        self.run(f'+ {at} {cls_name}')
        self.selected = at

    def free_cell(self) -> Coordinates:
        taken = {tuple(i.at) for i in self._all_infos()}
        for row in range(1, 100):
            for col in range(1, 27):
                at = Coordinates(row=row, col=CoordinateColumn(col))
                if tuple(at) not in taken:
                    return at
        raise RuntimeError('grid full')

    def delete_selected(self) -> None:
        if self.selected is not None:
            self.run(f'- {self.selected}')
            self.selected = None

    def copy(self) -> typing.Optional[tuple[str, str]]:
        if self.selected is None:
            return None
        return actions.clip_payload(self.controller, self.selected)

    def paste(self, payload: typing.Optional[tuple[str, str]],
              at: typing.Optional[Coordinates] = None) -> None:
        if payload is None:
            self.message = 'clipboard empty'
            return
        at = at or self.free_cell()
        self.run(actions.paste_line(at, payload))
        self.selected = at

    def search(self, query: str) -> list[str]:
        return actions.fuzzy_rank(self.controller.library.names, query)

    # --- devices (reference AddDevice dialog, dialog.py:172-266) ------------

    def device_names(self, kind: str) -> list[str]:
        """Rack device names for ``kind`` in {'source', 'sink'}."""
        devs = (self.controller.rack.sources() if kind == 'source'
                else self.controller.rack.sinks())
        return [d.name for d in devs]

    def bind_device(self, kind: str, device_name: str,
                    at: typing.Optional[Coordinates] = None) -> None:
        """Place a source/sink device node (undoable ``source``/``sink``
        command — the same line the console would run)."""
        at = at or self.free_cell()
        self.run(f'{kind} {at} {device_name}')
        self.selected = at

    # --- vis rack (reference window.py:294-332 auto-adds a canvas per
    # Vis node) --------------------------------------------------------------

    def vis_entries(self) -> list[tuple[str, typing.Any]]:
        """(label, node) for every Vis node currently in the patch, in
        grid order — the view mirrors this list into its vis dock."""
        from signals_tpu_torch.nodes.vis import Vis
        out = []
        for info in sorted(self.controller.map.iter_signals(),
                           key=lambda i: tuple(i.at)):
            sig = self.controller.map.get(info.at)
            if isinstance(sig, Vis):
                label = info.cls_name.rsplit('.', 1)[-1]
                out.append((f'{info.at} {label}', sig))
        return out

    def editor_fields(self) -> list[tuple[str, str]]:
        if self.selected is None:
            return []
        return actions.state_fields(self.controller, self.selected)

    def apply_edit(self, name: str, value_text: str) -> None:
        if self.selected is not None:
            self.run(actions.edit_line(self.selected, name, value_text))


class TkPatcherView:
    """tkinter shell: canvas scene, console, menus, dialogs."""

    def __init__(self, presenter: typing.Optional[PatcherPresenter] = None,
                 theme_name: str = 'Cyborg'):
        import tkinter as tk
        from tkinter import scrolledtext
        self.p = presenter or PatcherPresenter()
        th = theme.THEMES.get(theme_name, theme.GREEN)
        self.pal = {role: color.hex() for role, color in th.colors.items()}
        self.clipboard: typing.Optional[tuple[str, str]] = None

        self.root = tk.Tk()
        self.root.title('signals_tpu_torch patcher')
        self._build_menu(tk)
        self.canvas = tk.Canvas(self.root, width=1000, height=620,
                                bg=self.pal.get('base', '#0b0e11'),
                                highlightthickness=0)
        self.canvas.pack(fill='both', expand=True)
        #: vis dock (reference window.py:77-80,294-332): a matplotlib
        #: canvas embedded under the patcher, one axes per Vis node,
        #: animated on the reference's 30 ms cadence.  Created lazily on
        #: the first Vis node; destroyed when the last one goes.
        self.vis_rack = None
        self.vis_widget = None
        self._vis_labels: list[str] = []
        self.log = scrolledtext.ScrolledText(
            self.root, height=6, bg=self.pal.get('window'),
            fg=self.pal.get('text'), insertbackground=self.pal.get('text'))
        self.log.pack(fill='x')
        self.entry = tk.Entry(self.root, bg=self.pal.get('window'),
                              fg=self.pal.get('text'),
                              insertbackground=self.pal.get('text'))
        self.entry.pack(fill='x')
        self.entry.bind('<Return>', self._on_console)
        self.canvas.bind('<Button-1>', lambda e: self._gesture('press', e))
        self.canvas.bind('<B1-Motion>', lambda e: self._gesture('motion', e))
        self.canvas.bind('<ButtonRelease-1>',
                         lambda e: self._gesture('release', e))
        self.canvas.bind('<Double-Button-1>', lambda e: self.edit_dialog())
        # reference window.py:52-58 binds Alt+S/D/O/I for add/delete/
        # sink/source alongside the clipboard and file accelerators
        for seq, fn in (('<Control-z>', lambda e: self._run('undo')),
                        ('<Control-y>', lambda e: self._run('redo')),
                        ('<Control-c>', lambda e: self._copy()),
                        ('<Control-x>', lambda e: self._cut()),
                        ('<Control-v>', lambda e: self._paste()),
                        ('<Delete>', lambda e: self._delete()),
                        ('<Control-s>', lambda e: self.save_action()),
                        ('<Alt-s>', lambda e: self.add_dialog()),
                        ('<Alt-d>', lambda e: self._delete()),
                        ('<Alt-o>', lambda e: self.device_dialog('sink')),
                        ('<Alt-i>', lambda e: self.device_dialog('source'))):
            self.root.bind(seq, fn)
        self.redraw()
        self._vis_tick()

    # -- helpers ---------------------------------------------------------------

    def _run(self, line: str) -> None:
        self.p.run(line)
        self._log(self.p.message)
        self.redraw()

    def _log(self, text: str) -> None:
        if text:
            self.log.insert('end', text + '\n')
            self.log.see('end')

    def _gesture(self, kind: str, event) -> None:
        getattr(self.p, kind)(event.x, event.y)
        if kind == 'release' and self.p.port_menu is not None:
            self._port_menu_dialog()
        self._log(self.p.message)
        self.p.message = ''
        self.redraw()

    def _copy(self) -> None:
        payload = self.p.copy()
        if payload is not None:
            self.clipboard = payload
            # OS clipboard too (reference window.py:159-168 puts the
            # serialized Add on the system clipboard): the text form is
            # the `.sigs` add line, so it round-trips across processes
            try:
                self.root.clipboard_clear()
                self.root.clipboard_append(actions.clip_text(payload))
            except Exception:
                pass                      # no clipboard (headless X)

    def _cut(self) -> None:
        self._copy()
        self._delete()

    def _paste(self) -> None:
        # prefer the OS clipboard when it holds a `.sigs` add line
        # (reference window.py:170-178 reads the MIME payload back);
        # fall back to the in-process payload
        payload = None
        try:
            payload = actions.parse_clip_text(self.root.clipboard_get())
        except Exception:
            payload = None
        self.p.paste(payload or self.clipboard)
        self.redraw()

    def _delete(self) -> None:
        self.p.delete_selected()
        self.redraw()

    def _on_console(self, event) -> None:
        line = self.entry.get()
        self.entry.delete(0, 'end')
        self._run(line)

    # -- menus / dialogs ---------------------------------------------------------

    def _build_menu(self, tk) -> None:
        # reference window.py:39-66: File New/Open/Revert/Save/SaveAs/Quit
        bar = tk.Menu(self.root)
        filem = tk.Menu(bar, tearoff=0)
        filem.add_command(label='New', command=lambda: self._run('init'))
        filem.add_command(label='Open...', command=self.open_dialog)
        filem.add_command(label='Revert', command=self.revert_action)
        filem.add_command(label='Save  (Ctrl-S)', command=self.save_action)
        filem.add_command(label='Save As...', command=self.save_dialog)
        filem.add_separator()
        filem.add_command(label='Quit', command=self.root.destroy)
        bar.add_cascade(label='File', menu=filem)
        editm = tk.Menu(bar, tearoff=0)
        editm.add_command(label='Undo  (Ctrl-Z)',
                          command=lambda: self._run('undo'))
        editm.add_command(label='Redo  (Ctrl-Y)',
                          command=lambda: self._run('redo'))
        editm.add_separator()
        editm.add_command(label='Add signal...', command=self.add_dialog)
        editm.add_command(label='Add device...', command=self.device_dialog)
        editm.add_command(label='Edit state...', command=self.edit_dialog)
        editm.add_command(label='Delete  (Del)', command=self._delete)
        bar.add_cascade(label='Edit', menu=editm)
        self.root.config(menu=bar)

    def open_dialog(self) -> None:
        from tkinter import filedialog
        path = filedialog.askopenfilename(
            filetypes=[('signals patches', '*.sigs')])
        if path:
            self.p.load(path)
            self._log(self.p.message)
            self.redraw()

    def save_action(self) -> None:
        """Save to the current file, or prompt when there is none."""
        if self.p.save():
            self._log(self.p.message)
            self.redraw()
        else:
            self.save_dialog()

    def save_dialog(self) -> None:
        from tkinter import filedialog
        path = filedialog.asksaveasfilename(defaultextension='.sigs')
        if path:
            self.p.save(path)
            self._log(self.p.message)
            self.redraw()

    def revert_action(self) -> None:
        self.p.revert()
        self._log(self.p.message)
        self.redraw()

    def device_dialog(self, kind_default: str = 'sink') -> None:
        """Browse the rack and bind a source/sink
        (reference AddDevice, dialog.py:172-266).  ``kind_default``
        preselects the radio group — Alt+O opens on sinks, Alt+I on
        sources (reference window.py:55-58)."""
        import tkinter as tk
        top = tk.Toplevel(self.root)
        top.title('Add device')
        kind = tk.StringVar(value=kind_default)
        lb = tk.Listbox(top, height=10, width=48)

        def refresh(*_):
            lb.delete(0, 'end')
            for name in self.p.device_names(kind.get()):
                lb.insert('end', name)
            lb.selection_set(0)

        for k in ('source', 'sink'):
            tk.Radiobutton(top, text=k.capitalize(), variable=kind,
                           value=k, command=refresh).pack(anchor='w')
        lb.pack(fill='both', expand=True)

        def accept(*_):
            sel = lb.curselection()
            if sel:
                self.p.bind_device(kind.get(), lb.get(sel[0]))
                self._log(self.p.message)
                self.redraw()
            top.destroy()

        lb.bind('<Double-Button-1>', accept)
        tk.Button(top, text='Bind', command=accept).pack(fill='x')
        refresh()

    def add_dialog(self) -> None:
        """Fuzzy add picker (reference dialog.py:118-169)."""
        import tkinter as tk
        top = tk.Toplevel(self.root)
        top.title('Add signal')
        entry = tk.Entry(top)
        entry.pack(fill='x')
        lb = tk.Listbox(top, height=12)
        lb.pack(fill='both', expand=True)

        def refresh(*_):
            lb.delete(0, 'end')
            for name in self.p.search(entry.get())[:40]:
                lb.insert('end', name)
            lb.selection_set(0)

        def accept(*_):
            sel = lb.curselection()
            if sel:
                self.p.add(lb.get(sel[0]))
                self.redraw()
            top.destroy()

        entry.bind('<KeyRelease>', refresh)
        entry.bind('<Return>', accept)
        lb.bind('<Double-Button-1>', accept)
        refresh()
        entry.focus_set()

    def edit_dialog(self) -> None:
        """State editor form (reference dialog.py:72-115)."""
        import tkinter as tk
        fields = self.p.editor_fields()
        if not fields:
            return
        top = tk.Toplevel(self.root)
        top.title(f'Edit {self.p.selected}')
        entries = {}
        for i, (name, value) in enumerate(fields):
            tk.Label(top, text=name).grid(row=i, column=0, sticky='e')
            e = tk.Entry(top, width=32)
            e.insert(0, value)
            e.grid(row=i, column=1)
            entries[name] = (e, value)

        def accept():
            for name, (e, old) in entries.items():
                if e.get() != old:
                    self.p.apply_edit(name, e.get())
                    self._log(self.p.message)
            top.destroy()
            self.redraw()

        tk.Button(top, text='Apply', command=accept).grid(
            row=len(fields), column=1, sticky='e')

    def _port_menu_dialog(self) -> None:
        import tkinter as tk
        src, dst, names = self.p.port_menu
        top = tk.Toplevel(self.root)
        top.title(f'{src} -> {dst}')
        for i, name in enumerate(names):
            def pick(i=i):
                self.p.choose_port(i)
                top.destroy()
                self._log(self.p.message)
                self.redraw()

            tk.Button(top, text=name, command=pick).pack(fill='x')

    # -- drawing -----------------------------------------------------------------

    def redraw(self) -> None:
        c = self.canvas
        c.delete('all')
        scene = self.p.scene()
        for cable in scene['cables']:
            c.create_line(*[xy for p in cable['points'] for xy in p],
                          fill=self.pal.get('cable', '#caa9fa'), width=2)
        if scene['pending']:
            c.create_line(*[xy for p in scene['pending'] for xy in p],
                          fill=self.pal.get('cable', '#caa9fa'), width=1,
                          dash=(3, 2))
        for node in scene['nodes']:
            x0, y0, x1, y1 = node['box']
            fill = self.pal.get('node_active' if node['selected'] else 'node')
            c.create_rectangle(x0, y0, x1, y1, fill=fill,
                               outline=self.pal.get('text'), width=1)
            c.create_text((x0 + x1) / 2, (y0 + y1) / 2, text=node['label'],
                          fill=self.pal.get('text')
                          if node['enabled'] else self.pal.get('dim_text'))
            c.create_text(x0 + 2, y1 - 7, text=str(node['at']), anchor='w',
                          fill=self.pal.get('dim_text'), font=('', 7))
        for node in scene['nodes']:
            # power toggle glyph (reference PowerToggle): filled when on
            x, y = node['power']
            on = self.pal.get('port', '#7fd1b9')
            off = self.pal.get('dim_text', '#555555')
            c.create_oval(x - PORT_R + 1, y - PORT_R + 1,
                          x + PORT_R - 1, y + PORT_R - 1,
                          fill=on if node['enabled'] else '',
                          outline=on if node['enabled'] else off)
        for port in scene['ports']:
            x, y = port['pos']
            color = self.pal.get('port', '#7fd1b9')
            c.create_oval(x - PORT_R, y - PORT_R, x + PORT_R, y + PORT_R,
                          fill=color if port['kind'] == 'out' else '',
                          outline=color)
        title = 'signals_tpu_torch patcher' + (' *' if self.p.dirty else '')
        self.root.title(title)
        self._sync_vis()

    # -- vis dock ----------------------------------------------------------------

    def _embed_figure(self, figure):
        """Embed a matplotlib figure as a Tk widget; overridable (tests
        stub it; a missing TkAgg backend degrades to no dock)."""
        from matplotlib.backends.backend_tkagg import FigureCanvasTkAgg
        agg = FigureCanvasTkAgg(figure, master=self.root)
        widget = agg.get_tk_widget()
        widget.pack(fill='x')
        return agg, widget

    def _sync_vis(self) -> None:
        """Mirror the patch's Vis nodes into the dock (auto-add/remove,
        reference window.py:294-332)."""
        entries = self.p.vis_entries()
        labels = [name for name, _ in entries]
        if labels == self._vis_labels:
            return
        self._vis_labels = labels
        if self.vis_widget is not None:
            try:
                self.vis_widget[1].destroy()
            except Exception:
                pass
            self.vis_widget = None
            self.vis_rack = None
        if not entries:
            return
        from signals_tpu_torch.ui.vis import VisRack
        rack = VisRack()
        for name, node in entries:
            rack.add(name, node)
        try:
            figure = rack._ensure_figure()
            self.vis_widget = self._embed_figure(figure)
        except Exception as e:         # headless / no TkAgg: dock disabled
            self._log(f'vis dock unavailable: {e}')
            self.vis_rack = None
            self.vis_widget = None
            return
        self.vis_rack = rack

    def _vis_tick(self) -> None:
        """30 ms animation cadence (reference ui/vis.py:16-52)."""
        from signals_tpu_torch.ui.vis import REFRESH_MS
        if self.vis_rack is not None and self.vis_widget is not None:
            try:
                self.vis_rack.update()
                self.vis_widget[0].draw_idle()
            except Exception:
                pass
        self.root.after(REFRESH_MS, self._vis_tick)

    def main(self) -> None:
        self.root.mainloop()


def main(argv: typing.Sequence[str] = ()) -> None:
    view = TkPatcherView()
    if argv:
        view.p.load(argv[0])
        view.redraw()
    view.main()


if __name__ == '__main__':
    main(sys.argv[1:])
