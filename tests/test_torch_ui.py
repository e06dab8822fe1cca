"""The port's layout and UI layer against the JAX package's: the layered
layout (``tests/test_layout.py``), themes, geometry, the ASCII view and the
vis rack (``tests/test_ui.py``), the terminal patcher's key handling
(``tests/test_tui.py``) and the graphical patcher's headless presenter and
Tk shell (``tests/test_gui.py``).

Each scenario runs the same steps through both packages — the port's
controller on the CPU (``device='cpu'``) — with the original test's
assertions, and returns what it observed: scene dicts, printed text, the
patch dump, cursor and gesture state.  Where the output is data the two
must be equal (tolerance 0: the UI layer computes nothing in floating
point that differs between the packages); a window title, which names the
package, is left out of the comparison."""

import importlib
import io
import sys
import types

import numpy as np
import pytest

import matplotlib

matplotlib.use('Agg')


class Pkg:
    """One package's command and UI modules, its controller on the CPU."""

    def __init__(self, name: str):
        self.name = name
        for mod in ('map', 'map.control', 'layout', 'ui.ascii', 'ui.svg',
                    'ui.geometry', 'ui.theme', 'ui.actions', 'ui.tui',
                    'ui.gui', 'ui.vis'):
            setattr(self, mod.split('.')[-1],
                    importlib.import_module(f'{name}.{mod}'))
        self.nodes_vis = importlib.import_module(f'{name}.nodes.vis')
        self.Fixed = importlib.import_module(f'{name}.nodes.fixed').Fixed
        self.kw = {'device': 'cpu'} if name == 'signals_tpu_torch' else {}

    def controller(self, interactive=False):
        return self.control.Controller(interactive=interactive,
                                       stdout=io.StringIO(), **self.kw)

    def at(self, s):
        return self.map.Coordinates.parse(s)

    def fixed(self, value):
        f = self.Fixed()
        f.get_state().value = np.atleast_2d(np.float32(value))
        return f


JAX = Pkg('signals_tpu')
TORCH = Pkg('signals_tpu_torch')


def both(scenario, *args):
    """The scenario's observations in the JAX package and in the port."""
    return scenario(JAX, *args), scenario(TORCH, *args)


def assert_same(scenario, *args):
    want, got = both(scenario, *args)
    assert got == want
    return got


# --- the layered layout (tests/test_layout.py) -------------------------------

def _chain(P, n):
    vs = [P.layout.Vertex(value=i) for i in range(n)]
    for a, b in zip(vs, vs[1:]):
        a.link(b)
    return vs


def _placed(strata):
    """Each layer's places and its vertices.  Which of two vertices with
    the same barycenter goes first follows their ``id()``, in either
    package, so a vertex's place is compared only where no tie can arise
    (:func:`ui_svg`, :func:`ui_ascii_view`)."""
    return [(sorted(v.x for v in layer), sorted(v.y for v in layer),
             sorted((v.w, v.is_bridge, repr(v.value)) for v in layer))
            for layer in strata]


def lay_strata(P):
    a, b, c = _chain(P, 3)
    d = P.layout.Vertex(value='d')
    d.link(c)
    layers = P.layout.Subgraph([a, b, c, d]).strata()
    got = [sorted(str(x.value) for x in layer if x.value is not None)
           for layer in layers]
    assert got == [['0', 'd'], ['1'], ['2']]
    return got


def lay_cycle(P):
    a, b = P.layout.Vertex(value='a'), P.layout.Vertex(value='b')
    a.link(b)
    b.link(a)
    with pytest.raises(P.layout.LayoutCycle) as e:
        P.layout.Subgraph([a, b]).strata()
    return str(e.value)


def lay_components(P):
    a, b, c = _chain(P, 3)
    d, e = _chain(P, 2)
    comps = P.layout.Subgraph([a, b, c, d, e]).components()
    got = sorted(len(c) for c in comps)
    assert got == [2, 3]
    return got


def lay_bridging(P):
    a, b, c = _chain(P, 3)
    a.link(c)
    strata = P.layout.Subgraph([a, b, c]).layout()
    assert any(v.is_bridge for v in strata[1])
    for i, layer in enumerate(strata):
        for v in layer:
            assert v.y == i
            for inp in v.inputs:
                assert inp.y == i - 1
    return _placed(strata)


def lay_deep_edge(P):
    vs = _chain(P, 5)
    vs[0].link(vs[4])
    g = P.layout.Subgraph(vs)
    strata = g.layout()
    assert len([v for v in g if v.is_bridge]) == 3
    return _placed(strata)


def lay_no_overlap(P):
    roots = [P.layout.Vertex(value=f'r{i}') for i in range(4)]
    sink = P.layout.Vertex(value='sink')
    for r in roots:
        r.link(sink)
    strata = P.layout.Subgraph(roots + [sink]).layout()
    xs = [v.x for v in strata[0]]
    assert len(set(xs)) == len(xs)
    return _placed(strata)


def lay_patch(P):
    ctl = P.controller()
    for line in ('+ 1a signals_tpu.nodes.fixed.Fixed value=[[440]]',
                 '+ 2a signals_tpu.nodes.osc.Sine',
                 '+ 3a signals_tpu.nodes.fx.Gain',
                 '+ 3b signals_tpu.nodes.fixed.Fixed value=[[0.5]]',
                 '> 1a 2a.hertz', '> 2a 3a.left', '> 3b 3a.right'):
        ctl.default(line)
    positions = P.layout.layout_patch(ctl.map)
    assert len(positions) == 4
    ys = {str(at): y for at, (x, y) in positions.items()}
    assert ys['1a'] == 0 and ys['2a'] == 1 and ys['3a'] == 2
    assert ys['3b'] in (0, 1)
    return sorted((str(at), y) for at, (x, y) in positions.items())


LAYOUT = (lay_strata, lay_cycle, lay_components, lay_bridging,
          lay_deep_edge, lay_no_overlap, lay_patch)


@pytest.mark.parametrize('scenario', LAYOUT, ids=lambda f: f.__name__)
def test_layout_matches_jax(scenario):
    assert_same(scenario)


# --- themes, geometry, the ASCII view, the vis rack (tests/test_ui.py) -------

def ui_palette(P):
    theme = P.theme
    out = {}
    for name, t in theme.THEMES.items():
        for role in theme.ROLES:
            assert isinstance(t[role], theme.Color)
        out[name] = (t.name, t.is_dark,
                     {role: tuple(t[role]) for role in theme.ROLES})
    assert theme.GREEN.is_dark and not theme.WHITE.is_dark
    return out


def ui_color_math(P):
    theme = P.theme
    c = theme.Color.parse('#8040c0')
    assert c == (128, 64, 192) and c.hex() == '#8040c0'
    assert c.lighter().luminance > c.luminance
    assert c.darker().luminance < c.luminance
    assert c.mix(theme.Color(0, 0, 0), 1.0) == (0, 0, 0)
    assert c.ansi_fg().startswith('\x1b[38;2;')
    return (tuple(c.lighter()), tuple(c.darker()), c.luminance,
            tuple(c.mix(theme.Color(10, 20, 30), 0.25)), c.ansi_fg())


def ui_theme_controller(P):
    theme = P.theme
    ctl = theme.ThemeController(theme.GREEN)
    seen = []
    ctl.register(seen.append)
    assert seen == [theme.GREEN]
    ctl.set_theme(theme.RED)
    assert seen[-1] is theme.RED
    ctl.unregister(seen.append)
    ctl.set_theme(theme.WHITE)
    return [t.name for t in seen]


def ui_geometry(P):
    g = P.geometry
    circ = g.circle((0, 0), 2.0, n=16)
    assert circ.shape == (17, 2)
    np.testing.assert_allclose(np.hypot(circ[:, 0], circ[:, 1]), 2.0,
                               atol=1e-9)
    poly = g.regular_polygon((1, 1), 1.0, 6)
    tri = g.tribar_polyline((0, 0), (10, 10))
    assert tri.shape == (4, 2)
    for a, b in zip(tri, tri[1:]):
        assert a[0] == b[0] or a[1] == b[1]
    hull = g.tribar_polygon((0, 0), (10, 10), width=2)
    rect = g.rect_containing_points(tri)
    assert rect == (0, 0, 10, 10)
    assert g.clip_to_rect((20, -5), rect) == (10, 0)
    return [a.tolist() for a in (circ, poly, tri, hull)] + [rect]


def _patched(P):
    ctl = P.controller()
    for line in ('+ 1a signals_tpu.nodes.fixed.Fixed value=[[440]]',
                 '+ 2a signals_tpu.nodes.osc.Sine',
                 '+ 3a signals_tpu.nodes.vis.Wave',
                 '> 1a 2a.hertz',
                 '> 2a 3a.input'):
        ctl.default(line)
    return ctl


def ui_ascii_view(P):
    ctl = _patched(P)
    text = P.ascii.render_map(ctl.map)
    assert '1a:Fixed' in text and '2a:Sine' in text and '3a:Wave' in text
    assert '2a --> 3a.input' in text
    text2 = P.ascii.render_map(ctl.map, use_layout=True)
    padded = P.ascii.render_map(ctl.map, pad_to=P.at('5e'))
    return text, text2, padded


def ui_view_command(P):
    ctl = _patched(P)
    ctl.default('view')
    ctl.default('view layout')
    out = ctl.stdout.getvalue()
    assert '2a:Sine' in out
    return out


def ui_svg(P):
    ctl = _patched(P)
    return (P.svg.render_svg(ctl.map), P.svg.render_svg(ctl.map,
                                                        use_layout=False))


def ui_vis_rack(P, tmp_path):
    wave, spec = P.nodes_vis.Wave(), P.nodes_vis.Spec()
    wave.input = P.fixed(0.5)
    spec.input = P.fixed(0.5)
    t = np.arange(1024).reshape(-1, 1) / 44100
    block = np.sin(2 * np.pi * 440 * t).astype(np.float32)
    wave.consume_tap(block, 0, 44100)
    spec.consume_tap(block, 0, 44100)
    rack = P.vis.VisRack(frames=2048)
    rack.add('wave', wave)
    rack.add('spec', spec)
    artists = rack.update()
    assert artists
    out = tmp_path / f'{P.name}.png'
    rack.save(out)
    assert out.stat().st_size > 1000
    lines = []
    for ax in rack._ensure_figure().axes:
        for ln in ax.get_lines():
            lines.append(np.asarray(ln.get_xydata()).tolist())
    return len(artists), len(rack), lines


UI = (ui_palette, ui_color_math, ui_theme_controller, ui_geometry,
      ui_ascii_view, ui_view_command, ui_svg)


@pytest.mark.parametrize('scenario', UI, ids=lambda f: f.__name__)
def test_ui_matches_jax(scenario):
    assert_same(scenario)


def test_vis_rack_matches_jax(tmp_path):
    """The rack draws the same lines from the same taps (a sine block into
    a ``Wave`` and a ``Spec``) and saves a PNG."""
    assert_same(ui_vis_rack, tmp_path)


def test_plot_command_renders_on_the_device_when_queue_empty(tmp_path):
    """``plot`` with nothing queued renders the tap's patch with
    ``render_vis`` on the controller's device (the CPU here) and draws the
    summary: the PNG is written and the ``Wave`` summary is the JAX
    package's, bit for bit (a sine, which both packages render to the same
    bits)."""
    def run(P):
        ctl = P.controller()
        for line in ('sink 7a default',
                     '+ 1a signals_tpu.nodes.fixed.Fixed value=[[440]]',
                     '+ 2a signals_tpu.nodes.osc.Sine',
                     '+ 3a signals_tpu.nodes.vis.Wave',
                     '> 1a 2a.hertz', '> 2a 3a.input', '> 3a 7a.input'):
            ctl.default(line)
        png = tmp_path / f'{P.name}.png'
        tap = ctl.map.find(P.at('3a'))
        seen = []
        deliver = tap.consume_summary
        tap.consume_summary = lambda *a: (seen.append(a), deliver(*a))
        ctl.default(f'plot 3a {png}')
        assert png.stat().st_size > 1000 and len(seen) == 1
        summary, frames, position, rate = seen[0]
        return np.asarray(summary), frames, position, rate

    (want, *wmeta), (got, *gmeta) = both(run)
    assert gmeta == wmeta and got.shape == want.shape == (750, 2, 1)
    assert np.array_equal(got, want)


# --- the terminal patcher (tests/test_tui.py) --------------------------------

def _tui(P):
    return P.tui.PatcherTUI(P.controller(interactive=True))


def _tui_state(tui):
    return (tui.mode, str(tui.cursor), tui.line, tui.pending,
            tui.port_menu, tui.clipboard, tui.picker, tui.message,
            tuple(tui.controller.dump()), tui.dirty)


def tui_script(P, keys):
    """Feed ``keys`` (a string is typed char by char; ``'\\n'`` is Enter)
    and record the TUI's state after each."""
    tui = _tui(P)
    states = []
    for k in keys:
        for ch in ([k] if len(k) == 1 else list(k)):
            tui.handle_key(ch)
        states.append(_tui_state(tui))
    return tui, states


ESC = '\x1b'
ADD_SINE = '+ 1a signals_tpu.nodes.osc.Sine\n'
TUI_SCRIPTS = {
    'command_mode_typing': [ADD_SINE],
    'grid_cursor_moves_and_clamps': [ESC, 'l', 'j'] + ['h', 'k'] * 5,
    'cable_gesture_with_port_menu': [
        '+ 1a signals_tpu.nodes.fixed.Fixed value=[[440]]\n',
        '+ 2a signals_tpu.nodes.osc.Sine\n', ESC, '\n', 'j', '\n', '1',
        'u'],
    'single_port_connects_without_menu': [
        ADD_SINE, '+ 2a signals_tpu.nodes.vis.Wave\n', ESC, '\n', 'j',
        '\n', 'x'],
    'delete_move_and_cancel': [ADD_SINE, ESC, 'm', 'l', '\n', 'd', 'u',
                               '\n', ESC, ESC],
    'add_gesture_prefills_command': [ESC, 'l', 'A'],
    'copy_paste_undo_round_trip': [
        '+ 1a signals_tpu.nodes.fixed.Fixed value=[[440]]\n', ESC, 'y',
        'l', 'p', 'u', 'r'],
    'cut_removes_and_paste_restores': [ADD_SINE, ESC, 'c', 'j', 'p', 'u',
                                       'u'],
    'copy_empty_cell_is_noop': [ESC, 'y', 'p'],
    'fuzzy_picker_adds_selected_signal': [ESC, 'a', 's', 'i', 'n', 'e',
                                          '\n', 'u'],
    'fuzzy_picker_subsequence_and_cancel': [ESC, 'a', 'l', 'w', 'p', 's',
                                            ESC],
    'picker_selection_keys': [ESC, 'a', 'p', 'a', 's', 's', '\t', '\n'],
    'disconnect_menu_and_history': [
        '+ 1a signals_tpu.nodes.fixed.Fixed value=[[440]]\n',
        '+ 1b signals_tpu.nodes.fixed.Fixed value=[[0]]\n',
        '+ 2a signals_tpu.nodes.osc.Sine\n', '> 1a 2a.hertz\n',
        '> 1b 2a.phase\n', ESC, 'j', 'x', '2', 'u', ESC, '\x1b[A'],
}


@pytest.mark.parametrize('name', TUI_SCRIPTS)
def test_tui_keys_match_jax(name):
    """The same keys leave both packages' terminal patchers in the same
    state after every key (mode, cursor, command line, pending gesture,
    port menu, clipboard, picker, message, dump), with the original test's
    checks on the port's."""
    (_, want), (tui, got) = both(tui_script, TUI_SCRIPTS[name])
    assert got == want
    at = TORCH.at
    m = tui.controller.map
    if name == 'command_mode_typing':
        assert m.get(at('1a')) is not None and tui.mode == 'cmd'
    elif name == 'grid_cursor_moves_and_clamps':
        assert got[2][1] == '2b' and str(tui.cursor) == '1a'
    elif name == 'cable_gesture_with_port_menu':
        assert got[3][3] == ('cable', at('1a')) and got[5][4] is not None
        assert 'hertz' in got[6][8][-1] and 'hertz' not in ''.join(got[7][8])
    elif name == 'single_port_connects_without_menu':
        assert got[5][8][-1] == '> 1a 2a.input' and len(got[6][8]) == 2
    elif name == 'delete_move_and_cancel':
        assert m.get(at('1b')) is not None and tui.pending is None
        assert tui.mode == 'cmd'
    elif name == 'add_gesture_prefills_command':
        assert tui.mode == 'cmd' and tui.line == '+ 1b '
    elif name == 'copy_paste_undo_round_trip':
        assert float(m.get(at('1b')).get_state().value[0, 0]) == 440.0
        assert 'Fixed' in tui.clipboard[0] and 'value=' in tui.clipboard[1]
    elif name == 'cut_removes_and_paste_restores':
        assert m.get(at('1a')) is not None and m.get(at('2a')) is None
    elif name == 'copy_empty_cell_is_noop':
        assert tui.clipboard is None and 'clipboard empty' in tui.message
    elif name == 'fuzzy_picker_adds_selected_signal':
        assert 'Sine' in got[5][7]
        assert got[6][8][0].startswith('+ 1a signals_tpu.nodes.osc.Sine')
        assert got[7][8] == ()
    elif name == 'fuzzy_picker_subsequence_and_cancel':
        assert any(x.endswith('LowPass') for x in tui.picker_matches('lwps'))
        assert tui.picker is None and m.get(at('1a')) is None
    elif name == 'picker_selection_keys':
        second = tui.picker_matches('pass')[1]
        assert type(m.get(at('1a'))).__name__ == second.rsplit('.', 1)[-1]


def test_tui_cell_span_matches_padded_render():
    def run(P):
        tui = _tui(P)
        for ch in '+ 2b signals_tpu.nodes.osc.Sine\n':
            tui.handle_key(ch)
        text = P.ascii.render_map(tui.controller.map, pad_to=P.at('4d'))
        lines = text.splitlines()
        y, x0, x1 = P.ascii.cell_span(P.at('2b'))
        assert '2b:Sine' in lines[y][x0:x1] and len(lines) >= 4
        return text, (y, x0, x1)

    assert_same(run)


class _Screen:
    """A curses window stand-in recording what the TUI draws."""

    def __init__(self, h=24, w=100):
        self.h, self.w = h, w
        self.calls = []

    def getmaxyx(self):
        return self.h, self.w

    def __getattr__(self, name):
        def method(*a, **k):
            self.calls.append((name, a))
        return method


def test_tui_draw_matches_jax():
    """The frame the TUI draws (a patch with a pending cable), call for
    call, except the title bar that names the package."""
    def run(P):
        tui = _tui(P)
        for ch in ('+ 1a signals_tpu.nodes.fixed.Fixed value=[[440]]\n'
                   '+ 2a signals_tpu.nodes.osc.Sine\n> 1a 2a.hertz\n'):
            tui.handle_key(ch)
        tui.handle_key(ESC)
        tui.handle_key('\n')
        scr = _Screen()
        tui.draw(scr)
        return [c for c in scr.calls if not any(
            isinstance(a, str) and 'patcher' in a for a in c[1])]

    got = assert_same(run)
    assert any('2a:Sine' in str(c) for c in got)


# --- the graphical patcher (tests/test_gui.py) -------------------------------

def _gui(P):
    return P.gui.PatcherPresenter(P.controller(interactive=True))


def _setup(p):
    p.run('+ 1a signals_tpu.nodes.fixed.Fixed value=[[440]]')
    p.run('+ 2a signals_tpu.nodes.osc.Sine')
    p.run('> 1a 2a.hertz')


def _scene(p):
    s = p.scene()
    return {k: (sorted(map(repr, v)) if isinstance(v, list) else repr(v))
            for k, v in s.items()}


def gui_scene(P):
    p = _gui(P)
    _setup(p)
    scene = p.scene()
    assert {n['label'] for n in scene['nodes']} == {'Fixed', 'Sine'}
    kinds = {(pt['kind'], pt['name']) for pt in scene['ports']}
    assert ('out', 'out') in kinds and ('in', 'hertz') in kinds
    assert len(scene['cables']) == 1 and scene['cables'][0]['port'] == \
        'hertz' and len(scene['cables'][0]['points']) == 4
    return _scene(p)


def gui_click_drag(P):
    p = _gui(P)
    _setup(p)
    x0, y0, x1, y1 = p.node_box(P.at('1a'))
    p.press((x0 + x1) / 2, (y0 + y1) / 2)
    assert str(p.selected) == '1a'
    bx, by = p.cell_origin(P.at('3b'))
    p.motion(bx + 10, by + 10)
    mid = _scene(p)
    p.release(bx + 10, by + 10)
    assert p.controller.map.get(P.at('3b')) is not None
    assert p.controller.map.get(P.at('1a')) is None
    after = list(p.controller.dump())
    p.run('undo')
    assert p.controller.map.get(P.at('1a')) is not None
    return mid, after, _scene(p)


def gui_cable_port_menu(P):
    p = _gui(P)
    p.run('+ 1a signals_tpu.nodes.fixed.Fixed value=[[300]]')
    p.run('+ 2a signals_tpu.nodes.osc.Sine')
    ox, oy = p.out_dot(P.at('1a'))
    p.press(ox, oy)
    assert p.drag is not None and p.drag[0] == 'cable'
    pending = _scene(p)
    tx, ty = p.in_dot(P.at('2a'), 0, 2)
    p.motion(tx, ty)
    p.release(tx, ty)
    menu = p.port_menu
    names = menu[2]
    p.choose_port(names.index('hertz'))
    conns = list(p.controller.map.iter_connections())
    assert len(conns) == 1 and conns[0].output.port == 'hertz'
    p.run('undo')
    assert not list(p.controller.map.iter_connections())
    return pending, repr(menu), p.message


def gui_single_port(P):
    p = _gui(P)
    p.run('+ 1a signals_tpu.nodes.osc.Sine')
    p.run('+ 2a signals_tpu.nodes.shape.Flatten')
    ox, oy = p.out_dot(P.at('1a'))
    p.press(ox, oy)
    tx, ty = p.cell_origin(P.at('2a'))
    p.release(tx + 10, ty + 10)
    assert p.port_menu is None
    assert len(list(p.controller.map.iter_connections())) == 1
    return list(p.controller.dump())


def gui_clipboard(P):
    p = _gui(P)
    _setup(p)
    p.selected = P.at('1a')
    payload = p.copy()
    assert payload is not None and 'Fixed' in payload[0]
    p.paste(payload, P.at('4c'))
    pasted = p.controller.map.get(P.at('4c'))
    assert float(pasted.get_state().value[0, 0]) == 440.0
    dump = list(p.controller.dump())
    p.run('undo')
    assert p.controller.map.get(P.at('4c')) is None
    return payload, dump


def gui_picker(P):
    p = _gui(P)
    matches = p.search('sine')
    assert matches and matches[0].endswith('Sine')
    p.add(matches[0])
    assert str(p.selected) == '1a'
    p.add(matches[0])
    assert str(p.selected) != '1a'
    return matches, str(p.selected), list(p.controller.dump())


def gui_editor(P):
    p = _gui(P)
    p.run('+ 1a signals_tpu.nodes.fixed.Fixed value=[[440]]')
    p.selected = P.at('1a')
    fields = p.editor_fields()
    assert 'value' in dict(fields) and 'enabled' in dict(fields)
    p.apply_edit('value', '[[880]]')
    sig = p.controller.map.get(p.selected)
    assert float(sig.get_state().value[0, 0]) == 880.0
    p.run('undo')
    assert float(sig.get_state().value[0, 0]) == 440.0
    return repr(fields)


def gui_dirty(P):
    p = _gui(P)
    seen = [p.dirty]
    p.run('+ 1a signals_tpu.nodes.osc.Sine')
    seen.append(p.dirty)
    p.mark_saved()
    seen.append(p.dirty)
    assert seen == [False, True, False]
    return seen


def gui_px_grid(P):
    p = _gui(P)
    out = []
    for s in ('1a', '3b', '7z', '12aa'):
        at = P.at(s)
        x, y = p.cell_origin(at)
        assert p.px_to_grid(x + 5, y + 5) == at
        out.append((x, y, p.node_box(at), p.out_dot(at), p.power_dot(at)))
    return out


def gui_power(P):
    p = _gui(P)
    p.run('+ 2b signals_tpu.nodes.osc.Sine')
    at = P.at('2b')
    sig = p.controller.map.get(at)
    x, y = p.power_dot(at)
    p.press(x, y)
    assert not sig.get_state().enabled
    node = next(n for n in p.scene()['nodes'] if n['at'] == at)
    assert not node['enabled'] and node['power'] == (x, y)
    p.run('undo')
    assert sig.get_state().enabled
    p.press(x, y)
    p.press(x, y)
    assert sig.get_state().enabled
    return list(p.controller.dump()), p.controller.modcount


def gui_save_revert(P, tmp_path):
    p = _gui(P)
    p.run('+ 1a signals_tpu.nodes.osc.Sine')
    assert not p.save()
    path = str(tmp_path / f'{P.name}.sigs')
    assert p.save(path) and p.path == path and not p.dirty
    p.run('+ 2a signals_tpu.nodes.osc.Square')
    assert p.dirty
    p.revert()
    assert not p.dirty
    assert {n['label'] for n in p.scene()['nodes']} == {'Sine'}
    assert p.save()
    return open(path).read()


def gui_bind_device(P):
    p = _gui(P)
    sinks, sources = p.device_names('sink'), p.device_names('source')
    assert sinks and sources
    p.bind_device('sink', 'null')
    bound = list(p.controller.map.iter_sinks())
    assert len(bound) == 1 and bound[0].device.name == 'null'
    assert any(n['label'] == 'null' for n in p.scene()['nodes'])
    scene = _scene(p)
    p.run('undo')
    assert not list(p.controller.map.iter_sinks())
    return sinks, sources, scene


def gui_vis_entries(P):
    p = _gui(P)
    assert p.vis_entries() == []
    p.run('+ 1a signals_tpu.nodes.osc.Sine')
    p.run('+ 3a signals_tpu.nodes.vis.Wave')
    p.run('> 1a 3a.input')
    entries = p.vis_entries()
    assert len(entries) == 1 and 'Wave' in entries[0][0]
    p.run('- 3a')
    assert p.vis_entries() == []
    return entries[0][0]


def gui_failed_save(P, tmp_path):
    p = _gui(P)
    _setup(p)
    good = str(tmp_path / f'{P.name}-ok.sigs')
    assert p.save(good) is True and not p.dirty
    p.run('+ 3a signals_tpu.nodes.osc.Sine')
    bad = str(tmp_path / 'no-such-dir' / 'x.sigs')
    assert p.save(bad) is True and 'error' in p.message.lower()
    assert p.path == good and p.dirty
    msg = p.message.replace(str(tmp_path), '<tmp>')
    assert p.save() is True and not p.dirty
    return msg


def gui_failed_load(P, tmp_path):
    p = _gui(P)
    _setup(p)
    good = str(tmp_path / f'{P.name}-ok.sigs')
    p.save(good)
    p.load(str(tmp_path / 'missing.sigs'))
    assert 'error' in p.message.lower() and p.path == good
    assert len(p.scene()['nodes']) == 2
    return p.message.replace(str(tmp_path), '<tmp>')


def gui_clip_text(P):
    actions = P.actions
    payload = ('signals_tpu.nodes.osc.Sine', 'enabled=true')
    text = actions.clip_text(payload)
    assert text == '+ 1a signals_tpu.nodes.osc.Sine enabled=true'
    assert actions.parse_clip_text(text) == payload
    assert actions.parse_clip_text('not a sigs line') is None
    assert actions.parse_clip_text('+ zz bad.coord x=1') is None
    return text, actions.fuzzy_rank(['a.LowPass', 'b.HighPass', 'c.Sine'],
                                    'pass')


GUI = (gui_scene, gui_click_drag, gui_cable_port_menu, gui_single_port,
       gui_clipboard, gui_picker, gui_editor, gui_dirty, gui_px_grid,
       gui_power, gui_bind_device, gui_vis_entries, gui_clip_text)
GUI_TMP = (gui_save_revert, gui_failed_save, gui_failed_load)


@pytest.mark.parametrize('scenario', GUI, ids=lambda f: f.__name__)
def test_gui_presenter_matches_jax(scenario):
    assert_same(scenario)


@pytest.mark.parametrize('scenario', GUI_TMP, ids=lambda f: f.__name__)
def test_gui_files_match_jax(scenario, tmp_path):
    assert_same(scenario, tmp_path)


class _FakeWidget:
    """Records every method call; stands in for any Tk widget."""

    def __init__(self, view, *a, **k):
        self.view = view
        self.calls = []
        self.bindings = {}
        view.widgets.append(self)

    def bind(self, seq, fn):
        self.bindings[seq] = fn

    def __getattr__(self, name):
        def method(*a, **k):
            self.calls.append((name, a, k))
            if name in ('get', 'curselection'):
                return () if name == 'curselection' else ''
            return None
        return method


class _FakeTk:
    """A tkinter stand-in: enough for ``TkPatcherView`` to build and
    redraw with no display."""

    def __init__(self):
        self.widgets = []
        view = self

        class Widget(_FakeWidget):
            def __init__(self, *a, **k):
                super().__init__(view, *a, **k)

        class Var:
            def __init__(self, value=''):
                self._v = value

            def get(self):
                return self._v

            def set(self, v):
                self._v = v

        for name in ('Tk', 'Canvas', 'Menu', 'Entry', 'Toplevel', 'Listbox',
                     'Label', 'Button', 'Radiobutton'):
            setattr(self, name, Widget)
        self.StringVar = Var


def _fake_view(P, monkeypatch):
    fake = _FakeTk()
    mod = types.ModuleType('tkinter')
    for name in ('Tk', 'Canvas', 'Menu', 'Entry', 'Toplevel', 'Listbox',
                 'Label', 'Button', 'Radiobutton', 'StringVar'):
        setattr(mod, name, getattr(fake, name))
    scrolled = types.ModuleType('tkinter.scrolledtext')
    scrolled.ScrolledText = fake.Tk
    mod.scrolledtext = scrolled
    monkeypatch.setitem(sys.modules, 'tkinter', mod)
    monkeypatch.setitem(sys.modules, 'tkinter.scrolledtext', scrolled)
    view_cls = P.gui.TkPatcherView
    monkeypatch.setattr(view_cls, '_embed_figure',
                        lambda self, fig: (fake.Tk(), fake.Tk()))
    return view_cls(_gui(P)), fake


def test_tk_view_matches_jax(monkeypatch):
    """The Tk shell against a fake tkinter: it builds, redraws, runs its
    gesture, dialog, console and clipboard paths, and draws the same canvas
    items as the JAX package's; a Vis node materializes its dock."""
    def run(P):
        view, fake = _fake_view(P, monkeypatch)
        view._run('+ 1a signals_tpu.nodes.fixed.Fixed value=[[440]]')
        view._run('+ 2a signals_tpu.nodes.osc.Sine')
        view._run('> 1a 2a.hertz')
        drawn = [c for c in view.canvas.calls if c[0].startswith('create_')]
        assert {'create_rectangle', 'create_text', 'create_oval',
                'create_line'} <= {c[0] for c in drawn}

        class E:
            x, y = view.p.out_dot(P.at('1a'))
        view._gesture('press', E)
        view._gesture('release', E)
        view.add_dialog()
        view.edit_dialog()
        view.device_dialog()
        view.entry.bindings['<Return>'](None)
        for seq in ('<Control-z>', '<Control-s>', '<Delete>', '<Alt-s>',
                    '<Alt-d>', '<Alt-o>', '<Alt-i>'):
            assert seq in view.root.bindings
        assert view.vis_rack is None
        view._run('+ 3a signals_tpu.nodes.vis.Wave')
        view._run('> 2a 3a.input')
        assert view.vis_rack is not None and len(view.vis_rack) == 1
        view._run('- 3a')
        assert view.vis_rack is None
        view.p.selected = P.at('2a')
        view._copy()
        appended = [c for c in view.root.calls if c[0] == 'clipboard_append']
        view.root.clipboard_get = lambda: ('+ 9z signals_tpu.nodes.osc.'
                                           'Square enabled=true')
        view.clipboard = None
        view._paste()
        assert any('Square' in ln for ln in view.p.controller.dump())
        view.device_dialog('source')
        return (drawn, appended[-1][1][0], list(view.p.controller.dump()),
                [c for c in view.canvas.calls if c[0].startswith('create_')])

    got = assert_same(run)
    assert got[1].startswith('+ 1a signals_tpu.nodes.osc.Sine')
