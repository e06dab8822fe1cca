"""The port's command layer against the JAX package's: the map
(``tests/test_map.py``), the controller and its commands
(``tests/test_control.py``, the ``bounce`` of ``tests/test_stream_bounce.py``),
``Config`` / ``Project`` (``tests/test_config.py``), the REPL process
(``python -m signals_tpu_torch``) and ``entry()``.

The port's controller runs on the CPU (``device='cpu'``).  A command script
runs line by line through both packages' controllers; after every line the
error (class name and message), the dump, the hash and the history (its
length, index and modification count) must be the same, and at the end the
printed text.  Renders are held to the JAX package's: the ``sine`` patch
bit for bit (both packages render it to the same bits), the swept voice
within 1e-5, ``fit`` within 1e-4 relative, ``entry`` within 64 x 1e-5."""

import doctest
import importlib
import io
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

import matplotlib

matplotlib.use('Agg')

import torch_refs  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / 'tests' / 'fixtures'
PKGS = ('signals_tpu', 'signals_tpu_torch')


def controller(pkg, interactive=False):
    control = importlib.import_module(f'{pkg}.map.control')
    kw = {'device': 'cpu'} if pkg == 'signals_tpu_torch' else {}
    return control.Controller(interactive=interactive, stdout=io.StringIO(),
                              **kw)


def at(pkg, s):
    return importlib.import_module(f'{pkg}.map').Coordinates.parse(s)


def transcript(pkg, script, tmp, interactive=False):
    """Run ``script`` (command lines, ``{tmp}`` and ``{fixtures}`` filled
    in; or callables ``(ctl, tmp) -> observation``) through ``pkg``'s
    controller; returns what each step showed and the printed text, with
    ``tmp`` written ``<tmp>``."""
    tmp.mkdir(exist_ok=True)
    ctl = controller(pkg, interactive)
    steps = []
    for item in script:
        if callable(item):
            steps.append(('call', item(ctl, tmp)))
            continue
        line = item.format(tmp=tmp, fixtures=FIXTURES)
        err = None
        try:
            ctl.default(line)
        except Exception as e:
            err = (type(e).__name__, str(e).replace(str(tmp), '<tmp>'))
        steps.append((item, err, tuple(ctl.dump()), ctl.hash(),
                      len(ctl.history), ctl.history_index, ctl.modcount))
    return steps, ctl.stdout.getvalue().replace(str(tmp), '<tmp>'), ctl


def both(script, tmp_path, interactive=False, shared=False):
    """``script`` through both packages, each in a directory of its own,
    or with ``shared`` one after the other in the same one (where a path
    is part of the patch, and so of its dump)."""
    want = transcript('signals_tpu', script,
                      tmp_path / ('run' if shared else 'jax'), interactive)
    got = transcript('signals_tpu_torch', script,
                     tmp_path / ('run' if shared else 'torch'), interactive)
    assert got[0] == want[0]
    assert got[1] == want[1]
    return got


FIXED = '+ {} signals_tpu.nodes.fixed.Fixed value=[[{}]]'
SINE = '+ {} signals_tpu.nodes.osc.Sine'
SINE_PATCH = ['sink 7a default', FIXED.format('1a', 440), SINE.format('2a'),
              '> 1a 2a.hertz', '> 2a 7a.input']


def write(name, text):
    def step(ctl, tmp):
        (tmp / name).write_text(text)
        return name
    return step


def _sink(ctl):
    return next(s for _, s in ctl.map._map.items()
                if type(s).__name__ == 'SinkDevice')


def sink_state(ctl, tmp):
    sink = _sink(ctl)
    return sink.frame_position, sink.is_active, sink.tell()


def sink_active(ctl, tmp):
    return _sink(ctl).is_active


def not_realtime(ctl, tmp):
    for _, sig in ctl.map._map.items():
        if type(sig).__name__ == 'SinkDevice':
            sig.realtime = False
    return 'offline'


def wav_shape(name):
    def step(ctl, tmp):
        from signals_tpu_torch.runtime.wavio import read_wav
        data, rate = read_wav(tmp / name)
        return data.shape, rate
    return step


def read_text(name):
    def step(ctl, tmp):
        return (tmp / name).read_text().replace(str(tmp), '<tmp>')
    return step


def file_size(name):
    def step(ctl, tmp):
        return (tmp / name).stat().st_size > 1000
    return step


def wav_stats(name):
    """A WAV's shape and rate, and whether it carries sound."""
    def step(ctl, tmp):
        from signals_tpu_torch.runtime.wavio import read_wav
        data, rate = read_wav(tmp / name)
        return data.shape, rate, bool(np.abs(data).max() > 1e-3)
    return step


def reference_copy(name):
    """The reference's byte-for-byte fixture ``name`` with its FileWriter's
    path moved from ``/tmp`` into the test's directory."""
    def step(ctl, tmp):
        text = (FIXTURES / 'reference' / name).read_text()
        (tmp / name).write_text(text.replace('/tmp/lowpass_test.wav',
                                             str(tmp / 'lowpass_test.wav')))
        return name
    return step


SCRIPTS = {
    'add_edit_show': [FIXED.format('1a', 440), SINE.format('2a'),
                      '> 1a 2a.hertz', 'show', '* 1a value=[[880]]',
                      'undo', 'show'],
    'symbols_and_names': ['+ 1a signals_tpu.nodes.osc.Sine',
                          'add 1b signals_tpu.nodes.osc.Sine',
                          'con 1a 1b.phase', '>/ 1b.phase', 'mv 1b 2b',
                          'ed 2b enabled=false', 'rm 2b', '- 1a',
                          'undo 8', 'redo 8', 'show'],
    'bad_command_and_syntax': ['frobnicate 1a', 'add', '+ 1a', '* 1a',
                               'undo x', 'fit', 'bounce 1a x.wav 1 flac',
                               'undo', 'redo'],
    'undo_redo_cycle': [SINE.format('1a'), FIXED.format('1b', 100),
                        '> 1b 1a.hertz', 'undo', 'undo', 'redo 2', 'undo 3',
                        'undo', 'redo 3', 'redo'],
    'undo_remove_restores_links': [
        FIXED.format('1a', 440), SINE.format('2a'),
        '+ 3a signals_tpu.nodes.fx.Gain', '> 1a 2a.hertz', '> 2a 3a.left',
        '- 2a', 'undo', 'redo', 'undo'],
    'history_truncation': [SINE.format('1a'),
                           '+ 1b signals_tpu.nodes.osc.Square', 'undo',
                           '+ 1c signals_tpu.nodes.osc.Triangle', 'redo'],
    'map_errors': [
        '- 9z', SINE.format('1a'), '+ 1a signals_tpu.nodes.osc.Square',
        '> 2a 1a.hertz', FIXED.format('2a', 3), '> 1a 2a.value',
        '> 2a 1a.nope', '> 2a 1a.hertz', '> 2a 1a.hertz', '>/ 1a.phase',
        '>/ 2a.value', '+ 3a signals_tpu.nodes.osc.Sine bogus=1',
        '* 1a bogus=1', '* 1a enabled=maybe', '+ 3b signals.chain.nothing.X',
        '+ 3c Sine', '= 5e 6e', 'bounce 1a {tmp}/x.wav', 'plot 1a '
        '{tmp}/x.png', 'fit 1a {tmp}/x.wav 1a.value', 'play 1a', 'stats',
        'view'],
    'bad_state_values_rejected_at_add': [
        '+ 1a signals_tpu.nodes.fx.LowPass streaming=banana',
        '+ 1b signals_tpu.nodes.fx.LowPass context=7.5',
        '+ 1c signals_tpu.nodes.delay.Delay frames=0.5',
        '+ 1d signals_tpu.nodes.env.ADSR attack=fast',
        '+ 2a signals_tpu.nodes.fx.LowPass streaming=true context=128',
        '+ 2b signals_tpu.nodes.delay.Delay frames=100'],
    'save_load_hash_roundtrip': SINE_PATCH + [
        'save {tmp}/patch.sigs', 'load {tmp}/patch.sigs',
        'load {tmp}/patch.sigs', 'undo', 'init', 'undo', 'undo', 'undo'],
    'load_rejects_non_dump_commands': [
        write('bad.sigs', 'undo\n'), 'load {tmp}/bad.sigs',
        'load {tmp}/missing.sigs'],
    'batch_rollback_is_atomic': [
        SINE.format('1a'),
        write('partial.sigs', '+ 2a signals_tpu.nodes.osc.Square\n'
                              '+ 2a signals_tpu.nodes.osc.Triangle\n'),
        'load {tmp}/partial.sigs', 'show'],
    'init_clears': [FIXED.format('1a', 1), SINE.format('2a'),
                    '> 1a 2a.hertz', 'init', 'undo', 'redo'],
    'grep': ['grep *osc*', 'grep *nomatch*', 'grep *', 'grep signals*Pass'],
    'mv': [SINE.format('1a'), '= 1a 5c', 'show', 'undo', FIXED.format('3c', 1),
           '= 3c 1a', 'mv 1a 3c', 'undo 3'],
    'sources_sinks_listing': ['sinks', 'sources'],
    'reference_fixture_loads': [
        'load {fixtures}/lowpass_test.sigs', 'undo', 'redo', 'view',
        'load {fixtures}/vis_test.sigs', 'show', 'undo', 'undo', 'redo 2'],
    'playback_and_seek': SINE_PATCH + [
        not_realtime, 'seek 10 7a', sink_state, 'play 7a', sink_active,
        'pause 7a', sink_active, 'stop 7a', sink_state],
    'stats_closed': ['sink 7a default', 'sink 8a null', 'stats',
                     'sink 7a null', '- 8a', 'stats'],
    'bounce_sine': SINE_PATCH + ['bounce 7a {tmp}/b.wav 0.25',
                                 wav_shape('b.wav')],
    'fit_command_errors': SINE_PATCH + [
        'bounce 7a {tmp}/target.wav 0.05', 'fit 7a {tmp}/target.wav '
        '1a.nonsense', FIXED.format('9a', 1), 'fit 7a {tmp}/target.wav '
        '9a.value', 'fit 7a {tmp}/target.wav 1a.value --steps 0',
        'fit 7a {tmp}/target.wav 1a.value --seconds 0.005', '>/ 7a.input',
        'fit 7a {tmp}/target.wav 1a.value'],
    'plot_and_export': [
        'sink 7a default', FIXED.format('1a', 440), SINE.format('2a'),
        '+ 3a signals_tpu.nodes.vis.Wave', '> 1a 2a.hertz', '> 2a 3a.input',
        '> 3a 7a.input', 'bounce 7a {tmp}/b.wav 0.1', 'plot 3a '
        '{tmp}/wave.png', file_size('wave.png'), 'export {tmp}/patch.svg',
        read_text('patch.svg'), 'export {tmp}/grid.svg grid',
        read_text('grid.svg'), 'view', 'view layout'],
    'reference_fixture_verbatim_end_to_end': [
        reference_copy('lowpass_test.sigs'), 'load {tmp}/lowpass_test.sigs',
        'bounce 7a {tmp}/ref_bounce.wav 0.25', wav_stats('ref_bounce.wav'),
        wav_stats('lowpass_test.wav'), 'save {tmp}/resave.sigs',
        'load {tmp}/resave.sigs', 'load {fixtures}/reference/vis_test.sigs',
        'bounce 4c {tmp}/vis.wav 0.1', wav_stats('vis.wav')],
    'engine_shape': [
        'sink 7a default', 'sink 8a default', FIXED.format('1a', 440),
        SINE.format('2a'), '+ 3a signals_tpu.nodes.vis.Wave',
        '> 1a 2a.hertz', '> 2a 3a.input', '> 3a 8a.input'],
}


@pytest.mark.parametrize('name', SCRIPTS)
def test_script_matches_jax(name, tmp_path):
    """The same command lines: the same errors, dumps, hashes, histories
    and printed text as the JAX package's controller."""
    steps, out, ctl = both(SCRIPTS[name], tmp_path,
                           shared=name.startswith('reference_fixture_verb'))
    errors = {s[0]: s[1] for s in steps if s[0] != 'call'}
    if name == 'add_edit_show':
        assert steps[2][2] == (
            '+ 1a signals_tpu.nodes.fixed.Fixed enabled=true value=[[440.0]]',
            '+ 2a signals_tpu.nodes.osc.Sine enabled=true', '> 1a 2a.hertz')
    elif name == 'bad_command_and_syntax':
        assert [e[0] for e in errors.values()] == [
            'BadCommand', 'BadCommandSyntax', 'BadCommandSyntax',
            'BadCommandSyntax', 'BadCommandSyntax', 'BadCommandSyntax',
            'BadCommandSyntax', 'BadUndo', 'BadRedo']
    elif name == 'undo_redo_cycle':
        assert steps[5][3] == steps[2][3] and steps[6][2] == ()
        assert errors['undo'][0] == 'BadUndo'
        assert errors['redo'][0] == 'BadRedo'
    elif name == 'map_errors':
        kinds = [e[0] for e in errors.values() if e]
        assert {'Empty', 'NonEmpty', 'BadReceiver', 'BadPort',
                'AlreadyConnected', 'NotConnected', 'BadName',
                'BadProperty', 'BadPropertyValue', 'BadSignal',
                'BadPlaybackTarget', 'BadVis'} <= set(kinds)
    elif name == 'bad_state_values_rejected_at_add':
        assert all(e is not None for e in list(errors.values())[:4])
        assert list(errors.values())[4:] == [None, None]
    elif name == 'save_load_hash_roundtrip':
        assert steps[5][3] == steps[6][3] == steps[7][3] == steps[8][3]
    elif name == 'batch_rollback_is_atomic':
        assert errors['load {tmp}/partial.sigs'][0] == 'NonEmpty'
        assert steps[2][3] == steps[0][3]
    elif name == 'playback_and_seek':
        assert steps[7][1] == (10 * 1024, False, 10)
        assert steps[9][1] is True and steps[11][1] is False
        assert steps[13][1] == (0, False, 0)
    elif name == 'stats_closed':
        assert '7a default: (closed)' in out
    elif name == 'fit_command_errors':
        assert 'not a fittable' in errors['fit 7a {tmp}/target.wav '
                                          '1a.nonsense'][1]
        assert 'does not feed' in errors['fit 7a {tmp}/target.wav '
                                         '9a.value'][1]
    elif name == 'plot_and_export':
        assert steps[9][1] is True and '<svg' in steps[11][1]
    elif name == 'reference_fixture_verbatim_end_to_end':
        assert steps[3][1] == ((11264, 1), 44100, True)
        assert steps[4][1][1:] == (44100, True)
        assert steps[4][1][0][0] >= 0.2 * 44100
        assert steps[6][3] == steps[5][3]
        assert steps[9][1][2]
    elif name == 'engine_shape':
        from signals_tpu_torch.map.control import _engine_shape_for
        a, b = (ctl.map.find(at(PKGS[1], s)) for s in ('7a', '8a'))
        a.block_frames, b.block_frames = 256, 2048
        vis = ctl.map.find(at(PKGS[1], '3a'))
        assert _engine_shape_for(ctl.map, vis) == (2048, b.rate)
        ctl.default('>/ 2a.hertz')
        orphan = ctl.map.find(at(PKGS[1], '1a'))
        assert _engine_shape_for(ctl.map, orphan) == (256, a.rate)


def test_unknown_jax_package_name_is_refused_in_both(tmp_path):
    """A patch naming a class the JAX package's node module lacks fails to
    load in both packages with ``BadSignal`` and leaves the patch as it was;
    the port says why without importing the JAX package."""
    bad = tmp_path / 'nope.sigs'
    bad.write_text(SINE.format('1b') + '\n'
                   '+ 1a signals_tpu.nodes.osc.Nope\n')
    errors = []
    for pkg in PKGS:
        ctl = controller(pkg)
        ctl.default(SINE.format('2a'))
        with pytest.raises(Exception) as e:
            ctl.default(f'load {bad}')
        errors.append((type(e.value).__name__, str(e.value)))
        assert list(ctl.dump()) == [
            '+ 2a signals_tpu.nodes.osc.Sine enabled=true']
    assert errors[0][0] == errors[1][0] == 'BadSignal'
    assert "'signals_tpu' is never imported" in errors[1][1]


INTERACTIVE = {
    'swallows_map_errors': ['- 9z', 'frobnicate', 'add', SINE.format('1a'),
                            '+ 1a signals_tpu.nodes.osc.Sine', 'undo 2',
                            'EOF'],
    'io_error_is_clean': ['sink 7a null', SINE.format('1a'),
                          '> 1a 7a.input',
                          'bounce 7a /nonexistent_dir_xyz/out.wav 0.01',
                          'save /nonexistent_dir_xyz/p.sigs',
                          'export /nonexistent_dir_xyz/p.svg'],
}


@pytest.mark.parametrize('name', INTERACTIVE)
def test_interactive_script_matches_jax(name, tmp_path):
    """An interactive controller prints a map-layer or file error as one
    line, as the JAX package's does, and keeps going."""
    steps, out, ctl = both(INTERACTIVE[name], tmp_path, interactive=True)
    assert 'Traceback' not in out
    assert ('Empty' in out if name == 'swallows_map_errors'
            else 'IO error:' in out)
    if name == 'swallows_map_errors':
        assert ctl.exit and ctl.last_error is None     # EOF ends the loop
    else:
        assert ctl.last_error.startswith('IO error:')


# --- the map (tests/test_map.py) ----------------------------------------------

def test_map_doctests():
    import signals_tpu_torch.map as smap
    results = doctest.testmod(smap, verbose=False)
    assert results.failed == 0 and results.attempted > 0


def _info(M, s, cls, **state):
    return M.MappedSigInfo(at=M.Coordinates.parse(s), cls_name=cls,
                           state=M.SigState(state))


def map_coordinates(M):
    out = []
    for i in (1, 25, 26, 27, 52, 701, 702, 703, 1234):
        assert int(M.CoordinateColumn(str(M.CoordinateColumn(i)))) == i
        out.append(str(M.CoordinateColumn(i)))
    with pytest.raises(ValueError):
        M.CoordinateColumn(0)
    for bad in ('a1', '0a', 'a', '1', '1A', ''):
        with pytest.raises(ValueError):
            M.Coordinates.parse(bad)
    return out


def map_state_items(M):
    item = M.SigStateItem
    assert item.parse('x=1.5').v == 1.5 and item.parse('x=true').v is True
    assert item.parse('x=hello').v == 'hello'
    np.testing.assert_array_equal(item.parse('x=[[1.0, 2.0]]').v,
                                  [[1.0, 2.0]])
    assert str(item(k='x', v=np.array([[1, 2]]))) == 'x=[[1,2]]'
    return [str(item.parse(t)) for t in ('a=1', 'b=[[1,2.5]]', 'c=s',
                                         'd=false', 'e=null')]


def map_info(M):
    sine = _info(M, '1a', 'signals_tpu.nodes.osc.Sine')
    assert sine.state == {'enabled': True}
    assert set(sine.port_names()) == {'hertz', 'phase'}
    ref = _info(M, '1a', 'signals.chain.osc.Sine')
    assert type(ref.create()).__name__ == 'Sine'
    with pytest.raises(M.BadName) as e:
        _info(M, '1a', 'signals_tpu.nodes.osc.Sine', bogus=1)
    lp = _info(M, '2b', 'signals.chain.fx.LowPass')
    return (dict(sine.state), sorted(sine.port_names()), str(e.value),
            sorted(lp.state_attr_names()), str(lp.flags), lp.sort_key())


def map_document(M):
    m = M.Map(**({'device': 'cpu'} if M.__name__.endswith('_torch.map')
                 else {}))
    c = M.Coordinates.parse
    m.add(_info(M, '1a', 'signals_tpu.nodes.fixed.Fixed',
                value=np.array([[440.0]])))
    m.add(_info(M, '2a', 'signals_tpu.nodes.osc.Sine'))
    with pytest.raises(M.NonEmpty):
        m.add(_info(M, '1a', 'signals_tpu.nodes.osc.Sine'))
    with pytest.raises(M.BadPort):
        m.connect(M.ConnectionInfo(input_at=c('1a'),
                                   output=M.PortInfo.parse('2a.nope')))
    assert m.connect(M.ConnectionInfo(
        input_at=c('1a'), output=M.PortInfo.parse('2a.hertz'))) is None
    with pytest.raises(M.AlreadyConnected):
        m.connect(M.ConnectionInfo(input_at=c('1a'),
                                   output=M.PortInfo.parse('2a.hertz')))
    with pytest.raises(M.NotConnected):
        m.disconnect(M.PortInfo.parse('2a.phase'))
    m.add(_info(M, '1b', 'signals_tpu.nodes.fixed.Fixed',
                value=np.array([[880.0]])))
    displaced = m.connect(M.ConnectionInfo(
        input_at=c('1b'), output=M.PortInfo.parse('2a.hertz')))
    assert displaced == c('1a')
    old = m.edit(c('1a'), M.SigState(value=np.array([[220.0]])))
    np.testing.assert_array_equal(old['value'], [[440.0]])
    removed = m.rm(c('1b'))
    assert removed.cls_name == 'signals_tpu.nodes.fixed.Fixed'
    assert len(removed.links_out) == 1
    with pytest.raises(M.Empty):
        m.rm(c('1b'))
    m.add(removed)
    for link in removed.links:
        m.connect(link)
    fixed, sine = m.find(c('1a')), m.find(c('2a'))
    m.mv(c('1a'), c('2a'))
    assert m.find(c('2a')) is fixed and m.find(c('1a')) is sine
    m.mv(c('2a'), c('3c'))
    return ([(str(i.at), i.cls_name, str(i.state))
             for i in m.iter_signals()],
            sorted((str(x.input_at), str(x.output))
                   for x in m.iter_connections()),
            str(displaced), str(removed.at), removed.links_out)


def map_devices(M):
    dev = importlib.import_module(M.__name__.rsplit('.', 1)[0] + '.nodes.dev')
    rack = dev.Rack()
    rack.scan()
    kw = {'device': 'cpu'} if M.__name__.endswith('_torch.map') else {}
    m = M.Map(**kw)
    c = M.Coordinates.parse
    m.add(M.MappedDevInfo.for_sink(at=c('9a'),
                                   device=rack.get_sink('default')))
    m.add(M.MappedDevInfo.for_source(at=c('9b'),
                                     device=rack.get_source('capture')))
    sinks, sources = list(m.iter_sinks()), list(m.iter_sources())
    assert len(sinks) == 1 and sinks[0].device.name == 'default'
    assert list(m.iter_signals()) == []
    removed = m.rm(c('9a'))
    m.add(removed)
    return ([(str(i.at), i.cls_name, i.device.name, str(i.state))
             for i in sinks + sources], removed.cls_name,
            type(m.find(c('9a'))).__name__)


MAP = (map_coordinates, map_state_items, map_info, map_document,
       map_devices)


@pytest.mark.parametrize('scenario', MAP, ids=lambda f: f.__name__)
def test_map_matches_jax(scenario):
    want, got = (scenario(importlib.import_module(f'{p}.map')) for p in PKGS)
    assert got == want


def test_map_device_nodes_render_where_the_map_says():
    """A device node added through a map renders on the map's device; the
    rack's record stays ``MappedDevInfo.device``."""
    import torch

    from signals_tpu_torch.map import Coordinates, Map, MappedDevInfo
    from signals_tpu_torch.nodes.dev import Rack
    rack = Rack()
    rack.scan()
    m = Map('cpu')
    info = MappedDevInfo.for_sink(at=Coordinates.parse('1a'),
                                  device=rack.get_sink('null'))
    m.add(info)
    assert m.find(Coordinates.parse('1a')).device == torch.device('cpu')
    assert info.device.name == 'null'


# --- Config / Project (tests/test_config.py) ----------------------------------

def config_scenario(pkg, tmp):
    P = importlib.import_module(pkg)
    out = []
    cfg = P.Config(theme_='RED', block_frames=512, samplerate=48000)
    cfg.save(tmp / f'{pkg}.json')
    loaded = P.Config.load(tmp / f'{pkg}.json')
    assert loaded == cfg and loaded.theme.name == 'Vampire'
    out.append(((tmp / f'{pkg}.json').read_text(), loaded.asdict()))
    d = P.Config()
    out.append((d.theme_, d.block_frames, d.samplerate))
    project = P.Project.default()
    assert project.name == 'default' and project.config.samplerate == 44100
    out.append((project.name, project.config.asdict(),
                project.config.theme.name,
                str(project.path.relative_to(P.env.project_root))))
    (tmp / pkg / 'proj').mkdir(parents=True)
    (tmp / pkg / 'proj' / 'config.json').write_text(json.dumps(
        {'theme_': 'WHITE', 'block_frames': 2048, 'samplerate': 22050}))
    p2 = P.Project(path=tmp / pkg / 'proj')
    assert p2.config.block_frames == 2048 and not p2.config.theme.is_dark
    out.append((p2.name, p2.config.asdict()))
    return out


def test_config_and_project_match_jax(tmp_path):
    """``Config`` round trips, defaults, the default project's shared
    ``templates/default/config.json`` and a project directory read the same
    in both packages; the themes are the port's own module."""
    want, got = (config_scenario(p, tmp_path) for p in PKGS)
    assert got[0][0] == want[0][0] and got[1:] == want[1:]
    import signals_tpu_torch
    assert signals_tpu_torch.env.project_root == REPO
    assert type(signals_tpu_torch.Config().theme).__module__ == \
        'signals_tpu_torch.ui.theme'


# --- bounce (tests/test_stream_bounce.py, tests/test_control.py) --------------

SUBTYPES = ('float32', 'pcm16', 'mulaw', 'alaw', 'adpcm', 'slac')


def bounce_files(pkg, lines, tmp, seconds, subtypes=SUBTYPES):
    ctl = controller(pkg)
    for line in lines:
        ctl.default(line)
    files = {}
    for sub in subtypes:
        path = tmp / f'{pkg}-{sub}.{"slac" if sub == "slac" else "wav"}'
        ctl.default(f'bounce 9a {path} {seconds} {sub}')
        files[sub] = path.read_bytes()
    return files, ctl.stdout.getvalue().replace(pkg + '-', '')


def test_sine_bounce_every_subtype_is_the_jax_file(tmp_path):
    """The ``sine`` patch (330 Hz, as ``test_bounce_command_streams_slac``)
    bounced in every subtype: each file byte for byte the JAX package's,
    the printed lines the same."""
    lines = ['+ 1a signals.chain.fixed.Fixed enabled=true value=[[330]]',
             '+ 2a signals.chain.osc.Sine', '> 1a 2a.hertz',
             'sink 9a default', '> 2a 9a.input']
    (want, wout), (got, gout) = (bounce_files(p, lines, tmp_path, 0.5)
                                 for p in PKGS)
    assert gout == wout
    for sub in SUBTYPES:
        assert got[sub] == want[sub], sub
    from signals_tpu_torch.runtime.sndfile import SlacReader
    r = SlacReader(tmp_path / 'signals_tpu_torch-slac.slac')
    a = r.read(0, r.frames)
    assert r.frames >= int(0.4 * 44100) and np.abs(a).max() > 0.5
    spec = np.abs(np.fft.rfft(a[:, 0] * np.hanning(a.shape[0])))
    freqs = np.fft.rfftfreq(a.shape[0], 1 / 44100)
    assert abs(freqs[spec.argmax()] - 330.0) < 5.0


def test_swept_bounce_matches_jax_and_the_oracle(tmp_path):
    """The bench's swept mono voice written as a ``.sigs`` patch
    (:func:`torch_refs.swept_voice_sigs`) and bounced for 8 blocks: the
    float32 file within 1e-5 of the JAX package's and of the port's numpy
    pull oracle; each encoded file byte for byte what the port's numpy
    encoder makes of the port's own float32 audio."""
    from signals_tpu_torch.runtime import codecs, sndfile
    from signals_tpu_torch.runtime.wavio import read_wav
    lines = torch_refs.swept_voice_sigs()
    seconds = 8 * 1024 / 44100
    want, _ = bounce_files('signals_tpu', lines, tmp_path, seconds,
                           ('float32',))
    got, out = bounce_files('signals_tpu_torch', lines, tmp_path, seconds)
    audio, rate = read_wav(tmp_path / 'signals_tpu_torch-float32.wav')
    jaudio, _ = read_wav(tmp_path / 'signals_tpu-float32.wav')
    assert audio.shape == jaudio.shape == (8 * 1024, 1) and rate == 44100
    assert float(np.abs(audio - jaudio).max()) <= 1e-5
    ctl = controller('signals_tpu_torch')
    for line in lines:
        ctl.default(line)
    root = ctl.map.find(at(PKGS[1], '9a')).input.sig
    oracle = torch_refs.pull_oracle(root, 8, 1)
    assert float(np.abs(audio - oracle).max()) <= 1e-5
    assert np.abs(audio).max() > 0.05
    for sub in SUBTYPES[1:]:
        ref = tmp_path / f'ref-{sub}.{"slac" if sub == "slac" else "wav"}'
        if sub == 'slac':
            payload = codecs.slac2_encode_np(audio)[0]
            w = sndfile.SlacWriter(ref, rate=44100, channels=1)
        else:
            payload = (codecs.ima_encode_np(audio)[0] if sub == 'adpcm'
                       else getattr(codecs, f'{sub}_encode')(np, audio))
            w = sndfile.open_writer(ref, rate=44100, channels=1, subtype=sub)
        w.write_encoded(payload, audio.shape[0])
        w.close()
        assert got[sub] == ref.read_bytes(), sub
    assert f'wrote {tmp_path}/float32.wav: 8192 frames (1 ch)' in out


# --- fit -----------------------------------------------------------------------

FIT_PATCH = ['sink 7a default', FIXED.format('1a', 440), SINE.format('2a'),
             FIXED.format('3a', 0.8), '+ 4a signals_tpu.nodes.fx.Gain',
             '> 1a 2a.hertz', '> 2a 4a.left', '> 3a 4a.right',
             '> 4a 7a.input']
FIT_LINE = re.compile(r'fit target\.wav: loss (\S+) -> (\S+) over 3 steps; '
                      r'3a\.value=(\S+)\n$')


def fit_run(pkg, tmp):
    ctl = controller(pkg)
    for line in FIT_PATCH:
        ctl.default(line)
    target = tmp / f'{pkg}' / 'target.wav'
    target.parent.mkdir()
    ctl.default(f'bounce 7a {target} 0.1')
    ctl.default('* 3a value=[[0.1]]')
    ctl.stdout.truncate(0)
    ctl.stdout.seek(0)
    ctl.default(f'fit 7a {target} 3a.value --steps 3 --lr 0.1')
    node = ctl.map.find(at(pkg, '3a'))
    fitted = np.array(node.get_state().value)
    line = ctl.stdout.getvalue()
    ctl.default('undo')
    restored = np.array(node.get_state().value)
    ctl.default('redo')
    return line, fitted, restored, np.array(node.get_state().value)


def test_fit_command_matches_jax(tmp_path):
    """``fit`` of a gain over 3 steps on the CPU: the printed losses and
    the fitted value within 1e-4 relative of the JAX package's, the line
    of the same form; ``undo`` gives back exactly 0.1 (the float32 value
    the edit set), ``redo`` exactly the fitted value."""
    (wline, wfit, _, _), (line, fit, restored, refit) = (
        fit_run(p, tmp_path) for p in PKGS)
    wm, m = FIT_LINE.match(wline), FIT_LINE.match(line)
    assert wm and m, (wline, line)
    for a, b in zip(m.groups(), wm.groups()):
        assert abs(float(a) - float(b)) <= 1e-4 * abs(float(b)), (a, b)
    assert np.allclose(fit, wfit, rtol=1e-4, atol=0)
    assert float(fit.ravel()[0]) > 0.1
    assert restored.dtype == fit.dtype
    assert np.array_equal(restored, np.array([[0.1]], dtype=restored.dtype))
    assert np.array_equal(refit, fit)


# --- the REPL process and entry() ---------------------------------------------

REPL_SCRIPT = '\n'.join([
    FIXED.format('1a', 220), SINE.format('2a'), '> 1a 2a.hertz',
    '+ 3a signals_tpu.nodes.vis.Wave', '> 2a 3a.input', 'view', 'hash',
    '- 9z', 'undo', 'hash', 'grep *Pass', 'exit']) + '\n'


def repl(pkg, stdin, tmp):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, '-m', pkg], input=stdin,
                          capture_output=True, text=True, timeout=120,
                          cwd=tmp, env=env)


def test_repl_process_matches_jax(tmp_path):
    """``python -m signals_tpu_torch`` fed a command script on stdin with
    no sink: exit code 0 and the same printed text, hashes included, as
    ``python -m signals_tpu``."""
    want, got = (repl(p, REPL_SCRIPT, tmp_path) for p in PKGS)
    assert got.returncode == want.returncode == 0, got.stderr
    assert got.stdout == want.stdout
    hashes = re.findall(r'[0-9a-f]{64}', got.stdout)
    assert len(hashes) == 2 and hashes[0] != hashes[1]


def test_repl_process_refuses_the_cpu(tmp_path):
    """The REPL renders on the GPU: where torch sees none, ``sink`` prints
    the "no CUDA GPU" error, adds nothing, and the ``bounce`` after it
    renders nothing (the REPL never falls back to the CPU)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip('torch sees a GPU: the sink is made there')
    out = tmp_path / 'out.wav'
    script = '\n'.join([SINE.format('1a'), 'sink 7a default',
                        '> 1a 7a.input', f'bounce 7a {out} 0.1', 'show',
                        'exit']) + '\n'
    proc = repl('signals_tpu_torch', script, tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert 'torch sees no CUDA GPU' in proc.stdout
    assert 'at 7a: Coordinates are empty' in proc.stdout
    assert not out.exists()
    assert 'sink 7a' not in proc.stdout.split('Coordinates are empty')[-1]


def test_entry_matches_jax():
    """``entry(device='cpu')``: two consecutive blocks of the 64-voice
    mix within 64 x 1e-5 of ``jax.jit`` of ``__graft_entry__.entry()``,
    the carry threaded."""
    import jax

    import __graft_entry__
    from signals_tpu_torch.entry import entry
    fwd, (params, carry, pos) = entry(device='cpu')
    jfwd, (jparams, jcarry, jpos) = __graft_entry__.entry()
    jfwd = jax.jit(jfwd)
    assert pos == jpos == 0
    for i in range(2):
        mix, carry = fwd(params, carry, i * 1024)
        jmix, jcarry = jfwd(jparams, jcarry, i * 1024)
        mix, jmix = mix.numpy(), np.asarray(jmix)
        assert mix.shape == jmix.shape == (1024, 1)
        assert float(np.abs(mix - jmix).max()) <= 64 * 1e-5
        assert np.abs(jmix).max() > 0.05
