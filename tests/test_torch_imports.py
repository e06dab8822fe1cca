"""The port stands alone: importing every module of ``signals_tpu_torch``
(the node library, ``learn`` and the sound-file modules included) pulls in
neither ``jax``, ``optax`` nor the JAX package nor matplotlib nor
``soundfile``, builds no kernel, and leaves TF32 off; the modules copied
from the JAX package do not mention ``jax`` at all."""

import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]

PROBE = '''
import pkgutil, sys
import signals_tpu_torch
for m in pkgutil.walk_packages(signals_tpu_torch.__path__, 'signals_tpu_torch.'):
    __import__(m.name)
from signals_tpu_torch import registry
registry.ensure_loaded()
from signals_tpu_torch.compiler import _build
assert 'signals_tpu_torch.learn' in sys.modules
assert 'signals_tpu_torch.nodes.wavetable' in sys.modules
for m in ('nodes.files', 'runtime.sndfile', 'runtime.wavio',
          'runtime.codecs', 'core.resample'):
    assert 'signals_tpu_torch.' + m in sys.modules, m
bad = sorted(n for n in sys.modules
             if n.split('.')[0] in ('jax', 'jaxlib', 'optax', 'signals_tpu',
                                    'soundfile'))
assert not bad, bad
assert 'matplotlib' not in sys.modules
assert _build._lib is None
import torch
assert not torch.backends.cuda.matmul.allow_tf32
assert not torch.backends.cudnn.allow_tf32
print('ok', len([n for n in sys.modules if n.startswith('signals_tpu_torch')]))
'''


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, '-c', PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith('ok')


def test_registry_keeps_reference_qualnames():
    from signals_tpu_torch.registry import load_signal
    from signals_tpu_torch.nodes import delay, fx, osc
    assert load_signal('signals.chain.osc.Sine') is osc.Sine
    assert load_signal('signals.chain.fx.LowPass') is fx.LowPass
    assert load_signal('signals.chain.fx.Amp') is fx.Amp
    # Drive and Delay have no reference counterpart: their own names only
    assert load_signal('signals_tpu_torch.nodes.fx.Drive') is fx.Drive
    assert load_signal('signals_tpu_torch.nodes.delay.Delay') is delay.Delay
    for name in ('HighPass', 'BandPass', 'BandStop'):
        assert load_signal(f'signals.chain.fx.{name}') is getattr(fx, name)
    from signals_tpu_torch.nodes import dyn, noise, reverb, vis
    assert load_signal('signals.chain.noise.White') is noise.White
    assert load_signal('signals.chain.vis.Wave') is vis.Wave
    assert load_signal('signals.chain.vis.Spec') is vis.Spec
    for mod, name in ((noise, 'Pink'), (noise, 'SampleHold'),
                      (reverb, 'Reverb'), (dyn, 'Compressor'), (dyn, 'Gate'),
                      (dyn, 'Limiter')):
        assert load_signal(f'{mod.__name__}.{name}') is getattr(mod, name)
    assert osc.Sawtooth.cls_name() == 'signals_tpu_torch.nodes.osc.Sawtooth'
    from signals_tpu_torch.nodes import wavetable
    assert (load_signal('signals_tpu.nodes.wavetable.Wavetable')
            is wavetable.Wavetable)


def test_copied_modules_never_mention_jax():
    """The numpy modules copied from the JAX package (the codecs' numpy
    half, ``wavio``, ``sndfile``, ``resample``) and the file nodes keep no
    line that names ``jax``."""
    for rel in ('runtime/codecs.py', 'runtime/wavio.py', 'runtime/sndfile.py',
                'core/resample.py', 'nodes/files.py'):
        text = (REPO / 'signals_tpu_torch' / rel).read_text()
        assert 'jax' not in text.lower(), rel
        assert 'signals_tpu.' not in text.replace('``signals_tpu.', ''), rel


def test_registry_keeps_file_and_eq_qualnames():
    from signals_tpu_torch.nodes import files, fx
    from signals_tpu_torch.registry import load_signal
    assert load_signal('signals.chain.files.FileReader') is files.FileReader
    assert load_signal('signals.chain.files.FileWriter') is files.FileWriter
    for name in ('Peak', 'LowShelf', 'HighShelf', 'Notch', 'Allpass', 'Pan',
                 'Quantize'):
        cls = getattr(fx, name)
        assert load_signal(f'signals_tpu.nodes.fx.{name}') is cls
        assert load_signal(f'signals_tpu_torch.nodes.fx.{name}') is cls


NEW_MODULES = ('nodes.shape', 'nodes.seq', 'nodes.moddelay', 'nodes.phaser',
               'nodes.conv', 'parallel.voices', 'utils.midifile')

PROBE_NEW = '''
import importlib, sys
for m in %r:
    importlib.import_module('signals_tpu_torch.' + m)
from signals_tpu_torch import registry
registry.ensure_loaded()
bad = sorted(n for n in sys.modules
             if n.split('.')[0] in ('jax', 'jaxlib', 'optax', 'signals_tpu'))
assert not bad, bad
print('ok')
''' % (NEW_MODULES,)


def test_sequencing_and_modfx_modules_import_no_jax():
    """The modules of sequenced polyphony and the modulation effects import
    neither ``jax`` nor the JAX package, alone as through the registry."""
    proc = subprocess.run([sys.executable, '-c', PROBE_NEW], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith('ok')
    for rel in ('parallel/voices.py', 'utils/midifile.py', 'nodes/seq.py',
                'nodes/shape.py', 'nodes/moddelay.py', 'nodes/phaser.py',
                'nodes/conv.py'):
        text = (REPO / 'signals_tpu_torch' / rel).read_text()
        assert 'import jax' not in text and 'from jax' not in text, rel
        assert 'from signals_tpu.' not in text, rel
        assert 'import signals_tpu.' not in text, rel


def test_sequenced_poly_and_vmap_layout_default_to_the_card():
    """``PolyPatch(layout='vmap')`` and ``sequenced_poly`` (whose default
    layout is ``'vmap'``) ask for the GPU unless told otherwise: where torch
    sees none they raise instead of running on the CPU."""
    import inspect

    import numpy as np
    import torch

    from signals_tpu_torch.nodes.env import ADSR
    from signals_tpu_torch.nodes.fx import RingMod
    from signals_tpu_torch.nodes.osc import Sine
    from signals_tpu_torch.nodes.seq import GateSeq, PitchSeq
    from signals_tpu_torch.parallel import PolyPatch
    from signals_tpu_torch.parallel.voices import Note, sequenced_poly

    assert inspect.signature(PolyPatch).parameters['device'].default == \
        'cuda'
    assert inspect.signature(sequenced_poly).parameters['layout'].default \
        == 'vmap'

    def build():
        gate, pitch = GateSeq(), PitchSeq()
        osc = Sine()
        osc.hertz = pitch
        env = ADSR()
        env.gate = gate
        out = RingMod()
        out.left = osc
        out.right = env
        return out, gate, pitch

    def make(kind):
        root, gate, pitch = build()
        if kind == 'seq':
            return sequenced_poly(root, gate=gate, pitch=pitch,
                                  notes=[Note(0.0, 0.1, 220.0)], n_voices=2,
                                  block_frames=256)
        return PolyPatch(root, n_voices=2, layout='vmap', block_frames=256,
                         overrides={(pitch, 'values'): np.ones((2, 1))})

    for kind in ('seq', 'poly'):
        if torch.cuda.is_available():
            assert make(kind).device.type == 'cuda'
        else:
            with pytest.raises(RuntimeError, match='CUDA'):
                make(kind)


def test_registry_keeps_sequencing_and_modfx_qualnames():
    import importlib

    from signals_tpu_torch.registry import load_signal
    for modname, names in (('seq', ('GateSeq', 'PitchSeq')),
                           ('moddelay', ('FracDelay',)),
                           ('phaser', ('Phaser',)), ('conv', ('Convolve',)),
                           ('shape', ('Flatten', 'FlattenUnit', 'Select',
                                      'Merge'))):
        m = importlib.import_module(f'signals_tpu_torch.nodes.{modname}')
        for name in names:
            cls = getattr(m, name)
            assert load_signal(f'signals_tpu.nodes.{modname}.{name}') is cls
            assert load_signal(f'signals_tpu_torch.nodes.{modname}.'
                               f'{name}') is cls
            if modname == 'shape':
                assert load_signal(f'signals.chain.shape.{name}') is cls


OUTPUT_MODULES = ('nodes.dev', 'runtime.ring', 'runtime.portaudio',
                  'runtime.codecs', 'utils', 'utils.checkpoint')

PROBE_OUTPUT = '''
import importlib, sys
for m in %r:
    importlib.import_module('signals_tpu_torch.' + m)
from signals_tpu_torch import registry
registry.ensure_loaded()
from signals_tpu_torch.runtime import ring
from signals_tpu_torch.compiler import _build
assert ring._lib is None and _build._lib is None    # nothing built
bad = sorted(n for n in sys.modules
             if n.split('.')[0] in ('jax', 'jaxlib', 'optax', 'signals_tpu',
                                    'sounddevice'))
assert not bad, bad
print('ok')
''' % (OUTPUT_MODULES,)


def test_output_path_modules_import_no_jax():
    """The sinks, the ring, PortAudio, the device codecs and the checkpoint
    import neither ``jax`` nor the JAX package (nor ``sounddevice``), and
    build nothing when imported; their sources name neither."""
    proc = subprocess.run([sys.executable, '-c', PROBE_OUTPUT], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith('ok')
    for rel in ('nodes/dev.py', 'runtime/ring.py', 'runtime/portaudio.py',
                'runtime/codecs.py', 'utils/__init__.py',
                'utils/checkpoint.py', 'runtime/native/ring.cc',
                'compiler/csrc/codecs.cu'):
        text = (REPO / 'signals_tpu_torch' / rel).read_text()
        assert 'import jax' not in text and 'from jax' not in text, rel
        assert 'from signals_tpu.' not in text, rel
        assert 'import signals_tpu.' not in text, rel
        assert 'libsigring.so' not in text, rel


def test_output_path_entry_points_default_to_the_card():
    """``SinkDevice`` / ``SourceDevice``, the encoded entry points (through
    ``compile_node``) and ``checkpoint.load`` ask for the GPU unless told
    otherwise: where torch sees none, they raise."""
    import inspect

    import torch

    from signals_tpu_torch.compiler import compile_node
    from signals_tpu_torch.nodes.dev import Rack, SinkDevice, SourceDevice
    from signals_tpu_torch.utils import checkpoint

    for fn in (SinkDevice, SourceDevice, compile_node, checkpoint.load):
        assert inspect.signature(fn).parameters['device'].default == 'cuda'
    rack = Rack()
    rack.scan()
    for make in (lambda: SinkDevice(rack.get_sink('default')),
                 lambda: SourceDevice(rack.get_source('capture'))):
        if torch.cuda.is_available():
            assert make().device.type == 'cuda'
        else:
            with pytest.raises(RuntimeError, match='CUDA'):
                make()


def test_registry_keeps_device_qualnames():
    from signals_tpu_torch import registry
    from signals_tpu_torch.nodes import dev
    from signals_tpu_torch.registry import Library, load_signal
    assert 'signals_tpu_torch.nodes.dev' in registry._NODE_MODULES
    for name in ('SinkDevice', 'SourceDevice'):
        cls = getattr(dev, name)
        for prefix in ('signals.chain.dev', 'signals_tpu.nodes.dev',
                       'signals_tpu_torch.nodes.dev'):
            assert load_signal(f'{prefix}.{name}') is cls
    lib = Library()
    lib.scan()
    assert not any('Device' in n for n in lib.names)   # devices hidden


PROBE_JAX_NAMES = '''
import json, sys
from signals_tpu_torch.registry import BadPath, load_signal
names = json.loads(sys.stdin.read())
got = {}
for name in names:
    cls = load_signal(name)
    got[name] = [cls.__module__, cls.__qualname__]
refused = []
for name in ('signals_tpu.nodes.osc.NoSuchNode', 'signals_tpu.map.Map',
             'signals_tpu.compiler.compile_node', 'jax.numpy.sin',
             'jaxlib.xla_client.Client', 'optax.adam'):
    try:
        load_signal(name)
    except BadPath:
        refused.append(name)
bad = sorted(n for n in sys.modules
             if n.split('.')[0] in ('jax', 'jaxlib', 'optax', 'signals_tpu'))
print(json.dumps({'got': got, 'refused': refused, 'bad': bad}))
'''


def test_registry_resolves_the_jax_package_names_without_importing_it():
    """Every ``signals_tpu.nodes.*`` name of the JAX package's registry (the
    names its REPL writes into a ``.sigs`` file) resolves to the port's
    class of the same module and name, and another name under the JAX
    package or JAX raises ``BadPath``; in a fresh process, neither the JAX
    package nor JAX is imported by any of it."""
    import json

    from signals_tpu import registry as jax_registry
    jax_registry.ensure_loaded()
    names = [n for n in jax_registry.registry.names(include_aliases=True,
                                                    devices=True)
             if n.startswith('signals_tpu.nodes.')]
    assert len(names) >= 44
    proc = subprocess.run([sys.executable, '-c', PROBE_JAX_NAMES], cwd=REPO,
                          input=json.dumps(names), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    assert out['bad'] == []
    assert len(out['refused']) == 6, out['refused']
    for name in names:
        cls = jax_registry.load_signal(name)
        module, qual = out['got'][name]
        assert module == cls.__module__.replace('signals_tpu.',
                                                'signals_tpu_torch.', 1)
        assert qual == cls.__qualname__


COMMAND_MODULES = ('signals_tpu_torch.map', 'signals_tpu_torch.map.control',
                   'signals_tpu_torch.layout', 'signals_tpu_torch.ui',
                   'signals_tpu_torch.entry', 'signals_tpu_torch.__main__')

PROBE_COMMANDS = '''
import importlib, pkgutil, sys
import signals_tpu_torch
for m in %r:
    importlib.import_module(m)
import signals_tpu_torch.ui
for m in pkgutil.walk_packages(signals_tpu_torch.ui.__path__,
                               'signals_tpu_torch.ui.'):
    importlib.import_module(m.name)
assert len([n for n in sys.modules if n.startswith('signals_tpu_torch.ui.')]) == 8
signals_tpu_torch.Project.default().config.theme
from signals_tpu_torch.compiler import _build
assert _build._lib is None
bad = sorted(n for n in sys.modules
             if n.split('.')[0] in ('jax', 'jaxlib', 'optax', 'signals_tpu',
                                    'matplotlib', 'tkinter', '_tkinter'))
assert not bad, bad
print('ok')
''' % (COMMAND_MODULES,)


def test_command_layer_modules_import_no_jax_matplotlib_or_tkinter():
    """The map, the controller, the layout, the nine ``ui`` modules, the
    REPL's ``__main__`` and ``entry`` import neither JAX, the JAX package,
    matplotlib nor tkinter (the GUI, the plots and the vis rack import
    them when they draw), and build no kernel."""
    proc = subprocess.run([sys.executable, '-c', PROBE_COMMANDS], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith('ok')


def test_copied_command_modules_never_mention_jax():
    """The backend-neutral modules copied from the JAX package for the
    command layer (the layout, the nine ``ui`` modules, ``__main__``) keep
    no line that names ``jax``; those and the rewritten map, controller and
    ``entry`` import neither JAX nor the JAX package."""
    copied = ['layout/__init__.py', '__main__.py']
    copied += [f'ui/{p.name}' for p in (REPO / 'signals_tpu_torch' /
                                        'ui').glob('*.py')]
    assert len(copied) == 11
    for rel in copied + ['map/__init__.py', 'map/control.py', 'entry.py']:
        text = (REPO / 'signals_tpu_torch' / rel).read_text()
        if rel in copied:
            assert 'jax' not in text.lower(), rel
        assert 'import jax' not in text and 'from jax' not in text, rel
        assert 'from signals_tpu.' not in text, rel
        assert 'import signals_tpu.' not in text, rel
        assert 'import signals_tpu\n' not in text, rel


def test_command_layer_defaults_to_the_card():
    """``Controller``, ``Map``, the REPL's ``main`` and ``entry`` ask for the
    GPU unless told otherwise: where torch sees none, a sink added through
    the controller or the map, and ``entry()``, raise instead of running on
    the CPU."""
    import inspect

    import torch

    from signals_tpu_torch import entry
    from signals_tpu_torch.map import Coordinates, Map, MappedDevInfo
    from signals_tpu_torch.map import control
    from signals_tpu_torch.nodes.dev import Rack

    for fn in (control.Controller, Map, control.main, entry.entry):
        assert inspect.signature(fn).parameters['device'].default == 'cuda'
    ctl = control.Controller(interactive=False)
    assert ctl.device == 'cuda' and ctl.map.device == 'cuda'
    rack = Rack()
    rack.scan()
    makes = (lambda: ctl.default('sink 1a default'),
             lambda: Map().add(MappedDevInfo.for_sink(
                 at=Coordinates.parse('1a'),
                 device=rack.get_sink('default'))),
             entry.entry)
    for make in makes:
        if torch.cuda.is_available():
            make()
        else:
            with pytest.raises(RuntimeError, match='no CUDA GPU'):
                make()
    if not torch.cuda.is_available():
        assert list(ctl.dump()) == []      # the failed sink left nothing


PROBE_MESH = '''
import sys
from signals_tpu_torch import entry, parallel
from signals_tpu_torch.parallel import (MIN_EFFICIENT_VOICES_PER_DEVICE,
                                        PolyPatch, efficient_device_count,
                                        voice_mesh)
from signals_tpu_torch.graph import RequestRate
from signals_tpu_torch.compiler import _build
bad = sorted(n for n in sys.modules
             if n.split('.')[0] in ('jax', 'jaxlib', 'optax', 'signals_tpu'))
assert not bad, bad
assert _build._lib is None
print('ok')
'''


def test_mesh_code_imports_no_jax():
    """The voice mesh (``parallel.voice_mesh``, ``PolyPatch(mesh=...)``),
    ``entry.dryrun_multichip`` and the mesh tests' rank worker import
    neither JAX nor the JAX package and build nothing when imported."""
    proc = subprocess.run([sys.executable, '-c', PROBE_MESH], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith('ok')
    for path in (REPO / 'signals_tpu_torch' / 'parallel' / '__init__.py',
                 REPO / 'signals_tpu_torch' / 'entry.py',
                 REPO / 'tests' / 'torch_mesh_worker.py'):
        text = path.read_text()
        assert 'import jax' not in text and 'from jax' not in text, path
        assert 'from signals_tpu.' not in text, path
        assert 'import signals_tpu.' not in text, path
