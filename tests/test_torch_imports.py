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
