"""The port stands alone: importing every module of ``signals_tpu_torch``
(the node library and ``learn`` included) pulls in neither ``jax``,
``optax`` nor the JAX package nor matplotlib, builds no kernel, and leaves
TF32 off."""

import pathlib
import subprocess
import sys

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
bad = sorted(n for n in sys.modules
             if n.split('.')[0] in ('jax', 'jaxlib', 'optax', 'signals_tpu'))
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
