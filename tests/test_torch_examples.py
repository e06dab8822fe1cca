"""The port's examples (``examples_torch/``) against the JAX package's
(``examples/``), on the CPU.

One port script for each JAX example, by file name.  Each runs in its own
subprocess with ``--device cpu``, in the environment of
``tests/test_examples.py`` (its own ``HOME`` and ``TMPDIR``, the working
directory a temporary one), to rc 0.  The JAX example runs the same way
(its ``main`` called with an output path in the same directory), and the
two files are compared: float32 WAVs within 1e-5 per voice of the patch,
the pcm16 AIFF within one LSB.  ``fit_patch`` writes no file: both
packages' runs record each fit (its losses and the fitted values), the
first two fits' values agree within 1e-4 relative, and the third fit's
first 50 losses too (after that Adam at learning rate 0.02 oscillates at
the noise floor, where float rounding sends the two runs apart).
``play_sine`` plays two seconds on the virtual ``default`` sink: rc 0 and
a nonzero peak.
"""

import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_DIR = REPO / 'examples_torch'
JAX_DIR = REPO / 'examples'
EXAMPLES = sorted(p.name for p in JAX_DIR.glob('*.py'))

#: example -> (the output files' names as its ``main`` takes them, the
#: patch's voice count: the tolerance is 1e-5 a voice)
FILES = {
    'feedback_echo.py': (['echo.wav'], 1),
    'melody.py': (['melody.wav'], 1),
    'midi_poly.py': (['demo.mid', 'midi_poly.wav'], 8),
    'modulation.py': (['modulation.wav'], 1),
    'poly_bounce.py': (['poly_bounce.wav'], 16),
    'space_echo.py': (['space_echo.aiff'], 1),
}

#: run an example's ``main(*args)`` (the JAX package's: its ``__main__``
#: block takes no output path in every script)
CALL_MAIN = '''
import runpy, sys
sys.path.insert(0, {repo!r})
runpy.run_path({script!r})['main'](*{args!r})
'''

#: run an example as ``__main__`` with every ``learn.fit`` and
#: ``PolyPatch.fit`` of package ``pkg`` recorded: each fit's losses and
#: the values fitted into its first trainable, written as JSON to ``out``
RECORD_FITS = '''
import importlib, json, runpy, sys
import numpy as np
sys.path.insert(0, {repo!r})
learn = importlib.import_module({pkg!r} + '.learn')
parallel = importlib.import_module({pkg!r} + '.parallel')
fits = []
fit, poly_fit = learn.fit, parallel.PolyPatch.fit

def record(result, value):
    fits.append({{'losses': [float(x) for x in np.ravel(result.losses)],
                 'value': [float(x) for x in np.ravel(value)]}})
    return result

def fit_recorded(root, target, trainable, **kw):
    result = fit(root, target, trainable, **kw)
    return record(result, trainable[0][0].get_state().value)

def poly_fit_recorded(self, target, trainable, **kw):
    result = poly_fit(self, target, trainable, **kw)
    node = trainable[0][0]
    return record(result, next(s for n, _p, _a, s in self._channel_overrides
                               if n is node))

learn.fit = fit_recorded
parallel.PolyPatch.fit = poly_fit_recorded
sys.argv = [{script!r}] + {argv!r}
runpy.run_path({script!r}, run_name='__main__')
with open({out!r}, 'w') as f:
    json.dump(fits, f)
'''


def run(args, cwd):
    env = {'HOME': str(cwd), 'PATH': '/usr/bin:/bin:/usr/local/bin',
           'TMPDIR': str(cwd)}
    proc = subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, timeout=600, cwd=str(cwd), env=env)
    assert proc.returncode == 0, (
        f'{args} failed:\nstdout: {proc.stdout[-2000:]}\n'
        f'stderr: {proc.stderr[-2000:]}')
    return proc.stdout


def read(path):
    from signals_tpu_torch.runtime.sndfile import open_reader
    r = open_reader(str(path))
    try:
        return r.read(0, r.frames)
    finally:
        r.close()


def test_example_inventory():
    """One port script for each JAX example, under the same name, and
    nothing else in ``examples_torch/``."""
    assert len(EXAMPLES) >= 8
    assert sorted(p.name for p in PORT_DIR.glob('*.py')) == EXAMPLES
    assert sorted([*FILES, 'fit_patch.py', 'play_sine.py']) == EXAMPLES


@pytest.mark.parametrize('name', sorted(FILES))
def test_example_writes_the_jax_examples_file(name, tmp_path):
    names, voices = FILES[name]
    port_dir, jax_dir = tmp_path / 'port', tmp_path / 'jax'
    port_dir.mkdir()
    jax_dir.mkdir()
    said = run([str(PORT_DIR / name)] + [str(port_dir / n) for n in names]
               + ['--device', 'cpu'], port_dir)
    run(['-c', CALL_MAIN.format(repo=str(REPO), script=str(JAX_DIR / name),
                                args=[str(jax_dir / n) for n in names])],
        jax_dir)
    assert names[-1] in said
    if name == 'midi_poly.py':        # the demo score, byte for byte
        assert ((port_dir / names[0]).read_bytes()
                == (jax_dir / names[0]).read_bytes())
    got, want = read(port_dir / names[-1]), read(jax_dir / names[-1])
    assert got.shape == want.shape and got.shape[0] > 44100
    assert np.isfinite(got).all() and np.abs(want).max() > 0.1
    err = float(np.abs(got.astype(np.float64) - want).max())
    if name == 'space_echo.py':       # pcm16: one LSB
        assert err <= 1.0 / 32768 + 1e-9, err
    else:
        assert err <= voices * 1e-5, err


def test_fit_patch_follows_the_jax_examples_fits(tmp_path):
    fits = {}
    for pkg, script, argv in (
            ('signals_tpu_torch', PORT_DIR / 'fit_patch.py',
             ['--device', 'cpu']),
            ('signals_tpu', JAX_DIR / 'fit_patch.py', [])):
        out = tmp_path / f'{pkg}.json'
        said = run(['-c', RECORD_FITS.format(
            repo=str(REPO), pkg=pkg, script=str(script), argv=argv,
            out=str(out))], tmp_path)
        assert 'poly fit' in said
        fits[pkg] = json.loads(out.read_text())
    got, want = fits['signals_tpu_torch'], fits['signals_tpu']
    assert len(got) == len(want) == 3
    assert [len(f['losses']) for f in got] == [150, 300, 200]

    def rel(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return float(np.abs(a - b).max() / np.abs(b).max())

    for g, w in zip(got[:2], want[:2]):          # the gain, the pitch
        assert rel(g['value'], w['value']) <= 1e-4, (g['value'], w['value'])
    assert rel(got[2]['losses'][:50], want[2]['losses'][:50]) <= 1e-4
    assert abs(got[0]['value'][0] - 0.7) < 0.05      # 0.716 in both
    assert abs(got[1]['value'][0] - 440.0) < 1.0
    assert got[2]['losses'][-1] < 0.01 * got[2]['losses'][0]


def test_play_sine_plays(tmp_path):
    said = run([str(PORT_DIR / 'play_sine.py'), '--device', 'cpu'],
               tmp_path)
    frames, peak = re.search(r'rendered (\d+) frames, \d+ underruns, '
                             r'peak ([0-9.]+)', said).groups()
    assert int(frames) > 0 and float(peak) > 0.5
