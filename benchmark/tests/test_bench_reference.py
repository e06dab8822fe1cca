"""The plain references against the program's CPU render at tiny sizes,
and the control (the reference in bfloat16) against the reference: the
program sits far inside the cells' limits, the control far outside."""

import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark.lib import harness

BENCH = pathlib.Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 17
CPU = torch.device('cpu')


def config(name, **over):
    cfg = json.loads((BENCH / 'configs' / f'{name}.json').read_text())
    cfg.update(over)
    return cfg


def modules(name):
    return (harness.load_file(BENCH / 'configs' / f'{name}.py'),
            harness.load_file(BENCH / 'reference' / f'{name}.py',
                              f'benchmark.reference.{name}'))


def limit(cell, key):
    return json.loads((BENCH / 'limits' / f'{cell}.json').read_text())[key]


def gap(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize('block0', [0, 16])
def test_flagship_mix(block0):
    cfg = config('flagship', voices=4)
    prog, ref = modules('flagship')
    system = prog.build(cfg, SEED, CPU, {'blocks': 16, 'kind': 'render'})
    got = system.render(block0 * 1024, 16)[:, 0].double().numpy()
    want = ref.mix(cfg, system.inputs, block0 * 1024, 16, CPU).numpy()
    ctrl = ref.mix(cfg, system.inputs, block0 * 1024, 16, CPU,
                   torch.bfloat16).double().numpy()
    assert gap(got, want) < 1e-6
    assert gap(ctrl, want) > 3 * limit('flagship-512v-bounce', 'mix_gap')


SMALL_SCORE = dict(voices=8, score_seconds=4.0, melody_notes=20, chords=5)


@pytest.mark.parametrize('block0', [0, 24])
def test_score_mix(block0):
    cfg = config('score', **SMALL_SCORE)
    prog, ref = modules('score')
    system = prog.build(cfg, SEED, CPU, {'blocks': 32, 'kind': 'render'})
    got = system.render(block0 * 1024, 32)[:, 0].double().numpy()
    want = ref.mix(cfg, system.inputs, block0 * 1024, 32, CPU).numpy()
    ctrl = ref.mix(cfg, system.inputs, block0 * 1024, 32, CPU,
                   torch.bfloat16).double().numpy()
    assert gap(got, want) < 1e-6
    assert gap(ctrl, want) > 3 * limit('score-64v-bounce', 'mix_gap')


def test_score_voice_allocation_matches_the_program():
    from signals_tpu_torch.parallel.voices import allocate_voices, Note
    cfg = config('score', voices=3)
    prog, ref = modules('score')
    notes = prog.notes(config('score', **SMALL_SCORE), SEED)
    want = allocate_voices([Note(*n) for n in notes], 3,
                           release=cfg['release'])
    got = ref.plain.allocate(notes, 3, cfg['release'])
    assert [[tuple(n) for n in v] for v in want] == got


def test_score_fit_first_steps():
    cfg = config('score', **SMALL_SCORE)
    traffic = dict(json.loads((BENCH / 'traffic' / 'fit_cutoff.json')
                              .read_text()), blocks=32)
    prog, ref = modules('score')
    system = prog.build(cfg, SEED, CPU, traffic)
    p0 = system.param()
    loss0, g0 = system.loss_grad()
    losses = system.fit(3, traffic['learning_rate'], True)
    p3 = system.param()
    want = ref.fit_reference(cfg, system.inputs, traffic, p0, [p3], CPU)
    assert list(p0) == list(g0) == ['cutoff'] and p0['cutoff'].shape == (1,)
    assert np.allclose(losses, want['losses'], rtol=1e-5)
    assert loss0 == pytest.approx(want['losses'][0], rel=1e-5)
    assert g0['cutoff'] == pytest.approx(want['grads'][0]['cutoff'],
                                         rel=2e-3)
    assert p3['cutoff'] - p0['cutoff'] == pytest.approx(
        want['params'][-1]['cutoff'] - p0['cutoff'], rel=1e-4)
