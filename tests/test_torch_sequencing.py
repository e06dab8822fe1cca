"""Sequenced polyphony against the JAX package: ``nodes.seq``,
``parallel.voices``, ``utils.midifile`` and ``PolyPatch(layout='vmap')``.

Every test of ``tests/test_seq.py`` and ``tests/test_voices.py`` has a
counterpart here that runs both packages on the same numbers (``TOL =
1e-5``, the reference tests' own); the voice allocator, the padded tracks
and the MIDI reader are held to the JAX package's output exactly.  The
compiled ``GateSeq`` / ``PitchSeq`` evaluate the sorted events instead of
the JAX package's literal ``(frames, C, E)`` comparison, a pitch counted
where the track does not loop and searched where it does, a gate searched:
the forms give the same bits on tracks with ties, pads, ``loop`` and
overlapping events, at frame times past 2**24 and on a grid's stride, under
``torch.func.vmap``, and gradients still reach ``values``; the card case
holds the benchmark's 64-voice score to it.

The vmap layout vmaps the one-voice plan over the voices
(``torch.func.vmap``); its mix is held to the channels layout, to the sum
of the solo voices' pull oracles and to the JAX package's vmap layout
within V x 1e-5 (1e-5 where the reference test uses it), through the mega,
delay-solver, segmented-scan and per-block plans, swept and streaming
filters.  Each kernel entry is called once per call site for all voices
(the plain calls counted, as many as the one-voice plan makes), no op falls
back to a per-voice loop, and a vmap-layout fit's gradient is within 1e-4
relative of the JAX package's.
"""

import importlib
import struct
import sys
import warnings

import numpy as np
import pytest
import torch

import signals_tpu_torch.compiler as TC
from signals_tpu_torch.compiler import kernels as K
from signals_tpu_torch.nodes.seq import gate_sorted, pitch_sorted

RATE = 44100
F = 256
F_SEQ = 512            # tests/test_seq.py's block size
TOL = 1e-5
PKGS = ('signals_tpu', 'signals_tpu_torch')


def mod(pkg, name):
    return importlib.import_module(f'{pkg}.{name}')


def fixed(pkg, value):
    f = mod(pkg, 'nodes.fixed').Fixed()
    f.get_state().value = np.atleast_2d(np.asarray(value, np.float32))
    return f


def pull(root, n_blocks, channels=1, pkg='signals_tpu_torch', frames=F):
    core = mod(pkg, 'core')
    out = []
    for i in range(n_blocks):
        loc = core.BlockLoc(position=i * frames, rate=RATE,
                            shape=core.Shape(frames, channels))
        b = root.respond(core.Request(requestor=None, port='t', loc=loc))
        out.append(np.broadcast_to(b, (frames, channels)))
    return np.concatenate(out)


def compile_port(root, channels=1, frames=F):
    return TC.compile_node(root, block_frames=frames, rate=RATE,
                           channels=channels, device='cpu')


def compile_jax(root, channels=1, frames=F):
    from signals_tpu.compiler import compile_node
    return compile_node(root, block_frames=frames, rate=RATE,
                        channels=channels)


def as_np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def poly_kw(pkg):
    return {'device': 'cpu'} if pkg == PKGS[1] else {}


@pytest.fixture(autouse=True)
def _fresh_caches():
    yield
    TC._compile_cache.clear()
    JC = sys.modules.get('signals_tpu.compiler')   # none on a card's host
    if JC is not None:
        JC._compile_cache.clear()


# --- GateSeq / PitchSeq ---------------------------------------------------------


def melody():
    # (start_s, dur_s, hertz)
    return [(0.00, 0.10, 220.0), (0.15, 0.10, 330.0), (0.30, 0.15, 440.0)]


@pytest.mark.parametrize('pkg', PKGS)
def test_gate_seq_activity(pkg):
    g = mod(pkg, 'nodes.seq').GateSeq()
    g.set_events([(e[0], e[1]) for e in melody()], rate=RATE)
    audio = pull(g, 45, pkg=pkg, frames=F_SEQ)[:, 0]
    assert audio[int(0.05 * RATE)] == 1.0
    assert audio[int(0.12 * RATE)] == 0.0
    assert audio[int(0.20 * RATE)] == 1.0
    assert audio[int(0.50 * RATE)] == 0.0
    assert set(np.unique(audio)) <= {0.0, 1.0}
    if pkg == PKGS[1]:
        got, _ = compile_port(g, frames=F_SEQ).render(n_blocks=45)
        assert np.array_equal(got.numpy()[:, 0], audio)


@pytest.mark.parametrize('pkg', PKGS)
def test_pitch_seq_sample_and_hold(pkg):
    p = mod(pkg, 'nodes.seq').PitchSeq()
    p.set_events(melody(), rate=RATE)
    audio = pull(p, 45, pkg=pkg, frames=F_SEQ)[:, 0]
    assert audio[int(0.05 * RATE)] == 220.0
    assert audio[int(0.12 * RATE)] == 220.0
    assert audio[int(0.20 * RATE)] == 330.0
    assert audio[int(0.40 * RATE)] == 440.0
    if pkg == PKGS[1]:
        got, _ = compile_port(p, frames=F_SEQ).render(n_blocks=45)
        assert np.array_equal(got.numpy()[:, 0], audio)


def looped_voice(pkg):
    seq = mod(pkg, 'nodes.seq')
    gate = seq.GateSeq()
    gate.set_events([(0.0, 0.05), (0.1, 0.05)], rate=RATE)
    gate.get_state().loop = int(0.2 * RATE)
    pitch = seq.PitchSeq()
    pitch.set_events(melody(), rate=RATE)
    pitch.get_state().loop = int(0.5 * RATE)
    osc = mod(pkg, 'nodes.osc').Sine()
    osc.hertz = pitch
    env = mod(pkg, 'nodes.env').ADSR()
    env.gate = gate
    st = env.get_state()
    st.attack, st.decay, st.sustain, st.release = 0.005, 0.02, 0.6, 0.03
    voiced = mod(pkg, 'nodes.fx').RingMod()
    voiced.left = osc
    voiced.right = env
    return voiced


def test_seq_parity_and_loop():
    audio, _ = compile_port(looped_voice(PKGS[1]),
                            frames=F_SEQ).render(n_blocks=90)
    audio = audio.numpy()
    oracle = pull(looped_voice(PKGS[1]), 90, frames=F_SEQ)
    assert np.abs(audio - oracle).max() <= TOL
    want, _ = compile_jax(looped_voice(PKGS[0]),
                          frames=F_SEQ).render(n_blocks=90)
    assert np.abs(audio - np.asarray(want)).max() <= TOL
    gate = mod(PKGS[1], 'nodes.seq').GateSeq()
    gate.set_events([(0.0, 0.05), (0.1, 0.05)], rate=RATE)
    gate.get_state().loop = int(0.2 * RATE)
    n = int(0.2 * RATE)
    g_audio, _ = compile_port(gate, frames=F_SEQ).render(n_blocks=45)
    g_audio = g_audio.numpy()[:, 0]
    assert np.array_equal(g_audio[:n], g_audio[n:2 * n])


def test_sequenced_patch_is_loop_free_and_seekable():
    seq = mod(PKGS[1], 'nodes.seq')
    gate = seq.GateSeq()
    gate.set_events([(0.0, 0.1), (0.2, 0.1)], rate=RATE)
    pitch = seq.PitchSeq()
    pitch.set_events(melody(), rate=RATE)
    osc = mod(PKGS[1], 'nodes.osc').Sine()
    osc.hertz = pitch
    env = mod(PKGS[1], 'nodes.env').ADSR()
    env.gate = gate
    voiced = mod(PKGS[1], 'nodes.fx').RingMod()
    voiced.left = osc
    voiced.right = env
    compiled = compile_port(voiced, frames=F_SEQ)
    assert not compiled.carry0
    full, _ = compiled.render(n_blocks=40)
    seeked, _ = compiled.render(position=20 * F_SEQ, n_blocks=10)
    assert torch.equal(seeked, full[20 * F_SEQ:30 * F_SEQ])


def literal_gate(starts, ends, n):
    """The JAX package's ``GateSeq`` kernel, ``(F, C, E)`` in numpy."""
    n = n[:, :, None]
    return ((n >= starts) & (n < ends)).astype(np.float32).max(axis=2)


def literal_pitch(starts, values, n):
    """The JAX package's ``PitchSeq`` kernel, ``(F, C, E)`` in numpy."""
    n = n[:, :, None]
    key = np.where(n >= starts, starts, np.float32(-np.inf))
    idx = np.argmax(key, axis=2)
    vals = np.broadcast_to(values, (idx.shape[0], *values.shape))
    return np.take_along_axis(vals, idx[:, :, None], axis=2)[:, :, 0]


def tricky_tracks():
    """Three rows: ties among starts (first index wins), pads at -1e9,
    overlapping and nested events, empty and inverted events, a start at
    -inf, the same start as the frame itself, unsorted order."""
    pad = -1e9
    starts = np.array([
        [100.0, 40.0, 100.0, 40.0, 300.0, pad, 250.0, 500.0],
        [pad, pad, 10.0, 10.0, 10.0, 700.0, 650.0, 650.0],
        [-np.inf, 200.0, 150.0, 200.0, 900.0, 30.0, 30.0, pad],
    ], dtype=np.float32)
    ends = np.array([
        [200.0, 120.0, 130.0, 40.0, 350.0, pad, 260.0, 480.0],
        [pad, pad, 60.0, 400.0, 20.0, 900.0, 700.0, 660.0],
        [50.0, 260.0, 210.0, 200.0, 1000.0, 31.0, 90.0, pad],
    ], dtype=np.float32)
    values = np.arange(24, dtype=np.float32).reshape(3, 8) * 10.0 + 100.0
    return starts, ends, values


@pytest.mark.parametrize('loop', [0, 333])
def test_sorted_form_equals_literal(loop):
    starts, ends, values = tricky_tracks()
    frames = np.arange(-20, 1300, dtype=np.int32)
    if loop:
        frames = np.mod(frames, np.int32(loop))
    n = frames.astype(np.float32)[:, None]
    g = gate_sorted(torch.from_numpy(starts), torch.from_numpy(ends),
                    torch.from_numpy(n))
    p = pitch_sorted(torch.from_numpy(starts), torch.from_numpy(values),
                     torch.from_numpy(n))
    assert np.array_equal(g.numpy(), literal_gate(starts, ends, n))
    assert np.array_equal(p.numpy(), literal_pitch(starts, values, n))
    assert set(np.unique(g.numpy())) == {0.0, 1.0}


def test_seq_nodes_sorted_render_equals_jax_literal():
    """The compiled nodes (sorted form) against the JAX package's compiled
    nodes (literal form) on the tricky tracks, looped: the same bits."""
    starts, ends, values = tricky_tracks()
    out = {}
    for pkg in PKGS:
        seq = mod(pkg, 'nodes.seq')
        g, p = seq.GateSeq(), seq.PitchSeq()
        for node in (g, p):
            st = node.get_state()
            st.starts, st.ends, st.loop = starts, ends, 1500
        p.get_state().values = values
        comp = compile_port if pkg == PKGS[1] else compile_jax
        out[pkg] = [as_np(comp(n, channels=3).render(n_blocks=9)[0])
                    for n in (g, p)]
    for a, b in zip(*out.values()):
        assert np.array_equal(a, b)


def test_pitch_sorted_gradient_reaches_values(monkeypatch):
    starts, _, values = tricky_tracks()
    n = np.arange(0, 1200, dtype=np.float32)[:, None]
    v = torch.from_numpy(values).requires_grad_()
    pitch_sorted(torch.from_numpy(starts), v, torch.from_numpy(n)).sum() \
        .backward()
    # each value's gradient counts the frames that hold it
    idx = literal_pitch(starts, np.arange(24, dtype=np.float32)
                        .reshape(3, 8) % 8, n).astype(int)
    want = np.zeros((3, 8), np.float32)
    for c in range(3):
        np.add.at(want[c], idx[:, c], 1.0)
    assert np.array_equal(v.grad.numpy(), want)
    # the counted form's gradient, with the starts counted densely (this
    # short window) and by tiles and runs (a long one's way, forced): the
    # searched form's bits, under integer cotangents too (their sums are
    # exact in either order)
    seq = mod(PKGS[1], 'nodes.seq')
    w = torch.from_numpy(np.random.default_rng(3).integers(
        -4, 5, (1200, 3)).astype(np.float32))

    def grads(ascending):
        out = []
        for cot in (None, w):
            v.grad = None
            p = pitch_sorted(torch.from_numpy(starts), v, torch.from_numpy(n),
                             ascending=ascending)
            (p.sum() if cot is None else (p * cot).sum()).backward()
            out.append(v.grad.clone())
        return out
    searched = grads(False)
    assert torch.equal(searched[0], torch.from_numpy(want))
    for dense in (seq._DENSE, 0):
        monkeypatch.setattr(seq, '_DENSE', dense)
        for got, exp in zip(grads(True), searched):
            assert torch.equal(got, exp)


#: window offsets of the counted lookup's tests: from 2**24 on, float32
#: frame times tie (consecutive frames round to one value)
WINDOW_OFFSETS = (0, 1000, 2 ** 24 - 50, 2 ** 24 + 7, 3 * 2 ** 24)


def shifted_tricky_tracks(offset, stride):
    """:func:`tricky_tracks` on frames ``offset + stride * i`` (the pads and
    -inf stay)."""
    starts, ends, values = tricky_tracks()

    def move(a):
        return np.where(np.abs(a) < 1e8, a * stride + offset,
                        a).astype(np.float32)
    return move(starts), move(ends), values


def random_tracks(rng, offset, span):
    """Three rows of ten events about a window ``span`` frames wide at
    ``offset``: starts before, inside and after it, tied starts, a pad at
    -1e9, a start at -inf and a NaN one, empty and inverted events."""
    starts = offset + rng.integers(-span // 2, span + span // 2,
                                   (3, 10)).astype(np.float64)
    starts[:, 1] = starts[:, 4]
    starts[0, 2], starts[1, 3], starts[2, 5] = -1e9, -np.inf, np.nan
    ends = starts + rng.integers(-span // 8, span // 2, (3, 10))
    values = rng.standard_normal((3, 10))
    return (starts.astype(np.float32), ends.astype(np.float32),
            values.astype(np.float32))


@pytest.mark.parametrize('stride', [1, 7])
@pytest.mark.parametrize('offset', WINDOW_OFFSETS)
@pytest.mark.parametrize('tracks', ['tricky', 'random'])
@pytest.mark.parametrize('count', ['dense', 'tiled'])
def test_counted_lookup_equals_searched_and_literal(count, tracks, offset,
                                                    stride, monkeypatch):
    """A pitch track read at frame times that never decrease (one that
    does not loop) is counted, not searched: the same bits as the searched
    form and the JAX package's literal form, where float32 frame times tie
    (past 2**24) and on a grid's stride, with the starts counted densely (a
    short window) or by tiles and runs (a long one); the searched gate
    holds to the literal form there too; 20 random track sets a case."""
    seq = mod(PKGS[1], 'nodes.seq')
    if count == 'tiled':
        monkeypatch.setattr(seq, '_DENSE', 0)
    frames = offset + stride * np.arange(-20, 1300, dtype=np.int64)
    n = frames.astype(np.float32)[:, None]
    rng = np.random.default_rng([offset, stride])
    sets = ([shifted_tricky_tracks(offset, stride)] if tracks == 'tricky'
            else [random_tracks(rng, offset, 1320 * stride)
                  for _ in range(20)])
    t = torch.from_numpy
    seq.reset_lookup_counts()
    for starts, ends, values in sets:
        gate = gate_sorted(t(starts), t(ends), t(n))
        pitch = [pitch_sorted(t(starts), t(values), t(n), ascending=a)
                 for a in (True, False)]
        assert torch.equal(pitch[0], pitch[1])
        with np.errstate(invalid='ignore'):
            assert np.array_equal(gate.numpy(), literal_gate(starts, ends, n))
            assert np.array_equal(pitch[0].numpy(),
                                  literal_pitch(starts, values, n))
    assert seq.LOOKUPS == {'counted': len(sets), 'searched': 2 * len(sets)}


@pytest.mark.parametrize('loop', [0, 333])
@pytest.mark.parametrize('kind', ['GateSeq', 'PitchSeq'])
def test_looped_track_is_searched(kind, loop):
    """The compiled ``PitchSeq`` counts when its track does not loop and
    searches when it does (the frame times wrap); the ``GateSeq`` searches
    either way: one lookup a render, the literal form's bits."""
    seq = mod(PKGS[1], 'nodes.seq')
    starts, ends, values = tricky_tracks()
    node = getattr(seq, kind)()
    st = node.get_state()
    st.starts, st.ends, st.loop = starts, ends, loop
    if kind == 'PitchSeq':
        st.values = values
    compiled = compile_port(node, channels=3)
    seq.reset_lookup_counts()
    got, _ = compiled.render(n_blocks=6)
    counted = int(kind == 'PitchSeq' and not loop)
    assert seq.LOOKUPS == {'counted': counted, 'searched': 1 - counted}
    frames = np.arange(6 * F)
    if loop:
        frames = frames % loop
    n = frames.astype(np.float32)[:, None]
    want = (literal_gate(starts, ends, n) if kind == 'GateSeq'
            else literal_pitch(starts, values, n))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize('over', ['voices', 'blocks'])
@pytest.mark.parametrize('count', ['dense', 'tiled'])
def test_counted_lookup_under_vmap(count, over, monkeypatch):
    """Both pitch forms, and the gate, under ``torch.func.vmap``, over the
    voices' tracks (the vmap layout: the frame times shared) or over the
    blocks' frame times (the stateless plan: the tracks shared), with no
    fallback to a per-voice loop: the same bits, and the vmap layout's the
    channels layout's."""
    if count == 'tiled':
        monkeypatch.setattr(mod(PKGS[1], 'nodes.seq'), '_DENSE', 0)
    rng = np.random.default_rng(5)
    V, E, nf = 8, 12, 5000
    starts = rng.integers(-500, 6500, (V, 1, E)).astype(np.float32)
    starts[:, 0, 3] = starts[:, 0, 7]
    ends = starts + rng.integers(-5, 900, (V, 1, E)).astype(np.float32)
    values = rng.standard_normal((V, 1, E)).astype(np.float32)
    starts, ends, values = map(torch.from_numpy, (starts, ends, values))
    n = torch.arange(1000, 1000 + nf, dtype=torch.float32)[:, None]
    out = {}
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings('error', message='.*performance drop.*')
            for a in (True, False):
                if over == 'voices':
                    out[a] = (torch.func.vmap(lambda s, e: gate_sorted(
                                  s, e, n))(starts, ends),
                              torch.func.vmap(lambda s, v: pitch_sorted(
                                  s, v, n, ascending=a))(starts, values))
                else:
                    blocks = n.reshape(8, -1, 1)
                    out[a] = (torch.func.vmap(lambda m: gate_sorted(
                                  starts[:, 0], ends[:, 0], m))(blocks),
                              torch.func.vmap(lambda m: pitch_sorted(
                                  starts[:, 0], values[:, 0], m,
                                  ascending=a))(blocks))
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    for got, want in zip(out[True], out[False]):
        assert torch.equal(got, want)
    if over == 'voices':
        chan = (gate_sorted(starts[:, 0], ends[:, 0], n),
                pitch_sorted(starts[:, 0], values[:, 0], n, ascending=True))
        for got, want in zip(out[True], chan):
            assert torch.equal(got[:, :, 0].T, want)


def score_of(device, **sizes):
    """The benchmark's ``score`` configuration (sizes changed by
    ``sizes``), built by its ``build`` from a seed."""
    import json
    from benchmark.lib import harness
    score = harness.load_file(harness.BENCH / 'configs' / 'score.py')
    cfg = json.loads((harness.BENCH / 'configs' / 'score.json').read_text())
    cfg.update(sizes)
    return score.build(cfg, 2 ** 31 + 11, device,
                       {'kind': 'render', 'blocks': 8})


@pytest.mark.parametrize('layout', ['vmap', 'channels'])
def test_score_render_counts_its_lookups(layout, monkeypatch):
    """The benchmark's score voice at a tiny size: of its four lookups a
    render, the pitch track's two at block rate (one sample, and the
    blocks' grid) and the velocity's at every frame are counted, the
    gate's on the ADSR's grid searched, and the render is the searched
    form's bit for bit."""
    seq = mod(PKGS[1], 'nodes.seq')
    sc = score_of('cpu', voices=4, score_seconds=2.0, melody_notes=8,
                  chords=2, layout=layout)
    seq.reset_lookup_counts()
    counted = sc.render(0, 8)
    assert seq.LOOKUPS == {'counted': 3, 'searched': 1}
    force_searched(monkeypatch)
    seq.reset_lookup_counts()
    searched = sc.render(0, 8)
    assert seq.LOOKUPS == {'counted': 0, 'searched': 4}
    assert torch.equal(counted, searched)


def force_searched(monkeypatch):
    """Every compiled ``PitchSeq`` searched, looped or not."""
    seq = mod(PKGS[1], 'nodes.seq')
    pitch = seq.pitch_sorted
    monkeypatch.setattr(seq, 'pitch_sorted', lambda s, v, n, ascending:
                        pitch(s, v, n, ascending=False))


@pytest.mark.cuda
def test_cuda_score_render_counted_equals_searched(monkeypatch):
    """The benchmark's 64-voice score over its 2584 blocks on the card: the
    counted lookups give the searched form's render bit for bit, and the
    velocity lookup (every frame of every voice) makes no synchronizing
    call."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    seq = mod(PKGS[1], 'nodes.seq')
    sc = score_of('cuda')
    nb = 2584
    counted = sc.render(0, nb)
    vel = sc.poly.compiled.root.right.sig
    assert isinstance(vel, seq.PitchSeq)
    params, _ = sc.poly.params()
    leaf = params[sc.poly.compiled.index.info(vel).uid]
    n = torch.arange(nb * 1024, dtype=torch.int32,
                     device='cuda').to(torch.float32)[:, None]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        torch.func.vmap(lambda s, v: seq.pitch_sorted(
            s, v, n, ascending=True))(leaf['starts'], leaf['values'])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    force_searched(monkeypatch)
    seq.reset_lookup_counts()
    searched = sc.render(0, nb)
    assert seq.LOOKUPS == {'counted': 0, 'searched': 4}
    assert torch.equal(counted, searched)


def test_multichannel_seq_tracks_pull_vs_compiled():
    seq = mod(PKGS[1], 'nodes.seq')
    g = seq.GateSeq()
    st = g.get_state()
    st.starts = np.array([[0.0, 2000.0], [500.0, -1e9]], dtype=np.float32)
    st.ends = np.array([[400.0, 2400.0], [900.0, -1e9]], dtype=np.float32)
    assert g.channels == 2
    ref = pull(g, 12, channels=2)
    got, _ = compile_port(g, channels=2).render(n_blocks=12)
    assert np.array_equal(got.numpy(), ref)
    assert ref[100, 0] == 1.0 and ref[100, 1] == 0.0
    assert ref[600, 0] == 0.0 and ref[600, 1] == 1.0

    p = seq.PitchSeq()
    st = p.get_state()
    st.starts = np.array([[0.0, 1000.0], [-1e9, 500.0]], dtype=np.float32)
    st.ends = np.array([[400.0, 1400.0], [-1e9, 900.0]], dtype=np.float32)
    st.values = np.array([[220.0, 330.0], [110.0, 440.0]], dtype=np.float32)
    ref = pull(p, 12, channels=2)
    got, _ = compile_port(p, channels=2).render(n_blocks=12)
    assert np.array_equal(got.numpy(), ref)
    assert ref[100, 0] == 220.0 and ref[100, 1] == 110.0
    assert ref[1200, 0] == 330.0 and ref[700, 1] == 440.0


# --- voices: allocation and tracks ---------------------------------------------


def notes_of(pkg, rows):
    Note = mod(pkg, 'parallel.voices').Note
    return [Note(*r) for r in rows]


def allocate_both(rows, n_voices, **kw):
    out = []
    for pkg in PKGS:
        voices = mod(pkg, 'parallel.voices').allocate_voices(
            notes_of(pkg, rows), n_voices, **kw)
        out.append([[tuple(n) for n in v] for v in voices])
    assert out[0] == out[1]
    return out[1]


def test_chord_spreads_over_voices():
    voices = allocate_both([(0.0, 1.0, hz) for hz in (220.0, 330.0, 440.0)],
                           4)
    non_empty = [v for v in voices if v]
    assert len(non_empty) == 3
    assert sorted(v[0][2] for v in non_empty) == [220.0, 330.0, 440.0]


def test_sequential_notes_respect_release_tail():
    rows = [(0.0, 0.1, 220.0), (0.15, 0.1, 330.0)]
    assert [len(v) for v in allocate_both(rows, 2)] == [2, 0]
    assert [len(v) for v in allocate_both(rows, 2, release=0.1)] == [1, 1]


def test_stealing_clips_the_held_note():
    voices = allocate_both([(0.0, 1.0, 220.0), (0.1, 1.0, 330.0),
                            (0.2, 0.5, 440.0)], 2)
    stolen = voices[0][0]
    assert stolen[2] == 220.0
    assert stolen[0] + stolen[1] == pytest.approx(0.2)
    assert voices[0][1][2] == 440.0


def test_bad_inputs():
    V = mod(PKGS[1], 'parallel.voices')
    with pytest.raises(ValueError):
        V.allocate_voices([V.Note(0.0, 0.0, 220.0)], 2)
    with pytest.raises(ValueError):
        V.allocate_voices([], 0)


def test_score_tracks_match_jax():
    rows = [[(0.0, 0.1, 220.0, 0.5), (0.2, 0.1, 330.0)],
            [(0.05, 0.1, 440.0)], []]
    tracks = [mod(pkg, 'parallel.voices').score_tracks(
        [notes_of(pkg, v) for v in rows], rate=RATE) for pkg in PKGS]
    for k in ('starts', 'ends', 'values', 'velocities'):
        assert tracks[0][k].dtype == tracks[1][k].dtype == np.float32
        assert np.array_equal(tracks[0][k], tracks[1][k])
    tr = tracks[1]
    assert tr['starts'].shape == (3, 1, 2)
    assert tr['starts'][1, 0, 1] == tr['ends'][1, 0, 1] == -1e9
    assert tr['values'][1, 0, 1] == 440.0
    assert (tr['values'][2] == 0.0).all()


# --- voices: end to end ----------------------------------------------------------


def mono_synth(pkg):
    seq = mod(pkg, 'nodes.seq')
    gate, pitch = seq.GateSeq(), seq.PitchSeq()
    osc = mod(pkg, 'nodes.osc').Sine()
    osc.hertz = pitch
    env = mod(pkg, 'nodes.env').ADSR()
    env.gate = gate
    st = env.get_state()
    st.attack, st.decay, st.sustain, st.release = 0.002, 0.01, 0.8, 0.01
    out = mod(pkg, 'nodes.fx').RingMod()
    out.left = osc
    out.right = env
    return out, gate, pitch


CHORD_MELODY = [(0.00, 0.28, 220.0), (0.00, 0.08, 660.0),
                (0.12, 0.08, 880.0)]


def sequenced(pkg, rows, n_voices, *, layout='vmap', velocity=False,
              build=mono_synth, **kw):
    root, gate, pitch = build(pkg)
    vel = None
    if velocity:
        vel = mod(pkg, 'nodes.seq').PitchSeq()
        amp = mod(pkg, 'nodes.fx').RingMod()
        amp.left = root
        amp.right = vel
        root = amp
    return mod(pkg, 'parallel.voices').sequenced_poly(
        root, gate=gate, pitch=pitch, velocity=vel,
        notes=notes_of(pkg, rows), n_voices=n_voices, rate=RATE,
        block_frames=F, channels=1, layout=layout, **kw, **poly_kw(pkg))


def test_sequenced_poly_plays_a_chord_and_a_melody():
    poly = sequenced(PKGS[1], CHORD_MELODY, 3)
    assert poly.layout == 'vmap'
    n_blocks = int(0.3 * RATE) // F
    audio, _ = poly.render(n_blocks=n_blocks)
    audio = audio.numpy()
    want, _ = sequenced(PKGS[0], CHORD_MELODY, 3).render(n_blocks=n_blocks)
    assert np.abs(audio - np.asarray(want)).max() <= 3 * TOL
    seg = audio[:int(0.08 * RATE), 0]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    freqs = np.fft.rfftfreq(len(seg), 1 / RATE)
    floor = spec.mean()
    for hz in (220.0, 660.0):
        assert spec[np.abs(freqs - hz) < 30].max() > 10 * floor
    seg2 = audio[int(0.13 * RATE):int(0.19 * RATE), 0]
    spec2 = np.abs(np.fft.rfft(seg2 * np.hanning(len(seg2))))
    freqs2 = np.fft.rfftfreq(len(seg2), 1 / RATE)
    assert spec2[np.abs(freqs2 - 880.0) < 40].max() > 10 * spec2.mean()
    assert np.abs(audio[int(0.295 * RATE):]).max() < 1e-3


def test_sequenced_poly_velocity_track():
    rows = [(0.00, 0.1, 440.0, 1.0), (0.15, 0.1, 440.0, 0.25)]
    poly = sequenced(PKGS[1], rows, 2, velocity=True)
    audio, _ = poly.render(n_blocks=int(0.3 * RATE) // F)
    audio = audio.numpy()
    loud = np.abs(audio[int(0.03 * RATE):int(0.09 * RATE)]).max()
    quiet = np.abs(audio[int(0.18 * RATE):int(0.24 * RATE)]).max()
    assert quiet == pytest.approx(loud * 0.25, rel=0.1)
    want, _ = sequenced(PKGS[0], rows, 2, velocity=True).render(
        n_blocks=int(0.3 * RATE) // F)
    assert np.abs(audio - np.asarray(want)).max() <= 2 * TOL


def test_sequenced_poly_channels_layout_matches_vmap():
    """Both layouts in both packages on the reference test's score."""
    n_blocks = int(0.3 * RATE) // F
    audio = {}
    for pkg in PKGS:
        for layout in ('vmap', 'channels'):
            poly = sequenced(pkg, CHORD_MELODY, 3, layout=layout)
            audio[pkg, layout] = as_np(poly.render(n_blocks=n_blocks)[0])
    ref = audio[PKGS[0], 'vmap']
    for k, a in audio.items():
        assert a.shape == ref.shape
        assert np.abs(a - ref).max() <= TOL, k


# --- MIDI files --------------------------------------------------------------------


def _varlen(v):
    out = [v & 0x7F]
    v >>= 7
    while v:
        out.append(0x80 | (v & 0x7F))
        v >>= 7
    return bytes(reversed(out))


def _track_chunk(events):
    body = b''.join(_varlen(d) + e for d, e in events)
    body += _varlen(0) + b'\xff\x2f\x00'
    return b'MTrk' + struct.pack('>I', len(body)) + body


def _smf(tracks, *, fmt=1, tpq=480):
    head = b'MThd' + struct.pack('>IHHH', 6, fmt, len(tracks), tpq)
    return head + b''.join(tracks)


def read_both(path, **kw):
    notes = [mod(pkg, 'utils.midifile').read_midi(path, **kw)
             for pkg in PKGS]
    assert [tuple(n) for n in notes[0]] == [tuple(n) for n in notes[1]]
    return notes[1]


def test_read_midi_basic(tmp_path):
    trk = _track_chunk([(0, b'\x90\x45\x64'), (480, b'\x80\x45\x00'),
                        (240, b'\x90\x40\x50'), (240, b'\x40\x00')])
    path = tmp_path / 't.mid'
    path.write_bytes(_smf([trk], fmt=0))
    notes = read_both(path)
    assert len(notes) == 2
    assert notes[0].hz == pytest.approx(440.0)
    assert notes[0].dur == pytest.approx(0.5)
    assert notes[0].velocity == pytest.approx(100 / 127)
    V = mod(PKGS[1], 'parallel.voices')
    assert notes[1].hz == pytest.approx(V.midi_to_hz(0x40))
    assert notes[1].start == pytest.approx(0.75)
    assert notes[1].dur == pytest.approx(0.25)


def test_read_midi_tempo_map_across_tracks(tmp_path):
    tempo = _track_chunk([
        (0, b'\xff\x51\x03' + (250000).to_bytes(3, 'big')),
        (960, b'\xff\x51\x03' + (500000).to_bytes(3, 'big'))])
    melody_trk = _track_chunk([(480, b'\x90\x45\x7f'),
                               (960, b'\x80\x45\x00')])
    path = tmp_path / 'tempo.mid'
    path.write_bytes(_smf([tempo, melody_trk]))
    (note,) = read_both(path)
    assert note.start == pytest.approx(0.25)
    assert note.dur == pytest.approx(0.25 + 0.5)


def test_read_midi_hanging_note_and_channel_filter(tmp_path):
    trk = _track_chunk([(0, b'\x90\x45\x40'), (0, b'\x99\x24\x40'),
                        (480, b'\x89\x24\x00')])
    path = tmp_path / 'h.mid'
    path.write_bytes(_smf([trk], fmt=0))
    assert len(read_both(path)) == 2
    melodic = read_both(path, include_channels={0})
    assert len(melodic) == 1
    assert melodic[0].dur == pytest.approx(0.5)


def test_read_midi_rejects_garbage(tmp_path):
    path = tmp_path / 'bad.mid'
    path.write_bytes(b'RIFFxxxx')
    with pytest.raises(mod(PKGS[1], 'utils.midifile').BadMidiFile):
        mod(PKGS[1], 'utils.midifile').read_midi(path)


def test_midi_to_sequenced_poly_roundtrip(tmp_path):
    trk = _track_chunk([(0, b'\x90\x45\x7f'), (0, b'\x90\x4c\x7f'),
                        (480, b'\x80\x45\x00'), (0, b'\x80\x4c\x00')])
    path = tmp_path / 'chord.mid'
    path.write_bytes(_smf([trk], fmt=0))
    rows = [tuple(n) for n in read_both(path)]
    n_blocks = int(0.5 * RATE) // F
    audio, _ = sequenced(PKGS[1], rows, 4).render(n_blocks=n_blocks)
    audio = audio.numpy()
    want, _ = sequenced(PKGS[0], rows, 4).render(n_blocks=n_blocks)
    assert np.abs(audio - np.asarray(want)).max() <= 4 * TOL
    seg = audio[:int(0.4 * RATE), 0]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    freqs = np.fft.rfftfreq(len(seg), 1 / RATE)
    V = mod(PKGS[1], 'parallel.voices')
    for hz in (440.0, V.midi_to_hz(0x4c)):
        assert spec[np.abs(freqs - hz) < 20].max() > 10 * spec.mean()


# --- PolyPatch(layout='vmap') ------------------------------------------------------


def subtractive(pkg, cut=2000.0, swept=False, streaming=False):
    """saw (per-voice pitch) -> LowPass -> gain 1/8; the cutoff a Fixed,
    or (``swept``) a 0.5 Hz LFO around it; ``streaming``: an exact IIR."""
    fx = mod(pkg, 'nodes.fx')
    hz = fixed(pkg, 110.0)
    saw = mod(pkg, 'nodes.osc').Sawtooth()
    saw.hertz = hz
    lp = fx.LowPass()
    lp.input = saw
    if swept:
        lfo = mod(pkg, 'nodes.osc').Sine()
        lfo.hertz = fixed(pkg, 0.5)
        dep = fx.Gain()
        dep.left = lfo
        dep.right = fixed(pkg, 900.0)
        c = fx.Mix()
        c.left = dep
        c.right = fixed(pkg, 2 * cut)
        c.mix = fixed(pkg, 0.5)
        lp.cutoff = c
        lp.get_state().context = 512
    else:
        lp.cutoff = fixed(pkg, cut)
    lp.get_state().streaming = streaming
    g = fx.Gain()
    g.left = lp
    g.right = fixed(pkg, 1.0 / 8)
    return g, hz


def poly_of(pkg, root, overrides, n_voices, layout='vmap', frames=F):
    return mod(pkg, 'parallel').PolyPatch(
        root, n_voices=n_voices, overrides=overrides, block_frames=frames,
        rate=RATE, channels=1, layout=layout, **poly_kw(pkg))


FREQS = np.array([110.0, 220.0, 330.0, 440.0], dtype=np.float32)


def test_vmap_poly_equals_sum_of_solo_voices():
    root, hz = subtractive(PKGS[1])
    poly = poly_of(PKGS[1], root, {(hz, 'value'): FREQS}, 4)
    audio, _ = poly.render(n_blocks=6)
    total = np.zeros((6 * F, 1), np.float32)
    for f in FREQS:
        solo, solo_hz = subtractive(PKGS[1])
        solo_hz.get_state().value = np.array([[f]], dtype=np.float32)
        total += pull(solo, 6)
    assert np.abs(audio.numpy() - total).max() <= TOL
    # the live node keeps its one-voice state in this layout
    assert hz.get_state().value.shape == (1, 1)


def test_vmap_default_layout_is_channels_without_a_mesh():
    root, hz = subtractive(PKGS[1])
    poly = mod(PKGS[1], 'parallel').PolyPatch(
        root, n_voices=4, overrides={(hz, 'value'): FREQS}, block_frames=F,
        rate=RATE, device='cpu')
    assert poly.layout == 'channels'


@pytest.mark.parametrize('case', ['static', 'swept', 'streaming',
                                  'streaming_swept', 'blocks'])
def test_vmap_layout_matches_channels_and_jax(case, monkeypatch):
    """The mix of the vmap layout against the channels layout and the JAX
    package's vmap layout (V x 1e-5), through the plan the one-voice patch
    picks; each kernel entry is called as often as the one-voice patch's
    plan calls it (once for all voices), and nothing falls back to a
    per-voice loop."""
    swept = 'swept' in case
    streaming = 'streaming' in case
    V, nb = 4, 16
    if swept:
        monkeypatch.setattr(TC.filters, 'SEG_SOURCE_GEN', True)

    def build(pkg):
        return subtractive(pkg, swept=swept, streaming=streaming)

    counted = {name: [] for name in ('sosfilt_segments_gen_plain',
                                     'sosfilt_segments_plain',
                                     'sosfilt_batch_plain',
                                     'sosfilt_timeline_plain',
                                     'sosfilt_stream_plain')}

    def count(name):
        orig = getattr(K, name)

        def wrapped(*a, **k):
            counted[name].append(1)
            return orig(*a, **k)
        monkeypatch.setattr(K, name, wrapped)

    for name in counted:
        count(name)
    frames = 1024 if swept else F          # swept carry needs F = 1024
    solo, _ = build(PKGS[1])
    one = TC.compile_node(solo, block_frames=frames, rate=RATE, channels=1,
                          device='cpu')
    if case == 'blocks':
        one.enable_mega = False
    plan = one.plan(nb)
    one.render(n_blocks=nb)
    solo_calls = {k: len(v) for k, v in counted.items()}
    for v in counted.values():
        v.clear()
    TC._compile_cache.clear()

    root, hz = build(PKGS[1])
    poly = poly_of(PKGS[1], root, {(hz, 'value'): FREQS}, V, frames=frames)
    if case == 'blocks':
        poly.compiled.enable_mega = False
        poly.compiled._render_cache.clear()
    assert poly.compiled.plan(nb) == plan
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings('error', message='.*performance drop.*')
            got, carry = poly.render(n_blocks=nb)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    assert {k: len(v) for k, v in counted.items()} == solo_calls
    assert sum(solo_calls.values()) >= 1
    got = got.numpy()
    if streaming:
        leaf = next(iter(next(iter(carry.values())).values()))
        assert leaf.shape[0] == V

    root_c, hz_c = build(PKGS[1])
    chan = poly_of(PKGS[1], root_c, {(hz_c, 'value'): FREQS}, V,
                   layout='channels', frames=frames)
    want_c, _ = chan.render(n_blocks=nb)
    assert np.abs(got - want_c.numpy()).max() <= V * TOL
    if not swept:                  # the JAX vmap layout at F = 1024 is slow
        root_j, hz_j = build(PKGS[0])
        jp = poly_of(PKGS[0], root_j, {(hz_j, 'value'): FREQS}, V,
                     frames=frames)
        want_j, _ = jp.render(n_blocks=nb)
        assert np.abs(got - np.asarray(want_j)).max() <= V * TOL


def test_vmap_poly_carry_resumable():
    root, hz = subtractive(PKGS[1], streaming=True)
    freqs = np.linspace(100, 400, 8).astype(np.float32)
    poly = poly_of(PKGS[1], root, {(hz, 'value'): freqs}, 8)
    full, _ = poly.render(n_blocks=8)
    a, carry = poly.render(n_blocks=4)
    b, _ = poly.render(position=4 * F, n_blocks=4, carry=carry)
    assert float((torch.cat([a, b]) - full).abs().max()) <= 1e-6


def test_vmap_carry_from_jax_continues_on_the_port():
    """A vmap-layout render begun in the JAX package continues on the port
    from its stacked ``(V, ...)`` carry, with its params replayed."""
    from signals_tpu_torch.interop import carry_from_jax, params_from_jax
    freqs = np.linspace(100, 400, 4).astype(np.float32)
    root_j, hz_j = subtractive(PKGS[0], streaming=True)
    jp = poly_of(PKGS[0], root_j, {(hz_j, 'value'): freqs}, 4)
    ja, jcarry = jp.render(n_blocks=4)
    leaf = next(iter(next(iter(jcarry.values())).values()))
    assert np.asarray(leaf).shape[0] == 4
    root, hz = subtractive(PKGS[1], streaming=True)
    poly = poly_of(PKGS[1], root, {(hz, 'value'): freqs}, 4)
    full, _ = poly.render(n_blocks=8)
    b, _ = poly.render(position=4 * F, n_blocks=4,
                       params=params_from_jax(jp.params()[0], 'cpu'),
                       carry=carry_from_jax(jcarry, 'cpu'))
    got = np.concatenate([np.asarray(ja), b.numpy()])
    assert np.abs(got - full.numpy()).max() <= 4 * TOL


def test_vmap_params_replay_jax_stacked_leaves():
    from signals_tpu_torch.interop import params_from_jax
    root_j, hz_j = subtractive(PKGS[0])
    jp = poly_of(PKGS[0], root_j, {(hz_j, 'value'): FREQS}, 4)
    jparams, jaxes = jp.params()
    root, hz = subtractive(PKGS[1])
    poly = poly_of(PKGS[1], root, {(hz, 'value'): FREQS}, 4)
    params, axes = poly.params()
    assert axes == jaxes
    replay = params_from_jax(jparams, 'cpu')
    for uid, leaves in params.items():
        for k, v in leaves.items():
            assert replay[uid][k].shape == v.shape
            assert torch.equal(replay[uid][k], v)
    a, _ = poly.render(n_blocks=4, params=replay)
    b, _ = poly.render(n_blocks=4)
    assert torch.equal(a, b)


def test_vmap_override_validation_and_set_override():
    root, hz = subtractive(PKGS[1])
    with pytest.raises(ValueError):
        poly_of(PKGS[1], root, {(hz, 'value'): np.zeros(3)}, 4)
    poly = poly_of(PKGS[1], root, {(hz, 'value'): FREQS}, 4)
    a, _ = poly.render(n_blocks=4)
    poly.set_override(hz, 'value', FREQS[::-1].copy())
    b, _ = poly.render(n_blocks=4)
    # the same voices, reordered: the voice sum associates differently
    assert float((a - b).abs().max()) <= 1e-6
    poly.set_override(hz, 'value', FREQS * 2)
    c, _ = poly.render(n_blocks=4)
    assert float((a - c).abs().max()) > 1e-3
    with pytest.raises(KeyError):
        poly.set_override(root, 'value', FREQS)


def test_vmap_stateful_voices():
    """Per-voice envelopes: gates at different rates stay independent."""
    def build(pkg):
        gate = mod(pkg, 'nodes.osc').Square()
        gate.hertz = fixed(pkg, 2.0)
        env = mod(pkg, 'nodes.env').ADSR()
        env.gate = gate
        carrier = mod(pkg, 'nodes.osc').Sine()
        carrier.hertz = fixed(pkg, 220.0)
        g = mod(pkg, 'nodes.fx').Gain()
        g.left = carrier
        g.right = env
        return g, gate.hertz.sig

    rates = np.array([1.0, 2.0, 4.0, 8.0], dtype=np.float32)
    out = []
    for pkg in PKGS:
        root, gh = build(pkg)
        out.append(as_np(poly_of(pkg, root, {(gh, 'value'): rates}, 4)
                         .render(n_blocks=10)[0]))
    assert np.isfinite(out[1]).all() and np.abs(out[1]).max() > 0
    assert np.abs(out[0] - out[1]).max() <= 4 * TOL


def echo_voice(pkg, channels=1, saturate=False):
    """saw -> Mix with a feedback Delay of 2 (5 when saturated) blocks."""
    fx = mod(pkg, 'nodes.fx')
    hz = fixed(pkg, 110.0)
    saw = mod(pkg, 'nodes.osc').Sawtooth()
    saw.hertz = hz
    mix = fx.Mix()
    d = mod(pkg, 'nodes.delay').Delay()
    d.get_state().channels = channels
    d.get_state().frames = (5 if saturate else 2) * F
    fb = fx.Gain()
    if saturate:
        sh = fx.Drive()
        sh.input = d
        sh.drive = fixed(pkg, 2.0)
        fb.left = sh
    else:
        fb.left = d
    fb.right = fixed(pkg, 0.5 if saturate else 0.4)
    mix.left = saw
    mix.right = fb
    mix.mix = fixed(pkg, 0.5 if saturate else 0.6)
    d.input = mix
    g = fx.Gain()
    g.left = mix
    g.right = fixed(pkg, 0.25)
    return g, hz


@pytest.mark.parametrize('saturate', [False, True],
                         ids=['delay_mega', 'segment_scan'])
def test_vmap_feedback_voices(saturate):
    """Feedback-echo voices: the one-voice patch's delay solver (or its
    segmented scan for a saturated loop) vmapped over the voices, against
    the forced per-block loop, the channels layout and the JAX package's
    vmap layout."""
    V, nb = 4, 20
    root, hz = echo_voice(PKGS[1], saturate=saturate)
    poly = poly_of(PKGS[1], root, {(hz, 'value'): FREQS}, V)
    assert poly.compiled.plan(nb) == ('segment_scan' if saturate
                                      else 'delay_mega')
    got, carry = poly.render(n_blocks=nb)
    assert next(iter(carry.values()))['buf'].shape[0] == V
    TC._compile_cache.clear()
    root2, hz2 = echo_voice(PKGS[1], saturate=saturate)
    ref = poly_of(PKGS[1], root2, {(hz2, 'value'): FREQS}, V)
    ref.compiled.enable_mega = False
    ref.compiled._render_cache.clear()
    want, _ = ref.render(n_blocks=nb)
    assert float((got - want).abs().max()) <= 1e-6
    TC._compile_cache.clear()
    root3, hz3 = echo_voice(PKGS[1], channels=V, saturate=saturate)
    chan = poly_of(PKGS[1], root3, {(hz3, 'value'): FREQS}, V,
                   layout='channels')
    want_c, _ = chan.render(n_blocks=nb)
    assert float((got - want_c).abs().max()) <= V * TOL
    root_j, hz_j = echo_voice(PKGS[0], saturate=saturate)
    want_j, _ = poly_of(PKGS[0], root_j, {(hz_j, 'value'): FREQS},
                        V).render(n_blocks=nb)
    assert np.abs(got.numpy() - np.asarray(want_j)).max() <= V * TOL


def test_vmap_refuses_a_reverb():
    """A ``Reverb`` under ``layout='vmap'`` renders (no refusal remains):
    the voices fold into the FDN kernel's lanes, within V x 1e-5 of the
    channels layout and of the JAX package's vmap layout."""
    nb, V = 16, 4

    def reverb_voice(pkg):
        root, hz = subtractive(pkg)
        rv = mod(pkg, 'nodes.reverb').Reverb()
        rv.input = root
        rv.get_state().t60 = 0.7
        return rv, hz

    rv, hz = reverb_voice(PKGS[1])
    got, carry = poly_of(PKGS[1], rv, {(hz, 'value'): FREQS}, V).render(
        n_blocks=nb)
    assert carry and all(
        v.shape[0] == V for c in carry.values() for v in c.values())
    rv, hz = reverb_voice(PKGS[1])
    want_c, _ = poly_of(PKGS[1], rv, {(hz, 'value'): FREQS}, V,
                        layout='channels').render(n_blocks=nb)
    assert float((got - want_c).abs().max()) <= V * TOL
    rv, hz = reverb_voice(PKGS[0])
    want_j, _ = poly_of(PKGS[0], rv, {(hz, 'value'): FREQS}, V).render(
        n_blocks=nb)
    assert np.abs(got.numpy() - np.asarray(want_j)).max() <= V * TOL
    assert np.abs(got.numpy()).max() > 100 * TOL


def gain_voice(pkg, cut=1500.0):
    """sine -> static LowPass -> per-voice gain (the reference's fit
    voice with a filter in the path)."""
    fx = mod(pkg, 'nodes.fx')
    hz = fixed(pkg, 220.0)
    osc = mod(pkg, 'nodes.osc').Sine()
    osc.hertz = hz
    cutn = fixed(pkg, cut)
    lp = fx.LowPass()
    lp.input = osc
    lp.cutoff = cutn
    lp.get_state().context = 256
    vol = fixed(pkg, 0.5)
    g = fx.Gain()
    g.left = lp
    g.right = vol
    return g, hz, cutn, vol


def test_vmap_fit_gradient_matches_jax():
    """The gradient of the spectral loss of a vmap-layout mix with respect
    to the shared cutoff and the per-voice gains, in both packages: within
    1e-4 relative."""
    import jax
    import jax.numpy as jnp
    V, nb = 4, 12
    freqs = np.linspace(200, 900, V).astype(np.float32)
    gains = np.linspace(0.3, 0.8, V).astype(np.float32)
    root_t, hz_t, _, vol_t = gain_voice(PKGS[1], cut=2500.0)
    target, _ = poly_of(PKGS[1], root_t, {(hz_t, 'value'): freqs,
                                          (vol_t, 'value'): gains * 1.3},
                        V).render(n_blocks=nb)
    target = target.numpy()
    TC._compile_cache.clear()

    root, hz, cut, vol = gain_voice(PKGS[1])
    poly = poly_of(PKGS[1], root, {(hz, 'value'): freqs,
                                   (vol, 'value'): gains}, V)
    params, _ = poly.params()
    uc = poly.compiled.index.info(cut).uid
    uv = poly.compiled.index.info(vol).uid
    params[uc]['value'].requires_grad_()
    params[uv]['value'].requires_grad_()
    from signals_tpu_torch import learn
    mix, _ = poly.render_fn(nb)(params, poly.init_carry(), 0)
    loss = learn.spectral_loss(mix.reshape(nb * F, 1),
                               torch.from_numpy(target))
    loss.backward()
    got = (params[uc]['value'].grad.numpy(), params[uv]['value'].grad.numpy())

    from signals_tpu import learn as jlearn
    root_j, hz_j, cut_j, vol_j = gain_voice(PKGS[0])
    jp = poly_of(PKGS[0], root_j, {(hz_j, 'value'): freqs,
                                   (vol_j, 'value'): gains}, V)
    jparams, _ = jp.params()
    raw = jp._raw_render_fn(nb)
    carry = jp.init_carry()
    host = jp.compiled.stage_host(0, nb)

    def jloss(c, g):
        p = {u: dict(leaves) for u, leaves in jparams.items()}
        p[uc]['value'], p[uv]['value'] = c, g
        m, _ = raw(p, carry, 0, host)
        return jlearn.spectral_loss(m.reshape(nb * F, 1),
                                    jnp.asarray(target))

    want = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(jparams[uc]['value']), jnp.asarray(jparams[uv]['value']))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
        assert np.abs(w).max() > 0


def test_vmap_fit_recovers_per_voice_gains():
    """``PolyPatch.fit`` in the vmap layout: per-voice gains recovered
    from one mixed target, written back through ``set_override``."""
    V = 4
    freqs = np.linspace(200, 900, V).astype(np.float32)
    tgt_g = np.random.default_rng(3).uniform(0.4, 0.9, V).astype(np.float32)
    root_t, hz_t, _, vol_t = gain_voice(PKGS[1])
    target, _ = poly_of(PKGS[1], root_t, {(hz_t, 'value'): freqs,
                                          (vol_t, 'value'): tgt_g},
                        V).render(n_blocks=16)
    TC._compile_cache.clear()
    root, hz, _, vol = gain_voice(PKGS[1])
    poly = poly_of(PKGS[1], root, {(hz, 'value'): freqs,
                                   (vol, 'value'): np.full(V, 0.2,
                                                           np.float32)}, V)
    res = poly.fit(target.numpy(), [(vol, 'value')], steps=150,
                   learning_rate=0.02)
    uid = poly.compiled.index.info(vol).uid
    fitted = poly._overrides[(uid, 'value')].reshape(V)
    assert np.abs(fitted - tgt_g).max() < 0.05, fitted
    assert res.losses[-1] < res.losses[0] * 0.05
    audio, _ = poly.render(n_blocks=16)
    assert np.abs(audio.numpy() - target.numpy()).max() < 0.15
