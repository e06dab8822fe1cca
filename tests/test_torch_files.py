"""Host inputs and sound files in the port against the JAX package.

On the CPU, at small sizes (F 256-1024, a few blocks, 1-2 channels), the
same seeded numpy audio through both packages:

* the copied codecs (mu-law, A-law, IMA ADPCM, SLAC v1/v2) give the same
  bytes and the same decoded samples; ``wavio`` / ``sndfile`` write
  byte-identical files for every subtype (WAV float32, pcm16, mulaw,
  alaw, adpcm; AIFF; AU float32, pcm16, mulaw, alaw; SLAC) and read each
  other's; the libsndfile branch through a duck-typed ``soundfile``;
* ``FileReader.host_read`` with ``conform_rate`` at 32 and 64 taps bit for
  bit;
* ``FileReader`` -> LowPass -> ``FileWriter`` through ``compile_node``:
  ``plan() == 'stateless'`` (the JAX package's per-block ``vmap`` of a
  carry-free batch), the render and ``step`` within
  1e-5 of the JAX render and of the port's pull oracle, from block 0 and
  from block 3, the staged windows' keys equal to the JAX package's;
* the strided control-grid windows of ``tests/test_grid_samples_ahead.py``
  (a ``FileReader`` gating nested ADSRs; a ``FileReader`` sweeping a
  LowPass cutoff on the carry grid);
* the ``Transport``, ``PolyPatch.render`` and a ``make_loss_fn`` gradient
  after a ``FileReader`` (against ``jax.grad``, 1e-3), ``learn.fit`` and
  ``PolyPatch.fit``;
* the written file read back equal to the returned audio under the port's
  encoder, valid while still open; a disabled ``FileWriter`` handed
  nothing; a disabled ``FileReader`` silent.

The full-size bounce (60 s stereo, four EQs) runs on the card:
``chip_smoke.py`` phase 8.
"""

import importlib
import types

import numpy as np
import pytest
import torch

from signals_tpu_torch import learn
from signals_tpu_torch.compiler import compile_node
from signals_tpu_torch.parallel import PolyPatch
from signals_tpu_torch.runtime import Transport

RATE = 44100
TOL = 1e-5
GRAD_TOL = 1e-3
JAX, PORT = 'signals_tpu', 'signals_tpu_torch'


def nodes(pkg):
    return {m: importlib.import_module(f'{pkg}.nodes.{m}')
            for m in ('env', 'files', 'fixed', 'fx', 'osc')}


def runtime(pkg, mod):
    return importlib.import_module(f'{pkg}.runtime.{mod}')


def fixed(mod, value):
    f = mod['fixed'].Fixed()
    f.get_state().value = np.atleast_2d(np.asarray(value, np.float32))
    return f


def audio(frames, channels=2, seed=0):
    """Seeded noise plus a sine: full-scale-ish float32 ``(frames, ch)``."""
    rng = np.random.default_rng(seed)
    t = np.arange(frames, dtype=np.float64)[:, None]
    tone = 0.4 * np.sin(2 * np.pi * 330.0 * t / RATE * (1 + np.arange(
        channels)))
    return (tone + 0.25 * rng.standard_normal((frames, channels))
            ).astype(np.float32)


def write_file(path, data, rate=RATE, subtype='float32'):
    w = runtime(PORT, 'sndfile').open_writer(path, rate=rate,
                                             channels=data.shape[1],
                                             subtype=subtype)
    w.write(data)
    w.close()
    return str(path)


def reader(mod, path, **state):
    rd = mod['files'].FileReader()
    rd.get_state().path = path
    for k, v in state.items():
        setattr(rd.get_state(), k, v)
    return rd


def lowpass(mod, inp, cutoff=1500.0, context=512):
    lp = mod['fx'].LowPass()
    lp.input = inp
    lp.cutoff = cutoff if not isinstance(cutoff, float) else fixed(mod,
                                                                   cutoff)
    lp.get_state().context = context
    return lp


def pull_oracle(pkg, root, n, channels, F, start=0):
    core = importlib.import_module(f'{pkg}.core')
    return np.concatenate([np.broadcast_to(root.respond(core.Request(
        requestor=None, port='test',
        loc=core.BlockLoc(position=i * F, rate=RATE,
                          shape=core.Shape(F, channels)))), (F, channels))
        for i in range(start, start + n)])


def jax_compile(root, F, channels):
    import signals_tpu.compiler as C
    C._compile_cache.clear()
    return C.compile_node(root, block_frames=F, rate=RATE, channels=channels)


def port_compile(root, F, channels):
    return compile_node(root, block_frames=F, rate=RATE, channels=channels,
                        device='cpu')


def err(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max())


# --- codecs and files ---------------------------------------------------------

@pytest.mark.parametrize('codec', ['mulaw', 'alaw', 'ima', 'slac', 'slac2'])
def test_codecs_match_jax(codec):
    from signals_tpu.runtime import codecs as J
    from signals_tpu_torch.runtime import codecs as P
    x = np.clip(audio(3001, 2, seed=1), -1.0, 1.0)
    if codec in ('mulaw', 'alaw'):
        enc, dec = f'{codec}_encode', f'{codec}_decode'
        a, b = getattr(P, enc)(np, x), getattr(J, enc)(np, x)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(getattr(P, dec)(np, a), getattr(J, dec)(np, b))
    elif codec == 'ima':
        spb = P.ima_samples_per_block(1024, 2)
        assert spb == J.ima_samples_per_block(1024, 2)
        (a, align), (b, jalign) = (P.ima_encode_np(x, samples_per_block=spb),
                                   J.ima_encode_np(x, samples_per_block=spb))
        assert align == jalign == 1024 and np.array_equal(a, b)
        kw = dict(channels=2, block_align=align, frames=3001)
        assert np.array_equal(P.ima_decode_np(a, **kw),
                              J.ima_decode_np(b, **kw))
    else:
        enc, dec = f'{codec}_encode_np', f'{codec}_decode_np'
        (a, n), (b, m) = getattr(P, enc)(x), getattr(J, enc)(x)
        assert n == m and np.array_equal(a, b)
        assert np.array_equal(getattr(P, dec)(a, n, 2),
                              getattr(J, dec)(b, m, 2))


WRITERS = [('.wav', 'float32'), ('.wav', 'pcm16'), ('.wav', 'mulaw'),
           ('.wav', 'alaw'), ('.wav', 'adpcm'), ('.aiff', 'float32'),
           ('.au', 'float32'), ('.au', 'pcm16'), ('.au', 'mulaw'),
           ('.au', 'alaw'), ('.slac', 'slac')]


@pytest.mark.parametrize('ext,subtype', WRITERS)
def test_writers_byte_identical_and_read_each_other(tmp_path, ext, subtype):
    x = np.clip(audio(2500, 2, seed=2), -1.0, 1.0)
    files = {}
    for pkg in (JAX, PORT):
        path = tmp_path / f'{pkg}{ext}'
        kw = {} if ext == '.aiff' else {'subtype': subtype}
        w = runtime(pkg, 'sndfile').open_writer(path, rate=48000,
                                                channels=2, **kw)
        for lo in range(0, 2500, 700):           # blocks of any size
            w.write(x[lo:lo + 700])
        w.close()
        files[pkg] = path
    assert files[PORT].read_bytes() == files[JAX].read_bytes()
    reads = {}
    for pkg in (JAX, PORT):
        for src in (JAX, PORT):
            r = runtime(pkg, 'sndfile').open_reader(files[src])
            assert (r.rate, r.channels, r.frames) == (48000, 2, 2500)
            reads[pkg, src] = (r.read(-7, 2520), r.read(1000, 300))
            r.close()
    first = reads[JAX, JAX]
    for got in reads.values():
        assert all(np.array_equal(a, b) for a, b in zip(got, first))
    assert not first[0][:7].any() and not first[0][2507:].any()


class FakeSoundFile:
    """Duck-typed ``soundfile.SoundFile`` over an in-memory store
    (``tests/test_sndfile.py``'s)."""

    store: dict = {}

    def __init__(self, path, mode='r', samplerate=None, channels=None):
        self.path, self.mode = str(path), mode
        if mode == 'r':
            self.samplerate, self._data = FakeSoundFile.store[self.path]
            self.channels = self._data.shape[1]
        else:
            self.samplerate, self.channels = samplerate, channels
            self._data = np.zeros((0, channels), dtype=np.float32)
        self._pos = 0

    def __len__(self):
        return self._data.shape[0]

    def seek(self, pos):
        self._pos = pos

    def read(self, frames, dtype='float32', always_2d=True):
        out = self._data[self._pos:self._pos + frames]
        self._pos += out.shape[0]
        return out

    def write(self, block):
        self._data = np.concatenate([self._data, block], axis=0)

    def close(self):
        if self.mode == 'w':
            FakeSoundFile.store[self.path] = (self.samplerate, self._data)


def test_libsndfile_dispatch_with_fake(tmp_path):
    from signals_tpu_torch.runtime import sndfile
    sf = types.ModuleType('soundfile')
    sf.SoundFile = FakeSoundFile
    data = audio(500, 2, seed=3)
    path = tmp_path / 'clip.flac'
    w = sndfile.open_writer(path, rate=44100, channels=2, sf_module=sf)
    w.write(data)
    w.close()
    r = sndfile.open_reader(path, sf_module=sf)
    assert r.frames == 500 and r.rate == 44100
    assert np.array_equal(r.read(100, 50), data[100:150])
    got = r.read(480, 40)
    assert np.array_equal(got[:20], data[480:]) and not got[20:].any()
    r.close()


@pytest.mark.parametrize('taps', [32, 64])
def test_conform_rate_bit_exact(tmp_path, taps):
    """A 48 kHz file read at 44.1 kHz through both packages' ``host_read``
    (the same numpy code): the same bits at every position, before frame 0
    and past the end included."""
    path = write_file(tmp_path / 'in48.wav', audio(9000, 2, seed=4),
                      rate=48000)
    rd = {pkg: reader(nodes(pkg), path, conform_rate=True,
                      resample_taps=taps) for pkg in (JAX, PORT)}
    for pos, n in ((0, 256), (-300, 512), (4099, 1000), (8100, 700)):
        got = rd[PORT].host_read(pos, n, RATE)
        want = rd[JAX].host_read(pos, n, RATE)
        assert got.dtype == np.float32 and np.array_equal(got, want)
    from signals_tpu.core.resample import resample as jres
    from signals_tpu_torch.core.resample import resample
    x = audio(3000, 1, seed=5)
    assert np.array_equal(resample(x, 48000, RATE, taps=taps),
                          jres(x, 48000, RATE, taps=taps))


# --- FileReader -> filters -> FileWriter through the compiler -----------------

def bounce(pkg, src, out='/dev/null', subtype='float32', **state):
    mod = nodes(pkg)
    lp = lowpass(mod, reader(mod, src, **state))
    wr = mod['files'].FileWriter()
    wr.get_state().path = str(out)
    wr.get_state().subtype = subtype
    wr.input = lp
    return wr


@pytest.mark.parametrize('start', [0, 3])
def test_bounce_matches_jax_and_oracle(tmp_path, start):
    F, nb = 256, 6
    src = write_file(tmp_path / 'in.wav', audio(3000, 2, seed=6))
    jc = jax_compile(bounce(JAX, src), F, 2)
    pc = port_compile(bounce(PORT, src), F, 2)
    assert pc.plan(nb) == 'stateless' and not pc.mega_compatible
    assert not jc.mega_compatible and not jc._use_mega
    assert jc.packed_mega_streams(nb) is None
    assert jc.delay_mega_plan() is None and jc.segment_scan_core(nb) is None
    assert [k for *_, k in pc._host_spec] == [k for *_, k in jc._host_spec]
    want, _ = jc.render(position=start * F, n_blocks=nb)
    got, _ = pc.render(position=start * F, n_blocks=nb)
    assert err(got, want) <= TOL
    oracle = pull_oracle(PORT, bounce(PORT, src), nb, 2, F, start)
    assert err(got, oracle) <= TOL
    params = pc.params()
    for b in (start, start + 2):
        block, _ = pc.step(params, {}, b * F)
        assert err(block, oracle[(b - start) * F:(b - start + 1) * F]) <= TOL
    staged = pc.stage_host(start * F, nb)
    jstaged = jc.stage_host(start * F, nb)
    assert staged.keys() == jstaged.keys()
    assert all(np.array_equal(staged[k], jstaged[k]) for k in staged)


def test_conform_rate_render_matches_jax(tmp_path):
    F, nb = 256, 5
    src = write_file(tmp_path / 'in48.wav', audio(4000, 1, seed=7),
                     rate=48000)
    want, _ = jax_compile(bounce(JAX, src, conform_rate=True), F, 1).render(
        n_blocks=nb)
    got, _ = port_compile(bounce(PORT, src, conform_rate=True), F, 1).render(
        n_blocks=nb)
    assert err(got, want) <= TOL


def test_nested_grid_nodes_with_host_source(tmp_path):
    """``tests/test_grid_samples_ahead.py:73``: a host-fed ADSR gate read by
    another ADSR — strided control-grid windows staged one grid point a
    step — against the JAX render and the oracle."""
    gate = np.sign(np.sin(np.linspace(0, 40, 44100))).astype(np.float32)
    path = write_file(tmp_path / 'gate.wav', gate.reshape(-1, 1))

    def build(pkg):
        mod = nodes(pkg)
        a1 = mod['env'].ADSR()
        a1.gate = reader(mod, path)
        a2 = mod['env'].ADSR()
        a2.gate = a1
        return a2

    F = 1024
    pc = port_compile(build(PORT), F, 1)
    jc = jax_compile(build(JAX), F, 1)
    keys = [k for *_, k in pc._host_spec]
    assert keys == [k for *_, k in jc._host_spec]
    assert any(k.count(',') == 2 for k in keys)      # a strided window
    got, _ = pc.render(n_blocks=6)
    want, _ = jc.render(n_blocks=6)
    assert err(got, want) <= TOL
    # the first ADSR alone against the pull oracle (the oracle cannot pull
    # a stateful gate at the grid points of a second one)
    mod = nodes(PORT)
    one = mod['env'].ADSR()
    one.gate = reader(mod, path)
    got, _ = port_compile(one, F, 1).render(n_blocks=6)
    oracle = mod['env'].ADSR()
    oracle.gate = reader(mod, path)
    assert err(got, pull_oracle(PORT, oracle, 6, 1, F)) <= TOL


@pytest.mark.parametrize('start', [0, 3])
def test_host_fed_swept_cutoff(tmp_path, start):
    """A ``FileReader`` sweeping a LowPass cutoff on the carry grid: the
    cutoff is read on the block grid over the filter's fixed window (the
    carry segment's earliest start up to the block), one staged point a
    block."""
    F, nb = 1024, 10
    t = np.arange(20 * F) / RATE
    cut = (1200.0 + 900.0 * np.sin(2 * np.pi * 0.7 * t)).astype(np.float32)
    cpath = write_file(tmp_path / 'cut.wav', cut.reshape(-1, 1))
    src = write_file(tmp_path / 'in.wav', audio(20 * F, 1, seed=8))

    def build(pkg):
        mod = nodes(pkg)
        return lowpass(mod, reader(mod, src), reader(mod, cpath))

    pc = port_compile(build(PORT), F, 1)
    assert pc.carry_seg_align == 8 and pc.plan(nb) == 'blocks'
    got, _ = pc.render(position=start * F, n_blocks=nb)
    want, _ = jax_compile(build(JAX), F, 1).render(position=start * F,
                                                    n_blocks=nb)
    assert err(got, want) <= TOL
    oracle = pull_oracle(PORT, build(PORT), nb, 1, F, start)
    assert err(got, oracle) <= TOL


def test_transport_batches(tmp_path):
    """Each render-ahead batch stages its own blocks; a seek off the block
    grid's start and the batches after it equal one render."""
    F = 256
    src = write_file(tmp_path / 'in.wav', audio(6000, 2, seed=9))
    pc = port_compile(bounce(PORT, src), F, 2)
    whole, _ = pc.render(n_blocks=19)
    blocks = []
    tr = Transport(pc, consumer=lambda b, pos: blocks.append((pos, b)),
                   blocks_per_call=4)
    tr.seek(3 * F)
    for _ in range(4):
        tr.render_ahead()
    assert [p for p, _ in blocks] == [(3 + i) * F for i in range(16)]
    got = np.concatenate([b for _, b in blocks])
    assert err(got, whole[3 * F:]) <= 1e-6
    want, _ = jax_compile(bounce(JAX, src), F, 2).render(position=3 * F,
                                                        n_blocks=16)
    assert err(got, want) <= TOL


def poly_file_voice(pkg, src, vol):
    mod = nodes(pkg)
    g = mod['fx'].Gain()
    g.left = lowpass(mod, reader(mod, src))
    g.right = vol = fixed(mod, vol)
    return g, vol


def test_polypatch_render_host_fed(tmp_path):
    """A mono file under four per-voice gains: ``PolyPatch.render`` stages
    the file through the compiled patch (the per-block plan) and sums the
    voices, as the JAX ``PolyPatch`` does."""
    from signals_tpu.parallel import PolyPatch as JPoly
    F, gains = 256, np.array([0.2, 0.5, 0.7, 0.9], np.float32)
    src = write_file(tmp_path / 'in.wav', audio(3000, 1, seed=10))
    polys = {}
    for pkg, cls, kw in ((PORT, PolyPatch, {'device': 'cpu'}),
                         (JAX, JPoly, {})):
        root, vol = poly_file_voice(pkg, src, 0.5)
        polys[pkg] = cls(root, n_voices=4, overrides={(vol, 'value'): gains},
                         block_frames=F, rate=RATE, **kw)
    assert polys[PORT].compiled.mega_mix(5) is None
    got, _ = polys[PORT].render(position=2 * F, n_blocks=5)
    want, _ = polys[JAX].render(position=2 * F, n_blocks=5)
    assert err(got, want) <= 4 * TOL


def test_loss_gradient_after_reader_matches_jax(tmp_path):
    """``make_loss_fn``'s gradient of a gain after a ``FileReader`` and a
    LowPass against ``jax.grad`` of the JAX package's."""
    import jax
    from signals_tpu.learn import make_loss_fn as jmake
    F, nb = 256, 4
    src = write_file(tmp_path / 'in.wav', audio(3000, 1, seed=11))
    target = 0.3 * audio(nb * F, 1, seed=12)
    root, vol = poly_file_voice(JAX, src, 0.4)
    jc = jax_compile(root, F, 1)
    jg = jax.jit(jax.grad(jmake(jc, target), allow_int=True))(jc.params())
    want = np.asarray(jg[jc.index.info(vol).uid]['value'])
    root, vol = poly_file_voice(PORT, src, 0.4)
    pc = port_compile(root, F, 1)
    params = pc.params()
    uid = pc.index.info(vol).uid
    params[uid]['value'] = leaf = params[uid]['value'].clone(
    ).requires_grad_()
    (got,) = torch.autograd.grad(learn.make_loss_fn(pc, target)(params),
                                 [leaf])
    got = got.numpy()
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= GRAD_TOL * np.abs(want).max()


def test_fits_after_reader(tmp_path):
    """``learn.fit`` and ``PolyPatch.fit`` of gains after a ``FileReader``:
    the loss falls and the gains come back."""
    F = 256
    src = write_file(tmp_path / 'in.wav', audio(3000, 1, seed=13))
    root, vol = poly_file_voice(PORT, src, 0.8)
    target = port_compile(root, F, 1).render(n_blocks=4)[0].numpy()
    root, vol = poly_file_voice(PORT, src, 0.2)
    res = learn.fit(root, target, [(vol, 'value')], block_frames=F,
                    steps=40, learning_rate=0.1, device='cpu')
    assert res.losses[-1] < res.losses[0] * 0.1
    assert abs(float(vol.get_state().value[0, 0]) - 0.8) < 0.05

    gains = np.array([0.3, 0.9], np.float32)
    root, vol = poly_file_voice(PORT, src, 0.5)
    target = PolyPatch(root, n_voices=2, overrides={(vol, 'value'): gains},
                       block_frames=F, rate=RATE,
                       device='cpu').render(n_blocks=4)[0].numpy()
    root, vol = poly_file_voice(PORT, src, 0.5)
    poly = PolyPatch(root, n_voices=2,
                     overrides={(vol, 'value'): np.full(2, 0.1, np.float32)},
                     block_frames=F, rate=RATE, device='cpu')
    res = poly.fit(target, [(vol, 'value')], steps=60, learning_rate=0.03)
    assert res.losses[-1] < res.losses[0] * 0.1
    # one mixed target: the SUM of the two gains is what it determines
    assert abs(float(vol.get_state().value.sum()) - 1.2) < 0.05


# --- the writer ---------------------------------------------------------------

def test_written_file_is_the_returned_audio(tmp_path):
    """A pcm16 bounce: the file is valid while the writer is still open,
    and byte for byte the returned audio under the port's pcm16 encoder."""
    from signals_tpu_torch.runtime import sndfile
    F, nb = 256, 6
    src = write_file(tmp_path / 'in.wav', audio(3000, 2, seed=14))
    out = tmp_path / 'out.wav'
    wr = bounce(PORT, src, out, subtype='pcm16')
    got, _ = port_compile(wr, F, 2).render(n_blocks=nb)
    r = sndfile.open_reader(out)                      # still recording
    assert (r.frames, r.channels, r.rate) == (nb * F, 2, RATE)
    # pcm16: written at 32767 full scale, read back at 32768
    assert np.abs(r.read(0, nb * F) - got.numpy()).max() <= 6e-5
    r.close()
    wr.destroy()
    ref = write_file(tmp_path / 'ref.wav', got.numpy(), subtype='pcm16')
    assert out.read_bytes() == open(ref, 'rb').read()


def test_disabled_writer_and_reader(tmp_path):
    """A disabled ``FileWriter`` forwards its audio and is handed nothing; a
    disabled ``FileReader`` is silent, as in the pull oracle."""
    F = 256
    src = write_file(tmp_path / 'in.wav', audio(3000, 2, seed=15))
    out = tmp_path / 'off.wav'
    wr = bounce(PORT, src, out)
    wr.get_state().enabled = False
    pc = port_compile(wr, F, 2)
    got, _ = pc.render(n_blocks=4)
    assert not out.exists()
    want = pull_oracle(PORT, bounce(PORT, src), 4, 2, F)
    assert err(got, want) <= TOL
    rd = wr._ports['input'].sig._ports['input'].sig
    rd.get_state().enabled = False
    silent, _ = pc.render(n_blocks=4)
    assert not silent.abs().max()
    oracle = bounce(PORT, src)
    oracle._ports['input'].sig._ports['input'].sig.get_state().enabled = \
        False
    assert not pull_oracle(PORT, oracle, 4, 2, F).any()
    assert not out.exists()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return torch.device('cuda')


@pytest.mark.cuda
def test_cuda_bounce_matches_plain(tmp_path, cuda_device):
    """The bounce on the card: one ``sosfilt_timeline`` (K4) a block,
    within 1e-5 of the CPU render."""
    from signals_tpu_torch.compiler import kernels as K
    F, nb = 1024, 8
    src = write_file(tmp_path / 'in.wav', audio(9000, 2, seed=16))
    want, _ = port_compile(bounce(PORT, src), F, 2).render(n_blocks=nb)
    pc = compile_node(bounce(PORT, src), block_frames=F, rate=RATE,
                      channels=2, device=cuda_device)
    K.reset_launch_counts()
    got, _ = pc.render(n_blocks=nb)
    assert K.LAUNCHES['timeline'] == nb
    assert err(got.cpu(), want) <= TOL

