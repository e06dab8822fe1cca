"""The device half of the port's codecs against the JAX package.

Every encoder of ``signals_tpu_torch.runtime.codecs`` that runs on a
tensor (``mulaw_encode`` / ``alaw_encode`` / ``pcm16_encode`` on a
``TorchXP``, ``ima_encode``, ``slac_encode``, ``slac2_encode``) gives the
same bytes as the numpy encoder of both packages and as the JAX package's
device encoder (``*_jax`` under ``jax.jit`` on the CPU) on the same seeded
float input: tonal audio at 1, 2 and 16 channels, input beyond ±1,
silence, a full-scale square (SLAC v2's escape codes), full-scale noise,
frames that are not a multiple of the block, and no frames at all.  On the
CPU ``ima_encode`` runs its plain step loop; the hand-written kernel is
held to that loop on the card (``-m cuda``), at the shapes of
``chip_smoke.py`` phase 10 (a).
"""

import importlib

import numpy as np
import pytest
import torch

from signals_tpu_torch.core.xp import TorchXP
from signals_tpu_torch.runtime import codecs

CPU = TorchXP('cpu')


def jax_side():
    """``(jax, jax.numpy, signals_tpu.runtime.codecs)``, imported when a
    CPU test needs them: the card tests of this file run where JAX is not
    installed."""
    return (importlib.import_module('jax'),
            importlib.import_module('jax.numpy'),
            importlib.import_module('signals_tpu.runtime.codecs'))


def tonal(n, channels, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)[:, None] / 44100.0
    f = 110.0 * (1 + np.arange(channels))[None, :]
    x = 0.6 * np.sin(2 * np.pi * f * t) * np.linspace(0.01, 1.0, n)[:, None]
    x = x + 0.05 * rng.standard_normal((n, channels))
    return x.astype(np.float32)


def square(n):
    return np.where(np.arange(n) % 2 == 0, 1.0, -1.0).astype(
        np.float32).reshape(-1, 1)


SIGNALS = {
    'tonal-1': lambda: tonal(5003, 1, 1),
    'tonal-2': lambda: tonal(3001, 2, 2),
    'tonal-16': lambda: tonal(1100, 16, 3),
    'beyond-1': lambda: (1.7 * tonal(2000, 1, 4)).astype(np.float32),
    'silence': lambda: np.zeros((700, 1), np.float32),
    'square': lambda: square(700),
    'noise': lambda: np.random.default_rng(99).uniform(
        -1, 1, (1500, 1)).astype(np.float32),
    'three': lambda: np.array([[5e-4], [-3e-4], [7e-4]], np.float32),
}


@pytest.mark.parametrize('name', sorted(SIGNALS))
@pytest.mark.parametrize('enc', ['mulaw', 'alaw'])
def test_g711_on_tensors_matches_numpy_and_jax(name, enc):
    jax, jnp, jcodecs = jax_side()
    x = SIGNALS[name]()
    got = getattr(codecs, f'{enc}_encode')(CPU, torch.from_numpy(x))
    assert got.dtype == torch.uint8
    want = getattr(jcodecs, f'{enc}_encode')(np, x)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(getattr(codecs, f'{enc}_encode')(np, x), want)
    fn = jax.jit(lambda a: getattr(jcodecs, f'{enc}_encode')(jnp, a))
    assert np.array_equal(np.asarray(fn(x)), want)


@pytest.mark.parametrize('name', sorted(SIGNALS))
def test_pcm16_matches_the_writers_quantization(name):
    """``pcm16_encode`` is the JAX compiler's PCM16 quantizer (32767
    scale, half to even; ``compiler/__init__.py:2132-2134``)."""
    jax, jnp, jcodecs = jax_side()
    x = SIGNALS[name]()
    got = codecs.pcm16_encode(CPU, torch.from_numpy(x))
    want = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) * np.float32(
        32767.0)), -32768, 32767).astype(jnp.int16))
    assert got.dtype == torch.int16
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize('spb', [1017, 505, 9])
@pytest.mark.parametrize('name', ['tonal-1', 'tonal-2', 'tonal-16',
                                  'beyond-1', 'silence', 'square', 'noise'])
def test_ima_matches_numpy_and_jax(name, spb):
    jax, jnp, jcodecs = jax_side()
    x = SIGNALS[name]()
    got = codecs.ima_encode(torch.from_numpy(x), samples_per_block=spb)
    want, block_align = jcodecs.ima_encode_np(x, samples_per_block=spb)
    assert got.dtype == torch.uint8
    assert got.shape[0] == -(-x.shape[0] // spb) * block_align
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(codecs.ima_encode_np(
        x, samples_per_block=spb)[0], want)
    fn = jax.jit(lambda a: jcodecs.ima_encode_jax(a, samples_per_block=spb))
    assert np.array_equal(np.asarray(fn(x)), want)


def test_ima_edges():
    """No frames, an even block, and a block whose nibble words cannot
    interleave (``(spb - 1) % 8``, where the numpy encoder's reshape fails
    too) — the same on every device."""
    empty = torch.zeros((0, 2))
    assert codecs.ima_encode(empty).shape == (0,)
    assert codecs.ima_encode_np(np.zeros((0, 2), np.float32))[0].size == 0
    x = torch.from_numpy(tonal(600, 1, 5))
    with pytest.raises(ValueError, match='odd'):
        codecs.ima_encode(x, samples_per_block=504)
    with pytest.raises(ValueError, match='multiple of 8'):
        codecs.ima_encode(x, samples_per_block=507)
    with pytest.raises(ValueError):
        codecs.ima_encode_np(x.numpy(), samples_per_block=507)
    with pytest.raises(ValueError, match='float32'):
        codecs.ima_encode(x.double())


def test_ima_plain_loop_decodes():
    """The plain loop's payload decodes to the input within ADPCM's
    error (the round trip of ``tests/test_codecs.py``)."""
    x = tonal(4000, 2, 6)
    payload = codecs.ima_encode_plain(torch.from_numpy(x),
                                      samples_per_block=505)
    dec = codecs.ima_decode_np(payload.numpy(), channels=2,
                               block_align=(252 + 4) * 2,
                               frames=x.shape[0])
    err = dec - x
    assert 10 * np.log10(np.mean(x ** 2) / np.mean(err ** 2)) > 24.0


SLAC_SIGNALS = sorted(SIGNALS) + ['empty']


def slac_input(name):
    if name == 'empty':
        return np.zeros((0, 1), np.float32)
    return SIGNALS[name]()


@pytest.mark.parametrize('name', SLAC_SIGNALS)
@pytest.mark.parametrize('version', [1, 2])
def test_slac_matches_numpy_and_jax(name, version):
    jax, jnp, jcodecs = jax_side()
    x = slac_input(name)
    suffix = '' if version == 1 else '2'
    buf, total = getattr(codecs, f'slac{suffix}_encode')(torch.from_numpy(x))
    want, n = getattr(jcodecs, f'slac{suffix}_encode_np')(x)
    assert buf.dtype == torch.uint8 and total.dtype == torch.int64
    assert int(total) == want.shape[0]
    assert np.array_equal(buf[:int(total)].numpy(), want)
    assert not buf[int(total):].any()          # zero past the live length
    nb = -(-x.size // 256)
    assert buf.shape[0] == nb * (577 if version == 1 else 1155)
    port_np, port_n = getattr(codecs, f'slac{suffix}_encode_np')(x)
    assert port_n == n and np.array_equal(port_np, want)
    jbuf, jtotal = jax.jit(getattr(jcodecs, f'slac{suffix}_encode_jax'))(x)
    assert int(jtotal) == int(total)
    assert np.array_equal(np.asarray(jbuf)[:int(jtotal)], want)
    if n:
        decode = getattr(codecs, f'slac{suffix}_decode_np')
        ref = np.clip(np.round(x * np.float32(32767.0)), -32768,
                      32767).astype(np.int16)
        assert np.array_equal(decode(buf[:int(total)].numpy(), n,
                                     x.shape[1]), ref)


def test_slac2_takes_every_escape_and_every_order():
    """A stream whose blocks pick all four predictor orders and many
    Rice parameters, with escape codes: full-scale noise, a square, a
    ramp, a sine and silence back to back."""
    jax, jnp, jcodecs = jax_side()
    rng = np.random.default_rng(7)
    t = np.arange(4096) / 44100.0
    x = np.concatenate([
        rng.uniform(-1, 1, 1024), square(1024)[:, 0],
        np.linspace(-0.9, 0.9, 1024),
        0.7 * np.sin(2 * np.pi * 3000 * t[:1024]),
        np.zeros(1024), 0.01 * rng.standard_normal(1024)]).astype(
            np.float32)[:, None]
    s = jcodecs._slac_pcm16(np, x)
    zz3 = jcodecs._slac2_residual_cands(np, s.astype(np.int32))
    zz3 = ((zz3 << 1) ^ (zz3 >> 31)).reshape(4, -1, 256)
    order, k, _ = jcodecs._slac2_plan(np, zz3)
    assert len(set(order.tolist())) >= 3 and len(set(k.tolist())) >= 5
    buf, total = codecs.slac2_encode(torch.from_numpy(x))
    want, _ = jcodecs.slac2_encode_np(x)
    assert np.array_equal(buf[:int(total)].numpy(), want)


def test_pack_words_is_the_or_of_the_codes():
    """``_pack_words`` against a bit-by-bit numpy reference at random code
    lengths (1-36 bits, abutting), every shift phase of a 32-bit word."""
    rng = np.random.default_rng(3)
    nb, N = 5, 256
    ln = rng.integers(1, 37, (nb, N))
    ln[:, :N // 2] = np.minimum(ln[:, :N // 2], 33)
    code = rng.integers(0, 1 << 36, (nb, N)) & ((1 << ln) - 1)
    starts = np.cumsum(ln, axis=1) - ln
    got = codecs._pack_words(torch.from_numpy(code),
                             torch.from_numpy(starts), 288, 3).numpy()
    want = np.zeros((nb, 288 * 32), np.uint8)
    for b in range(nb):
        for i in range(N):
            for j in range(int(ln[b, i])):
                want[b, starts[b, i] + j] = (code[b, i] >> j) & 1
    want = (want.reshape(nb, -1, 8) << np.arange(8)).sum(axis=2)
    assert np.array_equal(got, want.astype(np.uint8))


@pytest.mark.parametrize('subtype', list(codecs.DEVICE_SUBTYPES))
def test_device_encode_dispatch(subtype):
    jax, jnp, jcodecs = jax_side()
    x = tonal(3000, 2, 8)
    got = codecs.device_encode(torch.from_numpy(x), subtype)
    if subtype == 'slac':
        got = got[0][:int(got[1])]
    want = {'pcm16': lambda: np.clip(np.round(x * np.float32(32767.0)),
                                     -32768, 32767).astype(np.int16),
            'mulaw': lambda: jcodecs.mulaw_encode(np, x),
            'alaw': lambda: jcodecs.alaw_encode(np, x),
            'adpcm': lambda: jcodecs.ima_encode_np(x)[0],
            'slac': lambda: jcodecs.slac2_encode_np(x)[0]}[subtype]()
    assert got.numpy().dtype == want.dtype
    assert np.array_equal(got.numpy(), want)


def test_device_encode_refuses_unknown_subtype():
    with pytest.raises(ValueError, match='unsupported'):
        codecs.device_encode(torch.zeros((4, 1)), 'flac')


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return torch.device('cuda')


#: chip_smoke.py phase 10 (a): the IMA kernel at these channel counts and
#: block sizes, frames not a multiple of the block
IMA_CARD_SHAPES = [(ch, spb) for ch in (1, 2, 16, 64) for spb in (1017, 505)]


@pytest.mark.cuda
@pytest.mark.parametrize('ch,spb', IMA_CARD_SHAPES)
def test_cuda_ima_kernel_matches_plain_loop(cuda_device, ch, spb):
    from signals_tpu_torch.compiler import kernels as K
    frames = 64 * spb * 4 // ch + 333
    x = torch.from_numpy(tonal(frames, ch, ch + spb)).to(cuda_device)
    x[frames // 3] = 1.5                       # beyond full scale
    K.reset_launch_counts()
    got = codecs.ima_encode(x, samples_per_block=spb)
    again = codecs.ima_encode(x, samples_per_block=spb)
    torch.cuda.synchronize()
    assert K.LAUNCHES['ima'] == 2
    want = codecs.ima_encode_plain(x, samples_per_block=spb)
    assert torch.equal(got, want) and torch.equal(got, again)
    assert np.array_equal(got.cpu().numpy(), codecs.ima_encode_np(
        x.cpu().numpy(), samples_per_block=spb)[0])


@pytest.mark.cuda
@pytest.mark.parametrize('name', SLAC_SIGNALS)
def test_cuda_encoders_match_numpy(cuda_device, name):
    x = slac_input(name)
    xc = torch.from_numpy(x).to(cuda_device)
    for version, enc_np in ((1, codecs.slac_encode_np),
                            (2, codecs.slac2_encode_np)):
        buf, total = (codecs.slac_encode if version == 1
                      else codecs.slac2_encode)(xc)
        want, _ = enc_np(x)
        assert np.array_equal(buf[:int(total)].cpu().numpy(), want), version
    xp = TorchXP(cuda_device)
    assert np.array_equal(codecs.mulaw_encode(xp, xc).cpu().numpy(),
                          codecs.mulaw_encode(np, x))
    assert np.array_equal(codecs.alaw_encode(xp, xc).cpu().numpy(),
                          codecs.alaw_encode(np, x))
