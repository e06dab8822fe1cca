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


#: csrc/codecs.cu's tile geometry: chains a tile (one warp walks them),
#: steps a staged chunk, floats a staged row
IMA_LANES, IMA_CHUNK, IMA_ROW = 32, 32, 33


def ima_tile_walk_model(x, spb):
    """A numpy model of ``csrc/codecs.cu``'s ``ima_encode``: every tile at
    once, each lane of its warp as an array column.

    The warp stages chunk ``n`` (samples ``32 n .. 32 n + 31`` of each
    chain) into buffer ``n & 1``: its copy ``l`` is step ``k`` of chain
    ``j``, ``(k, j) = (l, lane)`` for a wide tile (ch >= 32: 32 channels of
    one block, the last group narrower) and ``(lane, l)`` for a narrow one
    (32 // ch whole blocks), the frame clamped to the last, written to slot
    ``k * 33 + j``.  The slots no copy writes keep what an earlier chunk
    (or the start, a sentinel) left there, as shared memory does.  The walk
    reads chain ``lane``'s sample of step ``k`` at slot ``k * 33 + lane`` of
    buffer ``n & 1`` and quantizes it: the header from samples 0 and 1 (a
    7-step binary search for the starting index), then each step with the
    index moved by arithmetic, one 32-bit word stored every 8 codes at the
    byte the kernel stores it.  Returns the payload as uint8."""
    x = np.atleast_2d(np.asarray(x, np.float32))
    frames, ch = x.shape
    nb = -(-frames // spb)
    last = frames - 1
    steps = codecs._IMA_STEPS.astype(np.int64)
    bw = ((spb - 1) // 8 + 1) * ch                 # words a block
    out = np.zeros(nb * bw, np.uint32)
    wide = ch >= IMA_LANES
    if wide:
        groups = -(-ch // IMA_LANES)
        t = np.arange(nb * groups)
        b0, c0 = t // groups, (t % groups) * IMA_LANES
        n_chains = np.minimum(IMA_LANES, ch - c0)
    else:
        per = IMA_LANES // ch
        t = np.arange(-(-nb // per))
        b0, c0 = t * per, np.zeros_like(t)
        n_chains = np.minimum(per, nb - b0) * ch
    lane = np.arange(IMA_LANES)
    n_chunks = -(-spb // IMA_CHUNK)

    # warp 0: (tile, l, lane) -> the chain, step and frame of each load
    ll, ln = np.meshgrid(lane, lane, indexing='ij')          # (l, lane)
    k_of = ll if wide else ln
    j_of = ln if wide else ll
    chain_b = (b0[:, None, None] if wide
               else b0[:, None, None] + j_of[None] // ch)
    chain_c = (c0[:, None, None] + j_of[None] if wide
               else np.broadcast_to(j_of[None] % ch, chain_b.shape))
    staged_ok = j_of[None] < n_chains[:, None, None]
    tix = np.broadcast_to(t[:, None, None], staged_ok.shape)
    bufs = np.full((2, t.size, IMA_CHUNK * IMA_ROW), 0.377, np.float32)

    def stage(n):
        f = np.minimum(chain_b * spb + n * IMA_CHUNK + k_of[None], last)
        f = np.where(staged_ok, f, 0)
        c = np.where(staged_ok, chain_c, 0)
        slot = k_of[None] * IMA_ROW + j_of[None]
        bufs[n & 1][tix[staged_ok], np.broadcast_to(
            slot, staged_ok.shape)[staged_ok]] = x[f, c][staged_ok]

    # warp 1: chain `lane` of each tile
    active = lane[None] < n_chains[:, None]
    b = b0[:, None] + (0 if wide else lane[None] // ch)
    c = c0[:, None] + lane[None] if wide else np.broadcast_to(
        lane[None] % ch, active.shape)
    pred = np.zeros(active.shape, np.int64)
    index = np.zeros(active.shape, np.int64)
    word = np.zeros(active.shape, np.int64)

    def store(at, value):
        out[at[active]] = value[active]

    for n in range(n_chunks):
        stage(n)
        col = bufs[n & 1]

        def sample(k):
            v = col[:, k * IMA_ROW + lane] * np.float32(32768.0)
            # one saturating conversion: a NaN gives 0
            return np.nan_to_num(np.clip(np.rint(v), -32768, 32767),
                                 nan=0.0).astype(np.int64)

        lo = 0
        if n == 0:
            pred = sample(0).copy()
            if spb > 1:
                d = np.abs(sample(1) - pred)
                for half in (64, 32, 16, 8, 4, 2, 1):
                    i = index + half
                    ok = (i <= 88) & (steps[np.minimum(i, 88)] <= d)
                    index = np.where(ok, i, index)
            store(b * bw + c, (pred & 0xFFFF) | (index << 16))
            lo = 1
        for i in range(lo, min(IMA_CHUNK, spb - n * IMA_CHUNK)):
            k = n * IMA_CHUNK + i
            step = steps[index]
            diff = sample(i) - pred
            adiff = np.abs(diff)
            b4 = adiff >= step
            adiff = adiff - np.where(b4, step, 0)
            b2 = adiff >= step >> 1
            adiff = adiff - np.where(b2, step >> 1, 0)
            b1 = adiff >= step >> 2
            diffq = ((step >> 3) + np.where(b4, step, 0)
                     + np.where(b2, step >> 1, 0)
                     + np.where(b1, step >> 2, 0))
            pred = np.clip(pred + np.where(diff < 0, -diffq, diffq),
                           -32768, 32767)
            moved = np.where(b4, index + 2 + 4 * b2 + 2 * b1, index - 1)
            index = np.clip(moved, 0, 88)
            code = (np.where(diff < 0, 8, 0) | 4 * b4 | 2 * b2 | b1)
            j = k - 1
            word = word | (code << (4 * (j & 7)))
            if j & 7 == 7:
                store(b * bw + ch + (j >> 3) * ch + c, word)
                word = np.zeros_like(word)
    return out.astype('<u4').view(np.uint8)


#: (ch, spb, frames): two or more tiles at each width with a short last
#: block, and a render shorter than one block
IMA_MODEL_CASES = (
    [(ch, spb, spb * (70 // ch + 2) - spb // 3)
     for ch in (1, 2, 16, 33, 64) for spb in (9, 505, 1017)]
    + [(ch, spb, spb // 2) for ch in (1, 33) for spb in (505, 1017)])


@pytest.mark.parametrize('ch,spb,frames', IMA_MODEL_CASES)
def test_ima_tile_walk_model_equals_numpy(ch, spb, frames):
    """The kernel's tile walk (which staged chunk and slot each chain reads
    at each step, which word lands at which byte) gives
    ``ima_encode_np``'s bytes at 1, 2, 16, 33 and 64 channels: narrow
    tiles of whole blocks, a wide block in groups of 32 and 1 channels,
    a short last block and a render shorter than one block."""
    x = tonal(frames, ch, 7 * ch + spb)
    x[frames // 3] = 1.5                       # beyond full scale
    want, _ = codecs.ima_encode_np(x, samples_per_block=spb)
    assert np.array_equal(ima_tile_walk_model(x, spb), want)


def with_nans(x, spb):
    """``x`` with NaN samples where the encoder reads them differently:
    a block's first sample (its header's predictor), its second (the
    starting index) and one inside it, on the first channel and the
    last."""
    x = x.copy()
    for at in (0, spb + 1, 2 * spb + spb // 2):
        x[at % x.shape[0], 0] = np.nan
        x[(at + 3) % x.shape[0], -1] = np.nan
    return x


@pytest.mark.parametrize('ch,spb', [(1, 9), (2, 505), (33, 1017)])
def test_ima_nan_sample_encodes_as_the_jax_encoder(ch, spb):
    """A NaN sample quantizes to 0 in the JAX package's ``ima_encode_jax``
    (its float-to-int conversion), in the kernel's saturating conversion
    (the tile-walk model) and in ``ima_encode_plain``, the CPU path of
    ``ima_encode``: all three give the bytes of the input with its NaNs
    set to 0."""
    jax, jnp, jcodecs = jax_side()
    frames = 3 * spb + 5
    x = with_nans(tonal(frames, ch, 11 * ch + spb), spb)
    want, _ = codecs.ima_encode_np(np.nan_to_num(x, nan=0.0),
                                   samples_per_block=spb)
    assert np.array_equal(np.asarray(jcodecs.ima_encode_jax(
        x, samples_per_block=spb)), want)
    assert np.array_equal(ima_tile_walk_model(x, spb), want)
    assert np.array_equal(codecs.ima_encode(
        torch.from_numpy(x), samples_per_block=spb).numpy(), want)


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
#: block sizes, frames not a multiple of the block; then the edges of its
#: tiles (``IMA_MODEL_CASES``: groups of 32 and 1 channels, a short last
#: block, a render shorter than one block)
IMA_CARD_SHAPES = ([(ch, spb, 64 * spb * 4 // ch + 333)
                    for ch in (1, 2, 16, 64) for spb in (1017, 505)]
                   + IMA_MODEL_CASES)


@pytest.mark.cuda
@pytest.mark.parametrize('ch,spb,frames', IMA_CARD_SHAPES)
def test_cuda_ima_kernel_matches_plain_loop(cuda_device, ch, spb, frames):
    from signals_tpu_torch.compiler import kernels as K
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
@pytest.mark.parametrize('ch,spb', [(1, 9), (2, 505), (33, 1017)])
def test_cuda_ima_kernel_encodes_nan_as_the_jax_encoder(cuda_device, ch,
                                                        spb):
    """NaN samples on the card: the kernel gives the bytes of the input
    with its NaNs set to 0, as ``ima_encode_plain`` and the JAX package's
    encoder do (``test_ima_nan_sample_encodes_as_the_jax_encoder``)."""
    x = with_nans(tonal(3 * spb + 5, ch, 11 * ch + spb), spb)
    got = codecs.ima_encode(torch.from_numpy(x).to(cuda_device),
                            samples_per_block=spb)
    want, _ = codecs.ima_encode_np(np.nan_to_num(x, nan=0.0),
                                   samples_per_block=spb)
    assert np.array_equal(got.cpu().numpy(), want)
    assert torch.equal(got, codecs.ima_encode_plain(
        torch.from_numpy(x).to(cuda_device), samples_per_block=spb))


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
