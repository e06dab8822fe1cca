"""Minimal RIFF/WAVE read & write (``signals_tpu.runtime.wavio``, copied:
numpy only, no array library of a device).

Read: PCM 8/16/24/32-bit, IEEE float32/float64, G.711 mu-law/A-law and
IMA ADPCM (plus the EXTENSIBLE wrapper).  Write: IEEE float32, PCM16,
mu-law, A-law or IMA ADPCM.  The reference delegates sound-file IO to
libsndfile via the ``soundfile`` package
(``src/signals/chain/files.py:8,44``); this self-contained implementation
covers seekable block IO without that dependency —
:mod:`signals_tpu_torch.runtime.sndfile` dispatches to libsndfile for other
formats when the package is importable.
"""

from __future__ import annotations

import pathlib
import struct
import typing

import numpy as np

_FMT_PCM = 1
_FMT_FLOAT = 3
_FMT_ALAW = 6
_FMT_MULAW = 7
_FMT_IMA_ADPCM = 0x11


class WavError(Exception):
    pass


class WavReader:
    """Seekable frame reader. Supports PCM16 and float32 WAV files."""

    def __init__(self, path):
        self.path = pathlib.Path(path)
        self._f = self.path.open('rb')
        self._parse_header()

    def _parse_header(self) -> None:
        f = self._f
        riff, _, wave = struct.unpack('<4sI4s', f.read(12))
        if riff != b'RIFF' or wave != b'WAVE':
            raise WavError(f'{self.path}: not a RIFF/WAVE file')
        self._data_offset = None
        self.frames = 0
        fmt = None
        fact_frames = None
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            cid, size = struct.unpack('<4sI', header)
            if cid == b'fmt ':
                fmt = f.read(size)
            elif cid == b'fact' and size >= 4:
                fact_frames = struct.unpack('<I', f.read(4))[0]
                f.seek(size - 4 + (size & 1), 1)
            elif cid == b'data':
                self._data_offset = f.tell()
                data_size = size
                f.seek(size + (size & 1), 1)
            else:
                f.seek(size + (size & 1), 1)
        if fmt is None or self._data_offset is None:
            raise WavError(f'{self.path}: missing fmt/data chunk')
        (audio_fmt, channels, rate, _, block_align, bits) = struct.unpack(
            '<HHIIHH', fmt[:16])
        if audio_fmt == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
            audio_fmt = struct.unpack('<H', fmt[24:26])[0]
        if audio_fmt not in (_FMT_PCM, _FMT_FLOAT, _FMT_ALAW, _FMT_MULAW,
                             _FMT_IMA_ADPCM):
            raise WavError(f'{self.path}: unsupported format {audio_fmt}')
        if audio_fmt == _FMT_PCM and bits not in (8, 16, 24, 32):
            raise WavError(f'{self.path}: unsupported PCM depth {bits}')
        if audio_fmt == _FMT_FLOAT and bits not in (32, 64):
            raise WavError(f'{self.path}: unsupported float depth {bits}')
        self.fmt_code = audio_fmt
        self.is_float = audio_fmt == _FMT_FLOAT
        self.bits = bits
        self.channels = channels
        self.rate = rate
        self._frame_bytes = block_align
        if audio_fmt == _FMT_IMA_ADPCM:
            from signals_tpu_torch.runtime import codecs
            if len(fmt) >= 20:
                self._spb = struct.unpack('<H', fmt[18:20])[0]
            else:
                self._spb = codecs.ima_samples_per_block(
                    block_align, channels)
            self._block_align = block_align
            n_blocks = data_size // block_align
            self.frames = n_blocks * self._spb
            if fact_frames is not None:
                self.frames = min(self.frames, fact_frames)
        else:
            self.frames = data_size // block_align

    def _decode(self, raw: bytes) -> np.ndarray:
        """Raw frame bytes -> float32 in [-1, 1] (PCM) / as stored (float)."""
        if self.fmt_code == _FMT_MULAW:
            from signals_tpu_torch.runtime import codecs
            return codecs.mulaw_decode(np, np.frombuffer(raw, dtype=np.uint8))
        if self.fmt_code == _FMT_ALAW:
            from signals_tpu_torch.runtime import codecs
            return codecs.alaw_decode(np, np.frombuffer(raw, dtype=np.uint8))
        if self.is_float:
            dt = '<f4' if self.bits == 32 else '<f8'
            return np.frombuffer(raw, dtype=dt).astype(np.float32)
        if self.bits == 8:          # WAV 8-bit PCM is unsigned
            u = np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
            return (u - 128.0) / 128.0
        if self.bits == 16:
            return np.frombuffer(raw, dtype='<i2').astype(np.float32) / 32768.0
        if self.bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            i = (b[:, 0].astype(np.int32)
                 | (b[:, 1].astype(np.int32) << 8)
                 | (b[:, 2].astype(np.int32) << 16))
            i = np.where(i >= 1 << 23, i - (1 << 24), i)
            return i.astype(np.float32) / float(1 << 23)
        return (np.frombuffer(raw, dtype='<i4').astype(np.float32)
                / float(1 << 31))

    def read(self, position: int, frames: int) -> np.ndarray:
        """Read ``frames`` frames at absolute frame ``position`` as float32
        ``(frames, channels)``; out-of-range regions are zero-filled."""
        out = np.zeros((frames, self.channels), dtype=np.float32)
        start = max(position, 0)
        stop = min(position + frames, self.frames)
        if stop > start and self.fmt_code == _FMT_IMA_ADPCM:
            # ADPCM blocks decode independently (header carries predictor
            # + index), so random access happens at block granularity
            from signals_tpu_torch.runtime import codecs
            b0 = start // self._spb
            b1 = (stop - 1) // self._spb + 1
            self._f.seek(self._data_offset + b0 * self._block_align)
            raw = self._f.read((b1 - b0) * self._block_align)
            payload = np.frombuffer(raw, dtype=np.uint8)
            dec = codecs.ima_decode_np(payload, channels=self.channels,
                                       block_align=self._block_align)
            data = dec[start - b0 * self._spb:stop - b0 * self._spb]
            out[start - position:start - position + data.shape[0]] = data
            return out
        if stop > start:
            self._f.seek(self._data_offset + start * self._frame_bytes)
            raw = self._f.read((stop - start) * self._frame_bytes)
            data = self._decode(raw).reshape(-1, self.channels)
            out[start - position:start - position + data.shape[0]] = data
        return out

    def close(self) -> None:
        self._f.close()


class WavWriter:
    """Sequential frame writer (float32, PCM16, mu-law, A-law or IMA
    ADPCM); header finalized on close."""

    _ADPCM_SPB = 1017               # samples per ADPCM block (odd)

    def __init__(self, path, *, rate: int, channels: int,
                 subtype: str = 'float32'):
        if subtype not in ('float32', 'pcm16', 'mulaw', 'alaw', 'adpcm'):
            raise WavError(f'unsupported write subtype {subtype!r}')
        self.path = pathlib.Path(path)
        self.rate = int(rate)
        self.channels = int(channels)
        self.subtype = subtype
        self._sample_bytes = {'float32': 4, 'pcm16': 2, 'mulaw': 1,
                              'alaw': 1, 'adpcm': 0}[subtype]
        self.frames = 0
        if subtype == 'adpcm':
            from signals_tpu_torch.runtime import codecs
            self._spb = self._ADPCM_SPB
            self._block_align = ((self._spb - 1) // 2 + 4) * self.channels
            self._pending = np.zeros((0, self.channels), dtype=np.float32)
            self._data_bytes = 0
        self._f = self.path.open('wb')
        self._write_header()

    def _write_header(self) -> None:
        self._f.seek(0)
        if self.subtype == 'adpcm':
            # 20-byte fmt (cbSize=2 + wSamplesPerBlock) and a fact chunk
            # with the true frame count, as the WAV spec requires for
            # compressed formats
            ba = self._block_align
            byte_rate = (self.rate * ba + self._spb - 1) // self._spb
            self._f.write(struct.pack(
                '<4sI4s4sIHHIIHHHH4sII4sI',
                b'RIFF', 4 + 28 + 12 + 8 + self._data_bytes, b'WAVE',
                b'fmt ', 20, _FMT_IMA_ADPCM, self.channels, self.rate,
                byte_rate, ba, 4, 2, self._spb,
                b'fact', 4, self.frames,
                b'data', self._data_bytes))
            return
        sb = self._sample_bytes
        data_size = self.frames * self.channels * sb
        fmt = {'float32': _FMT_FLOAT, 'pcm16': _FMT_PCM,
               'mulaw': _FMT_MULAW, 'alaw': _FMT_ALAW}[self.subtype]
        if fmt in (_FMT_MULAW, _FMT_ALAW):
            # 18-byte fmt (cbSize=0) + fact chunk, per spec for non-PCM
            self._f.write(struct.pack(
                '<4sI4s4sIHHIIHHH4sII4sI',
                b'RIFF', 4 + 26 + 12 + 8 + data_size, b'WAVE',
                b'fmt ', 18, fmt, self.channels, self.rate,
                self.rate * self.channels * sb, self.channels * sb,
                8 * sb, 0,
                b'fact', 4, self.frames,
                b'data', data_size))
            return
        self._f.write(struct.pack(
            '<4sI4s4sIHHIIHH4sI',
            b'RIFF', 36 + data_size, b'WAVE',
            b'fmt ', 16, fmt, self.channels, self.rate,
            self.rate * self.channels * sb, self.channels * sb, 8 * sb,
            b'data', data_size))

    def _encode(self, block: np.ndarray) -> bytes:
        if self.subtype == 'float32':
            return block.astype('<f4').tobytes()
        if self.subtype == 'pcm16':
            q = np.clip(np.rint(block * 32767.0), -32768, 32767)
            return q.astype('<i2').tobytes()
        from signals_tpu_torch.runtime import codecs
        if self.subtype == 'mulaw':
            return codecs.mulaw_encode(np, block).tobytes()
        return codecs.alaw_encode(np, block).tobytes()

    def _flush_adpcm(self, final: bool = False) -> None:
        from signals_tpu_torch.runtime import codecs
        n_whole = self._pending.shape[0] // self._spb
        take = n_whole * self._spb
        if final and self._pending.shape[0] > take:
            take = self._pending.shape[0]       # encoder pads the tail
        if take == 0:
            return
        payload, _ = codecs.ima_encode_np(self._pending[:take],
                                          samples_per_block=self._spb)
        self._pending = self._pending[take:]
        self._f.seek(0, 2)
        self._f.write(payload.tobytes())
        self._data_bytes += payload.nbytes

    def write(self, block: np.ndarray) -> None:
        block = np.asarray(block, dtype=np.float32)
        if block.ndim != 2 or block.shape[1] != self.channels:
            block = np.broadcast_to(block, (block.shape[0], self.channels))
        block = np.ascontiguousarray(block)
        if self.subtype == 'adpcm':
            self._pending = np.concatenate([self._pending, block], axis=0)
            self.frames += block.shape[0]
            self._flush_adpcm()
        else:
            self._f.seek(0, 2)
            self._f.write(self._encode(block))
            self.frames += block.shape[0]
        # keep the header valid after every block so the file is readable
        # while recording is still in progress
        self._write_header()
        self._f.flush()

    def write_encoded(self, payload: np.ndarray, frames: int) -> None:
        """Append pre-encoded payload: exactly this subtype's ``data``-chunk
        bytes, as a device-side encoder produces them (so a bounce fetches
        1-2 bytes/sample instead of 4-byte floats)."""
        if self.subtype == 'float32':
            raise WavError('write_encoded requires an encoded subtype')
        if self.subtype == 'pcm16':
            raw = np.ascontiguousarray(payload).astype('<i2').tobytes()
        else:
            raw = np.ascontiguousarray(payload).astype(np.uint8).tobytes()
        if self.subtype == 'adpcm':
            if self._pending.shape[0]:
                raise WavError(
                    'cannot mix write() and write_encoded() on one file')
            if len(raw) % self._block_align:
                raise WavError('adpcm payload must be whole blocks')
            self._data_bytes += len(raw)
        self._f.seek(0, 2)
        self._f.write(raw)
        self.frames += int(frames)
        self._write_header()
        self._f.flush()

    def close(self) -> None:
        if self.subtype == 'adpcm':
            self._flush_adpcm(final=True)
        self._write_header()
        self._f.close()


def read_wav(path) -> typing.Tuple[np.ndarray, int]:
    r = WavReader(path)
    try:
        return r.read(0, r.frames), r.rate
    finally:
        r.close()


def write_wav(path, data: np.ndarray, rate: int) -> None:
    data = np.atleast_2d(np.asarray(data, dtype=np.float32))
    if data.shape[0] == 1 and data.shape[1] > 4:
        data = data.T
    w = WavWriter(path, rate=rate, channels=data.shape[1])
    try:
        w.write(data)
    finally:
        w.close()
