"""Standard MIDI File reader (pure Python, no dependencies).

A copy of ``signals_tpu.utils.midifile``.  Parses SMF format 0/1 files
into :class:`~signals_tpu_torch.parallel.voices.Note` lists for the voice
allocator — the input side of the note-scheduling layer.  Only what
scoring needs is interpreted: note-on/off pairs and the tempo map; every
other channel/meta/sysex event is skipped structurally.
"""

from __future__ import annotations

import pathlib
import struct
import typing

from signals_tpu_torch.parallel.voices import Note, midi_to_hz


class BadMidiFile(Exception):
    pass


def _read_varlen(data: bytes, pos: int) -> tuple[int, int]:
    value = 0
    for _ in range(4):
        if pos >= len(data):
            raise BadMidiFile('truncated variable-length quantity')
        byte = data[pos]
        pos += 1
        value = (value << 7) | (byte & 0x7F)
        if not byte & 0x80:
            return value, pos
    raise BadMidiFile('variable-length quantity too long')


_DATA_BYTES = {0x8: 2, 0x9: 2, 0xA: 2, 0xB: 2, 0xC: 1, 0xD: 1, 0xE: 2}


def _parse_track(data: bytes) -> list[tuple[int, int, bytes]]:
    """One MTrk chunk -> [(abs_tick, status, data_bytes)], all events."""
    events = []
    pos = 0
    tick = 0
    status = 0
    while pos < len(data):
        delta, pos = _read_varlen(data, pos)
        tick += delta
        byte = data[pos]
        if byte >= 0x80:
            status = byte
            pos += 1
        elif status < 0x80:
            raise BadMidiFile('data byte with no running status')
        if status == 0xFF:                         # meta
            meta_type = data[pos]
            length, dpos = _read_varlen(data, pos + 1)
            events.append((tick, status,
                           data[pos:dpos + length]))
            pos = dpos + length
            if meta_type == 0x2F:                  # end of track
                break
        elif status in (0xF0, 0xF7):               # sysex
            length, dpos = _read_varlen(data, pos)
            pos = dpos + length
        else:
            n = _DATA_BYTES.get(status >> 4)
            if n is None:
                raise BadMidiFile(f'bad status byte 0x{status:02x}')
            events.append((tick, status, data[pos:pos + n]))
            pos += n
    return events


def read_midi(path, *, include_channels: typing.Optional[set] = None,
              ) -> list[Note]:
    """Read an SMF file into a time-sorted :class:`Note` list.

    Note-on with velocity 0 counts as note-off (running-status idiom);
    tempo changes (meta 0x51) apply from their tick onward across all
    tracks; notes left hanging at end-of-file are closed there.
    ``include_channels`` (0-based) filters channels, e.g. ``{9}`` excluded
    by passing every other channel.
    """
    data = pathlib.Path(path).read_bytes()
    if data[:4] != b'MThd':
        raise BadMidiFile('not a MIDI file (missing MThd)')
    hlen, fmt, ntrks, division = struct.unpack('>IHHH', data[4:14])
    if hlen < 6:
        raise BadMidiFile('bad header length')
    if fmt not in (0, 1):
        raise BadMidiFile(f'unsupported SMF format {fmt}')
    if division & 0x8000:
        # SMPTE: fixed seconds per tick, tempo events are irrelevant
        fps = -struct.unpack('>b', division.to_bytes(2, 'big')[:1])[0]
        tpf = division & 0xFF
        smpte_spt = 1.0 / (fps * tpf)
        tpq = None
    else:
        tpq = division
        smpte_spt = None

    # gather events from every track, merge by (tick, track order)
    merged: list[tuple[int, int, int, bytes]] = []
    pos = 8 + hlen
    track_i = 0
    while pos + 8 <= len(data) and track_i < ntrks:
        chunk_type = data[pos:pos + 4]
        (length,) = struct.unpack('>I', data[pos + 4:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 8 + length
        if chunk_type != b'MTrk':
            continue                               # skip alien chunks
        for tick, status, payload in _parse_track(body):
            merged.append((tick, track_i, status, payload))
        track_i += 1
    merged.sort(key=lambda e: (e[0], e[1]))

    notes: list[Note] = []
    active: dict[tuple[int, int], tuple[float, int]] = {}
    us_per_quarter = 500000                        # SMF default: 120 bpm
    last_tick = 0
    time = 0.0

    def advance(tick: int) -> float:
        nonlocal last_tick, time
        spt = (smpte_spt if smpte_spt is not None
               else us_per_quarter * 1e-6 / tpq)
        time += (tick - last_tick) * spt
        last_tick = tick
        return time

    for tick, _order, status, payload in merged:
        now = advance(tick)
        if status == 0xFF:
            if payload[:1] == b'\x51' and len(payload) >= 5:
                us_per_quarter = int.from_bytes(payload[2:5], 'big')
            continue
        kind, channel = status >> 4, status & 0x0F
        if include_channels is not None and channel not in include_channels:
            continue
        if kind == 0x9 and payload[1] > 0:         # note on
            key = (channel, payload[0])
            if key in active:                      # retrigger: close first
                start, vel = active.pop(key)
                if now > start:
                    notes.append(Note(start, now - start,
                                      midi_to_hz(key[1]), vel / 127.0))
            active[key] = (now, payload[1])
        elif kind == 0x8 or (kind == 0x9 and payload[1] == 0):
            key = (channel, payload[0])
            if key in active:
                start, vel = active.pop(key)
                if now > start:
                    notes.append(Note(start, now - start,
                                      midi_to_hz(key[1]), vel / 127.0))
    for (channel, midi_note), (start, vel) in active.items():
        if time > start:                           # close hanging notes
            notes.append(Note(start, time - start, midi_to_hz(midi_note),
                              vel / 127.0))
    notes.sort(key=lambda n: (n.start, n.hz))
    return notes
