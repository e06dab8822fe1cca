"""Voice allocation and note scheduling (``signals_tpu.parallel.voices``).

Turns a list of :class:`Note` events into per-voice ``GateSeq`` /
``PitchSeq`` tracks for a :class:`~signals_tpu_torch.parallel.PolyPatch`:

* allocation runs on the **host** once per score (small integer interval
  logic), producing padded per-voice event arrays;
* the arrays are **traced params**, so the arrangement is data: re-scoring
  never recompiles, and the render stays loop-free and seekable (the
  sequencer nodes are functions of the absolute frame index).

Typical use::

    notes = read_midi('song.mid')                  # or hand-written Notes
    poly = sequenced_poly(master, gate=g, pitch=p, notes=notes,
                          n_voices=8)              # device='cuda' default
    audio, _ = poly.render(n_blocks=400)
"""

from __future__ import annotations

import typing

import numpy as np

from signals_tpu_torch.parallel import PolyPatch

F32 = np.float32

#: sentinel start/end for padding events: always "started" (so the pad's
#: value only wins sample-and-hold before the first real note) and never
#: active as a gate (end precedes every timeline position).
_PAD = -1e9


class Note(typing.NamedTuple):
    """One note event in seconds / Hz.

    ``velocity`` is normalized to [0, 1]; route it to a velocity track
    (``sequenced_poly(velocity=...)``) or ignore it.
    """

    start: float
    dur: float
    hz: float
    velocity: float = 1.0

    @property
    def end(self) -> float:
        return self.start + self.dur


def midi_to_hz(note: float) -> float:
    """MIDI note number -> Hz (A4 = 69 = 440)."""
    return 440.0 * 2.0 ** ((note - 69.0) / 12.0)


def allocate_voices(notes: typing.Iterable[Note],
                    n_voices: int,
                    *,
                    release: float = 0.0) -> list[list[Note]]:
    """Greedy allocation of notes onto voices.

    A voice is busy from a note's start until its end plus ``release``;
    among idle voices the **most recently freed** is reused (classic
    voice economy — a melody stays on one voice), so ``release`` is what
    spreads fast passages across voices instead of retriggering through
    a sounding release tail.  When every voice is busy, the voice that
    frees earliest is **stolen**: its current note is clipped to end
    where the new note starts.

    Returns ``n_voices`` lists of non-overlapping notes (some possibly
    empty), each sorted by start time.
    """
    if n_voices < 1:
        raise ValueError('n_voices must be >= 1')
    ordered = sorted(notes, key=lambda n: (n.start, n.hz))
    voices: list[list[Note]] = [[] for _ in range(n_voices)]
    free_at = [float('-inf')] * n_voices
    for note in ordered:
        if note.dur <= 0:
            raise ValueError(f'note duration must be positive: {note}')
        idle = [i for i in range(n_voices) if free_at[i] <= note.start]
        if idle:
            i = max(idle, key=lambda j: free_at[j])
        else:
            i = min(range(n_voices), key=lambda j: free_at[j])
            last = voices[i][-1]
            if last.end > note.start:      # steal: clip the held note
                voices[i][-1] = last._replace(
                    dur=max(note.start - last.start, 1e-6))
        voices[i].append(note)
        free_at[i] = note.end + release
    return voices


def score_tracks(voices: list[list[Note]],
                 *,
                 rate: int = 44100) -> dict[str, np.ndarray]:
    """Per-voice padded event arrays for the sequencer nodes.

    Returns ``starts``/``ends``/``values``/``velocities``, each shaped
    ``(V, 1, E)`` with ``E = max`` events over voices — the exact override
    shapes for a vmap-layout :class:`PolyPatch` whose ``GateSeq``/
    ``PitchSeq`` placeholder state is ``(1, E)``.  Pad events sit at
    ``start = end = -1e9``: never gate-active, and their sample-and-hold
    value (the voice's first pitch, or 0 for silent voices) only shows
    before the first real note.
    """
    n_voices = len(voices)
    n_events = max(1, max((len(v) for v in voices), default=1))
    shape = (n_voices, 1, n_events)
    starts = np.full(shape, _PAD, dtype=F32)
    ends = np.full(shape, _PAD, dtype=F32)
    values = np.zeros(shape, dtype=F32)
    velocities = np.zeros(shape, dtype=F32)
    for i, voice in enumerate(voices):
        if voice:
            values[i, 0, :] = voice[0].hz
            velocities[i, 0, :] = voice[0].velocity
        for j, note in enumerate(voice):
            starts[i, 0, j] = note.start * rate
            ends[i, 0, j] = note.end * rate
            values[i, 0, j] = note.hz
            velocities[i, 0, j] = note.velocity
    return {'starts': starts, 'ends': ends, 'values': values,
            'velocities': velocities}


def sequenced_poly(root,
                   *,
                   gate,
                   pitch,
                   notes: typing.Iterable[Note],
                   n_voices: int,
                   velocity=None,
                   release: float = 0.0,
                   rate: int = 44100,
                   block_frames: int = 1024,
                   overrides: typing.Optional[dict] = None,
                   layout: str = 'vmap',
                   **poly_kwargs) -> PolyPatch:
    """Build a polyphonic, note-scheduled patch in one call.

    ``root`` is the single-voice patch output; ``gate`` is its
    :class:`~signals_tpu_torch.nodes.seq.GateSeq` and ``pitch`` its
    :class:`~signals_tpu_torch.nodes.seq.PitchSeq` (``velocity`` optionally
    a second ``PitchSeq`` carrying note velocities).  Notes are allocated
    onto ``n_voices`` voices and installed as per-voice traced overrides;
    extra per-voice ``overrides`` (detune tables etc.) pass through, and so
    do the other keywords of :class:`~signals_tpu_torch.parallel.PolyPatch`
    (``device``, ``channels``, ``mix_epilogue``).

    ``layout='channels'`` puts the voices on the lane axis (they become the
    sequencer nodes' track *rows*, so the score renders as one V-channel
    patch); it requires a mono voice chain.  The default ``'vmap'`` is
    fully general.
    """
    voices = allocate_voices(notes, n_voices, release=release)
    tracks = score_tracks(voices, rate=rate)
    n_events = tracks['starts'].shape[-1]

    # placeholder (1, E) state so the compiled track shape matches
    placeholder = np.full((1, n_events), _PAD, dtype=F32)
    for node in (gate, pitch) + ((velocity,) if velocity is not None
                                 else ()):
        state = node.get_state()
        state.starts = placeholder.copy()
        state.ends = placeholder.copy()
        if hasattr(state, 'values'):
            state.values = np.zeros((1, n_events), dtype=F32)

    all_overrides = dict(overrides or {})
    all_overrides[(gate, 'starts')] = tracks['starts']
    all_overrides[(gate, 'ends')] = tracks['ends']
    all_overrides[(pitch, 'starts')] = tracks['starts']
    all_overrides[(pitch, 'ends')] = tracks['ends']
    all_overrides[(pitch, 'values')] = tracks['values']
    if velocity is not None:
        all_overrides[(velocity, 'starts')] = tracks['starts']
        all_overrides[(velocity, 'ends')] = tracks['ends']
        all_overrides[(velocity, 'values')] = tracks['velocities']

    return PolyPatch(root, n_voices=n_voices, overrides=all_overrides,
                     rate=rate, block_frames=block_frames, layout=layout,
                     **poly_kwargs)
