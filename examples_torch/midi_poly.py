"""Polyphonic MIDI playback on the PyTorch port: .mid file -> voice
allocator -> PolyPatch (counterpart of ``examples/midi_poly.py``).

Writes a short demo MIDI file (a four-chord progression over a bass
line), reads it back through the SMF parser, allocates notes onto eight
voices, and renders the score in one call.  Point ``main`` at your own
``.mid`` to play it instead.

Run: python examples_torch/midi_poly.py [demo.mid] [out.wav]
     [--device cuda|cpu]
"""

import argparse
import pathlib
import sys

# runnable as `python examples_torch/<name>.py` from anywhere: the repo
# root (the signals_tpu_torch package) is the parent of this directory
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import struct

from signals_tpu_torch.nodes.env import ADSR
from signals_tpu_torch.nodes.fixed import Fixed
from signals_tpu_torch.nodes.fx import LowPass, RingMod
from signals_tpu_torch.nodes.osc import Sawtooth
from signals_tpu_torch.nodes.seq import GateSeq, PitchSeq
from signals_tpu_torch.parallel.voices import sequenced_poly
from signals_tpu_torch.runtime.wavio import write_wav
from signals_tpu_torch.utils.midifile import read_midi

RATE = 44100


def demo_midi(path):
    """I-vi-IV-V in C with a bass line, 120 bpm, one bar each."""
    def varlen(v):
        out = [v & 0x7F]
        v >>= 7
        while v:
            out.append(0x80 | (v & 0x7F))
            v >>= 7
        return bytes(reversed(out))

    chords = [(60, 64, 67), (57, 60, 64), (53, 57, 60), (55, 59, 62)]
    bass = [36, 33, 29, 31]
    events = []
    for chord, root in zip(chords, bass):
        for n in chord + (root,):
            events.append((0, bytes([0x90, n, 0x60])))
        events.append((480 * 4 - 40, bytes([0x80, chord[0], 0])))
        for n in chord[1:] + (root,):
            events.append((0, bytes([0x80, n, 0])))
        events.append((40, bytes([0x90, 0, 0])))   # re-align to the bar
        events.append((0, bytes([0x80, 0, 0])))
    body = b''.join(varlen(d) + e for d, e in events)
    body += varlen(0) + b'\xff\x2f\x00'
    with open(path, 'wb') as f:
        f.write(b'MThd' + struct.pack('>IHHH', 6, 0, 1, 480))
        f.write(b'MTrk' + struct.pack('>I', len(body)) + body)


def build_voice():
    gate = GateSeq()
    pitch = PitchSeq()
    vel = PitchSeq()
    osc = Sawtooth()
    osc.hertz = pitch
    lp = LowPass()
    lp.input = osc
    cut = Fixed()
    cut.get_state().value = [[1800.0]]
    lp.cutoff = cut
    env = ADSR()
    st = env.get_state()
    st.attack, st.decay, st.sustain, st.release = 0.01, 0.15, 0.6, 0.25
    env.gate = gate
    voiced = RingMod()
    voiced.left = lp
    voiced.right = env
    out = RingMod()
    out.left = voiced
    out.right = vel
    return out, gate, pitch, vel


def main(midi_path='demo.mid', out_path='midi_poly.wav', device='cuda'):
    demo_midi(midi_path)
    notes = read_midi(midi_path, include_channels=set(range(9)))
    print(f'{midi_path}: {len(notes)} notes, '
          f'{max(n.end for n in notes):.2f} s')
    root, gate, pitch, vel = build_voice()
    poly = sequenced_poly(root, gate=gate, pitch=pitch, velocity=vel,
                          notes=notes, n_voices=8, release=0.25,
                          rate=RATE, channels=1, layout='channels',
                          device=device)
    seconds = max(n.end for n in notes) + 0.3
    n_blocks = int(seconds * RATE) // poly.compiled.block_frames + 1
    audio, _ = poly.render(n_blocks=n_blocks)
    audio = audio.cpu().numpy()
    write_wav(out_path, audio * 0.15, RATE)
    print(f'wrote {out_path}: {audio.shape[0]} frames')


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description='a MIDI score to a WAV')
    parser.add_argument('midi_path', nargs='?', default='demo.mid')
    parser.add_argument('out_path', nargs='?', default='midi_poly.wav')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args()
    main(args.midi_path, args.out_path, device=args.device)
