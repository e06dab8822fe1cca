"""Render a short melody to WAV on the PyTorch port: sequencer ->
subtractive voice (counterpart of ``examples/melody.py``).

Run: python examples_torch/melody.py [out.wav] [--device cuda|cpu]
"""

import argparse
import pathlib
import sys

# runnable as `python examples_torch/<name>.py` from anywhere: the repo
# root (the signals_tpu_torch package) is the parent of this directory
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from signals_tpu_torch.compiler import compile_node
from signals_tpu_torch.nodes.env import ADSR
from signals_tpu_torch.nodes.fixed import Fixed
from signals_tpu_torch.nodes.fx import Gain, LowPass, RingMod
from signals_tpu_torch.nodes.osc import Sawtooth
from signals_tpu_torch.nodes.seq import GateSeq, PitchSeq
from signals_tpu_torch.runtime.wavio import write_wav

RATE = 44100


def fixed(v):
    f = Fixed()
    f.get_state().value = np.atleast_2d(np.asarray(v, dtype=np.float32))
    return f


def note(name):
    names = {'c': 0, 'd': 2, 'e': 4, 'f': 5, 'g': 7, 'a': 9, 'b': 11}
    return 261.63 * 2 ** (names[name] / 12)


def main(path='melody.wav', device='cuda'):
    line = 'c c g g a a g f f e e d d c'.split()
    beat = 0.22
    events = [(i * beat, beat * (0.9 if n != 'g' else 1.8), note(n))
              for i, n in enumerate(line)]

    gate = GateSeq()
    gate.set_events([(s, d) for s, d, _ in events], rate=RATE)
    pitch = PitchSeq()
    pitch.set_events(events, rate=RATE)

    osc = Sawtooth()
    osc.hertz = pitch
    lp = LowPass()
    lp.input = osc
    lp.cutoff = fixed(1800.0)
    env = ADSR()
    env.gate = gate
    st = env.get_state()
    st.attack, st.decay, st.sustain, st.release = 0.01, 0.05, 0.7, 0.08
    voiced = RingMod()
    voiced.left = lp
    voiced.right = env
    out = Gain()
    out.left = voiced
    out.right = fixed(0.6)

    seconds = events[-1][0] + 1.0
    compiled = compile_node(out, block_frames=1024, rate=RATE, channels=1,
                            device=device)
    audio, _ = compiled.render(n_blocks=int(seconds * RATE / 1024))
    audio = audio.cpu().numpy()
    write_wav(path, audio, RATE)
    print(f'wrote {path}: {audio.shape[0] / RATE:.2f}s, '
          f'peak {np.abs(audio).max():.3f}')


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description='a short melody to a WAV')
    parser.add_argument('path', nargs='?', default='melody.wav')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args()
    main(args.path, device=args.device)
