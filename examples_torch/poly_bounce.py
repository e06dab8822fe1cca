"""Bounce a 16-voice chord of subtractive voices to a WAV file on the
PyTorch port — the polyphonic path end to end (counterpart of
``examples/poly_bounce.py``).

Run: python examples_torch/poly_bounce.py [out.wav] [--device cuda|cpu]
"""

import argparse
import pathlib
import sys

# runnable as `python examples_torch/<name>.py` from anywhere: the repo
# root (the signals_tpu_torch package) is the parent of this directory
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from signals_tpu_torch.nodes.env import ADSR
from signals_tpu_torch.nodes.fixed import Fixed
from signals_tpu_torch.nodes.fx import Gain, LowPass, RingMod
from signals_tpu_torch.nodes.osc import Sawtooth, Square
from signals_tpu_torch.parallel import PolyPatch
from signals_tpu_torch.runtime.wavio import write_wav


def fixed(v):
    f = Fixed()
    f.get_state().value = np.atleast_2d(np.asarray(v, dtype=np.float32))
    return f


def main(path='poly_bounce.wav', seconds=2.0, device='cuda'):
    hz = fixed(110.0)
    saw = Sawtooth()
    saw.hertz = hz
    lp = LowPass()
    lp.input = saw
    lp.cutoff = fixed(1800.0)
    gate = Square()
    gate.hertz = fixed(1.0)
    env = ADSR()
    env.gate = gate
    voiced = RingMod()
    voiced.left = lp
    voiced.right = env
    out = Gain()
    out.left = voiced
    out.right = fixed(1.0 / 16)

    # a 16-voice stacked chord: root, fifth, octave... with slight detune
    base = 110.0
    intervals = [0, 7, 12, 16, 19, 24, 28, 31] * 2
    detune = 1 + 0.002 * np.arange(16)
    freqs = (base * 2 ** (np.array(intervals) / 12) * detune).astype(np.float32)

    poly = PolyPatch(out, n_voices=16, overrides={(hz, 'value'): freqs},
                     device=device)
    n_blocks = int(seconds * 44100 / 1024)
    audio, _ = poly.render(n_blocks=n_blocks)
    audio = audio.cpu().numpy()
    write_wav(path, audio, 44100)
    print(f'wrote {path}: {audio.shape[0]} frames, '
          f'peak {np.abs(audio).max():.3f}')


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description='16-voice chord to a WAV')
    parser.add_argument('path', nargs='?', default='poly_bounce.wav')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args()
    main(args.path, device=args.device)
