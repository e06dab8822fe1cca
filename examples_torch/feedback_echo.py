"""Feedback echo on the PyTorch port: the classic delay loop, rendered
loop-free.

A plucked saw repeats through ``Delay -> Gain(0.45) -> Mix`` feeding back
into itself.  The compiler proves the loop frame-local affine and solves
the whole render with one scan over delay-length segments
(``signals_tpu_torch/compiler/feedback.py``), so six seconds of audio are
one render call, not hundreds of block steps.  Counterpart of
``examples/feedback_echo.py``: the same patch, the same file.

Run: python examples_torch/feedback_echo.py [out.wav] [--device cuda|cpu]
"""

import argparse
import pathlib
import sys

# runnable as `python examples_torch/<name>.py` from anywhere: the repo
# root (the signals_tpu_torch package) is the parent of this directory
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from signals_tpu_torch.nodes.delay import Delay
from signals_tpu_torch.nodes.dev import Rack, SinkDevice
from signals_tpu_torch.nodes.env import ADSR
from signals_tpu_torch.nodes.fixed import Fixed
from signals_tpu_torch.nodes.fx import Gain, LowPass, Mix, RingMod
from signals_tpu_torch.nodes.osc import Sawtooth, Square
from signals_tpu_torch.runtime.wavio import write_wav

RATE = 44100


def fixed(v):
    f = Fixed()
    f.get_state().value = np.atleast_2d(np.asarray(v, dtype=np.float32))
    return f


def main(out_path='echo.wav', device='cuda'):
    # plucked lead: saw -> lowpass -> ADSR gate at 1.25 Hz
    saw = Sawtooth()
    saw.hertz = fixed(220.0)
    lp = LowPass()
    lp.input = saw
    lp.cutoff = fixed(1800.0)
    gate = Square()
    gate.hertz = fixed(1.25)
    env = ADSR()
    env.gate = gate
    st = env.get_state()
    st.attack, st.decay, st.sustain, st.release = 0.005, 0.12, 0.25, 0.08
    pluck = RingMod()
    pluck.left = lp
    pluck.right = env

    # the feedback loop: mix <- 0.45 * delay(mix), 3/8 s repeats
    mix = Mix()
    echo = Delay()
    echo.get_state().frames = int(0.375 * RATE)
    fb = Gain()
    fb.left = echo
    fb.right = fixed(0.45)
    mix.left = pluck
    mix.right = fb
    mix.mix = fixed(0.55)
    echo.input = mix

    rack = Rack()
    rack.scan()
    sink = SinkDevice(rack.get_sink('default'), realtime=False,
                      device=device)
    sink.get_state().channels = 2
    sink.input = mix
    audio = sink.render_offline(seconds=6.0).cpu().numpy()
    write_wav(out_path, audio, RATE)
    print(f'wrote {out_path}: {audio.shape[0]} frames, '
          f'peak {float(np.abs(audio).max()):.3f} '
          f'(repeats every 0.375 s, -13.9 dB per pass: the echo return '
          f'is (1-mix)*gain = 0.45*0.45)')


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description='feedback echo to a WAV')
    parser.add_argument('out_path', nargs='?', default='echo.wav')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args()
    main(args.out_path, device=args.device)
