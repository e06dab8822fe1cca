"""Modulation effects on the PyTorch port: a saw pad through a stereo
chorus (``FracDelay`` with per-channel LFO spread) into a swept
``Phaser``, bounced to a WAV (counterpart of ``examples/modulation.py``).

Run: python examples_torch/modulation.py [out.wav] [--device cuda|cpu]
"""

import argparse
import pathlib
import sys

# runnable as `python examples_torch/<name>.py` from anywhere: the repo
# root (the signals_tpu_torch package) is the parent of this directory
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from signals_tpu_torch.nodes.dev import Rack, SinkDevice
from signals_tpu_torch.nodes.files import FileWriter
from signals_tpu_torch.nodes.fixed import Fixed
from signals_tpu_torch.nodes.fx import Gain, Mix
from signals_tpu_torch.nodes.moddelay import FracDelay
from signals_tpu_torch.nodes.osc import Sawtooth, Sine
from signals_tpu_torch.nodes.phaser import Phaser
from signals_tpu_torch.nodes.shape import Merge


def fixed(v):
    f = Fixed()
    f.get_state().value = np.atleast_2d(np.asarray(v, dtype=np.float32))
    return f


def lfo_around(center, depth, hertz):
    # Mix(m=0.5) crossfades: 0.5*L + 0.5*R — double both legs so the
    # result swings center +/- depth, not half that
    osc = Sine()
    osc.hertz = fixed(hertz)
    d = Gain()
    d.left = osc
    d.right = fixed(2.0 * depth)
    m = Mix()
    m.left = d
    m.right = fixed(2.0 * center)
    m.mix = fixed(0.5)
    return m


def build(path):
    """The chain into a ``FileWriter`` at ``path``; returns the writer."""
    pad = Sawtooth()
    pad.hertz = fixed(146.83)               # D3

    # stereo chorus: two detuned moving taps, one per channel
    spread = Merge()
    spread.left = lfo_around(0.012, 0.004, 0.6)
    spread.right = lfo_around(0.017, 0.004, 0.73)
    chorus_tap = FracDelay()
    chorus_tap.get_state().max_delay = 0.03
    chorus_tap.input = pad
    chorus_tap.delay = spread
    chorus = Mix()
    chorus.left = pad
    chorus.right = chorus_tap
    chorus.mix = fixed(0.5)

    swoosh = Phaser()
    swoosh.input = chorus
    swoosh.sweep = lfo_around(1000.0, 700.0, 0.4)

    out = Gain()
    out.left = swoosh
    out.right = fixed(0.7)

    writer = FileWriter()
    writer.get_state().path = path
    writer.input = out
    return writer


def main(path='modulation.wav', device='cuda'):
    writer = build(path)
    rack = Rack()
    rack.scan()
    sink = SinkDevice(rack.get_sink('default'), realtime=False,
                      device=device)
    sink.get_state().channels = 2
    sink.input = writer
    audio = sink.render_offline(seconds=5.0).cpu().numpy()
    writer.destroy()                        # close the file
    print(f'rendered {audio.shape[0]} frames x {audio.shape[1]} ch '
          f'(peak {np.abs(audio).max():.3f}) -> {path}')


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description='chorus and phaser to a WAV')
    parser.add_argument('path', nargs='?', default='modulation.wav')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args()
    main(args.path, device=args.device)
