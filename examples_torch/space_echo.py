"""Space echo on the PyTorch port: a gated saw lead through the FDN
reverb and the RMS compressor, bounced to an AIFF (or FLAC) file
(counterpart of ``examples/space_echo.py``).

Run: python examples_torch/space_echo.py [out.aiff] [--device cuda|cpu]
"""

import argparse
import pathlib
import sys

# runnable as `python examples_torch/<name>.py` from anywhere: the repo
# root (the signals_tpu_torch package) is the parent of this directory
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from signals_tpu_torch.nodes.dev import Rack, SinkDevice
from signals_tpu_torch.nodes.dyn import Compressor
from signals_tpu_torch.nodes.env import ADSR
from signals_tpu_torch.nodes.files import FileWriter
from signals_tpu_torch.nodes.fixed import Fixed
from signals_tpu_torch.nodes.fx import Gain, LowPass, RingMod
from signals_tpu_torch.nodes.osc import Sawtooth, Square
from signals_tpu_torch.nodes.reverb import Reverb


def fixed(v):
    f = Fixed()
    f.get_state().value = np.atleast_2d(np.asarray(v, dtype=np.float32))
    return f


def main(path='space_echo.aiff', device='cuda'):
    saw = Sawtooth()
    saw.hertz = fixed(220.0)
    lp = LowPass()
    lp.input = saw
    lp.cutoff = fixed(1800.0)

    gate = Square()
    gate.hertz = fixed(2.5)
    env = ADSR()
    env.gate = gate
    st = env.get_state()
    st.attack, st.decay, st.sustain, st.release = 0.005, 0.05, 0.4, 0.08
    plucked = RingMod()
    plucked.left = lp
    plucked.right = env

    verb = Reverb()
    verb.input = plucked
    vs = verb.get_state()
    vs.t60, vs.mix = 2.5, 0.45

    squeeze = Compressor()
    squeeze.input = verb
    cs = squeeze.get_state()
    cs.threshold, cs.ratio, cs.makeup = 0.25, 3.0, 1.4

    out = Gain()
    out.left = squeeze
    out.right = fixed(0.8)

    writer = FileWriter()
    writer.get_state().path = path
    writer.input = out

    rack = Rack()
    rack.scan()
    sink = SinkDevice(rack.get_sink('default'), realtime=False,
                      device=device)
    sink.get_state().channels = 1
    sink.input = writer
    audio = sink.render_offline(seconds=4.0).cpu().numpy()
    writer.destroy()                        # close the file
    print(f'rendered {audio.shape[0]} frames '
          f'(peak {np.abs(audio).max():.3f}) -> {path}')


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description='reverb and compressor '
                                     'to an AIFF file')
    parser.add_argument('path', nargs='?', default='space_echo.aiff')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args()
    main(args.path, device=args.device)
