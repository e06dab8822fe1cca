"""Minimal programmatic API demo on the PyTorch port (counterpart of
``examples/play_sine.py``): wire a sine to a sink and play it through
the realtime ring runtime for two seconds.

Connection is attribute assignment on ports; rendering goes through the
compiled engine on ``--device``.  The rack's virtual ``default`` sink
paces the stream at the sample rate without sound hardware.

Run: python examples_torch/play_sine.py [--device cuda|cpu]
"""

import argparse
import pathlib
import sys

# runnable as `python examples_torch/<name>.py` from anywhere: the repo
# root (the signals_tpu_torch package) is the parent of this directory
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import time

import numpy as np

import signals_tpu_torch.nodes.dev as dev
import signals_tpu_torch.nodes.fixed as fixed
import signals_tpu_torch.nodes.osc as osc


def main(device='cuda'):
    rack = dev.Rack()
    rack.scan()
    for sink_info in rack.sinks():
        print(sink_info.describe())

    sink = dev.SinkDevice(rack.get_sink('default'), device=device)
    sink.get_state().channels = 2

    sine = osc.Sine()
    sink.input = sine

    sine_hertz = fixed.Fixed()
    sine_hertz.get_state().value = np.array([[440.0]], dtype=np.float32)
    sine.hertz = sine_hertz

    sink.capture(True)
    sink.start()
    try:
        time.sleep(2.0)
    except KeyboardInterrupt:
        pass
    sink.stop()
    sink.close()
    audio = sink.captured()
    print(f'rendered {audio.shape[0]} frames, '
          f'{sink.underruns} underruns, peak {np.abs(audio).max():.3f}')
    return audio


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description='play a sine for 2 s')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args()
    main(device=args.device)
