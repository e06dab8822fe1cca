"""Differentiable synthesis on the PyTorch port: recover synth parameters
by gradient descent against target audio (counterpart of
``examples/fit_patch.py``): a gain, a pitch, and eight per-voice gains
from one mix.

Run: python examples_torch/fit_patch.py [--device cuda|cpu]
"""

import argparse
import functools
import pathlib
import sys

# runnable as `python examples_torch/<name>.py` from anywhere: the repo
# root (the signals_tpu_torch package) is the parent of this directory
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from signals_tpu_torch.compiler import compile_node
from signals_tpu_torch.learn import fit, spectral_loss
from signals_tpu_torch.nodes.fixed import Fixed
from signals_tpu_torch.nodes.fx import Gain
from signals_tpu_torch.nodes.osc import Sine
from signals_tpu_torch.parallel import PolyPatch


def fixed(v):
    f = Fixed()
    f.get_state().value = np.atleast_2d(np.asarray(v, dtype=np.float32))
    return f


def main(device='cuda'):
    # target: a 0.7-gain 440 Hz sine, rendered by the framework itself
    t_hz, t_vol = fixed(440.0), fixed(0.7)
    t_osc = Sine()
    t_osc.hertz = t_hz
    t_out = Gain()
    t_out.left = t_osc
    t_out.right = t_vol
    target, _ = compile_node(t_out, block_frames=512, rate=44100,
                             channels=1, device=device).render(n_blocks=8)

    # model: same topology, wrong gain — fit it
    hz, vol = fixed(440.0), fixed(0.05)
    o = Sine()
    o.hertz = hz
    out = Gain()
    out.left = o
    out.right = vol
    result = fit(out, target, [(vol, 'value')], block_frames=512,
                 steps=150, learning_rate=0.05, device=device)
    print(f'loss {result.losses[0]:.4f} -> {result.losses[-1]:.6f}; '
          f'fitted gain = {float(vol.get_state().value[0, 0]):.3f} '
          f'(target 0.7)')

    # pitch estimation: the waveform-L2 term's gradient oscillates with
    # the beat phase of a detuned oscillator, so pitch fits drop it
    # (spectral_loss(waveform=0.0)) — a sine starting 30 Hz off lands
    # within a fraction of a Hz
    hz2, vol2 = fixed(470.0), fixed(0.7)
    o2 = Sine()
    o2.hertz = hz2
    out2 = Gain()
    out2.left = o2
    out2.right = vol2
    result = fit(out2, target, [(hz2, 'value')], block_frames=512,
                 steps=300, learning_rate=0.5,
                 loss=functools.partial(spectral_loss, waveform=0.0),
                 device=device)
    print(f'pitch fit: 470 Hz start -> '
          f'{float(hz2.get_state().value[0, 0]):.2f} Hz (target 440)')

    # polyphonic: 8 per-voice gains recovered SIMULTANEOUSLY from one
    # mixed target (each voice owns a distinct partial) — the same call
    # shards over a device mesh (PolyPatch(..., mesh=...).fit)
    freqs = np.linspace(200, 900, 8).astype(np.float32)
    tgt_gains = np.linspace(0.3, 0.9, 8).astype(np.float32)

    def poly_voice():
        hz, vol = fixed(220.0), fixed(0.5)
        o = Sine()
        o.hertz = hz
        g = Gain()
        g.left = o
        g.right = vol
        return g, hz, vol

    root_t, hz_t, vol_t = poly_voice()
    ptgt = PolyPatch(root_t, n_voices=8,
                     overrides={(hz_t, 'value'): freqs,
                                (vol_t, 'value'): tgt_gains},
                     block_frames=512, layout='channels', device=device)
    mix_target, _ = ptgt.render(n_blocks=24)

    root_m, hz_m, vol_m = poly_voice()
    poly = PolyPatch(root_m, n_voices=8,
                     overrides={(hz_m, 'value'): freqs,
                                (vol_m, 'value'): np.full(
                                    8, 0.2, np.float32)},
                     block_frames=512, layout='channels', device=device)
    result = poly.fit(mix_target, [(vol_m, 'value')], steps=200,
                      learning_rate=0.02)
    fitted = next(s for n, _p, _a, s in poly._channel_overrides
                  if n is vol_m).reshape(-1)
    err = float(np.abs(fitted - tgt_gains).max())
    print(f'poly fit: 8 per-voice gains from one mix, '
          f'max |error| = {err:.3f} '
          f'(loss {result.losses[0]:.3f} -> {result.losses[-1]:.5f})')


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description='fit a gain, a pitch and '
                                     'eight per-voice gains')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args()
    main(device=args.device)
