#!/usr/bin/env python3
"""The flagship-sized fit (``bench.py:549-651``, c9) on one NVIDIA GPU.

64 voices, each two sine partials (F0 and 3 F0, one trainable hertz) ->
Mix 0.7 -> LowPass (trainable cutoff) -> Gain (trainable gain): 192
trainables recovered against 12 s of per-voice target audio by
``signals_tpu_torch.learn.fit`` — Adam at a relative learning rate of
0.005, ``per_channel_spectral_loss`` — for 300 steps from the JAX
benchmark's start (hertz 2 % off, cutoffs 800 Hz, gains 0.5; seed 7).

Prints the card's name and power limit, steps/s, the loss ratio, the
median hertz error in cents at the start and the end, the median relative
cutoff and gain errors, and the peak device memory; the last line is one
JSON object with those numbers.

    python3 scripts/torch_fit_full.py
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

STEPS = 300               # bench.py:549-651's c9 run


def main() -> int:
    if not torch.cuda.is_available():
        print('torch_fit_full: no CUDA GPU visible to torch', file=sys.stderr)
        return 2
    from signals_tpu_torch import learn
    from signals_tpu_torch.compiler import compile_node
    cs.phase_build()
    card = cs.card_line()
    (t_hz, t_cut, t_vol), (s_hz, s_cut, s_vol) = cs.c9_targets()
    n_blocks = cs.c9_blocks()
    t_root, *_ = cs.build_c9(t_hz, t_cut, t_vol)
    target = compile_node(t_root, block_frames=cs.F, rate=cs.RATE,
                          channels=cs.V, device='cuda').render(
        n_blocks=n_blocks)[0]
    root, hz, cut, vol = cs.build_c9(s_hz, s_cut, s_vol)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = learn.fit(root, target, [(hz, 'value'), (cut, 'value'),
                                   (vol, 'value')],
                    rate=cs.RATE, block_frames=cs.F, steps=STEPS,
                    learning_rate=0.005, relative_lr=True,
                    loss=learn.per_channel_spectral_loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fit_hz = hz.get_state().value.reshape(-1)
    fit_cut = cut.get_state().value.reshape(-1)
    fit_vol = vol.get_state().value.reshape(-1)

    def cents(f):
        return float(np.median(np.abs(1200 * np.log2(f / t_hz))))

    out = {
        'card': card, 'n_voices': cs.V, 'n_blocks': n_blocks,
        'target_seconds': n_blocks * cs.F / cs.RATE, 'trainables': 3 * cs.V,
        'steps': STEPS, 'wall_s': wall,
        'steps_per_sec': STEPS / wall,
        'ms_per_step': wall / STEPS * 1e3,
        'loss_first': float(res.losses[0]),
        'loss_last': float(res.losses[-1]),
        'loss_ratio': float(res.losses[-1] / res.losses[0]),
        'hz_err_cents_start': cents(s_hz),
        'hz_err_cents_median': cents(fit_hz),
        'cut_err_rel_median': float(np.median(np.abs(fit_cut - t_cut)
                                              / t_cut)),
        'vol_err_rel_median': float(np.median(np.abs(fit_vol - t_vol)
                                              / t_vol)),
        'peak_bytes': torch.cuda.max_memory_allocated(),
    }
    for k, v in out.items():
        print(f'[fit_full] {k}: {v!r}')
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
