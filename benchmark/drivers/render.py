"""The loop of a traffic file of ``kind`` ``render``: closed loop, one
client.  Each call renders ``blocks`` blocks through the configuration's
``render(position, n_blocks)`` (the program's ``PolyPatch.render``) and
copies the mix, whatever its channels, into pinned host memory.

Positions: ``"zero"`` renders from block 0 every time; ``"advance"`` moves
on by the batch each call and wraps after ``wrap_batches`` batches.

``samples`` calls keep their mix for the check: the seed draws a moment of
the window for each, before the window opens, and the first call to start
after it copies its mix into a pinned buffer of its own instead of the
shared one, so keeping a mix costs the window nothing.

Each call's host times are kept: its start, the return of the program's
call (the enqueue), and its end after the copy to the host.
"""

from __future__ import annotations

import time

import numpy as np

#: the sampled moments lie in this share of the window, from its start
SAMPLED_SHARE = 0.9


class Driver:
    warm_units = 1

    def __init__(self, traffic: dict, system, seed: int):
        self.traffic = traffic
        self.system = system
        self.n = traffic['blocks']
        self.F = system.block_frames
        self.rate = system.rate
        wrap = (traffic.get('wrap_batches', 1)
                if traffic['positions'] == 'advance' else 1)
        self.positions = [k * self.n * self.F for k in range(wrap)]
        rng = np.random.default_rng([seed, 1])
        self.moments = np.sort(rng.uniform(0.0, SAMPLED_SHARE,
                                           traffic['samples']))
        self.host = None             # the shared pinned buffer
        self.kept = []               # one pinned buffer a sample
        self.samples = []            # [(call index, position, buffer)]
        self.calls = 0

    def _buffers(self, mix):
        import torch
        pin = self.system.device.type == 'cuda'

        def empty():
            return torch.empty(mix.shape, dtype=mix.dtype, pin_memory=pin)
        self.host = empty()
        self.kept = [empty() for _ in self.moments]

    def call(self, record=None, keep=False):
        """One call: render, copy to the host (into the next sample's
        buffer where ``keep``); ``record`` gets ``(t0, t_enqueued, t_end,
        audio seconds, 0)``."""
        pos = self.positions[self.calls % len(self.positions)]
        t0 = time.perf_counter()
        mix = self.system.render(pos, self.n)
        t1 = time.perf_counter()
        if self.host is None:
            self._buffers(mix)
        dest = self.kept[len(self.samples)] if keep else self.host
        dest.copy_(mix)
        t2 = time.perf_counter()
        if record is not None:
            record.append((t0, t1, t2, self.n * self.F / self.rate, 0))
        if keep:
            self.samples.append((self.calls, pos, dest))
        self.calls += 1

    def warm(self):
        import torch
        self.call()
        if self.system.device.type == 'cuda':
            torch.cuda.synchronize(self.system.device)

    def window(self, seconds: float) -> list:
        calls = []
        self.calls = 0
        self.samples = []
        start = time.perf_counter()
        end = start + seconds
        due = [start + u * seconds for u in self.moments]
        # at least as many calls as are sampled for the check
        while (time.perf_counter() < end
               or len(self.samples) < len(due)):
            k = len(self.samples)
            self.call(calls, keep=k < len(due)
                      and time.perf_counter() >= due[k])
        return calls

    def outputs(self) -> dict:
        return {'samples': [(i, pos, buf.numpy())
                            for i, pos, buf in self.samples]}

    def check(self, reference, cfg, inputs, outputs, device, dtype) -> dict:
        """``{'mix_gap': worst over the samples of max |mix - reference|
        / max |reference|}``."""
        import torch
        worst = 0.0
        for _, pos, got in outputs['samples']:
            want = reference.mix(cfg, inputs, pos, self.n, device, dtype)
            want = want.to(torch.float64).cpu().numpy().reshape(got.shape)
            gap = float(np.max(np.abs(got.astype(np.float64) - want))
                        / max(np.max(np.abs(want)), 1e-30))
            worst = max(worst, gap if np.isfinite(gap) else float('inf'))
        return {'mix_gap': worst}
