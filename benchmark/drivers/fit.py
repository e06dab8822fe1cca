"""The loop of a traffic file of ``kind`` ``fit``: the configuration's
``fit(steps)`` (the program's ``PolyPatch.fit`` or ``learn.fit``) back to
back in calls of ``steps_per_call`` optimizer steps, each continuing from
the last.  Set-up takes the first ``first_steps`` steps through the same
call.

The system's parameters are leaves: ``param()`` gives ``{leaf name:
float64 array}``, ``loss_grad()`` the loss at the current parameters and
the gradient as leaves of the same names.  The check compares them with
the reference's by the worst leaf: the gap between the program's norm of a
leaf and the reference's, as a share of the reference's norm of that leaf
or of the median leaf, whichever is larger.
"""

from __future__ import annotations

import time

import numpy as np

#: leaves whose reference gradient at the start is under this share of the
#: median leaf's move by round-off alone, and are left out of ``step_gap``
MOVES_BY_ROUNDING = 1e-3


def norms(leaves: dict) -> dict:
    return {k: float(np.linalg.norm(np.asarray(v, np.float64)))
            for k, v in leaves.items()}


def scale(*refs: dict) -> dict:
    """Per leaf, the largest of its norm and the median leaf's norm in any
    of ``refs`` (leaves by name)."""
    out = {}
    for ref in refs:
        n = norms(ref)
        med = float(np.median(list(n.values())))
        for k, v in n.items():
            out[k] = max(out.get(k, 0.0), v, med)
    return out


def worst_leaf(got: dict, want: dict, by: dict, leaves=None) -> float:
    """``max_l | |got_l| - |want_l| | / by_l`` over ``leaves`` (all of
    ``want``'s by default); inf where a number is not finite."""
    g, w = norms(got), norms(want)
    worst = 0.0
    for k in (want if leaves is None else leaves):
        gap = abs(g[k] - w[k]) / max(by[k], 1e-300)
        worst = max(worst, gap if np.isfinite(gap) else float('inf'))
    return worst


def change(after: dict, before: dict) -> dict:
    return {k: np.asarray(after[k], np.float64) - before[k] for k in after}


class Driver:

    def __init__(self, traffic: dict, system, seed: int):
        self.traffic = traffic
        self.system = system
        self.first = {}
        # the gradient at the start, then the first steps
        self.warm_units = 1 + traffic['first_steps']

    def warm(self):
        """The first steps, through the window's own call: the program's
        gradient at the start, then ``first_steps`` steps."""
        import torch
        t = self.traffic
        s = self.system
        p0 = s.param()
        _, g0 = s.loss_grad()
        losses = s.fit(t['first_steps'], t['learning_rate'], t['relative_lr'])
        self.first = {'p0': p0, 'g0': g0, 'losses': list(losses),
                      'p_after': s.param()}
        if s.device.type == 'cuda':
            torch.cuda.synchronize(s.device)

    def call(self, record=None):
        t = self.traffic
        k = t['steps_per_call']
        t0 = time.perf_counter()
        self.system.fit(k, t['learning_rate'], t['relative_lr'])
        t1 = time.perf_counter()
        if record is not None:
            record.append((t0, t1, t1, 0.0, k))

    def window(self, seconds: float) -> list:
        calls = []
        end = time.perf_counter() + seconds
        while not calls or time.perf_counter() < end:
            self.call(calls)
        return calls

    def outputs(self) -> dict:
        """The program's loss and gradient at the parameters the window
        reached, beside what set-up recorded of the first steps."""
        p_end = self.system.param()
        loss_end, g_end = self.system.loss_grad()
        return dict(self.first, p_end=p_end, loss_end=loss_end, g_end=g_end)

    def check(self, reference, cfg, inputs, outputs, device, dtype) -> dict:
        """``loss_gap``: the first steps' losses and the loss where the
        window ended, each as a share of the reference's loss there or at
        the start, whichever is larger.  ``grad_gap``: the gradient at the
        start and where the window ended, by the worst leaf, each leaf
        measured against the reference's norms at that point and at the
        start.  ``step_gap``: the change of the parameters over the first
        steps, by the worst leaf, leaving out the leaves that move by
        rounding alone (:data:`MOVES_BY_ROUNDING`)."""
        t = self.traffic
        o = outputs
        ref = reference.fit_reference(cfg, inputs, t, o['p0'], [o['p_end']],
                                      device, dtype)
        loss_end, g_end = ref['at'][0]
        l0, g0 = ref['losses'][0], ref['grads'][0]

        def rel(a, b):
            gap = float(abs(a - b) / max(abs(b), abs(l0), 1e-300))
            return gap if np.isfinite(gap) else float('inf')

        losses = o['losses'][:len(ref['losses'])]
        loss_gap = max([rel(a, b) for a, b in zip(losses, ref['losses'])]
                       + [rel(o['loss_end'], loss_end)])
        grad_gap = max(worst_leaf(o['g0'], g0, scale(g0)),
                       worst_leaf(o['g_end'], g_end, scale(g_end, g0)))
        n0 = norms(g0)
        med = float(np.median(list(n0.values())))
        moving = [k for k, v in n0.items() if v >= MOVES_BY_ROUNDING * med]
        want = change(ref['params'][-1], o['p0'])
        step_gap = worst_leaf(change(o['p_after'], o['p0']), want,
                              scale({k: want[k] for k in moving}), moving)
        return {'loss_gap': loss_gap, 'grad_gap': grad_gap,
                'step_gap': step_gap}
