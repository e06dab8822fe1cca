"""The ``stems`` configuration on the program: ``bench.py:549-651``'s
flagship-sized fit (c9).  Each of ``voices`` voices is two sine partials
(F0 and 3 F0 from one hertz) -> ``Mix`` -> ``LowPass`` (its cutoff, the
configuration's context) -> ``Gain`` (its gain), built as one patch of
``voices`` channels whose hertz, cutoff and gain are ``(1, voices)``
``Fixed`` rows: the channels layout, the filter one segment-kernel call
(K2) a render.  The system fits the ``3 voices`` values to target stems
through ``learn.fit`` with ``learn.per_channel_spectral_loss``; the
benchmark draws the target and start values from the seed and hands the
same values to the program and to the reference.

The check's leaves are the three rows in units of the start's values,
``max(|start|, 0.01)`` an element: the scale of ``relative_lr``'s step,
so Adam moves every element of every row about one learning rate a step
and the rows' changes are of one size.  A gradient leaf is the gradient in
the same units (the gradient in the value times the unit).  In hertz the
cutoff's gradient is ~1e-4 of the hertz's and its row would sit under the
check's floor for ``step_gap``; in these units it is ~0.2 of the median
row's."""

from __future__ import annotations

import numpy as np

#: the trainable rows, the fit's leaves: each voice's hertz, cutoff and gain
ROWS = ('hz', 'cutoff', 'gain')
#: the least unit of a leaf's element (``learn.fit``'s ``relative_lr`` floor)
FLOOR = 0.01


def make_inputs(cfg: dict, seed: int) -> dict:
    """What the benchmark hands to both sides: the ``target`` and ``start``
    values, ``{row: float32 (voices,)}``.  As ``bench.py:613-622``: target
    hertz ``base 2^((i mod 12)/12) (1 + 0.001 i)``, cutoffs evenly from the
    first to the last of ``target_cutoff_hz``, gains uniform on
    ``target_gain``; the start's hertz off the target's by a uniform share
    of ``start_hz_offset``, its cutoffs and gains the configuration's.  The
    gains and the offsets are drawn from the seed."""
    V = cfg['voices']
    rng = np.random.default_rng([seed, 0])
    i = np.arange(V)
    th = cfg['target_hz']
    hz = (th['base'] * 2.0 ** (i % th['semitones_mod'] / 12.0)
          * (1.0 + th['detune_per_voice'] * i)).astype(np.float32)
    lo, hi = cfg['target_cutoff_hz']
    gain = rng.uniform(*cfg['target_gain'], V).astype(np.float32)
    off = cfg['start_hz_offset']
    start_hz = (hz * (1.0 + rng.uniform(-off, off, V))).astype(np.float32)
    return {'target': {'hz': hz,
                       'cutoff': np.linspace(lo, hi, V).astype(np.float32),
                       'gain': gain},
            'start': {'hz': start_hz,
                      'cutoff': np.full(V, cfg['start_cutoff_hz'],
                                        np.float32),
                      'gain': np.full(V, cfg['start_gain'], np.float32)}}


def units(start: dict) -> dict:
    """Each element's unit in the leaves: ``{row: max(|start|, FLOOR)}``
    (float64 ``(voices,)``) of the start's values ``start``."""
    return {r: np.maximum(np.abs(np.asarray(start[r], np.float64)), FLOOR)
            for r in ROWS}


def leaves(values: dict, unit: dict) -> dict:
    """The values ``{row: (voices,)}`` as the check's leaves: one float64
    leaf of ``voices`` elements a row, in ``unit`` (:func:`units`)."""
    return {r: np.asarray(values[r], np.float64).reshape(-1) / unit[r]
            for r in ROWS}


def values(leaves_: dict, unit: dict) -> dict:
    """The inverse of :func:`leaves`: ``{row: float64 (voices,)}``."""
    return {r: np.asarray(leaves_[r], np.float64) * unit[r] for r in ROWS}


def fixed(value):
    from signals_tpu_torch.nodes.fixed import Fixed
    f = Fixed()
    f.get_state().value = np.atleast_2d(np.asarray(value, np.float32))
    return f


def patch(cfg: dict):
    """The voices' patch: ``(root, {row: its Fixed node})``."""
    from signals_tpu_torch.nodes.fx import Gain, LowPass, Mix
    from signals_tpu_torch.nodes.osc import Sine
    V = cfg['voices']
    rows = {r: fixed(np.zeros((1, V))) for r in ROWS}
    partials = []
    for k in cfg['partials']:
        osc = Sine()
        if k == 1.0:
            osc.hertz = rows['hz']
        else:
            hz = Gain()
            hz.left = rows['hz']
            hz.right = fixed(k)
            osc.hertz = hz
        partials.append(osc)
    mx = Mix()
    mx.left, mx.right = partials
    mx.mix = fixed(cfg['mix'])
    lp = LowPass()
    lp.input = mx
    lp.cutoff = rows['cutoff']
    lp.get_state().context = cfg['context']
    out = Gain()
    out.left = lp
    out.right = rows['gain']
    return out, rows


class Stems:
    def __init__(self, cfg: dict, seed: int, device, traffic: dict):
        from signals_tpu_torch.compiler import compile_node
        self.device = device
        self.cfg = cfg
        self.block_frames = F = cfg['block_frames']
        self.rate = cfg['rate']
        self.inputs = make_inputs(cfg, seed)
        self.unit = units(self.inputs['start'])
        self.root, self.rows = patch(cfg)
        self.n_fit = n = traffic['blocks']
        self.shapes = {'voices': cfg['voices'], 'blocks': n,
                       'context': cfg['context'], 'block_frames': F,
                       'nsec': 1}
        # the target stems, rendered once by the program and kept on the
        # device (no copy a call)
        self._set(self.inputs['target'])
        self.target = compile_node(
            self.root, block_frames=F, rate=self.rate,
            channels=cfg['voices'], device=device).render(
                n_blocks=n)[0].detach()
        self._set(self.inputs['start'])

    def _set(self, values: dict) -> None:
        """Puts the values ``{row: (voices,)}`` (not leaves) on the rows."""
        for r, node in self.rows.items():
            node.get_state().value = np.asarray(
                values[r], np.float32).reshape(1, -1)

    def loss(self, pred, target):
        """The configuration's loss, looked up at each call (a fault
        planted on ``learn`` reaches it)."""
        from signals_tpu_torch import learn
        c = self.cfg['loss']
        return learn.per_channel_spectral_loss(
            pred, target, fft_sizes=tuple(c['fft_sizes']),
            waveform=c['waveform'], log_eps=c['log_eps'])

    def param(self) -> dict:
        """The fitted values as leaves (:func:`leaves`)."""
        return leaves({r: node.get_state().value
                       for r, node in self.rows.items()}, self.unit)

    def fit(self, steps: int, learning_rate: float, relative_lr: bool):
        """``steps`` optimizer steps of the ``3 voices`` values through
        ``learn.fit``, continuing from where the last call left them; the
        steps' losses."""
        from signals_tpu_torch import learn
        res = learn.fit(self.root, self.target,
                        [(node, 'value') for node in self.rows.values()],
                        rate=self.rate, block_frames=self.block_frames,
                        steps=steps, learning_rate=learning_rate,
                        relative_lr=relative_lr, loss=self.loss, apply=True,
                        device=self.device)
        return res.losses

    def loss_grad(self) -> tuple[float, dict]:
        """The loss at the current values and its gradient in the leaves'
        units, through ``learn.fit``'s own render and loss
        (``learn.make_loss_core``)."""
        import torch
        from signals_tpu_torch import learn
        from signals_tpu_torch.compiler import compile_node
        compiled = compile_node(self.root, block_frames=self.block_frames,
                                rate=self.rate, device=self.device)
        params = compiled.params()
        rows = {}
        for r, node in self.rows.items():
            uid = compiled.index.info(node).uid
            rows[r] = params[uid]['value'] = (
                params[uid]['value'].detach().clone().requires_grad_())
        core = learn.make_loss_core(compiled, self.n_fit, loss=self.loss)
        value = core(params, self.target,
                     compiled.host_inputs(0, self.n_fit))
        grads = torch.autograd.grad(value, list(rows.values()))
        # the gradient in a leaf's unit: the value's gradient times it
        return float(value.detach()), {
            r: g.detach().to(torch.float64).cpu().numpy().reshape(-1)
            * self.unit[r] for r, g in zip(rows, grads)}


def build(cfg: dict, seed: int, device, traffic: dict) -> Stems:
    return Stems(cfg, seed, device, traffic)
