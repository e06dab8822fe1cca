"""The ``score`` configuration on the program: ``examples/midi_poly.py``'s
voice (a sawtooth at a ``PitchSeq`` pitch into a fixed ``LowPass``,
ring-modulated by an ADSR on a ``GateSeq``, then by a velocity
``PitchSeq``) as ``voices`` sequenced voices in the vmap layout.  The
benchmark draws the notes from the seed and hands the same notes to the
program (``sequenced_poly`` allocates the voices) and to the reference."""

from __future__ import annotations

import numpy as np


def notes(cfg: dict, seed: int) -> list:
    """``(start_s, dur_s, hz, velocity)`` of a melody (one note every
    ``score_seconds / melody_notes`` s, a random walk over MIDI 60-96,
    0.1-0.19 s long, velocity 60-127) and ``chords`` four-note chords (a
    root 36-72 with its third, fifth and octave at a random start, 0.1-1.0
    s long, velocity 40-99); A4 = 69 = 440 Hz, velocity over 127."""
    rng = np.random.default_rng([seed, 0])
    secs = cfg['score_seconds']

    def note(start, dur, midi, vel):
        return (start, dur, 440.0 * 2.0 ** ((midi - 69.0) / 12.0),
                vel / 127.0)

    out = []
    step = secs / cfg['melody_notes']
    pitch = 72
    for i in range(cfg['melody_notes']):
        pitch = int(np.clip(pitch + rng.integers(-4, 5), 60, 96))
        out.append(note(i * step, float(rng.uniform(0.1, 0.19)), pitch,
                        int(rng.integers(60, 128))))
    for _ in range(cfg['chords']):
        start = float(rng.uniform(0.0, secs - 1.0))
        dur = float(rng.uniform(0.1, 1.0))
        root = int(rng.integers(36, 73))
        third = 3 if rng.integers(2) else 4
        vel = int(rng.integers(40, 100))
        out.extend(note(start, dur, root + k, vel) for k in (0, third, 7, 12))
    return out


def voice(cfg: dict):
    """The voice's patch: ``(root, gate, pitch, velocity, cutoff)``."""
    from signals_tpu_torch.nodes.env import ADSR
    from signals_tpu_torch.nodes.fixed import Fixed
    from signals_tpu_torch.nodes.fx import LowPass, RingMod
    from signals_tpu_torch.nodes.osc import Sawtooth
    from signals_tpu_torch.nodes.seq import GateSeq, PitchSeq
    gate, pitch, vel = GateSeq(), PitchSeq(), PitchSeq()
    osc = Sawtooth()
    osc.hertz = pitch
    cut = Fixed()
    cut.get_state().value = np.full((1, 1), cfg['cutoff_hz'], np.float32)
    lp = LowPass()
    lp.input = osc
    lp.cutoff = cut
    lp.get_state().context = cfg['context']
    env = ADSR()
    st = env.get_state()
    st.attack, st.decay, st.sustain, st.release = cfg['adsr']
    env.gate = gate
    voiced = RingMod()
    voiced.left = lp
    voiced.right = env
    out = RingMod()
    out.left = voiced
    out.right = vel
    return out, gate, pitch, vel, cut


class Score:
    def __init__(self, cfg: dict, seed: int, device, traffic: dict):
        from signals_tpu_torch.parallel.voices import Note, sequenced_poly
        self.device = device
        self.block_frames = F = cfg['block_frames']
        self.rate = cfg['rate']
        self.inputs = make_inputs(cfg, seed)
        root, gate, pitch, vel, self.cut = voice(cfg)
        self.poly = sequenced_poly(
            root, gate=gate, pitch=pitch, velocity=vel,
            notes=[Note(*n) for n in self.inputs['notes']],
            n_voices=cfg['voices'], release=cfg['release'], rate=self.rate,
            block_frames=F, channels=1, layout=cfg['layout'], device=device)
        n = traffic['blocks']
        self.shapes = {'voices': cfg['voices'], 'blocks': n,
                       'context': cfg['context'], 'block_frames': F,
                       'nsec': 1}
        if traffic['kind'] == 'fit':
            self._set(traffic['target_hz'])
            self.target = self.poly.render(n_blocks=n)[0].detach()
            self._set(traffic['start_hz'])
            self.uid = self.poly.compiled.index.info(self.cut).uid
            self.n_fit = n

    def _set(self, hz: float) -> None:
        self.cut.get_state().value = np.full((1, 1), hz, np.float32)

    def render(self, position: int, n_blocks: int):
        return self.poly.render(position=position, n_blocks=n_blocks)[0]

    def param(self) -> dict:
        """The fitted leaf, the shared cutoff, by the reference's name."""
        return {'cutoff': np.asarray(self.cut.get_state().value,
                                     np.float64).reshape(-1)}

    def fit(self, steps: int, learning_rate: float, relative_lr: bool):
        """``steps`` optimizer steps of the cutoff, continuing from where
        the last call left it; the steps' losses."""
        res = self.poly.fit(self.target, [(self.cut, 'value')], steps=steps,
                            learning_rate=learning_rate,
                            relative_lr=relative_lr, apply=True)
        return res.losses

    def loss_grad(self) -> tuple[float, dict]:
        """The loss at the current cutoff and its gradient, through the
        fit's own render and loss."""
        import torch
        from signals_tpu_torch import learn
        params, _ = self.poly.params()
        leaf = params[self.uid]['value'].requires_grad_()
        mix, _ = self.poly.render_fn(self.n_fit)(
            params, self.poly.init_carry(), 0)
        value = learn.spectral_loss(mix.reshape(-1, 1), self.target)
        (g,) = torch.autograd.grad(value, leaf)
        return float(value.detach()), {
            'cutoff': g.detach().to(torch.float64).cpu().numpy().reshape(-1)}


def build(cfg: dict, seed: int, device, traffic: dict) -> Score:
    return Score(cfg, seed, device, traffic)


def make_inputs(cfg: dict, seed: int) -> dict:
    """What the benchmark hands to both sides: the notes."""
    return {'notes': notes(cfg, seed)}
