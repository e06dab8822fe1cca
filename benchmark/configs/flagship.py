"""The ``flagship`` configuration on the program: ``voices`` sawtooth
voices, each into a low-pass swept by a sine LFO (``0.5 depth sin + 0.5
cutoff``), ring-modulated by an ADSR that a square wave gates, times
``1 / voices``; a ``PolyPatch`` in the channels layout, so the render is
the mix plan (one generator-fed segment-kernel call with the voice sum in
the kernel).  The voices' pitches come from the seed."""

from __future__ import annotations

import numpy as np


def pitches(cfg: dict, seed: int) -> np.ndarray:
    """The source's detuned table (``base 2^(i mod 12 / 12) (1 + i/1000)``)
    with each voice moved by a uniform draw of ``detune_cents``."""
    V = cfg['voices']
    i = np.arange(V)
    table = cfg['pitch_base_hz'] * 2.0 ** (i % 12 / 12.0) * (1 + 0.001 * i)
    rng = np.random.default_rng([seed, 0])
    cents = rng.uniform(-1.0, 1.0, V) * cfg['detune_cents']
    return (table * 2.0 ** (cents / 1200.0)).astype(np.float32)


def _fixed(value):
    from signals_tpu_torch.nodes.fixed import Fixed
    f = Fixed()
    f.get_state().value = np.atleast_2d(np.float32(value))
    return f


def voice(cfg: dict):
    """The voice's patch; returns ``(root, pitch node)``."""
    from signals_tpu_torch.nodes.env import ADSR
    from signals_tpu_torch.nodes.fx import Gain, LowPass, Mix, RingMod
    from signals_tpu_torch.nodes.osc import Sawtooth, Sine, Square
    hz = _fixed(cfg['pitch_base_hz'])
    saw = Sawtooth()
    saw.hertz = hz
    lfo = Sine()
    lfo.hertz = _fixed(cfg['lfo_hz'])
    depth = Gain()
    depth.left = lfo
    depth.right = _fixed(cfg['depth_hz'])
    cutoff = Mix()
    cutoff.left = depth
    cutoff.right = _fixed(cfg['cutoff_hz'])
    cutoff.mix = _fixed(0.5)
    lp = LowPass()
    lp.input = saw
    lp.cutoff = cutoff
    lp.get_state().context = cfg['context']
    lp.get_state().carry = cfg['carry_blocks']
    gate = Square()
    gate.hertz = _fixed(cfg['gate_hz'])
    env = ADSR()
    env.gate = gate
    st = env.get_state()
    st.attack, st.decay, st.sustain, st.release = cfg['adsr']
    voiced = RingMod()
    voiced.left = lp
    voiced.right = env
    out = Gain()
    out.left = voiced
    out.right = _fixed(1.0 / cfg['voices'])
    return out, hz


class Flagship:
    def __init__(self, cfg: dict, seed: int, device, traffic: dict):
        from signals_tpu_torch.parallel import PolyPatch
        self.device = device
        self.block_frames = cfg['block_frames']
        self.rate = cfg['rate']
        self.inputs = make_inputs(cfg, seed)
        hz = self.inputs['hz']
        root, hz_node = voice(cfg)
        self.poly = PolyPatch(root, n_voices=cfg['voices'],
                              overrides={(hz_node, 'value'): hz},
                              block_frames=self.block_frames, rate=self.rate,
                              device=device)
        self.shapes = {'voices': cfg['voices'], 'blocks': traffic['blocks'],
                       'context': cfg['context'],
                       'blocks_per_seg': cfg['carry_blocks'],
                       'block_frames': self.block_frames, 'nsec': 1}

    def render(self, position: int, n_blocks: int):
        return self.poly.render(position=position, n_blocks=n_blocks)[0]


def build(cfg: dict, seed: int, device, traffic: dict) -> Flagship:
    return Flagship(cfg, seed, device, traffic)


def make_inputs(cfg: dict, seed: int) -> dict:
    """What the benchmark hands to both sides: the voices' pitches."""
    return {'hz': pitches(cfg, seed)}
