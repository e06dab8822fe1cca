"""The flagship forward step as one callable.

``entry(device='cuda')`` builds the 64-voice subtractive patch (saw ->
LFO-swept LowPass -> RingMod(ADSR gated by a 2 Hz Square) -> Gain 1/64) as
a ``PolyPatch(layout='vmap')`` and returns ``(forward, (params, carry,
0))``: ``forward(params, carry, position)`` renders one block of every
voice — ``torch.func.vmap`` of one voice's ``step`` over the stacked
per-voice params and carry — and sums the voices into the master mix,
returning ``(mix (F, 1), carry')`` on the device.  The patch and its
per-voice pitches are those of the JAX package's ``__graft_entry__.entry``.

The multi-device training step of the JAX package (``dryrun_multichip``)
has no counterpart here yet: it needs the voice axis sharded over a device
mesh.

    >>> # forward, (params, carry, position) = entry(device='cpu')
    >>> # mix, carry = forward(params, carry, position)
"""

from __future__ import annotations

import numpy as np
import torch

RATE = 44100
N_VOICES = 64
BLOCK_FRAMES = 1024


def _fixed(value):
    from signals_tpu_torch.nodes.fixed import Fixed
    f = Fixed()
    f.get_state().value = np.atleast_2d(np.asarray(value, dtype=np.float32))
    return f


def subtractive_voice():
    """``(root, hz)``: one voice of the flagship, its pitch at ``hz``."""
    from signals_tpu_torch.nodes.env import ADSR
    from signals_tpu_torch.nodes.fx import Gain, LowPass, Mix, RingMod
    from signals_tpu_torch.nodes.osc import Sawtooth, Sine, Square
    hz = _fixed(110.0)
    saw = Sawtooth()
    saw.hertz = hz
    lfo = Sine()
    lfo.hertz = _fixed(0.5)
    depth = Gain()
    depth.left = lfo
    depth.right = _fixed(900.0)
    cutoff = Mix()
    cutoff.left = depth
    cutoff.right = _fixed(2000.0)
    cutoff.mix = _fixed(0.5)
    lp = LowPass()
    lp.input = saw
    lp.cutoff = cutoff
    gate = Square()
    gate.hertz = _fixed(2.0)
    env = ADSR()
    env.gate = gate
    voiced = RingMod()
    voiced.left = lp
    voiced.right = env
    out = Gain()
    out.left = voiced
    out.right = _fixed(1.0 / N_VOICES)
    return out, hz


def poly(n_voices: int = N_VOICES, block_frames: int = BLOCK_FRAMES,
         device='cuda'):
    """The flagship's ``PolyPatch`` in the vmap layout, one pitch a voice
    (110 Hz up the chromatic scale, an octave every 12 voices)."""
    from signals_tpu_torch.parallel import PolyPatch
    root, hz = subtractive_voice()
    freqs = (110.0 * 2 ** (np.arange(n_voices) % 12 / 12.0)).astype(
        np.float32)
    return PolyPatch(root, n_voices=n_voices,
                     overrides={(hz, 'value'): freqs},
                     block_frames=block_frames, rate=RATE, channels=1,
                     layout='vmap', device=device)


def entry(device='cuda'):
    """``(forward, (params, carry, 0))``: one vmapped and mixed block of the
    64-voice patch on ``device``."""
    p = poly(device=device)
    compiled = p.compiled
    F, ch = compiled.block_frames, compiled.channels
    params, axes = p.params()
    #: a (V, 0) tensor vmapped on dim 0 gives every vmap the voice count
    voices = torch.empty((p.n_voices, 0), device=p.device)

    def voice_step(params, carry, position, _voice):
        block, carry2 = compiled.step(params, carry, position)
        return torch.broadcast_to(block, (F, ch)), carry2

    vstep = torch.func.vmap(voice_step, in_dims=(axes, 0, None, 0))

    def forward(params, carry, position):
        blocks, carry2 = vstep(params, carry, position, voices)
        return blocks.sum(dim=0), carry2

    return forward, (params, p.init_carry(), 0)


if __name__ == '__main__':
    fn, args = entry()
    out, _ = fn(*args)
    print('entry forward:', tuple(out.shape), float(out.abs().max()))
