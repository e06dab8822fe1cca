"""References and patch builders that the port's CPU tests and the card
harness (``chip_smoke.py``) share: the flagship voice and its ``.sigs``
form, the port's numpy pull oracle and the float64 filter design it can be
held to, B3's float64 adjoint and its inputs at one shape, and the reader
of a paced consumer's output stream.

A plain module, not a test file.  Imports neither ``jax`` nor
``signals_tpu``: ``chip_smoke.py`` runs it on a machine that has neither.
"""

from __future__ import annotations

import contextlib

import numpy as np

from benchmark.lib.roofline import VJP_FLOP

RATE = 44100
F = 1024            # block frames (the carry grid)
V = 64              # voices
C = 512             # LowPass.context_for(550 Hz)
B3_PLAIN_ROWS = 20000     # longer windows: exact_rows_vjp, not the plain loop


def poly_freqs(n):
    return (110.0 * 2 ** (np.arange(n) % 12 / 12.0)
            * (1 + 0.001 * np.arange(n))).astype(np.float32)



def fixed(value):
    from signals_tpu_torch.nodes.fixed import Fixed
    f = Fixed()
    f.get_state().value = np.atleast_2d(np.float32(value))
    return f



def envelope(filtered, gain):
    """``filtered`` -> RingMod with an ADSR gated by a 2 Hz Square -> Gain
    ``gain``."""
    from signals_tpu_torch.nodes.env import ADSR
    from signals_tpu_torch.nodes.fx import Gain, RingMod
    from signals_tpu_torch.nodes.osc import Square
    gate = Square()
    gate.hertz = fixed(2.0)
    env = ADSR()
    env.gate = gate
    st = env.get_state()
    st.attack, st.decay, st.sustain, st.release = 0.01, 0.08, 0.6, 0.1
    voiced = RingMod()
    voiced.left = filtered
    voiced.right = env
    out = Gain()
    out.left = voiced
    out.right = fixed(gain)
    return out



def build_subtractive_voice(gain=1.0 / V, peak=False):
    """Saw -> LowPass (cutoff 2000 + 900*Sine(0.5 Hz)/2 via Gain/Mix) ->
    RingMod with an ADSR gated by a 2 Hz Square -> Gain ``gain``.  With
    ``peak`` a Peak (+6 dB, Q 1, its freq that same 1000 ± 450 Hz sweep) in
    place of the LowPass (phase 8)."""
    from signals_tpu_torch.nodes.fx import Gain, LowPass, Mix, Peak
    from signals_tpu_torch.nodes.osc import Sawtooth, Sine

    hz = fixed(110.0)
    saw = Sawtooth()
    saw.hertz = hz
    lfo = Sine()
    lfo.hertz = fixed(0.5)
    depth = Gain()
    depth.left = lfo
    depth.right = fixed(900.0)
    cutoff = Mix()
    cutoff.left = depth
    cutoff.right = fixed(2000.0)
    cutoff.mix = fixed(0.5)
    if peak:
        lp = Peak()
        lp.freq = cutoff
        lp.gain = fixed(6.0)
        lp.q = fixed(1.0)
    else:
        lp = LowPass()
        lp.cutoff = cutoff
    lp.input = saw
    lp.get_state().context = LowPass.context_for(550.0, RATE)
    return envelope(lp, gain), hz



def swept_voice_sigs(sink='default', cutoff=2000.0, gain=1.0):
    """:func:`build_subtractive_voice` (at ``gain``, cutoff centre
    ``cutoff``) as the lines of a ``.sigs`` patch feeding a ``sink`` at 9a,
    with the reference's ``signals.chain.*`` names where it has them: the
    pitch at 1a, the cutoff centre's ``Fixed`` at 3a, the sink at 9a."""
    return [
        f'sink 9a {sink}',
        '+ 1a signals.chain.fixed.Fixed value=[[110]]',
        '+ 1b signals.chain.osc.Sawtooth',
        '+ 2a signals.chain.fixed.Fixed value=[[0.5]]',
        '+ 2b signals.chain.osc.Sine',
        '+ 2c signals.chain.fixed.Fixed value=[[900]]',
        '+ 2d signals.chain.fx.Gain',
        f'+ 3a signals.chain.fixed.Fixed value=[[{cutoff!r}]]',
        '+ 3b signals.chain.fixed.Fixed value=[[0.5]]',
        '+ 3c signals.chain.fx.Mix',
        f'+ 4a signals.chain.fx.LowPass context={C}',
        '+ 5a signals.chain.fixed.Fixed value=[[2]]',
        '+ 5b signals.chain.osc.Square',
        '+ 5c signals_tpu.nodes.env.ADSR attack=0.01 decay=0.08 sustain=0.6 '
        'release=0.1',
        '+ 6a signals.chain.fx.RingMod',
        f'+ 6b signals.chain.fixed.Fixed value=[[{gain!r}]]',
        '+ 7a signals.chain.fx.Gain',
        '> 1a 1b.hertz', '> 2a 2b.hertz', '> 2b 2d.left', '> 2c 2d.right',
        '> 2d 3c.left', '> 3a 3c.right', '> 3b 3c.mix', '> 1b 4a.input',
        '> 3c 4a.cutoff', '> 5a 5b.hertz', '> 5b 5c.gate', '> 4a 6a.left',
        '> 5c 6a.right', '> 6a 7a.left', '> 6b 7a.right', '> 7a 9a.input']



def pull_oracle(root, n_blocks, channels, start=0):
    """The port's numpy pull oracle: blocks ``start`` .. ``start + n_blocks
    - 1`` of ``root`` in order (the ADSR's pull evaluation is
    block-monotonic)."""
    from signals_tpu_torch.core import BlockLoc, Request, Shape
    out = []
    for i in range(start, start + n_blocks):
        loc = BlockLoc(position=i * F, rate=RATE, shape=Shape(F, channels))
        b = root.respond(Request(requestor=None, port='oracle', loc=loc))
        out.append(np.broadcast_to(b, (F, channels)))
    return np.concatenate(out)



@contextlib.contextmanager
def exact_design():
    """Within this block the numpy filter design is not rounded to float32:
    the pull oracle filters with the float64 coefficients as designed.  The
    oracle's context windows otherwise run scipy on the float32-rounded b/a
    form, whose rounding moves poles near the unit circle (a 60 Hz notch)
    far more than the coupled form's the kernels run on (phase 8)."""
    from signals_tpu_torch.compiler import filters
    design = filters.design_coupled

    def unrounded(xp, btype, crits, nyquist):
        if xp.is_torch:
            return design(xp, btype, crits, nyquist)
        return filters.coupled64(xp, filters._design64(xp, btype, crits,
                                                       nyquist))

    filters.design_coupled = unrounded
    try:
        yield
    finally:
        filters.design_coupled = design



def exact_rows_vjp(coeffs, x_t, gy, tail, zi=None, gzf=None):
    """``kernels.sosfilt_batch_vjp``'s ``(gcoeffs, gx, gzi)`` in float64 on
    ``x_t``'s device, for windows too long for the plain adjoint's frame
    loop (~0.3 ms a row on the card): per lane and section the forward
    state and the adjoint's lambda are complex first-order recurrences,
    s_t = p s_{t-1} + v_t and lambda_{t-1} = conj(p) lambda_t + (d1 + i
    d2) ybar_t with p = rc + i rs, run by ``scipy.signal.lfilter``, and the
    gradients are float64 sums over the rows."""
    from scipy.signal import lfilter
    co = coeffs.detach().double().cpu().numpy()
    x = x_t.detach().double().cpu().numpy()
    L, B, ch = x.shape
    nsec = co.shape[1]
    g = np.zeros((L, B, ch))
    g[L - tail:] = gy.detach().double().cpu().numpy()

    def states(z):
        if z is None:
            return np.zeros((B, nsec, ch), complex)
        z = z.detach().double().cpu().numpy()
        return z[:, :, 0] + 1j * z[:, :, 1]

    z0, zf = states(zi), states(gzf)
    gco = np.zeros((B, nsec, ch, 11))
    gx = np.zeros((L, B, ch))
    gzi = np.zeros((B, nsec, ch), complex)
    for b in range(B):
        for c in range(ch):
            rc, rs, d0, d1, d2 = co[b, :, c, 6:11].T
            v, lagged = [x[:, b, c]], []
            for s in range(nsec):
                p = rc[s] + 1j * rs[s]
                after = lfilter([1.0], [1.0, -p], v[s],
                                zi=[p * z0[b, s, c]])[0]
                sp = np.concatenate([[z0[b, s, c]], after[:-1]])
                lagged.append(sp)
                v.append(d0[s] * v[s] + d1[s] * sp.real + d2[s] * sp.imag)
            yb = g[:, b, c]
            for s in range(nsec - 1, -1, -1):
                p, sp = rc[s] + 1j * rs[s], lagged[s]
                w = (d1[s] + 1j * d2[s]) * yb
                lam = lfilter([1.0], [1.0, -np.conj(p)],
                              np.concatenate([[zf[b, s, c]], w[:0:-1]]))[::-1]
                gco[b, s, c, 6:] = (
                    np.sum(lam.real * sp.real + lam.imag * sp.imag),
                    np.sum(lam.imag * sp.real - lam.real * sp.imag),
                    np.sum(yb * v[s]), np.sum(yb * sp.real),
                    np.sum(yb * sp.imag))
                gzi[b, s, c] = np.conj(p) * lam[0] + w[0]
                yb = d0[s] * yb + lam.real
            gx[:, b, c] = yb
    import torch
    out = [torch.from_numpy(gco), torch.from_numpy(gx),
           None if zi is None else torch.from_numpy(
               np.stack([gzi.real, gzi.imag], axis=2))]
    return tuple(None if t is None else t.to(x_t.device) for t in out)



def b3_inputs(rng, dev, nsec, B, ch, L, tail, state, cuts=(500.0, 5000.0),
              layout='dense'):
    """B3's inputs at one shape, ``(coeffs (B, nsec, ch, 11), x_t (L, B,
    ch), gy (tail, B, ch), zi, gzf, flops, bytes)``.  Per window and lane a
    LowPass a section, its cutoff drawn from ``cuts``; ``layout``
    ``'unfold'``: windows of one timeline ``tail`` rows apart, read in
    place; ``'broadcast'``: one channel under every lane; ``state``: a
    start state and the end state's cotangent (else None).  Bytes: x (its
    distinct elements), gy and gx once, the coefficients read and their
    gradient written, and the states; operations: ``VJP_FLOP`` a
    section-row."""
    import torch
    from signals_tpu_torch.compiler.filters import design_coupled
    from signals_tpu_torch.core.xp import TorchXP

    def randn(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=dev)

    cut = torch.as_tensor(rng.uniform(*cuts, (1, nsec * B * ch)).astype(
        np.float32), device=dev)
    co = design_coupled(TorchXP(dev), 'lp', (cut,), np.float32(RATE / 2))
    co = co.reshape(nsec, B, ch, 11).permute(1, 0, 2, 3).contiguous()
    if layout == 'unfold':
        xt = randn(L - tail + B * tail, ch)
        x = xt.unfold(0, L, tail)[:B].permute(2, 0, 1)
    else:
        xt = randn(L, B, 1 if layout == 'broadcast' else ch)
        x = xt.expand(L, B, ch)
    gy = randn(tail, B, ch)
    zi = 0.5 * randn(B, nsec, 2, ch) if state else None
    gzf = randn(B, nsec, 2, ch) if state else None
    flops = L * B * ch * nsec * VJP_FLOP
    nbytes = 4 * (xt.numel() + gy.numel() + L * B * ch + 2 * co.numel()
                  + (3 * zi.numel() if state else 0))
    return co, x, gy, zi, gzf, flops, nbytes



def b3_calls(rng, dev, entry, nsec, B, ch, L, tail, state, *args):
    """B3 through the ``entry``'s backward (``'batch'``, ``'timeline'`` or
    ``'stream'``) on :func:`b3_inputs` (the other arguments): ``(kernel
    call, reference call, flops, bytes)``.  The reference is the entry's
    plain adjoint, or past ``B3_PLAIN_ROWS`` rows :func:`exact_rows_vjp`."""
    from signals_tpu_torch.compiler import kernels as K
    co, x, gy, zi, gzf, flops, nbytes = b3_inputs(rng, dev, nsec, B, ch, L,
                                                  tail, state, *args)
    if entry == 'batch':
        call = lambda: K.sosfilt_batch_vjp(            # noqa: E731
            co, x, gy, tail=tail, zi=zi, gzf=gzf)
        plain = lambda: K.sosfilt_batch_vjp_plain(     # noqa: E731
            co, x, gy, tail=tail, zi=zi, gzf=gzf)
    elif entry == 'timeline':
        call = lambda: K.sosfilt_timeline_vjp(         # noqa: E731
            co[0], x[:, 0], gy[:, 0])
        plain = lambda: K.sosfilt_timeline_vjp_plain(  # noqa: E731
            co[0], x[:, 0], gy[:, 0])
    else:
        call = lambda: K.sosfilt_stream_vjp(           # noqa: E731
            co[0], x[:, 0], zi[0], gy[:, 0], gzf[0])
        plain = lambda: K.sosfilt_stream_vjp_plain(    # noqa: E731
            co[0], x[:, 0], zi[0], gy[:, 0], gzf[0])
    if L <= B3_PLAIN_ROWS:
        return call, plain, flops, nbytes

    def exact():
        gco, gx, gzi = exact_rows_vjp(co, x, gy, tail, zi, gzf)
        if entry == 'batch':
            return gco, gx, gzi
        return (gco[0], gx[:, 0]) + (() if entry == 'timeline'
                                     else (gzi[0],))
    return call, exact, flops, nbytes



def match_stream(raw, want, block):
    """Whether a paced consumer's output ``raw`` (frames, ch) is ``want``
    in order with zero-filled underruns: each ``block``-frame block of
    ``raw`` either equals the next ``block`` frames of ``want`` or holds
    the next ``g < block`` of them and then zeros.  Where ``want`` holds
    zeros itself ``g`` is ambiguous, so every consistent reading is
    followed.  Returns ``(frames of want consumed, underrun blocks)`` of the
    reading that consumed most, with the fewest underruns; raises if none
    fits."""
    states = {0: 0}                       # position in want -> underruns
    for b0 in range(0, len(raw), block):
        blk = raw[b0:b0 + block]
        nz = np.flatnonzero(blk.any(axis=1))
        z = int(nz[-1]) + 1 if nz.size else 0
        nxt = {}
        for at, und in states.items():
            seg = want[at:at + len(blk)]
            same = np.all(seg == blk[:len(seg)], axis=1)
            g = len(seg) if same.all() else int(np.argmin(same))
            if g == len(blk):
                nxt[at + g] = min(nxt.get(at + g, und), und)
            for gg in range(z, min(g, len(blk) - 1) + 1):
                nxt[at + gg] = min(nxt.get(at + gg, und + 1), und + 1)
        if not nxt:
            raise AssertionError(f'stream block at frame {b0} is not the '
                                 f'rendered audio')
        states = dict(sorted(nxt.items())[-256:])
    at = max(states)
    return at, states[at]

