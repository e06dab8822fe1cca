"""Realtime soak of the PyTorch port: a paced virtual-sink transport under
live edits and seeks.

Runs a patch through the port's ``SinkDevice`` (realtime=True: render
thread -> native ring -> sample-rate-paced consumer) on ``--device``
(default the card) for ``--seconds`` of audio while editing it live
(a traced edit every 2 s, no recompile) and seeking twice, then reports
underruns and the transport's per-block latency.  Two patches:

* ``voice``: the mono subtractive voice (a saw into a ``LowPass`` swept by
  a 0.5 Hz LFO, ``RingMod`` with an ADSR, gain 0.5); the edit sweeps the
  cutoff's base;
* ``echo``: that voice through a damped feedback echo (a ``Delay`` of
  11 blocks + 7 frames, longer than the transport's 8-block render-ahead,
  a streaming ``LowPass`` at 2500 Hz in the loop, feedback gain 0.45); the
  edit moves the feedback gain.

The contract (``chip_smoke.py`` phase 14 holds it on the card): zero
underruns after the 2 s warmup outside the 1 s recovery window after each
seek, both seeks reflected in the position, at least one edit every 2 s,
and for the voice over 65 s more than 2000 blocks at a p50 over 3x
realtime and a p95 under one block.  On the CPU the port renders with the
plain versions of its kernels and is slower than realtime: there the soak
runs its machinery, not its contract.

Usage::

    python scripts/torch_soak.py [--seconds 65] [--patch voice|echo]
                                 [--block 1024] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

if __name__ == '__main__':      # runnable standalone from anywhere
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def fixed(value):
    from signals_tpu_torch.nodes.fixed import Fixed
    f = Fixed()
    f.get_state().value = np.atleast_2d(np.asarray(value, dtype=np.float32))
    return f


def build_voice():
    """The mono subtractive voice; returns ``(root, cutoff base Fixed)``."""
    from signals_tpu_torch.nodes.env import ADSR
    from signals_tpu_torch.nodes.fx import Gain, LowPass, Mix, RingMod
    from signals_tpu_torch.nodes.osc import Sawtooth, Sine, Square

    saw = Sawtooth()
    saw.hertz = fixed(110.0)
    lfo = Sine()
    lfo.hertz = fixed(0.5)
    depth = Gain()
    depth.left = lfo
    depth.right = fixed(900.0)
    base = fixed(2000.0)
    cutoff = Mix()
    cutoff.left = depth
    cutoff.right = base
    cutoff.mix = fixed(0.5)
    lp = LowPass()
    lp.input = saw
    lp.cutoff = cutoff
    gate = Square()
    gate.hertz = fixed(2.0)
    env = ADSR()
    env.gate = gate
    st = env.get_state()
    st.attack, st.decay, st.sustain, st.release = 0.01, 0.08, 0.6, 0.1
    out = RingMod()
    out.left = lp
    out.right = env
    g = Gain()
    g.left = out
    g.right = fixed(0.5)
    return g, base


def build_echo(block: int = 1024):
    """The voice through a damped feedback echo whose delay is longer than
    the transport's 8-block render-ahead; returns ``(root, feedback gain
    Fixed)``."""
    from signals_tpu_torch.nodes.delay import Delay
    from signals_tpu_torch.nodes.fx import Gain, LowPass, Mix

    voice, _ = build_voice()
    mix = Mix()
    d = Delay()
    d.get_state().frames = 11 * block + 7
    damp = LowPass()
    damp.input = d
    damp.cutoff = fixed(2500.0)
    damp.get_state().streaming = True
    fb_gain = fixed(0.45)
    fb = Gain()
    fb.left = damp
    fb.right = fb_gain
    mix.left = voice
    mix.right = fb
    mix.mix = fixed(0.55)
    d.input = mix
    return mix, fb_gain


def soak(seconds: float = 65.0, *, block: int = 1024, patch: str = 'voice',
         device='cuda',
         progress=lambda msg: print(msg, file=sys.stderr, flush=True)
         ) -> dict:
    """Play ``patch`` on the realtime ``null`` sink for ``seconds`` of wall
    clock with live edits and two seeks; returns the report (underruns,
    seeks, edits, position and the transport's latency summary).  Raises
    if the render thread died."""
    from signals_tpu_torch.nodes.dev import Rack, SinkDevice

    rack = Rack()
    rack.scan()
    if patch == 'echo':
        root, fb_gain = build_echo(block)
        cutoff_base = None
    else:
        root, cutoff_base = build_voice()
    sink = SinkDevice(rack.get_sink('null'), block_frames=block,
                      realtime=True, device=device)
    sink.get_state().channels = 1
    sink.input = root
    rate = sink.rate

    seek_times = sorted({seconds * 0.33, seconds * 0.66})
    seeks_done = []
    edits = 0
    recovery_s = 1.0          # post-seek window whose underruns are the
    seek_window = None        # seek's own (ring refill), per the contract
    seek_underruns = 0

    warmup_s = 2.0
    warm_underruns = None
    next_edit = warmup_s
    try:
        sink.start()
        t0 = time.monotonic()
        while True:
            elapsed = time.monotonic() - t0
            if elapsed >= seconds:
                break
            if warm_underruns is None and elapsed >= warmup_s:
                warm_underruns = sink.underruns
            if seek_window is not None and elapsed >= seek_window[1]:
                seek_underruns += sink.underruns - seek_window[0]
                seek_window = None
            if elapsed >= next_edit:
                # a traced edit, read whole by the next batch's params()
                # without recompiling: the cutoff base (voice) or the
                # feedback gain (echo)
                if cutoff_base is not None:
                    val = 1200.0 + 900.0 * np.sin(elapsed / 3.0)
                    cutoff_base.get_state().value = np.array(
                        [[val]], dtype=np.float32)
                else:
                    val = 0.45 + 0.35 * np.sin(elapsed / 3.0)
                    fb_gain.get_state().value = np.array(
                        [[val]], dtype=np.float32)
                edits += 1
                next_edit += 2.0
            if seek_times and elapsed >= seek_times[0]:
                if seek_window is not None:     # close an open window
                    seek_underruns += sink.underruns - seek_window[0]
                seek_window = (sink.underruns, elapsed + recovery_s)
                target_block = int((seek_times[0] + 5.0) * rate) // block
                sink.seek(target_block)
                seeks_done.append((round(elapsed, 1), target_block))
                seek_times.pop(0)
            if sink._transport.error is not None:
                raise RuntimeError(
                    f'transport died: {sink._transport.error!r}')
            time.sleep(0.1)
        final_underruns = sink.underruns
        if seek_window is not None:
            seek_underruns += final_underruns - seek_window[0]
        tell = sink.tell()
        transport = sink._transport
        stats = transport.stats.summary(block, rate)
    finally:
        if sink.is_active:
            sink.stop()
        if sink.is_open:
            sink.close()
    if transport.error is not None:
        raise RuntimeError(f'transport died: {transport.error!r}')

    report = {
        'patch': patch,
        'seconds': seconds,
        'edits': edits,
        'seeks': seeks_done,
        'warmup_underruns': warm_underruns or 0,
        'final_underruns': final_underruns,
        'seek_window_underruns': seek_underruns,
        # the contract counter: underruns after warmup and OUTSIDE the
        # post-seek recovery windows (a seek legitimately drains the ring)
        'underruns_after_warmup': (final_underruns - (warm_underruns or 0)
                                   - seek_underruns),
        'position_blocks': tell,
        'latency': stats,
    }
    progress(f'soak: {json.dumps(report)}')
    return report


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--seconds', type=float, default=65.0)
    parser.add_argument('--block', type=int, default=1024)
    parser.add_argument('--patch', choices=('voice', 'echo'),
                        default='voice')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)
    report = soak(args.seconds, block=args.block, patch=args.patch,
                  device=args.device)
    ok = report['underruns_after_warmup'] == 0
    print(json.dumps({'ok': ok, **report}))
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
