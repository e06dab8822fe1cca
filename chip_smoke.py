#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``signals_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Fifteen phases; any failure raises and exits non-zero:

1. **Build** the CUDA kernels from ``signals_tpu_torch/compiler/csrc`` (one
   ``nvcc`` per source, all at once) and print the toolchain, the card and
   ``ptxas``' report (B3's registers and spills at each section count;
   each FDN kernel's registers, shared memory and spills).
2. **Each kernel against its plain PyTorch version** on the card, at the
   shapes the main paths give it: the segment kernels at the flagship's
   (64 lanes, F=1024, C=512, 8-block carry segments) over 256 blocks and
   over a 60 s render's 2584 (323 carry segments) — the identity-cascade
   saw source bit-exact, filtered lanes within 1e-5 max-abs, group sums
   within 1e-5 of their max, and each kernel's device time beside its
   roofline bound (f32 operations at 67 TFLOP/s or bytes at 3.35 TB/s,
   the H100 SXM's peaks) and the share of it reached; the batched replay at
   the render-ahead shape (L = C + F = 1152, 8 windows, 16 lanes, tail F,
   the windows read in place from one timeline) and the timeline kernel at
   the step shape (1152, 16), each at 1 and 2 sections, the timeline kernel
   at the mono step (1152, 1) and the batched replay at the sampled
   filter's windows (C + 1 rows, tail 1), within 1e-5 max-abs; the
   segment gate's two sides (K2 and K3) at the render-ahead shape; and the
   carried-state entry of the zero-state kernels against the frame loop:
   one window of (1024, 1) and (1024, 16) at 1 and 2 sections from a
   non-zero start state, 16 windows of 1024 rows with their end states, a
   1152-row window cut into two calls against one call (1e-6) — ``y``
   within 1e-5 max-abs, the end state within 1e-5 of its scale; and the
   timeline segment kernel at the noise voice's shape (64 lanes of static
   cutoffs reading ONE noise channel in place, C = 256, 8-block segments,
   sum of 64) over 256 and 2584 blocks, bit for bit against the same call
   on the channel copied out to 64 lanes.
3. **The flagship render**: the 64-voice swept-subtractive PolyPatch built
   from the port's nodes, rendered on the card for 256 blocks through the
   product default (generator + mix epilogue), the per-voice plan and the
   timeline kernel (generator off), each with its launch counts reset just
   before it and checked just after; the first 32 blocks held to the port's
   numpy pull oracle within 64 x 1e-5 raw max-abs, every render to the
   default one.  Then the render time of a 60 s batch, kernel path and
   plain path.
4. **The per-block and render-ahead paths**, each render with its launch
   counts reset just before it and checked just after, every block held to
   the port's numpy pull oracle within 1e-5 per lane: (a) the mono
   subtractive voice (``bench.py:87-128``, one channel), 60 s from 0, then
   13 blocks from block 3 (off the carry-segment grid); (b) the
   static-cutoff voice (``bench.py:131-162``, context 128) at 16 channels
   through the ``Transport``: a seek to block 3, then three 8-block
   batches, one batched-replay launch each; (c) ``step`` of that voice and
   of a band voice (BandPass 300-3000 Hz in place of the LowPass), one
   timeline-kernel launch each.  Then the p50 of 50 steps, the p50 per
   block of 20 render-ahead batches and the 60 s mono render's realtime
   factor.

5. **Carried state**, each path with its launch counts reset just before
   it and checked just after, held to the port's numpy pull oracle within
   1e-5, its wall and device time printed: (a) the saturated echo (bench
   c6, ``bench.py:226-253``: a streaming LowPass and a tanh Drive on the
   return of a 16-block + 5-frame delay), mono, 2592 blocks (60.2 s: 162
   whole 16-block segments of the segmented feedback scan, one
   carried-state launch each); (b) the FM voice with a feedback delay (bench c5,
   ``bench.py:191-223``, at the ``Mix`` under its ``Spec``), 60 s through
   the loop-free delay solver (no filter: no kernel launch); (c) the
   static voice with ``streaming=True`` at 16 channels: 50 ``step`` calls
   (one carried-state launch each), three 8-block ``Transport`` batches
   with the carry threaded (one carried-state launch each over the whole
   window: the cutoff is fixed), and a render split 13 + 19 against one of
   32 (1e-6); (d) a streaming LowPass swept by an LFO (per-block
   coefficients: one batched launch with the blocks' end states, a scan of
   their state maps) read by a context LowPass at 8 channels, two 8-block
   windows (the second reads the first's output history).

6. **The rest of the nine-check set** of the JAX package's record
   (``BENCH_full.json`` ``parity_max_abs_err``; phases 3-5 hold
   ``poly64_mix``, ``subtractive``, ``saturated_echo``), each at full
   width with its launch counts reset just before it and checked just
   after, its plan, wall and device time printed, against the port's numpy
   pull oracle: (a) ``master_bus`` (``bench.py:256-278``: the swept mono
   voice -> FDN reverb -> RMS compressor -> gain), 2584 blocks on the
   whole-window plan with one generator-kernel launch and one launch of the
   reverb's network kernel (``csrc/fdn.cu``), 1e-5 over the first 32
   blocks, the same bits, audio and carry, as the plain turn loop (timed
   beside it), 13 + 19 blocks against them within 1e-6; (b)
   ``poly64_noise_mix`` (``bench.py:168-188``: one white-noise channel ->
   64 LowPass 1000-4000 Hz -> gain), 2584 blocks on the mix plan with one
   timeline-kernel launch, 64 x 1e-5 over 32 blocks; (c) ``sine``
   (``bench.py:57-65``), 43 blocks bit for bit, and ``render_vis``'s
   ``(750, 2, 1)`` summary equal to the numpy summary of the oracle's
   audio; (d) ``fm_delay`` at its ``Spec`` root (``bench.py:191-223``), 60 s
   through the delay solver with no kernel launch, 1e-5, its 80 band
   magnitudes within 1e-5 of the numpy summary's largest; (e) ``additive``
   (``bench.py:68-84``) at 16 voices bit for bit and ``poly64_static_mix``
   (``bench.py:131-162``) within 64 x 1e-5.

7. **Differentiable fitting** (``[fit]`` lines), each fit with its launch
   counts reset just before it and checked just after, its steps/s, ms a
   step, device time a step and busy share printed: (a) each backward
   kernel of ``csrc/adjoint.cu`` against its plain adjoint on the card
   within 1e-5 of each output's largest value and the same bits twice —
   B1 at the flagship's shape (32 blocks, sum of 64 and per lane), at the
   flagship fit's (64 blocks) and at c8's (43 blocks, C 1024), B2 at c9's
   (517 blocks, C 1024) and the noise voice's (one channel under 64
   lanes), both at the edges of their time-sliced scan (``VJP_EDGES``:
   block starts inside a chunk, 5 lanes, two sections, F 24, 30 Hz and
   15-18 kHz poles, 1024 blocks), B3 at ``B3_SHAPES`` (the render-ahead,
   step and carried-state shapes, the streaming fit's (8192, 16), the
   echo's segment (16384, 1) and 2^20 rows at two sections, whose
   checkpoints outgrow shared memory: held to a float64 reference,
   :func:`torch_refs.exact_rows_vjp`) — and its device time beside its
   bound and beside commit bef113c's (the serial walk through a scratch
   buffer; B1 at the flagship fit and c8, B2 at c9, B3 at every shape),
   B2's peak memory at c9 and B3's memory over its inputs at each shape;
   (b) c8 (``bench.py:449-546``: 64 saws -> LowPass with a trainable
   ``Fixed`` cutoff -> gain 1/64, 43 blocks): one loss-and-gradient call
   whose cutoff gradient is within 1e-4 of the same call on the plain
   kernels, then 16 ``learn.fit`` steps (``{K1: 16, B1: 16}``); (c) c9
   (``bench.py:549-651``: 64 voices x 12 s, two sine partials -> Mix ->
   LowPass -> gain, 192 trainables, ``relative_lr``,
   ``per_channel_spectral_loss``): 20 ``learn.fit`` steps, the loss falls,
   the peak memory (``{K2: 20, B2: 20}``); (d) ``PolyPatch.fit`` of the
   flagship's cutoff centre on the mix plan, 64 blocks: the gradient within
   1e-4 of the plain kernels' at 16 blocks, then 10 steps (``{K1: 10, B1:
   10}``); (e) the static voice's cutoff, 4 steps each through the batched
   replay (``{K3: 4, B3: 4}``) and as a streaming filter
   (``{sosfilt_stream: 4, B3: 4}``).

8. **Host inputs and the EQ family** (``[files]`` lines), each render
   with its launch counts reset just before it and checked just after:
   (a) the offline bounce of a 60 s stereo pcm16 WAV made from a seed
   (``FileReader`` -> LowShelf 120 Hz +3 dB -> Peak 1 kHz -4 dB Q 1.4 ->
   Notch 60 Hz Q 4 -> HighShelf 8 kHz +2 dB -> ``FileWriter`` pcm16), 2584
   blocks on the ``'stateless'`` plan (the one-block step vmapped over the
   blocks, ``{K4: 10}`` a batch): 32 blocks from 0 and 32 from block 3
   within 1e-5 of the oracle with the design in float64
   (:func:`exact_design`; the error against the oracle's float32 b/a
   coefficients printed beside it), the written file valid while open and
   byte for byte the returned audio under the pcm16 encoder, its wall time
   and, over 256 profiled blocks, its device time and busy share; the same
   256 blocks as a loop of ``step`` (``{K4: 10}`` a block), within 1e-6,
   with their walls side by side; (b) the same patch under the
   ``Transport`` in 8-block batches (``{K4: 10}`` a batch): four against
   the oracle, then the p50 per block of 20; (c) a
   48 kHz file with ``conform_rate`` -> streaming LowPass -> swept LowPass
   (fault C1) -> ``Pan`` -> ``FileWriter`` float32 (``{sosfilt_stream: 1,
   K2: 1}`` a block): 32 blocks from 0 and 16 from block 3 continuing the
   carry of blocks 0-2 within 1e-5, then 60 s timed; (d) the flagship
   with a swept ``Peak`` in place of its LowPass on the mix plan
   (``{K1: 1}``, 64 x 1e-5 over 32 blocks); (e) K1-K4 and the
   carried-state entry on RBJ coefficients (a 30 Hz low shelf, a Q 16
   peak) against their plain versions at phase 2's shapes, within phase
   2's budgets, the same bits twice.

9. **Sequenced polyphony and the modulation effects** (``[score]``,
   ``[modfx]`` and ``[seq]`` lines), each render with its launch counts
   reset just before it and checked just after, its plan, wall time,
   device time, busy share and peak memory printed: (a) a seeded 600-note
   score over 60 s (a 300-note melody and 75 four-note chords, MIDI 36-96,
   0.1-1.0 s) written as a format-0 SMF and read back with ``read_midi``,
   played by ``examples/midi_poly.py``'s voice (``GateSeq``, ``PitchSeq``
   and a velocity ``PitchSeq`` -> saw -> LowPass 1800 Hz -> ADSR, release
   0.25 s) at 64 voices through ``sequenced_poly``, 2584 blocks in the
   default vmap layout (``{K3: 1}``: the one-voice plan's single batched
   launch, folded over the 64 voices, as the voice alone launches it) and
   in the channels layout (``{K2: 1}``): the two within 64 x 1e-5 over the
   whole render, each within 64 x 1e-5 of the port's numpy pull oracle
   over 32 blocks from 0 and from block 1200, the padded event count E
   printed; (b) ``PolyPatch.fit`` of the score's shared cutoff in the vmap
   layout over 64 blocks: its gradient within 1e-4 of the plain kernels'
   at 16 blocks, then 10 steps (``{K3: 1, B3: 1}`` a step); (c)
   ``examples/modulation.py``'s chain (a ``Merge`` spread -> ``FracDelay``
   chorus -> ``Mix`` -> 4-stage ``Phaser`` swept 1000 ± 700 Hz at 0.4 Hz
   -> gain -> ``FileWriter``), stereo, 2584 blocks on the whole-window
   plan (no cascade kernel): the file byte for byte the audio, 1e-5 of the
   oracle over 32 blocks, the window within 1e-6 of 32 per-block steps and
   13 + 19 blocks with the carry within 1e-6 of the first 32, its eager
   kernels a block; (d) the mono subtractive voice -> ``Convolve`` with a
   synthetic 88 200-tap IR (2 s, 60 dB down) at mix 0.35 -> gain, 2584
   blocks on the whole-window plan (``{K1: 1, K4: 1}``: K4 over the IR's
   lookback before block 0), one FFT pair of 2^22 points: the first and
   the last 32 blocks within 1e-5 of the oracle (the voice's pull oracle
   convolved in float64), the FFT size and its time.

10. **The output path** (``[out]`` lines), each render or encode with its
   launch counts reset just before it and checked just after: (a) the
   flagship's 60 s 64-voice mix (mix plan, ``{K1: 1}``) through every
   device encoder — PCM16, mu-law, A-law, IMA ADPCM (``{ima: 1}``), SLAC v1
   and v2 — each byte-identical to its numpy encoder on the mix copied to
   the host and the same bytes twice, with its bytes a sample, its device
   time and the wall of render + encode + fetch beside the f32 fetch's, and
   SLAC v2's peak memory; then the IMA kernel against its plain loop, byte
   for byte, at 1, 2, 16 and 64 channels and 1017 / 505 samples a block,
   with its device time beside its bound and the loop's time, and its
   chains alone (``scripts/torch_ima_variants.py``'s chain-only patch:
   the serial floor) at 1 and 64 channels, then at the edges of its tiles
   (``IMA_EDGES``: 33
   channels, 3 channels, a short last block, renders shorter than a
   block) and on NaN samples (encoded as 0, as the JAX package's encoder
   does), byte for byte; (b) the mono
   swept voice on the ``default`` sink at 2 channels: ``render_offline``
   for 60 s (``{K1: 1}``, 1e-5 of the oracle over 32 blocks),
   ``render_offline_encoded`` for every subtype from block 0 and from block
   3 (byte-identical to the numpy encoders of ``render_offline``'s audio),
   ``render_offline_encoded_stream('slac')`` over 240 s in 60 s batches
   through ``SlacWriter`` read back bit-exact to the PCM16 of one 240 s
   render, the same stream with a cap so low that the batches take the
   overshoot copy, and the same batches rendered and fetched in turn; (c)
   the voice in real time (~5 s) through the native ring and the paced
   consumer writing PCM16 into a pipe, then the 16-channel static voice on
   the ``null`` sink (~3 s, ``{K3: 1}`` a batch): frames, underruns, p50 /
   p95 a block, the pipe's bytes against the captured blocks, the captured
   audio against ``render_offline``; (d) the cold and warm structural-swap
   latencies on the ``null`` sink (``bench.py:654-728``) with each
   program's own audio on both sides of each swap; (e) the saturated echo
   checkpointed after 13 blocks, loaded onto the card and resumed for 19,
   bit for bit the continuation from the device carry.

11. **The command layer** (``[shell]`` lines): the port's ``Controller``
   on its default device, the card, as a user drives it, each render with
   its launch counts reset just before it and checked just after: (a) the
   mono swept voice written as a ``.sigs`` file
   (:func:`swept_voice_sigs`, ``signals.chain.*`` names where the
   reference has them) and ``load``-ed, then ``bounce`` for 60 s in
   float32 (``{K1: 1}``; the file the same bits as the sink's
   ``render_offline``, its first 32 blocks within 1e-5 of the oracle), and
   in pcm16 (``{K1: 1}``, streamed), adpcm (``{K1: 1, ima: 1}``) and slac
   (``{K1: 1}``, one 60 s batch), each file byte for byte the one the
   direct encoded entry point writes; each command's wall beside the
   direct call's; (b) ``fit`` of the cutoff centre's ``Fixed`` from 1400
   Hz to a 1.5 s target bounced at 2000 Hz, 16 steps (``{K1: 16, B1:
   16}``): the loss falls, ``undo`` gives back 1400 exactly, ``redo`` the
   fitted value, ms a step; (c) ``play`` / ``stats`` / ``stop`` of the
   16-channel static voice on the realtime ``null`` sink for 3 s (one K3
   launch a batch, one more for the warmup; ``stats`` more than 0 blocks
   and 0 underruns); (d) ``save`` / ``load`` keeps the hash, and
   ``tests/fixtures/lowpass_test.sigs`` loads and bounces 10 s (``{K3:
   1}``: one lane of a static LowPass); (e) ``python -m signals_tpu_torch`` fed a command
   script on stdin ends in a ``bounce`` and ``exit``: rc 0 and the file
   written; (f) ``entry()``: two consecutive blocks of the 64-voice mix
   (``{K1: 1}`` each) within 64 x 1e-5 of the oracle, a block's wall and
   device time.  ``plot`` is not run here: the machine with the card has
   no matplotlib; the CPU tests (``tests/test_torch_ui.py``,
   ``tests/test_torch_shell.py``) cover it.

12. **The reverb under autograd and vmap** (``[reverb]`` lines): (a) each
   FDN kernel against its plain version on the card -- ``fdn_advance`` at
   the master bus's shape (one lane, 60 s), at 64 lanes with per-lane
   decay times (60 s; clusters of 8 CTAs) and at ``Reverb(size=4.0)``'s
   delays (one lane, 60 s; the rings in global memory), bit for bit;
   ``fdn_advance_vjp`` with its gain kernel ``fdn_vjp_gain`` at one lane,
   60 s, at 64 lanes over 256 blocks and at size 4.0, within 1e-5 of each
   output's largest value and the same bits twice -- each with its device
   time beside its bound, the plain version's and commit b3cf912's design's;
   ``learn.fit`` of the 60 s master bus with the voice's output gain, its
   cutoff centre and the reverb's ``t60`` and ``mix`` trainable against a
   target rendered at other values: the four gradients within 1e-4
   relative of the plain kernels', 8 steps (``{K1, fdn, B1, fdn_vjp,
   fdn_vjp_gain: 1}`` a step), the loss falling, ms a step and peak
   memory; (b) the flagship's 64 voices, each into its own
   ``Reverb``, 60 s, in the vmap layout (one 64-lane ``fdn`` launch, the
   voices folded) and the channels layout, within 64 x 1e-5 of each
   other, with their peak memory.

13. **The voice mesh on the card** (``[mesh]`` lines): a one-rank NCCL
   process group (a ``file://`` store under ``build/``), the flagship (64
   voices, 256 blocks) through ``PolyPatch(mesh=voice_mesh(1))`` in the
   channels layout (mix epilogue) and the vmap layout, each with its
   launch counts reset just before it and checked just after (``{K1:
   1}``), bit for bit the same patch without a mesh (a sum over one rank is
   a copy), the ``all_reduce``'s device time and both walls; a 3-step
   sharded ``PolyPatch.fit`` (vmap layout, per-voice pitches and the shared
   output gain, ``{K1: 3, B1: 3}``) whose losses and gradients are held to
   the unsharded fit's within 1e-4 relative; the group torn down.  World
   sizes above 1 need more GPUs than the card.

14. **The realtime soak** (``[soak]`` lines): ``scripts/torch_soak.py``'s
   mono voice for 65 s and its damped echo (a ``Delay`` of 11 blocks + 7
   frames, a streaming LowPass in the loop) for 35 s on the realtime
   ``null`` sink (native ring, paced consumer), a traced edit every 2 s and
   two seeks, each with its launch counts reset just before it and held
   just after to its kernels times its renders (the ``Transport``'s
   batches, counted, and the warmup); held to ``tests/test_soak.py``'s
   whole contract, with no retry: 0 underruns after the warmup outside the
   seeks' recovery windows, both seeks, and for the voice at least 30
   edits, a position past 95% of 65 s, more than 2000 blocks, p50 over 3x
   realtime and p95 under one block.

15. **The eight examples** (``[examples]`` lines): each
   ``examples_torch/*.py``'s ``main(..., device='cuda')``, its outputs
   under ``build/chip_smoke/examples/``, its launch counts reset just
   before it and checked just after (:data:`EXAMPLES`), its wall printed;
   then the same ``main`` on the CPU in this process, and the card's file
   held to the CPU's (float32 WAVs within 1e-5 a voice, the pcm16 AIFF
   within one LSB, ``midi_poly``'s score byte for byte), ``fit_patch``'s
   fitted gain and pitch and its poly fit's first 50 losses within 1e-4
   relative, ``play_sine``'s captured audio within 1e-5.

Prints one JSON line describing the kernels, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  Imports no JAX.  The
references and patch builders that the CPU tests share with it are in
``tests/torch_refs.py``; the roofline counts and the profiler's reading are
``benchmark/lib``'s.
"""

from __future__ import annotations

import collections
import contextlib
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np

from benchmark.lib import roofline, trace
from benchmark.lib.roofline import CASCADE_FLOP, VJP_FLOP

sys.path.append(str(pathlib.Path(__file__).resolve().parent / 'tests'))
from torch_refs import (  # noqa: E402
    B3_PLAIN_ROWS, C, F, RATE, V, b3_calls, build_subtractive_voice,
    envelope, exact_design, fixed, match_stream, poly_freqs, pull_oracle,
    swept_voice_sigs)

M = 8               # blocks per carry segment
N_BLOCKS = 256      # the main-path render
ORACLE_BLOCKS = 32
TOL = 1e-5          # per-voice parity budget
SECONDS = 60.0
STATIC_CH = 16      # the render-ahead voice's width
STATIC_C = 128      # LowPass.context_for(2000 Hz)
AHEAD = 8           # Transport.blocks_per_call
SEG_KERNELS = ('seg_cascade', 'sum_partials')   # K1/K2's kernel names


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def build_static_voice(band=False, streaming=False):
    """The static-cutoff voice (``bench.py:131-162``) at STATIC_CH
    pitches: saw -> LowPass 2000 Hz (context 128), or with ``band`` a
    BandPass 300-3000 Hz -> the envelope -> Gain 1/64.  ``streaming``
    makes the filter an exact IIR with carried state."""
    from signals_tpu_torch.nodes.fx import BandPass, LowPass
    from signals_tpu_torch.nodes.osc import Sawtooth
    saw = Sawtooth()
    saw.hertz = fixed(poly_freqs(STATIC_CH).reshape(1, STATIC_CH))
    if band:
        filt = BandPass()
        filt.low = fixed(300.0)
        filt.high = fixed(3000.0)
    else:
        filt = LowPass()
        filt.cutoff = fixed(2000.0)
    filt.input = saw
    filt.get_state().context = STATIC_C
    filt.get_state().streaming = streaming
    return envelope(filt, 1.0 / 64)


ECHO_BLOCKS = 16    # the saturated echo's delay, in blocks (+ 5 frames)


def build_saturated_echo():
    """bench c6 (``bench.py:226-253``): saw 110 Hz -> Mix 0.6 with the
    return of a 16-block + 5-frame Delay of the mix through a streaming
    LowPass 2500 Hz, Gain 0.55 and Drive 3 (tanh)."""
    from signals_tpu_torch.nodes.delay import Delay
    from signals_tpu_torch.nodes.fx import Drive, Gain, LowPass, Mix
    from signals_tpu_torch.nodes.osc import Sawtooth
    saw = Sawtooth()
    saw.hertz = fixed(110.0)
    mix = Mix()
    d = Delay()
    d.get_state().frames = ECHO_BLOCKS * F + 5
    lp = LowPass()
    lp.input = d
    lp.cutoff = fixed(2500.0)
    lp.get_state().streaming = True
    fb = Gain()
    fb.left = lp
    fb.right = fixed(0.55)
    shaper = Drive()
    shaper.input = fb
    shaper.drive = fixed(3.0)
    mix.left = saw
    mix.right = shaper
    mix.mix = fixed(0.6)
    d.input = mix
    return mix


def build_fm_delay(spec=False):
    """bench c5 (``bench.py:191-223``): a 3-operator FM stack -> Mix 0.6
    with the return of a 4-block Delay of the mix through Gain 0.45; the
    root is that ``Mix``, or with ``spec`` the ``Spec`` tap over it."""
    from signals_tpu_torch.nodes.delay import Delay
    from signals_tpu_torch.nodes.fx import Gain, Mix
    from signals_tpu_torch.nodes.osc import Sine

    def op(hz, index=None, by=None):
        o = Sine()
        o.hertz = fixed(hz)
        if by is not None:
            o.phase = by
        if index is None:
            return o
        g = Gain()
        g.left = o
        g.right = fixed(index)
        return g

    op1 = op(110.0, by=op(220.0, 2.0, by=op(660.0, 1.5)))
    mix = Mix()
    d = Delay()
    d.get_state().frames = 4 * F
    fb = Gain()
    fb.left = d
    fb.right = fixed(0.45)
    mix.left = op1
    mix.right = fb
    mix.mix = fixed(0.6)
    d.input = mix
    if not spec:
        return mix
    from signals_tpu_torch.nodes.vis import Spec
    tap = Spec()
    tap.input = mix
    return tap


def build_static_poly_voice():
    """The static-cutoff voice as ``bench.py:131-162`` has it, one pitch
    node to override per voice: ``(root, hz)``."""
    from signals_tpu_torch.nodes.fx import LowPass
    from signals_tpu_torch.nodes.osc import Sawtooth
    hz = fixed(110.0)
    saw = Sawtooth()
    saw.hertz = hz
    lp = LowPass()
    lp.input = saw
    lp.cutoff = fixed(2000.0)
    lp.get_state().context = LowPass.context_for(2000.0, RATE)
    return envelope(lp, 1.0 / 64), hz


NOISE_C = 256       # CritFilter.context_for(1000 Hz)
NOISE_CUTS = np.linspace(1000.0, 4000.0, V).astype(np.float32)


def build_noise_voice():
    """bench's noise voice (``bench.py:168-188``): one ``White`` channel ->
    LowPass (the cutoff overridden per voice) -> Gain 1/64: ``(root,
    cutoff)``."""
    from signals_tpu_torch.nodes.fx import CritFilter, Gain, LowPass
    from signals_tpu_torch.nodes.noise import White
    lp = LowPass()
    lp.input = White()
    cut = fixed(2000.0)
    lp.cutoff = cut
    lp.get_state().context = CritFilter.context_for(1000.0, RATE)
    assert lp.get_state().context == NOISE_C
    out = Gain()
    out.left = lp
    out.right = fixed(1.0 / 64)
    return out, cut


def build_sine_plot():
    """bench c1 (``bench.py:57-65``): a 440 Hz sine under a ``Wave``."""
    from signals_tpu_torch.nodes.osc import Sine
    from signals_tpu_torch.nodes.vis import Wave
    osc = Sine()
    osc.hertz = fixed(440.0)
    tap = Wave()
    tap.input = osc
    return tap


def build_additive_voice():
    """bench c2 (``bench.py:68-84``): a sine and a saw at one pitch -> Mix
    0.5 -> Gain 1/16: ``(root, hz)``."""
    from signals_tpu_torch.nodes.fx import Gain, Mix
    from signals_tpu_torch.nodes.osc import Sawtooth, Sine
    hz = fixed(220.0)
    sine, saw = Sine(), Sawtooth()
    sine.hertz = hz
    saw.hertz = hz
    m = Mix()
    m.left = sine
    m.right = saw
    m.mix = fixed(0.5)
    g = Gain()
    g.left = m
    g.right = fixed(1.0 / 16)
    return g, hz


def build_master_bus():
    """bench c7 (``bench.py:256-278``): the swept mono voice -> Reverb ->
    Compressor (window 2048, threshold 0.25, ratio 4) -> Gain 0.9."""
    from signals_tpu_torch.nodes.dyn import Compressor
    from signals_tpu_torch.nodes.fx import Gain
    from signals_tpu_torch.nodes.reverb import Reverb
    rv = Reverb()
    rv.input = build_subtractive_voice()[0]
    comp = Compressor()
    st = comp.get_state()
    st.window, st.threshold, st.ratio = 2 * F, 0.25, 4.0
    comp.input = rv
    out = Gain()
    out.left = comp
    out.right = fixed(0.9)
    return out


def build_streaming_into_context():
    """Eight saws -> streaming LowPass swept 1800 +- 450 Hz by a 3 Hz LFO
    -> context LowPass 900 Hz (context 128): the context filter reads the
    streaming filter's output before the current window."""
    from signals_tpu_torch.nodes.fx import Gain, LowPass, Mix
    from signals_tpu_torch.nodes.osc import Sawtooth, Sine
    saw = Sawtooth()
    saw.hertz = fixed(poly_freqs(8).reshape(1, 8))
    lfo = Sine()
    lfo.hertz = fixed(3.0)
    depth = Gain()
    depth.left = lfo
    depth.right = fixed(900.0)
    cutoff = Mix()
    cutoff.left = depth
    cutoff.right = fixed(3600.0)
    cutoff.mix = fixed(0.5)
    exact = LowPass()
    exact.input = saw
    exact.cutoff = cutoff
    exact.get_state().streaming = True
    lp = LowPass()
    lp.input = exact
    lp.cutoff = fixed(900.0)
    lp.get_state().context = STATIC_C
    return lp


def cuda_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events,
    after one warmup call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps, kernels):
    """Device milliseconds per call of the kernels whose name contains one
    of ``kernels``, from a ``torch.profiler`` trace of ``reps`` calls
    (after one warmup call).  A trace that lost some of the calls' kernel
    events (their count is not a multiple of ``reps``) is taken again, up
    to five times; None when no trace holds them all."""
    import torch

    def calls():
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        us = [d for _, _, d in trace.matching(trace.profile(calls)[1],
                                              kernels)]
        if us and len(us) % reps == 0:
            return sum(us) / reps / 1e3
    return None


def graph_ms(fn, reps):
    """Milliseconds per call of ``fn`` on the card with no host in between:
    ``reps`` calls captured in one CUDA graph, one replay timed by CUDA
    events (after a warm replay).  The kernels run back to back, so this is
    their device time plus the gaps between them (under 1 us each)."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, reps, kernels):
    """``(ms, how)``: :func:`device_ms`, or where no trace held the
    kernels' events :func:`graph_ms` (a little more: it counts the gaps
    between the launches too)."""
    ms = device_ms(fn, reps, kernels)
    if ms is not None:
        return ms, 'profiler'
    return graph_ms(fn, reps), f'CUDA graph of {reps} calls, gaps included'


def profiled(fn):
    """One call of ``fn`` under ``torch.profiler`` (after one warmup call):
    ``(wall ms, device ms, device events)``, the device time the sum of
    every kernel's and copy's duration on the card."""
    import torch

    def call():
        fn()
        torch.cuda.synchronize()

    call()
    t0 = time.perf_counter()
    call()
    wall = (time.perf_counter() - t0) * 1e3
    _, events = trace.profile(call)
    return wall, sum(d for _, _, d in events) / 1e3, len(events)


def phase_build():
    import torch
    from signals_tpu_torch.compiler import _build
    t0 = time.perf_counter()
    path, out = _build.build()
    print(f'[build] {path.name} in {time.perf_counter() - t0:.1f} s')
    for line in out.splitlines():
        if 'registers' in line or 'spill' in line or 'Compiling' in line:
            print(f'[build] ptxas: {line.strip()}')
    for name, kernel in (('K3', 'rows_cascade'), ('B3', 'rows_cascade_vjp')):
        for nsec, (regs, spills) in sorted(rows_ptxas(out, kernel).items()):
            print(f'[build] {name} {kernel}<{nsec}>: {regs} registers, '
                  f'{spills}')
    for name, (regs, smem, spills) in sorted(fdn_ptxas(out).items()):
        print(f'[build] FDN {name}: {regs} registers, {smem} bytes static '
              f'shared memory (+ the rings: dynamic), {spills}')
    release = [ln for ln in run([_build.nvcc_path(), '--version']).splitlines()
               if 'release' in ln]
    print(f'[build] torch {torch.__version__} cuda {torch.version.cuda}; '
          f'nvcc: {release[0].strip() if release else "?"}')
    print(f'[build] card: {card_line()}')


def rows_ptxas(out: str, kernel: str) -> dict:
    """``{sections: (registers, spills)}`` of each instance of the template
    ``kernel`` (``rows_cascade``, ``rows_cascade_vjp``) from ``nvcc -Xptxas
    -v``'s report (an entry's 'Compiling entry function' line, then its
    stack and spill line and its 'Used N registers' line)."""
    found, nsec = {}, None
    for line in out.splitlines():
        if 'Compiling entry function' in line:
            m = re.search(kernel + r'ILi(\d)E', line)
            nsec = int(m.group(1)) if m else None
        elif nsec is not None and 'spill stores' in line:
            found[nsec] = (None, line.strip())
        elif nsec is not None and 'registers' in line:
            m = re.search(r'Used (\d+) registers', line)
            found[nsec] = (int(m.group(1)), found.get(nsec, (0, '?'))[1])
            nsec = None
    return found


def fdn_ptxas(out: str) -> dict:
    """``{kernel: (registers, static shared bytes, spill line)}`` of each
    kernel of ``csrc/fdn.cu`` from ``nvcc -Xptxas -v``'s report, the
    templates named by their rings (shared or global memory) and, for the
    forward, one CTA a lane or clusters."""
    found, name = {}, None
    for line in out.splitlines():
        if 'Compiling entry function' in line:
            m = re.search(r'(fdn_advance_vjp|fdn_advance|fdn_vjp_gain_sum|'
                          r'fdn_vjp_gain)(I((?:Lb[01]E)+)E)?', line)
            name = None
            if m:
                flags = [f == '1' for f in re.findall(r'Lb([01])E',
                                                      m.group(3) or '')]
                name = m.group(1)
                if flags:
                    parts = ['shared rings' if flags[0] else 'global rings']
                    if len(flags) > 1:
                        parts.append('cluster' if flags[1] else 'CTA a lane')
                    name += f'<{", ".join(parts)}>'
                found[name] = [None, 0, '?']
        elif name is not None and 'spill stores' in line:
            found[name][2] = line.strip()
        elif name is not None and 'registers' in line:
            m = re.search(r'Used (\d+) registers', line)
            found[name][0] = int(m.group(1)) if m else None
            m = re.search(r'(\d+) bytes smem', line)
            found[name][1] = int(m.group(1)) if m else 0
            name = None
    return {k: tuple(v) for k, v in found.items()}


def card_line() -> str:
    return run(['nvidia-smi', '--query-gpu=name,power.limit',
                '--format=csv,noheader']).splitlines()[0]


def bound(flops, nbytes):
    """``(ms, 'operations' | 'bytes')``: :func:`roofline.bound_s` in
    milliseconds."""
    s, by = roofline.bound_s(flops, nbytes)
    return s * 1e3, by


def segment_cases(rng, nb):
    """The segment kernels at the flagship's geometry over ``nb`` blocks
    (``nb // M`` carry segments x V lanes, C context rows each), swept
    per-block LowPass coefficients: ``{name: (call, plain, flops(g),
    bytes(g))}``; ``call``/``plain`` take ``sum_groups``, ``flops``/``bytes``
    count the work of a call with that group (0: per lane)."""
    import torch
    from signals_tpu_torch.compiler import kernels as K
    from signals_tpu_torch.compiler.filters import design_coupled
    from signals_tpu_torch.core.xp import TorchXP
    dev = torch.device('cuda')
    geo = dict(n_segments=nb, seg_frames=F, context=C, blocks_per_seg=M)
    cuts = torch.as_tensor(rng.uniform(600.0, 5000.0, (1, nb * V))
                           .astype(np.float32), device=dev)
    co = design_coupled(TorchXP(dev), 'lp', (cuts,), np.float32(RATE / 2))
    co = co.reshape(1, nb, V, 11).permute(1, 0, 2, 3).contiguous()
    toff = torch.full((V,), -C, dtype=torch.int32, device=dev)
    lanef = torch.as_tensor(np.stack([poly_freqs(V), np.zeros(V, np.float32),
                                      np.ones(V, np.float32)]), device=dev)
    gen = dict(geo, osc_code=K.OSC_SAW, rate=RATE)
    x = K.gen_source_rows(toff, lanef, n_segments=1, seg_frames=nb * F,
                          context=C, osc_code=K.OSC_SAW, rate=RATE)[0]
    lane_rows = nb // M * V * (C + M * F)      # the rows the algorithm runs
    co_bytes = co.numel() * 4

    def out_bytes(g):
        return nb * F * (V // g if g else V) * 4

    def k1_work(g):
        return roofline.k1_work(blocks=nb, voices=V, context=C,
                                blocks_per_seg=M, block_frames=F,
                                summed=bool(g))

    return co, toff, lanef, gen, {
        'segments_gen': (
            lambda g=0: K.sosfilt_segments_gen(co, toff, lanef, **gen,
                                               sum_groups=g),
            lambda g=0: K.sosfilt_segments_gen_plain(co, toff, lanef, **gen,
                                                     sum_groups=g),
            lambda g: k1_work(g)[0],
            lambda g: k1_work(g)[1]),
        'segments': (
            lambda g=0: K.sosfilt_segments(co, x, **geo, sum_groups=g),
            lambda g=0: K.sosfilt_segments_plain(co, x, **geo, sum_groups=g),
            lambda g: lane_rows * (CASCADE_FLOP + (1 if g else 0)),
            lambda g: co_bytes + x.numel() * 4 + out_bytes(g)),
    }


def phase_kernels():
    """Each kernel vs its plain version on the card; returns per kernel
    ``{err, ms, plain_ms, device_ms, bound_ms, bound_by}`` at the shape of
    chip_smoke's main-path render (the segment kernels at N_BLOCKS blocks,
    sum of V)."""
    import torch
    from signals_tpu_torch.compiler import kernels as K
    from signals_tpu_torch.compiler.filters import design_coupled
    from signals_tpu_torch.core.xp import TorchXP
    dev = torch.device('cuda')
    rng = np.random.default_rng(0)
    card = card_line()
    results = {}
    for nb in (N_BLOCKS, n_blocks_60s()):
        co, toff, lanef, gen, cases = segment_cases(rng, nb)
        # identity cascade (d0 = 1): the kernel's saw must be bit-exact
        co_id = torch.zeros_like(co)
        co_id[..., 8] = 1.0
        src = K.gen_source_rows(toff, lanef, n_segments=nb // M,
                                seg_frames=M * F, context=C,
                                osc_code=K.OSC_SAW,
                                rate=RATE)[:, C:].reshape(nb, F, V)
        got_id = K.sosfilt_segments_gen(co_id, toff, lanef, **gen)
        err_id = float((got_id - src).abs().max())
        print(f'[kernels] segments_gen identity-cascade saw vs source rows, '
              f'{nb} blocks: max abs {err_id!r} (must be 0.0)')
        assert err_id == 0.0, err_id
        del co_id, src, got_id
        for name, (call, plain, flops, nbytes) in cases.items():
            got, want = call(), plain()
            err = float((got - want).abs().max())
            print(f'[kernels] {name} lanes vs plain, {nb} blocks: max abs '
                  f'{err!r} (tol {TOL})')
            assert torch.isfinite(got).all() and err <= TOL, err
            del got, want
            gsum, wsum = call(V), plain(V)
            rel = float((gsum - wsum).abs().max() / wsum.abs().max())
            print(f'[kernels] {name} sum_groups={V} vs plain, {nb} blocks: '
                  f'max abs / max {rel!r} (tol {TOL})')
            assert gsum.shape == (nb, F, 1) and rel <= TOL, rel
            for g in (V, 0):
                if g == 0 and name == 'segments':
                    continue           # K2 serves per-lane windows too,
                    # but its main-path call is the mix plan's sum
                dms = device_ms(lambda: call(g), 5, SEG_KERNELS)
                b_ms, b_by = bound(flops(g), nbytes(g))
                what = f'sum_groups={g}' if g else 'per lane'
                share = 'not measured' if dms is None else f'{b_ms / dms:.3f}'
                dtxt = 'not measured' if dms is None else f'{dms:.4f} ms'
                print(f'[kernels] {name} {what}, {nb} blocks '
                      f'({nb // M} carry segments x {V} lanes): device '
                      f'{dtxt} (profiler), bound {b_ms:.4f} ms '
                      f'({b_by}: {flops(g) / 1e9:.3f} GFLOP, '
                      f'{nbytes(g) / 1e6:.1f} MB), share {share}  [{card}]')
                if nb == N_BLOCKS and g == V:
                    ms = cuda_ms(lambda: call(V), 20)
                    plain_ms = cuda_ms(lambda: plain(V), 1)
                    print(f'[kernels] {name} sum_groups={V}, {nb} blocks: '
                          f'kernel {ms:.4f} ms per call (CUDA events, wrapper '
                          f'included), plain {plain_ms:.1f} ms')
                    results[name] = dict(err=max(err, rel), ms=ms,
                                         plain_ms=plain_ms, device_ms=dms,
                                         bound_ms=b_ms, bound_by=b_by)
        del cases
        torch.cuda.empty_cache()

    noise_shape_kernel(rng, dev, card, results)
    zero_state_kernels(rng, dev, card, results)
    carried_state_kernels(rng, dev, card, results)
    score_layout_kernel(rng, dev, card)
    return results


def noise_shape_kernel(rng, dev, card, results):
    """K2 at the noise voice's shape, against its plain version on ``dev``:
    V lanes of static cutoffs (one coefficient set per 8-block segment)
    reading ONE noise channel through a lane stride of 0, context NOISE_C,
    the in-kernel sum of V, over N_BLOCKS and a 60 s render's blocks.  The
    call on the channel copied out to V lanes (what a contiguous input
    costs: the copy and V times the input bytes) must give the same bits.
    Joins ``results['segments']``'s error and adds its ``noise_*`` keys."""
    import torch
    from signals_tpu_torch.compiler import kernels as K
    from signals_tpu_torch.compiler.filters import design_coupled
    from signals_tpu_torch.core.xp import TorchXP
    cuts = torch.as_tensor(NOISE_CUTS.reshape(1, V), device=dev)
    co1 = design_coupled(TorchXP(dev), 'lp', (cuts,), np.float32(RATE / 2))
    for nb in (N_BLOCKS, n_blocks_60s()):
        n_seg = nb // M
        co = torch.broadcast_to(co1[None], (n_seg, 1, V, 11))
        x = torch.as_tensor(rng.uniform(0.0, 1.0, (NOISE_C + nb * F, 1))
                            .astype(np.float32), device=dev)
        geo = dict(n_segments=n_seg, seg_frames=M * F, context=NOISE_C,
                   sum_groups=V)

        def call():
            return K.sosfilt_segments(co, x, **geo)

        def copied():
            return K.sosfilt_segments(co, x.expand(-1, V).contiguous(),
                                      **geo)

        got, want = call(), K.sosfilt_segments_plain(co, x, **geo)
        rel = float((got - want).abs().max() / want.abs().max())
        same = bool(torch.equal(got, copied()))
        print(f'[kernels] segments, noise shape ({V} lanes on 1 channel, C '
              f'{NOISE_C}, {n_seg} segments of {M} blocks, sum of {V}), '
              f'{nb} blocks vs plain: max abs / max {rel!r} (tol {TOL}); '
              f'same bits as the input copied out to {V} lanes: {same}')
        assert got.shape == (n_seg, M * F, 1) and rel <= TOL and same, rel
        del got, want
        lane_rows = n_seg * V * (NOISE_C + M * F)
        flops = lane_rows * (CASCADE_FLOP + 1)
        nbytes = (co1.numel() + x.numel() + nb * F) * 4
        b_ms, b_by = bound(flops, nbytes)
        dms, how = kernel_device_ms(call, 5, SEG_KERNELS)
        wide = x.expand(-1, V).contiguous()
        cms, _ = kernel_device_ms(
            lambda: K.sosfilt_segments(co, wide, **geo), 5, SEG_KERNELS)
        del wide
        ms = cuda_ms(call, 10)
        copied_ms = cuda_ms(copied, 5)
        print(f'[kernels] segments, noise shape, {nb} blocks: device '
              f'{dms:.4f} ms ({how}; {cms:.4f} ms reading a {V}-lane copy), '
              f'bound {b_ms:.4f} ms ({b_by}: {flops / 1e9:.3f} GFLOP, '
              f'{nbytes / 1e6:.1f} MB), share {b_ms / dms:.3f}; per call '
              f'{ms:.4f} ms (CUDA events, wrapper included) against '
              f'{copied_ms:.4f} ms making the copy first  [{card}]')
        results['segments']['err'] = max(rel, results['segments']['err'])
        if nb == N_BLOCKS:
            plain_ms = cuda_ms(
                lambda: K.sosfilt_segments_plain(co, x, **geo), 1)
            print(f'[kernels] segments, noise shape, {nb} blocks: plain '
                  f'{plain_ms:.1f} ms')
            results['segments'].update(
                noise_ms=dms, noise_call_ms=ms, noise_plain_ms=plain_ms,
                noise_bound_ms=b_ms, noise_bound_by=b_by)
        del x
        torch.cuda.empty_cache()


def zero_state_kernels(rng, dev, card, results):
    """K3/K4 vs their plain versions on ``dev`` at the main paths' shapes,
    each device time beside its bound; fills ``results['batch']`` and
    ``results['timeline']`` as :func:`phase_kernels` does the others."""
    import torch
    from signals_tpu_torch.compiler import kernels as K
    from signals_tpu_torch.compiler.filters import design_coupled
    from signals_tpu_torch.core.xp import TorchXP
    # the zero-state kernels at the shapes the per-block and render-ahead
    # paths give them: the render-ahead batch's windows read in place from
    # the (C + 8F, 16) timeline (overlapping views, as _batch_compute passes
    # them) and the step's (1152, 16) timeline, at 1 (low-pass) and 2
    # (band-pass) sections; the mono step (1152, 1); the sampled filter's
    # windows (C + 1 rows every F frames, tail 1, as _sampled_kernel).
    # Bytes: the distinct rows read, the rows written, the coefficients;
    # operations: every row of every window through every section.
    L = STATIC_C + F
    lanes3 = AHEAD * STATIC_CH
    xt = torch.as_tensor(rng.standard_normal((L + (AHEAD - 1) * F, STATIC_CH))
                         .astype(np.float32), device=dev)
    x3 = xt.unfold(0, L, F).permute(2, 0, 1)             # (L, 8, 16) view
    xs = xt.unfold(0, STATIC_C + 1, F).permute(2, 0, 1)  # (C + 1, 8, 16)
    rows, cos = {}, {}
    for nsec, btype in ((1, 'lp'), (2, 'bp')):
        lo = torch.as_tensor(rng.uniform(300.0, 3000.0, (1, lanes3))
                             .astype(np.float32), device=dev)
        crits = (lo,) if nsec == 1 else (lo, lo * 4.0)
        co3 = design_coupled(TorchXP(dev), btype, crits, np.float32(RATE / 2))
        co3 = co3.reshape(nsec, AHEAD, STATIC_CH, 11).permute(
            1, 0, 2, 3).contiguous()
        cos[nsec] = co3
        x4 = xt[:L].contiguous()
        rows[f'batch/{nsec}'] = (
            f'render-ahead, in place (L {L}, {AHEAD} x {STATIC_CH}, tail '
            f'{F}), {nsec} section(s)',
            lambda co3=co3: K.sosfilt_batch(co3, x3, tail=F),
            lambda co3=co3: K.sosfilt_batch_plain(co3, x3, tail=F),
            *roofline.k3_work(windows=AHEAD, lanes=STATIC_CH,
                              context=STATIC_C, tail=F, nsec=nsec))
        rows[f'timeline/{nsec}'] = (
            f'step ({L}, {STATIC_CH}), {nsec} section(s)',
            lambda co3=co3, x4=x4: K.sosfilt_timeline(co3[0], x4),
            lambda co3=co3, x4=x4: K.sosfilt_timeline_plain(co3[0], x4),
            L * STATIC_CH * CASCADE_FLOP * nsec,
            2 * L * STATIC_CH * 4 + co3[0].numel() * 4)
    co1, x1 = cos[1][0, :, :1].contiguous(), xt[:L, :1].contiguous()
    rows['timeline/mono'] = (
        f'mono step ({L}, 1), 1 section',
        lambda: K.sosfilt_timeline(co1, x1),
        lambda: K.sosfilt_timeline_plain(co1, x1),
        L * CASCADE_FLOP, 2 * L * 4 + co1.numel() * 4)
    rows['batch/sampled'] = (
        f'sampled, in place (C + 1 = {STATIC_C + 1} rows, {AHEAD} x '
        f'{STATIC_CH}, tail 1), 1 section',
        lambda: K.sosfilt_batch(cos[1], xs, tail=1),
        lambda: K.sosfilt_batch_plain(cos[1], xs, tail=1),
        (STATIC_C + 1) * lanes3 * CASCADE_FLOP,
        (STATIC_C + 1) * lanes3 * 4 + lanes3 * 4 + cos[1].numel() * 4)
    for key, (what, call, plain, flops, nbytes) in rows.items():
        name = key.split('/')[0]
        got, want = call(), plain()
        err = float((got - want).abs().max())
        print(f'[kernels] {name} {what} {tuple(got.shape)} vs plain: max '
              f'abs {err!r} (tol {TOL})')
        assert torch.isfinite(got).all() and err <= TOL, err
        ms = cuda_ms(call, 50)
        dev_ms, how = kernel_device_ms(call, 20, ('rows_cascade',))
        plain_ms = cuda_ms(plain, 1)
        b_ms, b_by = bound(flops, nbytes)
        print(f'[kernels] {name} {what}: {ms:.4f} ms '
              f'per call (CUDA events, wrapper included), device '
              f'{dev_ms:.4f} ms ({how}), bound {b_ms:.6f} ms ({b_by}: '
              f'{flops / 1e6:.3f} MFLOP, {nbytes / 1e6:.3f} MB), share '
              f'{b_ms / dev_ms:.4f}; plain {plain_ms:.1f} ms  [{card}]')
        if key in ('batch/1', 'timeline/1'):
            results[name] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                 device_ms=dev_ms, device_ms_by=how,
                                 bound_ms=b_ms, bound_by=b_by)
        else:
            results[name]['err'] = max(err, results[name]['err'])

    # the segment gate's two sides at one shape: the render-ahead batch's
    # windows through the timeline segment kernel instead (per-block
    # segments over the (C + 8F, 16) timeline), 1 section
    co_seg = cos[1]
    seg = K.sosfilt_segments(co_seg, xt, n_segments=AHEAD, seg_frames=F,
                             context=STATIC_C)
    bat = K.sosfilt_batch(co_seg, x3, tail=F).permute(1, 0, 2)
    err = float((seg - bat).abs().max())
    assert err <= TOL, err
    seg_ms, seg_how = kernel_device_ms(lambda: K.sosfilt_segments(
        co_seg, xt, n_segments=AHEAD, seg_frames=F, context=STATIC_C), 20,
        SEG_KERNELS)
    bat_ms, bat_how = kernel_device_ms(
        lambda: K.sosfilt_batch(co_seg, x3, tail=F), 20, ('rows_cascade',))
    print(f'[kernels] gate, render-ahead shape ({AHEAD} blocks x '
          f'{STATIC_CH} lanes, C={STATIC_C}): segments {seg_ms:.4f} ms '
          f'({seg_how}) vs batch {bat_ms:.4f} ms ({bat_how}) device, both '
          f'reading the timeline in place; outputs agree to {err!r}  '
          f'[{card}]')


def score_layout_kernel(rng, dev, card):
    """K3 at the 64-voice score's shape (the benchmark's ``score``: the
    60 s bounce's blocks as windows of context 1024 + F rows read in place
    from each voice's timeline, the vmap layout's voice-major one, 64
    voices folded one lane each, tail F, one LowPass at SCORE_CUT shared by
    the voices) in both output layouts: the same bits, each layout's device
    time beside the bound of ``roofline.k3_work`` (one count for both)."""
    import torch
    from signals_tpu_torch.compiler import kernels as K
    from signals_tpu_torch.compiler.filters import design_coupled
    from signals_tpu_torch.core.xp import TorchXP
    nb, voices, ctx = n_blocks_60s(), 64, 1024
    t = torch.arange(ctx + nb * F, device=dev, dtype=torch.float32)[None]
    hz = torch.as_tensor(rng.uniform(60.0, 900.0, (voices, 1))
                         .astype(np.float32), device=dev)
    xv = 2.0 * torch.remainder(t * hz / RATE, 1.0) - 1.0   # (64, C + nb F)
    x = xv.t().unfold(0, ctx + F, F).permute(2, 0, 1)    # (C + F, nb, 64)
    cut = torch.full((1, 1), SCORE_CUT, dtype=torch.float32, device=dev)
    co = design_coupled(TorchXP(dev), 'lp', (cut,), np.float32(RATE / 2))
    co = co[None].expand(nb, 1, voices, 11)
    calls = {name: (lambda tm=tm: K.sosfilt_batch(co, x, tail=F,
                                                  time_major=tm))
             for name, tm in (('lane-major', False), ('time-major', True))}
    lane, tm = (call() for call in calls.values())
    torch.cuda.synchronize()
    same = torch.equal(lane, tm)
    assert same and tm.stride() == (1, F, nb * F), same
    del lane, tm
    flops, nbytes = roofline.k3_work(windows=nb, lanes=voices, context=ctx,
                                     tail=F)
    b_ms, b_by = bound(flops, nbytes)
    for name, call in calls.items():
        dev_ms, how = kernel_device_ms(call, 20, ('rows_cascade',))
        print(f'[kernels] batch at the score shape ({ctx + F} rows, {nb} x '
              f'{voices} lanes, tail {F}), {name}: device {dev_ms:.4f} ms '
              f'({how}), bound {b_ms:.4f} ms ({b_by}: {flops / 1e9:.3f} '
              f'GFLOP, {nbytes / 1e6:.1f} MB), share {b_ms / dev_ms:.4f}; '
              f'the two layouts\' bits equal  [{card}]')
    torch.cuda.empty_cache()


def carried_state_kernels(rng, dev, card, results):
    """The carried-state entry (``sosfilt_stream``; ``sosfilt_batch`` with
    the end states) vs the frame loop on ``dev`` at the shapes the stateful
    paths give it: a streaming filter's step (1024, 1) and (1024, 16) at 1
    and 2 sections from a non-zero state, ``mega_step``'s 16 windows of
    1024 rows with their end states, and a 1152-row window cut into two
    calls.  Inputs are saws (the paths' scale), the state of the same
    scale.  Fills ``results['stream']``; the batched rows join
    ``results['batch']``'s error."""
    import torch
    from signals_tpu_torch.compiler import kernels as K
    from signals_tpu_torch.compiler.filters import design_coupled
    from signals_tpu_torch.core.xp import TorchXP

    def saws(n, lanes):
        t = torch.arange(n, device=dev, dtype=torch.float32)[:, None]
        hz = torch.as_tensor(rng.uniform(60.0, 900.0, (1, lanes))
                             .astype(np.float32), device=dev)
        return 2.0 * torch.remainder(t * hz / RATE, 1.0) - 1.0

    def coeffs(nsec, lanes):
        lo = torch.as_tensor(rng.uniform(300.0, 3000.0, (1, lanes))
                             .astype(np.float32), device=dev)
        crits = (lo,) if nsec == 1 else (lo, lo * 4.0)
        return design_coupled(TorchXP(dev), 'lp' if nsec == 1 else 'bp',
                              crits, np.float32(RATE / 2))

    def state(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=dev)

    def errs(got, want):
        (y, zf), (wy, wzf) = got, want
        assert torch.isfinite(y).all() and torch.isfinite(zf).all()
        return (float((y - wy).abs().max()),
                float((zf - wzf).abs().max())
                / max(1.0, float(wzf.abs().max())))

    # the JSON line's shape first; after the steps, the whole windows a
    # fixed-cutoff mega_step gives it: the echo's 16-block segment, mono,
    # and the streaming voice's 8-block Transport batch
    shapes = [(F, STATIC_CH, 1, 'step'), (F, STATIC_CH, 2, 'step'),
              (F, 1, 1, 'step'), (F, 1, 2, 'step'),
              (ECHO_BLOCKS * F, 1, 1, 'echo segment'),
              (AHEAD * F, STATIC_CH, 1, 'Transport batch')]
    for n, ch, nsec, kind in shapes:
        co, x, zi = coeffs(nsec, ch), saws(n, ch), state(nsec, 2, ch)
        what = f'{kind} ({n}, {ch}), {nsec} section(s), zi and zf'

        def call():
            return K.sosfilt_stream(co, x, zi)

        def plain():
            return K.sosfilt_stream_plain(co, x, zi)

        ey, ez = errs(call(), plain())
        print(f'[kernels] stream {what} vs plain: y max abs {ey!r}, zf '
              f'max abs / scale {ez!r} (tol {TOL})')
        assert ey <= TOL and ez <= TOL, (what, ey, ez)
        ms = cuda_ms(call, 50)
        dev_ms, how = kernel_device_ms(call, 20, ('rows_cascade',))
        plain_ms = cuda_ms(plain, 1)
        flops = n * ch * CASCADE_FLOP * nsec
        nbytes = (2 * n * ch + co.numel() + 2 * zi.numel()) * 4
        b_ms, b_by = bound(flops, nbytes)
        print(f'[kernels] stream {what}: {ms:.4f} ms per call (CUDA '
              f'events, wrapper included), device {dev_ms:.4f} ms ({how}), '
              f'bound {b_ms:.6f} ms ({b_by}: {flops / 1e6:.3f} MFLOP, '
              f'{nbytes / 1e6:.3f} MB), share {b_ms / dev_ms:.4f}; plain '
              f'{plain_ms:.1f} ms  [{card}]')
        if 'stream' not in results:
            results['stream'] = dict(err=max(ey, ez), ms=ms,
                                     plain_ms=plain_ms, device_ms=dev_ms,
                                     device_ms_by=how, bound_ms=b_ms,
                                     bound_by=b_by)
        else:
            results['stream']['err'] = max(ey, ez,
                                           results['stream']['err'])

    # mega_step's launch: nb windows of F rows, read in place as a permuted
    # view of the (nb, F, ch) blocks, with every window's end state
    nb = ECHO_BLOCKS
    for ch in (1, 8):
        xb = saws(nb * F, ch).reshape(nb, F, ch)
        co = coeffs(1, nb * ch).reshape(1, nb, ch, 11).permute(1, 0, 2, 3)
        what = f'{nb} windows of {F} rows x {ch}, tail {F}, zf'

        def call():
            return K.sosfilt_batch(co, xb.permute(1, 0, 2), tail=F,
                                   return_state=True)

        def plain():
            return K.sosfilt_batch_plain(
                torch.broadcast_to(co, (nb, 1, ch, 11)),
                xb.permute(1, 0, 2), tail=F, return_state=True)

        ey, ez = errs(call(), plain())
        dev_ms, how = kernel_device_ms(call, 20, ('rows_cascade',))
        flops = nb * F * ch * CASCADE_FLOP
        nbytes = (2 * nb * F * ch + co.numel() + 2 * nb * ch) * 4
        b_ms, b_by = bound(flops, nbytes)
        print(f'[kernels] batch {what} vs plain: y max abs {ey!r}, zf max '
              f'abs / scale {ez!r} (tol {TOL}); device {dev_ms:.4f} ms '
              f'({how}), bound {b_ms:.6f} ms ({b_by}), share '
              f'{b_ms / dev_ms:.4f}  [{card}]')
        assert ey <= TOL and ez <= TOL, (what, ey, ez)
        results['batch']['err'] = max(ey, ez, results['batch']['err'])

    # a window cut into two calls continues as one call
    L = STATIC_C + F
    co, x, zi = coeffs(2, STATIC_CH), saws(L, STATIC_CH), state(2, 2,
                                                                 STATIC_CH)
    y, zf = K.sosfilt_stream(co, x, zi)
    ya, za = K.sosfilt_stream(co, x[:STATIC_C], zi)
    yb, zb = K.sosfilt_stream(co, x[STATIC_C:], za)
    ey, ez = errs((torch.cat([ya, yb]), zb), (y, zf))
    print(f'[kernels] stream ({L}, {STATIC_CH}), 2 sections, cut at row '
          f'{STATIC_C} into two calls vs one call: y max abs {ey!r}, zf max '
          f'abs / scale {ez!r} (tol 1e-6)')
    assert ey <= 1e-6 and ez <= 1e-6, (ey, ez)


def n_blocks_60s():
    """Blocks of a 60 s render, rounded up to whole carry segments."""
    return int(np.ceil(SECONDS * RATE / F / M)) * M


def oracle_mix(n_blocks, peak=False):
    """The numpy pull oracle: the V-wide voice patch rendered per block and
    summed over voices."""
    from signals_tpu_torch.core import BlockLoc, Request, Shape
    root, hz = build_subtractive_voice(peak=peak)
    hz.get_state().value = poly_freqs(V).reshape(1, V)
    blocks = []
    for i in range(n_blocks):
        loc = BlockLoc(position=i * F, rate=RATE, shape=Shape(F, V))
        b = root.respond(Request(requestor=None, port='oracle', loc=loc))
        blocks.append(np.broadcast_to(b, (F, V)))
    return np.concatenate(blocks).sum(axis=1, keepdims=True)


def make_poly(peak=False, **kw):
    from signals_tpu_torch.parallel import PolyPatch
    root, hz = build_subtractive_voice(peak=peak)
    return PolyPatch(root, n_voices=V, overrides={(hz, 'value'): poly_freqs(V)},
                     block_frames=F, rate=RATE, layout='channels',
                     device='cuda', **kw)


@contextlib.contextmanager
def plain_kernels():
    """Within this block the kernel wrappers are swapped for their plain
    PyTorch versions (the node lowerings look them up at call time): the
    plain path on the card, for timing it beside the kernels."""
    from signals_tpu_torch.compiler import kernels as K
    names = ('sosfilt_segments_gen', 'sosfilt_segments', 'sosfilt_batch',
             'sosfilt_timeline', 'sosfilt_stream')
    saved = {n: getattr(K, n) for n in names}
    for n in names:
        setattr(K, n, getattr(K, f'{n}_plain'))
    try:
        with plain_fdn():
            yield
    finally:
        for n, fn in saved.items():
            setattr(K, n, fn)


def plain_fdn_entry():
    """``fdn_advance`` on its plain versions: the turn loop forward and the
    plain adjoint as its backward (an ``autograd.Function``, as the kernel
    entry is, so that a fit runs on it too)."""
    import torch
    from signals_tpu_torch.compiler import kernels as K

    class PlainFdn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, lines, inject, g, lengths):
            tl = K.fdn_advance_plain(lines, inject, g, lengths)
            ctx.save_for_backward(tl, g)
            ctx.lengths, ctx.L = lengths, lines.shape[0]
            return tl

        @staticmethod
        def backward(ctx, gtl):
            tl, g = ctx.saved_tensors
            return (*K.fdn_advance_vjp_plain(tl, g, gtl, ctx.lengths, ctx.L),
                    None)

    def entry(lines, inject, g, lengths):
        lengths = tuple(int(d) for d in lengths)
        return PlainFdn.apply(*K._check_fdn(lines, inject, g, lengths),
                              lengths)

    return entry


@contextlib.contextmanager
def plain_fdn():
    """Within this block the reverb's network runs its plain versions (the
    reverb looks ``fdn_advance`` up at call time)."""
    from signals_tpu_torch.compiler import kernels as K
    saved = K.fdn_advance
    K.fdn_advance = plain_fdn_entry()
    try:
        yield
    finally:
        K.fdn_advance = saved


def phase_render():
    """The flagship through the port's entry points.  Returns, per kernel,
    ``(launches, render)``: its launch count in the render that proves it
    (the default render for K1, the generator-off render for K2)."""
    import torch
    from signals_tpu_torch.compiler import filters, kernels as K
    default = make_poly()
    assert default._mix_epilogue, 'mix epilogue not on for cuda'
    assert default.compiled.mega_mix(N_BLOCKS) is not None, \
        'the flagship is not eligible for the mix plan'
    per_voice = make_poly(mix_epilogue=False)
    filters.SEG_SOURCE_GEN = False       # compile-time snapshot
    gen_off = make_poly()
    filters.SEG_SOURCE_GEN = 'auto'
    variants = (
        ('default (generator + mix epilogue)', default, {'segments_gen': 1}),
        ('mix_epilogue=False', per_voice, {'segments_gen': 1}),
        ('generator off (timeline kernel)', gen_off, {'segments': 1}),
    )
    mixes, counts = {}, {}
    for name, poly, expect in variants:
        mixes[name] = launched(
            name, lambda: poly.render(n_blocks=N_BLOCKS)[0], expect)
        counts[name] = dict(K.LAUNCHES)

    t0 = time.perf_counter()
    want = oracle_mix(ORACLE_BLOCKS)
    print(f'[render] numpy oracle, {ORACLE_BLOCKS} blocks: '
          f'{time.perf_counter() - t0:.1f} s')
    budget = V * TOL
    ref = None
    for name, mix in mixes.items():
        got = mix.cpu().numpy()
        assert got.shape == (N_BLOCKS * F, 1), got.shape
        assert np.isfinite(got).all(), name
        err = float(np.abs(got[:ORACLE_BLOCKS * F] - want).max())
        print(f'[render] {name}: vs oracle max abs {err!r} '
              f'(budget {budget:g}, peak {float(np.abs(want).max())!r})')
        assert err <= budget, (name, err)
        if ref is None:
            ref = got
        else:
            diff = float(np.abs(got - ref).max())
            print(f'[render] {name}: vs default over {N_BLOCKS} blocks '
                  f'max abs {diff!r}')
            assert diff <= budget, (name, diff)

    n60 = n_blocks_60s()
    audio_s = n60 * F / RATE
    card = card_line()
    for name, poly in (('kernel path (default plan)', default),
                       ('kernel path (mix_epilogue=False)', per_voice)):
        ms = cuda_ms(lambda: poly.render(n_blocks=n60), 3)
        print(f'[render] {name}: {n60} blocks ({audio_s:.3f} s audio) in '
              f'{ms:.3f} ms = {audio_s / (ms / 1e3):.1f}x realtime  [{card}]')
    with plain_kernels():
        ms = cuda_ms(lambda: default.render(n_blocks=n60), 1)
    print(f'[render] plain path (default plan, plain PyTorch cascade): '
          f'{ms:.1f} ms = {audio_s / (ms / 1e3):.1f}x realtime  [{card}]')
    return {'segments_gen': (counts[variants[0][0]]['segments_gen'],
                             variants[0][0]),
            'segments': (counts[variants[2][0]]['segments'],
                         variants[2][0])}


def launched(name, fn, expect, total=None, quiet=False):
    """Run ``fn`` with the launch counts reset just before it; assert the
    counts just after (every other kernel 0) and add them to ``total``.
    Returns ``fn``'s result.  ``quiet`` prints nothing (one of many equal
    calls)."""
    import torch
    from signals_tpu_torch.compiler import kernels as K
    K.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(K.LAUNCHES)
    want = {k: expect.get(k, 0) for k in counts}
    if not quiet:
        print(f'[launches] {name}: {counts}')
    assert counts == want, (name, counts, want)
    if total is not None:
        total.update(counts)
    return out


def held(name, got, want):
    """``got`` within TOL per lane of the oracle ``want``."""
    got = np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all(), name
    err = float(np.abs(got - want).max())
    print(f'[paths] {name}: vs oracle max abs {err!r} (tol {TOL}, peak '
          f'{float(np.abs(want).max())!r})')
    assert err <= TOL, (name, err)


def phase_paths():
    """The per-block and render-ahead paths through the port's entry points
    (``compile_node``, ``render``, ``step``, ``Transport``).  Returns, per
    zero-state kernel, ``(launches, what launched it)``."""
    import torch
    from signals_tpu_torch.compiler import compile_node
    from signals_tpu_torch.runtime import Transport
    from signals_tpu_torch.utils import LatencyStats
    card = card_line()
    total = collections.Counter()      # launches of the K3/K4 renders

    # (a) the mono subtractive voice: 60 s from 0, 13 blocks from block 3
    mono = compile_node(build_subtractive_voice(gain=1.0 / 64)[0],
                        block_frames=F, rate=RATE, channels=1, device='cuda')
    assert mono.carry_seg_align == M
    n60 = n_blocks_60s()
    t0 = time.perf_counter()
    want = pull_oracle(build_subtractive_voice(gain=1.0 / 64)[0], 16, 1)
    print(f'[paths] mono oracle, 16 blocks: {time.perf_counter() - t0:.1f} s')
    full = launched('mono 60 s from 0',
                    lambda: mono.render(n_blocks=n60)[0],
                    {'segments_gen': 1}).cpu().numpy()
    held('mono 60 s from 0, blocks 0-15', full[:16 * F], want)
    part = launched('mono 13 blocks from block 3',
                    lambda: mono.render(position=3 * F, n_blocks=13)[0],
                    {'segments_gen': 1}).cpu().numpy()
    held('mono 13 blocks from block 3', part, want[3 * F:])
    diff = float(np.abs(part - full[3 * F:16 * F]).max())
    print(f'[paths] mono from block 3 vs the 60 s render, same blocks: '
          f'max abs {diff!r}')
    assert diff <= TOL, diff

    # (b) the static voice through the Transport's render-ahead batches
    static = compile_node(build_static_voice(), block_frames=F, rate=RATE,
                          channels=STATIC_CH, device='cuda')
    assert static.carry_seg_align == 1
    want = pull_oracle(build_static_voice(), 3 + 3 * AHEAD + 1, STATIC_CH)
    tr = Transport(static, consumer=None, blocks_per_call=AHEAD)
    tr.seek(3 * F)
    batches = [launched(f'Transport batch at block {3 + i * AHEAD}',
                        lambda: tr.render(AHEAD), {'batch': 1}, total)
               for i in range(3)]
    held('static voice, 3 Transport batches', np.concatenate(batches),
         want[3 * F:(3 + 3 * AHEAD) * F])

    # (c) step() of the static voice and of the band voice
    band = compile_node(build_static_voice(band=True), block_frames=F,
                        rate=RATE, channels=STATIC_CH, device='cuda')
    want_band = pull_oracle(build_static_voice(band=True), 28, STATIC_CH)
    for name, patch, ref in (('static', static, want),
                             ('band', band, want_band)):
        params = patch.params()
        for b in (0, 3, 27):
            got = launched(f'{name} step at block {b}',
                           lambda: patch.step(params, {}, b * F)[0],
                           {'timeline': 1}, total)
            held(f'{name} step at block {b}', got.cpu().numpy(),
                 ref[b * F:(b + 1) * F])

    # timings (host clock, each including the copy off the card)
    for name, patch in (('static', static), ('band', band)):
        params = patch.params()
        stats = LatencyStats()
        for i in range(51):
            t0 = time.perf_counter()
            patch.step(params, {}, i * F)[0].cpu()
            if i:
                stats.record(time.perf_counter() - t0)
        print(f'[paths] {name} step, p50 of 50: {stats.p50 * 1e3:.4f} ms '
              f'({stats.headroom(F, RATE):.1f}x realtime)  [{card}]')
    tr = Transport(static, consumer=None, blocks_per_call=AHEAD)
    tr.render(AHEAD)
    tr.stats = LatencyStats()
    for _ in range(20):
        tr.render(AHEAD)
    print(f'[paths] static render-ahead, p50 per block of 20 {AHEAD}-block '
          f'batches: {tr.stats.p50 * 1e3:.4f} ms '
          f'({tr.stats.headroom(F, RATE):.1f}x realtime)  [{card}]')
    audio_s = n60 * F / RATE
    ms = cuda_ms(lambda: mono.render(n_blocks=n60), 3)
    print(f'[paths] mono 60 s render: {n60} blocks ({audio_s:.3f} s audio) '
          f'in {ms:.3f} ms = {audio_s / (ms / 1e3):.1f}x realtime  [{card}]')
    with plain_kernels():
        ms = cuda_ms(lambda: mono.render(n_blocks=n60), 1)
    print(f'[paths] mono 60 s render, plain PyTorch cascade: {ms:.1f} ms = '
          f'{audio_s / (ms / 1e3):.1f}x realtime  [{card}]')
    torch.cuda.synchronize()
    return {'batch': (total['batch'], 'Transport render-ahead: static '
                      'voice, 16 channels, 3 batches of 8 blocks'),
            'timeline': (total['timeline'], 'step(): static and band '
                         'voices, 3 blocks each')}


def phase_state():
    """Carried state through the port's entry points: feedback renders,
    streaming steps, ``Transport`` batches with the carry threaded, history
    reads.  Returns, per kernel, ``(launches, what launched it)``."""
    import torch
    from signals_tpu_torch.compiler import compile_node
    from signals_tpu_torch.runtime import Transport
    card = card_line()
    total = collections.Counter()

    def timed(name, fn, audio_s):
        wall, dev_ms, events = profiled(fn)
        print(f'[state] {name}: wall {wall:.3f} ms = '
              f'{audio_s / (wall / 1e3):.1f}x realtime, device {dev_ms:.3f} '
              f'ms in {events} kernels and copies, busy share '
              f'{dev_ms / wall:.3f}  [{card}]')

    # (a) the saturated echo: whole 16-block segments of the segmented scan
    echo = compile_node(build_saturated_echo(), block_frames=F, rate=RATE,
                        channels=1, device='cuda')
    n_echo = -(-n_blocks_60s() // ECHO_BLOCKS) * ECHO_BLOCKS
    n_seg = n_echo // ECHO_BLOCKS
    assert echo.plan(n_echo) == 'segment_scan', echo.plan(n_echo)
    t0 = time.perf_counter()
    want = pull_oracle(build_saturated_echo(), n_echo, 1)
    print(f'[state] saturated echo oracle, {n_echo} blocks: '
          f'{time.perf_counter() - t0:.1f} s')
    got, carry = launched(
        f'saturated echo, {n_echo} blocks in {n_seg} segments',
        lambda: echo.render(n_blocks=n_echo), {'stream': n_seg}, total)
    held(f'saturated echo, {n_echo} blocks ({n_echo * F / RATE:.1f} s)',
         got.cpu().numpy(), want)
    assert sorted(k for c in carry.values() for k in c) == ['buf', 'zi']
    timed(f'saturated echo, {n_echo} blocks, segment_scan_core S = '
          f'{ECHO_BLOCKS}', lambda: echo.render(n_blocks=n_echo),
          n_echo * F / RATE)

    # (b) the FM voice with a feedback delay: the loop-free delay solver
    n60 = n_blocks_60s()
    fm = compile_node(build_fm_delay(), block_frames=F, rate=RATE,
                      channels=1, device='cuda')
    assert fm.plan(n60) == 'delay_mega', fm.plan(n60)
    want = pull_oracle(build_fm_delay(), n60, 1)
    got, _ = launched(f'FM + feedback delay, {n60} blocks',
                      lambda: fm.render(n_blocks=n60), {}, total)
    held(f'FM + feedback delay, {n60} blocks', got.cpu().numpy(), want)
    timed(f'FM + feedback delay, {n60} blocks, delay_mega_core',
          lambda: fm.render(n_blocks=n60), n60 * F / RATE)

    # (c) the static voice as an exact IIR: steps, Transport batches, splits
    voice = compile_node(build_static_voice(streaming=True), block_frames=F,
                         rate=RATE, channels=STATIC_CH, device='cuda')
    assert voice.plan(AHEAD) == 'mega' and voice.carry0
    want = pull_oracle(build_static_voice(streaming=True), 50, STATIC_CH)
    params, carry, blocks = voice.params(), voice.carry0, []
    steps = collections.Counter()
    for b in range(50):
        block, carry = launched(f'streaming step at block {b}',
                                lambda: voice.step(params, carry, b * F),
                                {'stream': 1}, steps, quiet=b > 0)
        blocks.append(block)
    print(f"[launches] streaming steps at blocks 0-49, each checked alone: "
          f"'stream': {steps['stream']} in all")
    total.update(steps)
    held('streaming voice, 50 steps', torch.cat(blocks).cpu().numpy(), want)
    tr = Transport(voice, consumer=None, blocks_per_call=AHEAD)
    batches = [launched(f'streaming Transport batch at block {i * AHEAD}',
                        lambda: tr.render(AHEAD), {'stream': 1}, total)
               for i in range(3)]
    held('streaming voice, 3 Transport batches', np.concatenate(batches),
         want[:3 * AHEAD * F])
    whole, _ = voice.render(n_blocks=32)
    a, carry = voice.render(n_blocks=13)
    b, _ = voice.render(position=13 * F, n_blocks=19, carry=carry)
    diff = float((torch.cat([a, b]) - whole).abs().max())
    print(f'[state] streaming voice, 13 + 19 blocks vs 32: max abs {diff!r} '
          f'(tol 1e-6)')
    assert diff <= 1e-6, diff
    held('streaming voice, 32 blocks', whole.cpu().numpy(), want[:32 * F])
    state = {'carry': voice.carry0, 'block': 0}

    def one_step():
        block, state['carry'] = voice.step(params, state['carry'],
                                           state['block'] * F)
        state['block'] += 1
        return block.cpu()

    timed('streaming voice, one step with the copy off the card', one_step,
          F / RATE)
    timed(f'streaming voice, one {AHEAD}-block Transport batch',
          lambda: tr.render(AHEAD), AHEAD * F / RATE)

    # (d) a context filter reading a streaming filter's output history
    chain = compile_node(build_streaming_into_context(), block_frames=F,
                         rate=RATE, channels=8, device='cuda')
    assert chain.plan(AHEAD) == 'mega'
    assert any('hist' in c for c in chain.carry0.values())
    want = pull_oracle(build_streaming_into_context(), 2 * AHEAD, 8)
    carry, parts = chain.carry0, []
    for i in range(2):
        # the streaming filter's window and the context filter's replay
        part, carry = launched(
            f'streaming -> context, window {i}',
            lambda: chain.render(position=i * AHEAD * F, n_blocks=AHEAD,
                                 carry=carry), {'batch': 2}, total)
        parts.append(part)
    held('streaming -> context filter, 2 windows',
         torch.cat(parts).cpu().numpy(), want)
    timed(f'streaming -> context filter, one {AHEAD}-block window',
          lambda: chain.render(n_blocks=AHEAD), AHEAD * F / RATE)
    torch.cuda.synchronize()
    return {'stream': (total['stream'], f'saturated echo ({n_seg} '
                       f'segments), step() of the streaming static voice '
                       f'(50), its Transport batches (3)'),
            'batch': (total['batch'], 'swept mega_step and its context '
                      'reader: streaming -> context windows (2 x 2)')}


def phase_checks():
    """The rest of the nine-check set through the port's entry points.
    Returns, per kernel, ``(launches, what launched it)``."""
    import torch
    from signals_tpu_torch.compiler import compile_node
    from signals_tpu_torch.parallel import PolyPatch
    card = card_line()
    total = collections.Counter()
    n60 = n_blocks_60s()
    audio_s = n60 * F / RATE

    def timed(name, fn):
        wall, dev_ms, events = profiled(fn)
        print(f'[checks] {name}: wall {wall:.3f} ms = '
              f'{audio_s / (wall / 1e3):.1f}x realtime, device {dev_ms:.3f} '
              f'ms in {events} kernels and copies, busy share '
              f'{dev_ms / wall:.3f}  [{card}]')

    def within(name, got, want, tol):
        got = np.asarray(got)
        assert got.shape == want.shape and np.isfinite(got).all(), name
        err = float(np.abs(got - want).max())
        print(f'[checks] {name}: vs oracle max abs {err!r} (tol {tol:g}, '
              f'peak {float(np.abs(want).max())!r})')
        assert err <= tol, (name, err)

    def poly(build, values, **kw):
        root, node = build()
        return PolyPatch(root, n_voices=V, overrides={(node, 'value'): values},
                         block_frames=F, rate=RATE, device='cuda', **kw)

    def poly_oracle(build, values, n_blocks):
        root, node = build()
        node.get_state().value = values.reshape(1, V)
        return pull_oracle(root, n_blocks, V).sum(axis=1, keepdims=True)

    # (a) master_bus: K1 at one lane, the reverb's network in one launch
    bus = compile_node(build_master_bus(), block_frames=F, rate=RATE,
                       channels=1, device='cuda')
    assert bus.plan(n60) == 'mega', bus.plan(n60)
    assert sorted(k for c in bus.carry0.values() for k in c) == ['hist',
                                                                 'lines']
    t0 = time.perf_counter()
    want = pull_oracle(build_master_bus(), ORACLE_BLOCKS, 1)
    print(f'[checks] master_bus oracle, {ORACLE_BLOCKS} blocks: '
          f'{time.perf_counter() - t0:.1f} s')
    bus_launches = {'segments_gen': 1, 'fdn': 1}
    whole, wcarry = launched(f'master_bus, {n60} blocks, plan mega',
                             lambda: bus.render(n_blocks=n60), bus_launches,
                             total)
    within(f'master_bus, {n60} blocks, first {ORACLE_BLOCKS}',
           whole[:ORACLE_BLOCKS * F].cpu().numpy(), want, TOL)
    with plain_fdn():
        p_whole, p_carry = bus.render(n_blocks=n60)
    same = torch.equal(whole, p_whole) and all(
        torch.equal(wcarry[u][k], p_carry[u][k]) for u in wcarry
        for k in wcarry[u])
    print(f'[checks] master_bus, {n60} blocks: the network kernel vs the '
          f'plain turn loop, audio and carry the same bits: {same} (audio '
          f'max abs {float((whole - p_whole).abs().max())!r})')
    assert same
    del p_whole, p_carry
    a, carry = launched('master_bus, 13 blocks',
                        lambda: bus.render(n_blocks=13), bus_launches, total)
    b, _ = launched('master_bus, 19 blocks from block 13 with the carry',
                    lambda: bus.render(position=13 * F, n_blocks=19,
                                       carry=carry),
                    bus_launches, total)
    diff = float((torch.cat([a, b]) - whole[:32 * F]).abs().max())
    print(f'[checks] master_bus, 13 + 19 blocks vs the first 32 of {n60}: '
          f'max abs {diff!r} (tol 1e-6)')
    assert diff <= 1e-6, diff
    del whole
    timed(f'master_bus, {n60} blocks, plan mega',
          lambda: bus.render(n_blocks=n60))
    with plain_fdn():
        timed(f'master_bus, {n60} blocks, plan mega, the plain turn loop',
              lambda: bus.render(n_blocks=n60))

    # (b) poly64_noise_mix: K2 with the in-kernel sum, one noise channel
    noise = poly(build_noise_voice, NOISE_CUTS)
    assert noise.compiled.mega_mix(n60) is not None, \
        'the noise voice is not eligible for the mix plan'
    want = poly_oracle(build_noise_voice, NOISE_CUTS, ORACLE_BLOCKS)
    mix, _ = launched(f'poly64_noise_mix, {n60} blocks, mix plan',
                      lambda: noise.render(n_blocks=n60), {'segments': 1},
                      total)
    within(f'poly64_noise_mix, {n60} blocks, first {ORACLE_BLOCKS}',
           mix[:ORACLE_BLOCKS * F].cpu().numpy(), want, V * TOL)
    del mix
    timed(f'poly64_noise_mix, {n60} blocks, mix plan',
          lambda: noise.render(n_blocks=n60))

    # (c) sine under a Wave: the render bit for bit, the summary exact
    tap = build_sine_plot()
    sine = compile_node(tap, block_frames=F, rate=RATE, channels=1,
                        device='cuda')
    want = pull_oracle(build_sine_plot(), 43, 1)
    got, _ = launched('sine, 43 blocks', lambda: sine.render(
        n_blocks=43, deliver_taps=False), {}, total)
    err = float(np.abs(got.cpu().numpy() - want).max())
    print(f'[checks] sine, 43 blocks: vs oracle max abs {err!r} (must be '
          f'0.0)')
    assert err == 0.0, err
    summaries, _ = launched('sine, render_vis of 43 blocks',
                            lambda: sine.render_vis(n_blocks=43), {}, total)
    (summary,) = summaries.values()
    want_summary = tap.tap_summary(np, want, RATE)
    assert summary.shape == (750, 2, 1), summary.shape
    assert np.array_equal(summary, want_summary)
    print(f'[checks] sine, render_vis: summary {summary.shape} equals the '
          f'numpy summary of the oracle audio; {summary.nbytes} bytes '
          f'copied off the card for {want.nbytes} of audio')
    sine.render(n_blocks=4)
    assert tap.q.qsize() == 4 and tap.q.get_nowait().shape == (F, 1)
    timed(f'sine, render_vis of {n60} blocks',
          lambda: sine.render_vis(n_blocks=n60))

    # (d) fm_delay at its Spec root: the delay solver, no kernel
    spec = build_fm_delay(spec=True)
    fm = compile_node(spec, block_frames=F, rate=RATE, channels=1,
                      device='cuda')
    assert fm.plan(n60) == 'delay_mega', fm.plan(n60)
    want = pull_oracle(build_fm_delay(spec=True), n60, 1)
    got, _ = launched(f'fm_delay at the Spec, {n60} blocks',
                      lambda: fm.render(n_blocks=n60, deliver_taps=False),
                      {}, total)
    within(f'fm_delay at the Spec, {n60} blocks', got.cpu().numpy(), want,
           TOL)
    summaries, _ = launched(f'fm_delay, render_vis of {n60} blocks',
                            lambda: fm.render_vis(n_blocks=n60), {}, total)
    (bands,) = summaries.values()
    want_bands = spec.tap_summary(np, want, RATE)
    err = float(np.abs(bands - want_bands).max())
    print(f'[checks] fm_delay, render_vis: {bands.shape[0]} bands vs the '
          f'numpy summary of the oracle audio: max abs {err!r} (tol 1e-5 x '
          f'largest band {float(want_bands.max())!r})')
    assert bands.shape == (80,) and err <= TOL * float(want_bands.max())
    timed(f'fm_delay at the Spec, render_vis of {n60} blocks',
          lambda: fm.render_vis(n_blocks=n60))

    # (e) additive at 16 voices, bit for bit; the static mix
    root, hz = build_additive_voice()
    hz.get_state().value = poly_freqs(16).reshape(1, 16)
    add = compile_node(root, block_frames=F, rate=RATE, channels=16,
                       device='cuda')
    oroot, ohz = build_additive_voice()
    ohz.get_state().value = poly_freqs(16).reshape(1, 16)
    want = pull_oracle(oroot, 43, 16)
    got, _ = launched(f'additive, 16 voices, {n60} blocks',
                      lambda: add.render(n_blocks=n60), {}, total)
    err = float(np.abs(got[:43 * F].cpu().numpy() - want).max())
    print(f'[checks] additive, 16 voices, first 43 of {n60} blocks: vs '
          f'oracle max abs {err!r} (must be 0.0)')
    assert err == 0.0, err
    del got
    timed(f'additive, 16 voices, {n60} blocks',
          lambda: add.render(n_blocks=n60))
    static = poly(build_static_poly_voice, poly_freqs(V))
    assert static.compiled.mega_mix(n60) is not None
    want = poly_oracle(build_static_poly_voice, poly_freqs(V),
                       ORACLE_BLOCKS)
    mix, _ = launched(f'poly64_static_mix, {n60} blocks, mix plan',
                      lambda: static.render(n_blocks=n60),
                      {'segments_gen': 1}, total)
    within(f'poly64_static_mix, {n60} blocks, first {ORACLE_BLOCKS}',
           mix[:ORACLE_BLOCKS * F].cpu().numpy(), want, V * TOL)
    del mix
    timed(f'poly64_static_mix, {n60} blocks, mix plan',
          lambda: static.render(n_blocks=n60))
    torch.cuda.synchronize()
    return {'segments_gen': (total['segments_gen'], 'master_bus (whole, 13 '
                             '+ 19), poly64_static_mix'),
            'segments': (total['segments'], 'poly64_noise_mix, 64 lanes on '
                         'one noise channel'),
            'fdn': (total['fdn'], 'master_bus (whole, 13 + 19)')}


# --- phase 7: differentiable fitting ------------------------------------------

C8_BLOCKS = 43            # bench.py:449-546: 1 s at F = 1024
C8_C = 1024               # c8's LowPass context (the node's default)
C9_SECONDS = 12.0
C9_C = 1024               # c9's LowPass context (the node's default)
FIT_BLOCKS = 64           # the flagship fit (PolyPatch.fit, mix plan)
FIT_CHECK_BLOCKS = 16     # its gradient against the plain kernels
VJP_KERNELS = {'segments_gen_vjp': ('seg_cascade_vjp',),
               'segments_vjp': ('seg_cascade_vjp',),
               'rows_vjp': ('rows_cascade_vjp',)}
# The backward kernels' device ms at the timed shapes at commit bef113c
# (one thread per (segment or window, lane) walking its rows forward into a
# scratch buffer and back), printed beside this run's: PERF.md section 6
# (phase 7 and an A/B in one process) on an H100 80GB HBM3 at 700 W
# (the streaming fit's: 2.113-2.122 in the fit's profile, 1.916 alone)
VJP_BEFORE_MS = {'flagship fit': '3.308-3.380', 'c8': '1.094-1.107',
                 'c9': '2.031-2.115', 'render-ahead': '0.2735-0.2798',
                 'step': '0.2636', 'carried state': '0.2353',
                 'streaming fit': '1.916-2.122', 'echo segment': '1.847',
                 'past shared memory': '285.2'}
# B3's shapes (b3_calls' arguments): the static voice's render-ahead batch
# (8 windows of one timeline read in place), its step's timeline and its
# carried state, the streaming fit's window (one stream over 8 blocks), the
# echo's segment, and a window whose checkpoints outgrow shared memory
B3_SHAPES = {
    'render-ahead': ('batch', 1, AHEAD, STATIC_CH, STATIC_C + F, F, False,
                     (1000.0, 3000.0), 'unfold'),
    'step': ('timeline', 1, 1, STATIC_CH, STATIC_C + F, STATIC_C + F, False),
    'carried state': ('stream', 1, 1, STATIC_CH, F, F, True),
    'streaming fit': ('stream', 1, 1, STATIC_CH, AHEAD * F, AHEAD * F, True),
    'echo segment': ('stream', 1, 1, 1, ECHO_BLOCKS * F, ECHO_BLOCKS * F,
                     True),
    'past shared memory': ('stream', 2, 1, 1, 1 << 20, 1 << 20, True),
}
# The edges of B1 / B2's time-sliced adjoint scan (tests/test_torch_vjp.py
# GEN_VJP_CASES, SEG_VJP_CASES): oscillator (None: B2 on a noise timeline),
# lanes, blocks, F, C, m, sum group, sections, LowPass cutoffs (None: a
# band-pass), one input channel under every lane
VJP_EDGES = {
    'C 300 (mid-chunk block starts), 5 lanes, sum of 5':
        ('saw', 5, 8, 256, 300, 4, 5, 1, (500.0, 5000.0), False),
    'two sections, C 300, 48 lanes, sum of 48':
        ('saw', 48, 8, 256, 300, 4, 48, 2, None, False),
    'F 24, m 8 (chunks across block starts)':
        ('saw', 64, 16, 24, 40, 8, 0, 1, (500.0, 5000.0), False),
    '30 Hz poles, sum of 64':
        ('saw', 64, 16, 256, 128, 8, 64, 1, (30.0, 30.0), False),
    '15-18 kHz poles, sine':
        ('sine', 64, 16, 256, 128, 8, 0, 1, (15000.0, 18000.0), False),
    '1024 blocks, sum of 64 (fewer lanes a block to fit shared memory)':
        ('saw', 64, 1024, F, C, M, 64, 1, (600.0, 5000.0), False),
    'C 96, one channel':
        (None, 64, 8, 256, 96, 1, 0, 1, (500.0, 5000.0), True),
    'C 300, 5 lanes, m 4':
        (None, 5, 8, 256, 300, 4, 0, 1, (500.0, 5000.0), False),
    'F 24, m 8, two sections':
        (None, 48, 16, 24, 40, 8, 0, 2, None, False),
    '30 Hz poles, m 8':
        (None, 64, 8, 256, 512, 8, 0, 1, (30.0, 30.0), False),
}


def port_sig(node, *ports):
    """The node reached from ``node`` through the named input ports."""
    for p in ports:
        node = node._ports[p].sig
    return node


def build_c8(cutoff):
    """bench.py:449-546 (c8): 64 Sawtooth voices at the detuned table ->
    LowPass with a ``Fixed`` cutoff -> Gain 1/64; returns ``(root,
    cutoff node)``."""
    from signals_tpu_torch.nodes.fx import Gain, LowPass
    from signals_tpu_torch.nodes.osc import Sawtooth
    saw = Sawtooth()
    saw.hertz = fixed(poly_freqs(V).reshape(1, V))
    cut = fixed(cutoff)
    lp = LowPass()
    lp.input = saw
    lp.cutoff = cut
    g = Gain()
    g.left = lp
    g.right = fixed(1.0 / V)
    return g, cut


def build_c9(hzv, cutv, volv):
    """bench.py:549-651 (c9): per voice two sine partials (F0, 3 F0) ->
    Mix 0.7 -> LowPass -> Gain, with ``(1, 64)`` hertz, cutoff and gain
    ``Fixed`` rows; returns ``(root, hz, cut, vol)``."""
    from signals_tpu_torch.nodes.fx import Gain, LowPass, Mix
    from signals_tpu_torch.nodes.osc import Sine
    hz = fixed(np.asarray(hzv, np.float32).reshape(1, -1))
    o1 = Sine()
    o1.hertz = hz
    h3 = Gain()
    h3.left = hz
    h3.right = fixed(3.0)
    o2 = Sine()
    o2.hertz = h3
    mx = Mix()
    mx.left = o1
    mx.right = o2
    mx.mix = fixed(0.7)
    cut = fixed(np.asarray(cutv, np.float32).reshape(1, -1))
    lp = LowPass()
    lp.input = mx
    lp.cutoff = cut
    vol = fixed(np.asarray(volv, np.float32).reshape(1, -1))
    g = Gain()
    g.left = lp
    g.right = vol
    return g, hz, cut, vol


def c9_targets(n_voices=V):
    """bench.py:613-622: the target and start values of c9 (seed 7)."""
    rng = np.random.default_rng(7)
    tgt_hz = poly_freqs(n_voices)
    tgt_cut = np.linspace(350.0, 1200.0, n_voices).astype(np.float32)
    tgt_vol = rng.uniform(0.3, 0.9, n_voices).astype(np.float32)
    start_hz = (tgt_hz * (1.0 + rng.uniform(-0.02, 0.02, n_voices))
                ).astype(np.float32)
    return (tgt_hz, tgt_cut, tgt_vol), (
        start_hz, np.full(n_voices, 800.0, np.float32),
        np.full(n_voices, 0.5, np.float32))


def c9_blocks():
    return int(round(C9_SECONDS * RATE / F))


def rel_max(got, want):
    """max |got - want| over max |want|."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def memory_over_inputs(call) -> int:
    """Bytes a call allocates at its peak over what was held before it."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    call()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - held


def vjp_case(name, call, plain, *, bits=True, ref='the plain adjoint'):
    """A backward kernel's call against ``plain`` (its plain adjoint, or
    the reference named by ``ref``) on the card: every output within TOL of
    its largest |value|, and two calls the same bits.  Returns the largest
    error and the reference call's ms."""
    import torch
    got = call()
    again = call() if bits else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None, (name, i)
            continue
        assert a.shape == b.shape and torch.isfinite(a).all(), (name, i)
        err = max(err, rel_max(a, b))
        if bits:
            assert torch.equal(a, again[i]), (name, i, 'bits differ')
    print(f'[fit] {name}: vs {ref} max abs / max {err!r} (tol {TOL})'
          f'{", the same bits twice" if bits else ""}; {ref} '
          f'{plain_ms:.1f} ms')
    assert err <= TOL, (name, err)
    return err, plain_ms


def vjp_time(name, call, kernels, flops, nbytes, card, before):
    """Device ms of a backward kernel at one shape, beside its bound and
    its device ms at commit bef113c (``VJP_BEFORE_MS``)."""
    dms = device_ms(call, 3, kernels)
    b_ms, b_by = bound(flops, nbytes)
    dtxt = 'not measured' if dms is None else f'{dms:.4f} ms'
    share = 'not measured' if dms is None else f'{b_ms / dms:.4f}'
    print(f'[fit] {name}: device {dtxt} (profiler), bound {b_ms:.5f} ms '
          f'({b_by}: {flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.2f} MB), '
          f'share {share}; bef113c: {VJP_BEFORE_MS[before]} ms  [{card}]')
    return dms, b_ms, b_by


def vjp_edges(rng, dev):
    """B1 / B2 against their plain adjoints at ``VJP_EDGES``: each output
    within TOL of its largest |value|, the same bits twice.  Returns the
    largest error of each kernel."""
    import torch
    from signals_tpu_torch.compiler import kernels as K
    from signals_tpu_torch.compiler.filters import design_coupled
    from signals_tpu_torch.core.xp import TorchXP
    errs = {'segments_gen_vjp': 0.0, 'segments_vjp': 0.0}
    nyq = np.float32(RATE / 2)
    for name, (osc, lanes, nb, f, ctx, m, g, nsec, cuts,
               one_ch) in VJP_EDGES.items():
        def uniform(lo, hi):
            return torch.as_tensor(rng.uniform(lo, hi, (1, nb * lanes))
                                   .astype(np.float32), device=dev)
        co = (design_coupled(TorchXP(dev), 'lp', (uniform(*cuts),), nyq)
              if cuts else design_coupled(TorchXP(dev), 'bp', (
                  uniform(200.0, 800.0), uniform(2000.0, 6000.0)), nyq))
        co = co.reshape(nsec, nb, lanes, 11).permute(1, 0, 2, 3).contiguous()
        gy = torch.as_tensor(rng.standard_normal(
            (nb, f, lanes // g if g else lanes)).astype(np.float32),
            device=dev)
        kw = dict(n_segments=nb, seg_frames=f, context=ctx, sum_groups=g,
                  blocks_per_seg=m)
        if osc is None:
            x = torch.as_tensor(rng.standard_normal(
                (ctx + nb * f, 1 if one_ch else lanes)).astype(np.float32),
                device=dev)
            co, x = K._timeline(co, x, nb, f, ctx)
            kernel = 'segments_vjp'
            call = lambda: K.sosfilt_segments_vjp(        # noqa: E731
                co, x, gy, **kw)
            plain = lambda: K.sosfilt_segments_vjp_plain(  # noqa: E731
                co, x, gy, **kw)
        else:
            toff = torch.full((lanes,), -ctx, dtype=torch.int32, device=dev)
            lanef = torch.as_tensor(np.stack([
                rng.uniform(100.0, 1000.0, lanes),
                rng.uniform(0.0, 0.5, lanes),
                np.ones(lanes)]).astype(np.float32), device=dev)
            kw.update(osc_code={'saw': K.OSC_SAW, 'sine': K.OSC_SINE}[osc],
                      rate=RATE)
            kernel = 'segments_gen_vjp'
            call = lambda: K.sosfilt_segments_gen_vjp(    # noqa: E731
                co, toff, lanef, gy, **kw)
            plain = lambda: K.sosfilt_segments_gen_vjp_plain(  # noqa: E731
                co, toff, lanef, gy, **kw)
        err, _ = vjp_case(f'{"B1" if osc else "B2"} edge: {name}', call,
                          plain)
        errs[kernel] = max(errs[kernel], err)
    return errs


def b1_work(n_blocks, m, ctx, gy_width):
    """``(flops, bytes)`` of a B1 call at one section over V lanes from
    frame 0 with no source cotangent: the forward rows again and their
    adjoint, the saw synthesised once at phase 0 (the lanes of
    :func:`segment_cases`; :func:`roofline.synth_rows`), the coefficients,
    the output cotangent and the lanes' oscillator parameters read once,
    the coefficients' gradient written once."""
    n_seg = n_blocks // m
    flops = (n_seg * V * (ctx + m * F) * VJP_FLOP
             + roofline.synth_rows(n_seg, ctx + m * F, ctx, 0, V)
             * roofline.SAW_PH0_FLOP)
    co = n_blocks * V * 11 * 4
    return flops, 2 * co + n_blocks * F * gy_width * 4 + 16 * V


def vjp_kernels(card):
    """(a) Each backward kernel against its plain adjoint on the card, and
    its device time at the fits' shapes beside its bound.  Returns per
    kernel ``{err, ms, plain_ms, device_ms, bound_ms, bound_by}``."""
    import torch
    from benchmark.metrics import B2_roofline
    from signals_tpu_torch.compiler import kernels as K
    from signals_tpu_torch.compiler.filters import design_coupled
    from signals_tpu_torch.core.xp import TorchXP
    dev = torch.device('cuda')
    rng = np.random.default_rng(7)
    out = {}

    def randn(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=dev)

    def lowpass(cuts):
        c = torch.as_tensor(np.asarray(cuts, np.float32).reshape(1, -1),
                            device=dev)
        return design_coupled(TorchXP(dev), 'lp', (c,), np.float32(RATE / 2))

    # B1 at the flagship's shape: 32 blocks, 4 carry segments, sum and lanes
    co, toff, lanef, gen, _cases = segment_cases(rng, 32)
    errs = []
    for g in (V, 0):
        gy = randn(32, F, V // g if g else V)
        kw = dict(gen, sum_groups=g)
        err, pms = vjp_case(
            f'B1 segments_gen_vjp, flagship shape, 32 blocks, '
            f'{"sum of 64" if g else "per lane"}',
            lambda: K.sosfilt_segments_gen_vjp(co, toff, lanef, gy, **kw),
            lambda: K.sosfilt_segments_gen_vjp_plain(co, toff, lanef, gy,
                                                     **kw))
        errs.append(err)
    # ... and at the flagship fit's shape, where it is timed (64 blocks, sum
    # of 64, the source cotangent not needed: the cutoff's centre is
    # trained), then at c8's
    co, toff, lanef, gen, _cases = segment_cases(rng, FIT_BLOCKS)
    gy = randn(FIT_BLOCKS, F, 1)
    kw = dict(gen, sum_groups=V, source_grad=False)
    call = lambda: K.sosfilt_segments_gen_vjp(         # noqa: E731
        co, toff, lanef, gy, **kw)
    err, plain_ms = vjp_case(
        f'B1 segments_gen_vjp, flagship fit shape, {FIT_BLOCKS} blocks, sum '
        f'of {V}, no source cotangent', call,
        lambda: K.sosfilt_segments_gen_vjp_plain(co, toff, lanef, gy, **kw))
    errs.append(err)
    fl, nb_ = b1_work(FIT_BLOCKS, M, C, 1)
    dms, b_ms, b_by = vjp_time(
        f'B1 at the flagship fit ({FIT_BLOCKS} blocks, m {M}, C {C}, sum of '
        f'{V})', call, VJP_KERNELS['segments_gen_vjp'], fl, nb_, card,
        'flagship fit')
    ms = cuda_ms(call, 5)
    out['segments_gen_vjp'] = dict(err=max(errs), ms=ms, plain_ms=plain_ms,
                                   device_ms=dms, bound_ms=b_ms,
                                   bound_by=b_by)
    c8co = lowpass(np.full(V, 800.0))[None].expand(C8_BLOCKS, 1, V, 11)
    c8co = c8co.contiguous()
    c8toff = torch.full((V,), -C8_C, dtype=torch.int32, device=dev)
    c8gy = randn(C8_BLOCKS, F, V)
    c8kw = dict(n_segments=C8_BLOCKS, seg_frames=F, context=C8_C,
                osc_code=K.OSC_SAW, rate=RATE, blocks_per_seg=1)
    err, _ = vjp_case(
        f'B1 segments_gen_vjp, c8 shape ({C8_BLOCKS} blocks, C {C8_C}, per '
        f'lane, no source cotangent)',
        lambda: K.sosfilt_segments_gen_vjp(c8co, c8toff, lanef, c8gy,
                                           **c8kw, source_grad=False),
        lambda: K.sosfilt_segments_gen_vjp_plain(c8co, c8toff, lanef, c8gy,
                                                 **c8kw, source_grad=False))
    errs.append(err)
    out['segments_gen_vjp']['err'] = max(errs)
    fl, nb_ = b1_work(C8_BLOCKS, 1, C8_C, V)
    vjp_time(f'B1 at c8 ({C8_BLOCKS} blocks, m 1, C {C8_C}, per lane)',
             lambda: K.sosfilt_segments_gen_vjp(
                 c8co, c8toff, lanef, c8gy, **c8kw, source_grad=False),
             VJP_KERNELS['segments_gen_vjp'], fl, nb_, card, 'c8')
    del co, gy, c8co, c8gy
    torch.cuda.empty_cache()

    # B2 at c9's shape: per lane, static cutoffs, the context of 1024
    nb = c9_blocks()
    co = lowpass(np.linspace(350.0, 1200.0, V))[None].expand(nb, 1, V, 11)
    co = co.contiguous()
    x = randn(C9_C + nb * F, V)
    gy = randn(nb, F, V)
    kw = dict(n_segments=nb, seg_frames=F, context=C9_C)
    err_c9, plain_c9 = vjp_case(
        f'B2 segments_vjp, c9 shape ({nb} blocks, C {C9_C}, per lane)',
        lambda: K.sosfilt_segments_vjp(co, x, gy, **kw),
        lambda: K.sosfilt_segments_vjp_plain(co, x, gy, **kw))
    call = lambda: K.sosfilt_segments_vjp(co, x, gy, **kw)   # noqa: E731
    fl, nb_ = B2_roofline.work(dict(block_frames=F, context=C9_C, blocks=nb,
                                    voices=V, nsec=1))
    dms, b_ms, b_by = vjp_time(f'B2 at c9 ({nb} blocks)', call,
                               VJP_KERNELS['segments_vjp'], fl, nb_, card,
                               'c9')
    ms = cuda_ms(call, 3)
    held = torch.cuda.memory_allocated()
    over = memory_over_inputs(call)
    print(f'[fit] B2 at c9: peak memory {(held + over) / 2**20:.1f} MiB, '
          f'{over / 2**20:.1f} MiB over the {held / 2**20:.1f} MiB '
          f'held before the call (its inputs)  [{card}]')
    del co, x, gy
    torch.cuda.empty_cache()
    # ... and at the noise voice's shape: one channel under 64 lanes
    nbn = 32
    co = lowpass(NOISE_CUTS)[None].expand(nbn // M, 1, V, 11).contiguous()
    xn = randn(NOISE_C + nbn * F, 1).expand(NOISE_C + nbn * F, V)
    gy = randn(nbn // M, M * F, 1)
    kw = dict(n_segments=nbn // M, seg_frames=M * F, context=NOISE_C,
              sum_groups=V)
    err_n, _ = vjp_case(
        f'B2 segments_vjp, noise shape ({nbn} blocks, one channel under '
        f'{V} lanes, sum of {V})',
        lambda: K.sosfilt_segments_vjp(co, xn, gy, **kw),
        lambda: K.sosfilt_segments_vjp_plain(co, xn, gy, **kw))
    assert K.sosfilt_segments_vjp(co, xn, gy, **kw)[1].shape == xn.shape
    out['segments_vjp'] = dict(err=max(err_c9, err_n), ms=ms,
                               plain_ms=plain_c9, device_ms=dms,
                               bound_ms=b_ms, bound_by=b_by)
    del co, xn, gy
    torch.cuda.empty_cache()
    # ... and both at the edges of their time-sliced scan
    for name, err in vjp_edges(rng, dev).items():
        out[name]['err'] = max(out[name]['err'], err)
    torch.cuda.empty_cache()

    # B3 at B3_SHAPES: each held to its reference and timed beside its
    # bound and the serial walk of commit bef113c; the render-ahead shape
    # gives the kernels line's numbers
    errs, b3 = [], {}
    for name, shape in B3_SHAPES.items():
        entry, nsec, nw, ch, L, tail = shape[:6]
        call, ref, fl, nb_ = b3_calls(rng, dev, *shape)
        err, pms = vjp_case(
            f'B3 {entry}_vjp, {name} shape ({L} rows, {nw} x {ch} lanes, '
            f'{nsec} section{"s" if nsec > 1 else ""}, tail {tail})', call,
            ref, ref=('the float64 reference' if L > B3_PLAIN_ROWS
                      else 'the plain adjoint'))
        dms, b_ms, b_by = vjp_time(f'B3 at the {name} shape', call,
                                   VJP_KERNELS['rows_vjp'], fl, nb_, card,
                                   name)
        print(f'[fit] B3 at the {name} shape: '
              f'{memory_over_inputs(call) / 2**20:.2f} MiB over its inputs '
              f'(outputs and checkpoint buffer)')
        errs.append(err)
        b3[name] = (call, pms, dms, b_ms, b_by)
    call, plain_b3, dms, b_ms, b_by = b3['render-ahead']
    out['rows_vjp'] = dict(err=max(errs), ms=cuda_ms(call, 20),
                           plain_ms=plain_b3, device_ms=dms, bound_ms=b_ms,
                           bound_by=b_by)
    return out


def fit_steps(name, run, n, expect, total, card, audio_s):
    """``run(n)`` (n optimizer steps) after a one-step warmup, with the
    launch counts reset just before it and checked just after; then one
    step under the profiler for its device time.  Prints steps/s, ms a
    step, device ms a step and the busy share; returns ``run(n)``'s
    result."""
    import torch

    def step():
        run(1)
        torch.cuda.synchronize()

    step()
    t0 = time.perf_counter()
    res = launched(f'{name}, {n} steps', lambda: run(n),
                   {k: n * v for k, v in expect.items()}, total)
    wall = (time.perf_counter() - t0) * 1e3 / n
    _, events = trace.profile(step)
    by_name = collections.Counter()
    for kernel, _, us in events:
        by_name[kernel[:60]] += us
    dev_ms = sum(by_name.values()) / 1e3
    print(f'[fit] {name}: {n} steps at {1e3 / wall:.2f} steps/s, '
          f'{wall:.3f} ms a step ({audio_s / (wall / 1e3):.2f} s of audio '
          f'differentiated per s); one step: device {dev_ms:.3f} ms in '
          f'{len(events)} kernels and copies, busy share {dev_ms / wall:.3f}  '
          f'[{card}]')
    top = ', '.join(f'{k} {v / 1e3:.3f}' for k, v in by_name.most_common(4))
    print(f'[fit] {name}: device ms by kernel, largest: {top}')
    return res


def c9_memory_split(root, trainables, tgt, nb, card):
    """Which part of a c9 step sets its peak memory: the render's forward
    with the graph autograd keeps (the float64 sine chains), the loss's
    STFT frames, or the backward — each one's peak over what was held
    before it, and what it leaves held."""
    import torch
    from signals_tpu_torch import learn
    from signals_tpu_torch.compiler import compile_node
    patch = compile_node(root, block_frames=F, rate=RATE, channels=V,
                         device='cuda')
    core = patch.render_core(nb)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_allocated()
    parts = []

    def stage(name, fn):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        parts.append((name, torch.cuda.max_memory_allocated() - before,
                      torch.cuda.memory_allocated() - m0))
        return out

    with torch.no_grad():
        stage('render, no grad', lambda: core(patch.params(), {}, 0))
    params = patch.params()
    for node in trainables:
        params[patch.index.info(node).uid]['value'].requires_grad_()
    blocks = stage('render with the graph for the backward',
                   lambda: core(params, {}, 0)[0])
    loss = stage('per_channel_spectral_loss (STFT frames)',
                 lambda: learn.per_channel_spectral_loss(
                     blocks.reshape(nb * F, V), tgt))
    del blocks
    stage('backward', loss.backward)
    for name, peak, held in parts:
        print(f'[fit] c9 memory, {name}: peak {peak / 2**30:.3f} GiB over '
              f'what it started with, {held / 2**30:.3f} GiB held after  '
              f'[{card}]')
    del loss, params
    torch.cuda.empty_cache()


def phase_fit():
    """Differentiable fitting through the port's entry points (``learn``,
    ``PolyPatch.fit``).  Returns ``(per backward kernel {err, ms, ...},
    per kernel (launches, what launched it))``."""
    import torch
    from signals_tpu_torch import learn
    from signals_tpu_torch.compiler import compile_node
    t_phase = time.perf_counter()
    card = card_line()
    total = collections.Counter()
    kern = vjp_kernels(card)

    # (b) c8: one loss-and-gradient call against the plain kernels, then
    # 16 Adam steps
    t_root, _ = build_c8(2500.0)
    tgt = compile_node(t_root, block_frames=F, rate=RATE, channels=V,
                       device='cuda').render(n_blocks=C8_BLOCKS)[0]
    root, cut = build_c8(800.0)
    c8 = compile_node(root, block_frames=F, rate=RATE, channels=V,
                      device='cuda')
    assert c8.plan(C8_BLOCKS) == 'mega'
    loss_fn = learn.make_loss_fn(c8, tgt)
    uid = c8.index.info(cut).uid

    def value_and_grad(patch, lfn, uid):
        params = patch.params()
        leaf = params[uid]['value'].requires_grad_()
        value = lfn(params)
        return value, torch.autograd.grad(value, leaf)[0]

    v, g = launched('c8, loss and cutoff gradient',
                    lambda: value_and_grad(c8, loss_fn, uid),
                    {'segments_gen': 1, 'segments_gen_vjp': 1}, total)
    with plain_kernels():
        v_p, g_p = value_and_grad(c8, loss_fn, uid)
    rel = rel_max(g, g_p)
    print(f'[fit] c8: loss {v.item()!r} (plain {v_p.item()!r}), cutoff '
          f'gradient {g.item()!r} vs the plain kernels {g_p.item()!r}: '
          f'relative {rel!r} (tol 1e-4)')
    assert torch.isfinite(g).all() and rel <= 1e-4, rel
    fit_steps(f'c8 ({V} voices, {C8_BLOCKS} blocks), learn.fit',
              lambda n: learn.fit(root, tgt, [(cut, 'value')], rate=RATE,
                                  block_frames=F, steps=n,
                                  learning_rate=2.0, apply=False),
              16, {'segments_gen': 1, 'segments_gen_vjp': 1}, total, card,
              C8_BLOCKS * F / RATE)

    # (c) c9: 20 steps of learn.fit at 64 voices x 12 s
    (t_hz, t_cut, t_vol), (s_hz, s_cut, s_vol) = c9_targets()
    nb = c9_blocks()
    t_root, *_ = build_c9(t_hz, t_cut, t_vol)
    tgt = compile_node(t_root, block_frames=F, rate=RATE, channels=V,
                       device='cuda').render(n_blocks=nb)[0]
    root, hz, cut, vol = build_c9(s_hz, s_cut, s_vol)
    assert compile_node(root, block_frames=F, rate=RATE, channels=V,
                        device='cuda').plan(nb) == 'mega'
    torch.cuda.reset_peak_memory_stats()
    res = fit_steps(
        f'c9 ({V} voices x {nb} blocks, 192 trainables), learn.fit',
        lambda n: learn.fit(root, tgt, [(hz, 'value'), (cut, 'value'),
                                        (vol, 'value')],
                            rate=RATE, block_frames=F, steps=n,
                            learning_rate=0.005, relative_lr=True,
                            loss=learn.per_channel_spectral_loss,
                            apply=False),
        20, {'segments': 1, 'segments_vjp': 1}, total, card,
        nb * F / RATE)
    peak = torch.cuda.max_memory_allocated()
    print(f'[fit] c9: loss {res.losses[0]!r} -> {res.losses[-1]!r} over 20 '
          f'steps; peak memory {peak / 2**30:.3f} GiB  [{card}]')
    assert np.isfinite(res.losses).all() and res.losses[-1] < res.losses[0]
    c9_memory_split(root, (hz, cut, vol), tgt, nb, card)
    del tgt
    torch.cuda.empty_cache()

    # (d) PolyPatch.fit of the flagship's cutoff centre, mix plan
    t_poly = make_poly()
    port_sig(t_poly.compiled.root, 'left', 'left', 'cutoff',
             'right').get_state().value = np.full((1, 1), 2500.0, np.float32)
    tgt = t_poly.render(n_blocks=FIT_BLOCKS)[0]
    poly = make_poly()
    centre = port_sig(poly.compiled.root, 'left', 'left', 'cutoff', 'right')
    assert float(centre.get_state().value[0, 0]) == 2000.0
    assert poly.compiled.mega_mix(FIT_BLOCKS) is not None
    uid = poly.compiled.index.info(centre).uid
    render = poly.render_fn(FIT_CHECK_BLOCKS)
    short = tgt[:FIT_CHECK_BLOCKS * F]

    def poly_grad():
        params, _ = poly.params()
        leaf = params[uid]['value'].requires_grad_()
        mix, _ = render(params, {}, 0)
        value = learn.spectral_loss(mix.reshape(-1, 1), short)
        return torch.autograd.grad(value, leaf)[0]

    g = launched(f'flagship, cutoff-centre gradient, {FIT_CHECK_BLOCKS} '
                 f'blocks, mix plan', poly_grad,
                 {'segments_gen': 1, 'segments_gen_vjp': 1}, total)
    with plain_kernels():
        g_p = poly_grad()
    rel = rel_max(g, g_p)
    print(f'[fit] flagship: cutoff-centre gradient {g.item()!r} vs the plain '
          f'kernels {g_p.item()!r}: relative {rel!r} (tol 1e-4)')
    assert torch.isfinite(g).all() and rel <= 1e-4, rel
    res = fit_steps(f'flagship ({V} voices, {FIT_BLOCKS} blocks), '
                    f'PolyPatch.fit, mix plan',
                    lambda n: poly.fit(tgt, [(centre, 'value')], steps=n,
                                       learning_rate=20.0, apply=False),
                    10, {'segments_gen': 1, 'segments_gen_vjp': 1}, total,
                    card, FIT_BLOCKS * F / RATE)
    print(f'[fit] flagship: loss {res.losses[0]!r} -> {res.losses[-1]!r} '
          f'over 10 steps')
    assert np.isfinite(res.losses).all()

    # (e) the zero-state and carried-state entries' backward: the static
    # voice's cutoff (16 channels, context 128: the batched replay) and
    # the same voice streaming (one carried-state launch a window)
    for streaming, kernel in ((False, 'batch'), (True, 'stream')):
        t_root = build_static_voice(streaming=streaming)
        port_sig(t_root, 'left', 'left', 'cutoff').get_state().value = \
            np.full((1, 1), 1500.0, np.float32)
        tgt = compile_node(t_root, block_frames=F, rate=RATE,
                           channels=STATIC_CH, device='cuda').render(
            n_blocks=AHEAD)[0]
        root = build_static_voice(streaming=streaming)
        cutn = port_sig(root, 'left', 'left', 'cutoff')
        fit_steps(f'static voice{" (streaming)" if streaming else ""}, '
                  f'{STATIC_CH} channels, {AHEAD} blocks, learn.fit',
                  lambda n: learn.fit(root, tgt, [(cutn, 'value')],
                                      rate=RATE, block_frames=F, steps=n,
                                      learning_rate=20.0, apply=False),
                  4, {kernel: 1, f'{kernel}_vjp': 1}, total, card,
                  AHEAD * F / RATE)
    torch.cuda.synchronize()
    print(f'[fit] phase 7: {time.perf_counter() - t_phase:.1f} s')
    launches = {
        'segments_gen': (total['segments_gen'], 'c8 fit, flagship '
                         'PolyPatch.fit'),
        'segments': (total['segments'], 'c9 fit'),
        'batch': (total['batch'], 'static-voice fit'),
        'stream': (total['stream'], 'streaming static-voice fit'),
        'segments_gen_vjp': (total['segments_gen_vjp'], 'c8 fit, flagship '
                             'PolyPatch.fit'),
        'segments_vjp': (total['segments_vjp'], 'c9 fit'),
        'rows_vjp': (total['batch_vjp'] + total['timeline_vjp']
                     + total['stream_vjp'], 'static-voice fits: batched '
                     'and carried-state entries')}
    return kern, launches


# --- phase 8: host inputs and the EQ family -----------------------------------

TRACK_SEED = 8
#: the bounce's EQ chain: (node, freq Hz, q or None: the default, gain dB)
EQ_CHAIN = (('LowShelf', 120.0, None, 3.0), ('Peak', 1000.0, 1.4, -4.0),
            ('Notch', 60.0, 4.0, None), ('HighShelf', 8000.0, None, 2.0))
#: K4 launches a block of the bounce: each EQ is replayed over its own
#: window and over the context windows of the EQs after it (context 1024 =
#: one block): 4 + 3 + 2 + 1
BOUNCE_TIMELINE = 10
SRC_RATE = 48000     # the resampled file of (c)


def work_dir():
    """``build/chip_smoke/`` beside this script (git-ignored): phase 8's
    sound files."""
    import pathlib
    d = pathlib.Path(__file__).resolve().parent / 'build' / 'chip_smoke'
    d.mkdir(parents=True, exist_ok=True)
    return d


def seeded_track(n_frames, channels, seed, rate):
    """A test track made from ``seed``: a 55 Hz and a 1 kHz sine, their
    pitch differing per channel, under white noise, peak below 0.9."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames, dtype=np.float64)[:, None] / rate
    ch = 1.0 + 0.01 * np.arange(channels)
    x = (0.35 * np.sin(2 * np.pi * 55.0 * ch * t)
         + 0.25 * np.sin(2 * np.pi * 1000.0 * ch * t)
         + 0.08 * rng.standard_normal((n_frames, channels)))
    return x.astype(np.float32)


def write_track(path, data, rate, subtype):
    from signals_tpu_torch.runtime import sndfile
    w = sndfile.open_writer(path, rate=rate, channels=data.shape[1],
                            subtype=subtype)
    w.write(data)
    w.close()


def build_bounce(src, out=None):
    """The offline bounce: ``FileReader(src)`` -> LowShelf 120 Hz +3 dB ->
    Peak 1 kHz -4 dB Q 1.4 -> Notch 60 Hz Q 4 -> HighShelf 8 kHz +2 dB (the
    nodes' default context, 1024 frames) -> with ``out`` a pcm16
    ``FileWriter``."""
    from signals_tpu_torch.nodes import fx
    from signals_tpu_torch.nodes.files import FileReader, FileWriter
    node = FileReader()
    node.get_state().path = str(src)
    for kind, freq, q, gain in EQ_CHAIN:
        eq = getattr(fx, kind)()
        eq.input = node
        eq.freq = fixed(freq)
        if q is not None:
            eq.q = fixed(q)
        if gain is not None:
            eq.gain = fixed(gain)
        node = eq
    if out is None:
        return node
    wr = FileWriter()
    wr.get_state().path = str(out)
    wr.get_state().subtype = 'pcm16'
    wr.input = node
    return wr


def build_swept_chain(src, out=None):
    """Fault C1 and resampling: ``FileReader(src)`` at 48 kHz with
    ``conform_rate`` -> a streaming LowPass 3 kHz -> a LowPass swept by the
    flagship's 0.5 Hz LFO (1000 ± 450 Hz, context 512, 8-block carry
    segments) -> Pan 0.3 -> with ``out`` a float32 ``FileWriter``."""
    from signals_tpu_torch.nodes.files import FileReader, FileWriter
    from signals_tpu_torch.nodes.fx import Gain, LowPass, Mix, Pan
    from signals_tpu_torch.nodes.osc import Sine
    rd = FileReader()
    rd.get_state().path = str(src)
    rd.get_state().conform_rate = True
    exact = LowPass()
    exact.input = rd
    exact.cutoff = fixed(3000.0)
    exact.get_state().streaming = True
    lfo = Sine()
    lfo.hertz = fixed(0.5)
    depth = Gain()
    depth.left = lfo
    depth.right = fixed(900.0)
    cutoff = Mix()
    cutoff.left = depth
    cutoff.right = fixed(2000.0)
    cutoff.mix = fixed(0.5)
    swept = LowPass()
    swept.input = exact
    swept.cutoff = cutoff
    swept.get_state().context = C
    pan = Pan()
    pan.input = swept
    pan.position = fixed(0.3)
    if out is None:
        return pan
    wr = FileWriter()
    wr.get_state().path = str(out)
    wr.input = pan
    return wr


def rbj_kernels(rng, card, results):
    """(e) K1-K4 and the carried-state entry on RBJ coefficients — a 30 Hz
    low shelf (+6 dB, default Q) and a Q 16 peak (+6 dB at 800-1200 Hz),
    each lane and block its own frequency — against their plain versions
    on the card at phase 2's shapes (the segment kernels at the flagship's
    geometry over N_BLOCKS blocks, per lane and summed over V; K3 at the
    render-ahead shape; K4 at the step's and the mono step's; the
    carried-state entry at (1024, 16) from a non-zero state), within phase
    2's budgets, the same bits twice.  Joins each kernel's error into
    ``results``."""
    import torch
    from signals_tpu_torch.compiler import filters as FI
    from signals_tpu_torch.compiler import kernels as K
    from signals_tpu_torch.core.xp import TorchXP
    dev = torch.device('cuda')
    xp = TorchXP(dev)
    nyq = np.float32(RATE / 2)

    def design(btype, n):
        lo, hi, gain, q = ((27.0, 33.0, 6.0, 0.0) if btype == FI.LOWSHELF
                           else (800.0, 1200.0, 6.0, 16.0))
        freq = torch.as_tensor(rng.uniform(lo, hi, (1, n)).astype(
            np.float32), device=dev)
        return FI.design_coupled(xp, btype, (
            freq, torch.full_like(freq, gain), torch.full_like(freq, q)),
            nyq)

    def check(what, name, call, plain, tol_rel=False, state=False):
        got, want = call(), plain()
        again = call()
        if state:
            (y, zf), (wy, wzf), (y2, zf2) = got, want, again
            same = torch.equal(y, y2) and torch.equal(zf, zf2)
            err = max(float((y - wy).abs().max()),
                      float((zf - wzf).abs().max())
                      / max(1.0, float(wzf.abs().max())))
        else:
            same = torch.equal(got, again)
            err = float((got - want).abs().max())
            if tol_rel:
                err /= float(want.abs().max())
            assert torch.isfinite(got).all(), what
        print(f'[files] (e) {name} {what} vs plain: '
              f'{"max abs / max" if tol_rel else "max abs"} {err!r} (tol '
              f'{TOL}); same bits twice: {same}  [{card}]')
        assert err <= TOL and same, (what, name, err, same)
        results[name]['err'] = max(err, results[name]['err'])

    geo = dict(n_segments=N_BLOCKS, seg_frames=F, context=C,
               blocks_per_seg=M)
    toff = torch.full((V,), -C, dtype=torch.int32, device=dev)
    lanef = torch.as_tensor(np.stack([poly_freqs(V), np.zeros(V, np.float32),
                                      np.ones(V, np.float32)]), device=dev)
    gen = dict(geo, osc_code=K.OSC_SAW, rate=RATE)
    x = K.gen_source_rows(toff, lanef, n_segments=1, seg_frames=N_BLOCKS * F,
                          context=C, osc_code=K.OSC_SAW, rate=RATE)[0]
    L = STATIC_C + F
    xt = torch.as_tensor(rng.standard_normal((L + (AHEAD - 1) * F, STATIC_CH))
                         .astype(np.float32), device=dev)
    x3 = xt.unfold(0, L, F).permute(2, 0, 1)
    x4 = xt[:L].contiguous()
    for btype, what in ((FI.LOWSHELF, '30 Hz low shelf'),
                        (FI.PEAK, 'Q 16 peak')):
        co = design(btype, N_BLOCKS * V).reshape(1, N_BLOCKS, V, 11).permute(
            1, 0, 2, 3).contiguous()
        for g in (0, V):
            check(f'{what}, {N_BLOCKS} blocks, sum_groups={g}',
                  'segments_gen',
                  lambda: K.sosfilt_segments_gen(co, toff, lanef, **gen,
                                                 sum_groups=g),
                  lambda: K.sosfilt_segments_gen_plain(co, toff, lanef, **gen,
                                                       sum_groups=g),
                  tol_rel=bool(g))
            check(f'{what}, {N_BLOCKS} blocks, sum_groups={g}', 'segments',
                  lambda: K.sosfilt_segments(co, x, **geo, sum_groups=g),
                  lambda: K.sosfilt_segments_plain(co, x, **geo,
                                                   sum_groups=g),
                  tol_rel=bool(g))
        co3 = design(btype, AHEAD * STATIC_CH).reshape(
            1, AHEAD, STATIC_CH, 11).permute(1, 0, 2, 3).contiguous()
        check(f'{what}, render-ahead (L {L}, {AHEAD} x {STATIC_CH})',
              'batch', lambda: K.sosfilt_batch(co3, x3, tail=F),
              lambda: K.sosfilt_batch_plain(co3, x3, tail=F))
        co4 = co3[0]
        check(f'{what}, step ({L}, {STATIC_CH})', 'timeline',
              lambda: K.sosfilt_timeline(co4, x4),
              lambda: K.sosfilt_timeline_plain(co4, x4))
        co1, x1 = co4[:, :1].contiguous(), x4[:, :1].contiguous()
        check(f'{what}, mono step ({L}, 1)', 'timeline',
              lambda: K.sosfilt_timeline(co1, x1),
              lambda: K.sosfilt_timeline_plain(co1, x1))
        zi = torch.as_tensor(rng.standard_normal((1, 2, STATIC_CH)).astype(
            np.float32), device=dev)
        check(f'{what}, ({F}, {STATIC_CH}) from a non-zero state',
              'stream', lambda: K.sosfilt_stream(co4, x4[:F], zi),
              lambda: K.sosfilt_stream_plain(co4, x4[:F], zi), state=True)
    torch.cuda.synchronize()


def phase_files(results):
    """Host inputs and the EQ family through the port's entry points.
    Returns, per kernel, ``(launches, what launched it)``."""
    import torch
    from signals_tpu_torch.compiler import compile_node
    from signals_tpu_torch.runtime import Transport, sndfile
    from signals_tpu_torch.utils import LatencyStats
    card = card_line()
    total = collections.Counter()
    n60 = n_blocks_60s()
    audio_s = n60 * F / RATE
    t_phase = time.perf_counter()
    d = work_dir()

    def within(name, got, want, tol):
        got = np.asarray(got)
        assert got.shape == want.shape and np.isfinite(got).all(), name
        err = float(np.abs(got - want).max())
        print(f'[files] {name}: vs oracle max abs {err!r} (tol {tol:g}, '
              f'peak {float(np.abs(want).max())!r})')
        assert err <= tol, (name, err)

    def timed(name, fn, n_blocks):
        wall, dev_ms, events = profiled(fn)
        secs = n_blocks * F / RATE
        print(f'[files] {name}: wall {wall:.1f} ms = '
              f'{secs / (wall / 1e3):.2f}x realtime, device {dev_ms:.3f} ms '
              f'in {events} kernels and copies ({events / n_blocks:.1f} a '
              f'block), busy share {dev_ms / wall:.3f}  [{card}]')

    # (a) the 60 s stereo bounce: FileReader -> four EQs -> FileWriter pcm16
    src = d / 'track.wav'
    write_track(src, seeded_track(int(SECONDS * RATE), 2, TRACK_SEED, RATE),
                RATE, 'pcm16')
    out = d / 'bounce.wav'
    bounce = compile_node(build_bounce(src, out), block_frames=F, rate=RATE,
                          channels=2, device='cuda')
    assert bounce.plan(n60) == 'stateless', bounce.plan(n60)
    print(f'[files] bounce: {len(bounce._host_spec)} staged windows '
          f'{[k for *_, k in bounce._host_spec]}, plan stateless')
    t0 = time.perf_counter()
    got = launched(f'bounce, {n60} blocks, one batch', lambda: bounce.render(
        n_blocks=n60)[0].cpu().numpy(), {'timeline': BOUNCE_TIMELINE},
        total)
    first = time.perf_counter() - t0
    reader = sndfile.open_reader(out)              # the writer is still open
    assert (reader.frames, reader.channels, reader.rate) == (n60 * F, 2,
                                                             RATE)
    err = float(np.abs(reader.read(0, n60 * F) - got).max())
    reader.close()
    assert err <= 6e-5, err
    bounce.root._close()
    ref = d / 'reference.wav'
    write_track(ref, got, RATE, 'pcm16')
    same = out.read_bytes() == ref.read_bytes()
    print(f'[files] bounce, {n60} blocks ({audio_s:.3f} s): wall {first:.2f} '
          f's = {audio_s / first:.2f}x realtime, {first / n60 * 1e3:.3f} ms '
          f'a block (host clock; the staging, the copy off the card and the '
          f'file included)  [{card}]')
    print(f'[files] bounce: the file read while open within {err:.2e} of the '
          f'audio; byte for byte the audio under the pcm16 encoder: {same}')
    assert same
    # the render's host staging and its one pinned copy, apart from the wall
    t0 = time.perf_counter()
    staged = bounce.stage_host(0, n60)
    t_stage = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bounce.host_inputs(0, n60)
    torch.cuda.synchronize()
    t_both = time.perf_counter() - t0
    print(f'[files] bounce: host staging of {len(staged)} windows x {n60} '
          f'blocks ({sum(a.nbytes for a in staged.values()) / 1e6:.1f} MB) '
          f'{t_stage:.3f} s; staging and the pinned copy to the card '
          f'{t_both:.3f} s, the copy {t_both - t_stage:.3f} s; of the '
          f'{first:.2f} s wall (host clock)  [{card}]')
    del staged
    # the oracle with the float64 design (exact_design): the one the port's
    # rows are held to; beside it the oracle's float32 b/a coefficients
    t0 = time.perf_counter()
    with exact_design():
        want = pull_oracle(build_bounce(src), ORACLE_BLOCKS, 2)
        want3 = pull_oracle(build_bounce(src), ORACLE_BLOCKS, 2, start=3)
    print(f'[files] bounce oracles, 2 x {ORACLE_BLOCKS} blocks: '
          f'{time.perf_counter() - t0:.1f} s')
    rounded = pull_oracle(build_bounce(src), ORACLE_BLOCKS, 2)
    print(f'[files] bounce, first {ORACLE_BLOCKS} blocks: vs the oracle on '
          f'float32 b/a coefficients max abs '
          f'{float(np.abs(got[:ORACLE_BLOCKS * F] - rounded).max())!r}; that '
          f'oracle vs its float64 design '
          f'{float(np.abs(rounded - want).max())!r}')
    within(f'bounce, {n60} blocks, first {ORACLE_BLOCKS}',
           got[:ORACLE_BLOCKS * F], want, TOL)
    part = launched(f'bounce, {ORACLE_BLOCKS} blocks from block 3',
                    lambda: bounce.render(position=3 * F,
                                          n_blocks=ORACLE_BLOCKS)[0],
                    {'timeline': BOUNCE_TIMELINE}, total)
    within(f'bounce, {ORACLE_BLOCKS} blocks from block 3',
           part.cpu().numpy(), want3, TOL)
    del part
    timed(f'bounce, {N_BLOCKS} blocks (profiled), plan stateless',
          lambda: bounce.render(n_blocks=N_BLOCKS)[0].cpu(), N_BLOCKS)
    # the per-block path over the same blocks: a loop of step, one block
    # each (its own 10 launches a block)
    params = bounce.params()
    host = bounce.host_inputs(0, N_BLOCKS)

    def steps():
        return torch.cat([bounce.step(params, {}, i * F,
                                      bounce._host_slice(host, i))[0]
                          for i in range(N_BLOCKS)])

    stepped = launched(f'bounce, {N_BLOCKS} steps', steps,
                       {'timeline': BOUNCE_TIMELINE * N_BLOCKS}, total)
    diff = float(np.abs(stepped.cpu().numpy() - got[:N_BLOCKS * F]).max())
    print(f'[files] bounce, first {N_BLOCKS} blocks: the stateless batch vs '
          f'{N_BLOCKS} steps max abs {diff!r} (the same bits: '
          f'{diff == 0.0})')
    assert diff <= 1e-6, diff
    del got, stepped
    timed(f'bounce, {N_BLOCKS} steps (profiled), the per-block path',
          lambda: steps().cpu(), N_BLOCKS)
    for name, fn in ((f'{N_BLOCKS} steps', lambda: steps().cpu()),
                     (f'{N_BLOCKS} blocks, plan stateless',
                      lambda: bounce.render(n_blocks=N_BLOCKS,
                                            deliver_taps=False)[0].cpu())):
        wall = wall_ms(fn, reps=2)
        print(f'[files] bounce, {name}: wall {wall:.1f} ms = '
              f'{N_BLOCKS * F / RATE / (wall / 1e3):.2f}x realtime '
              f'(host clock, best of 2, the copy off the card included, no '
              f'file written)  [{card}]')

    # (b) the same patch under the Transport in 8-block batches
    tr = Transport(bounce, consumer=None, blocks_per_call=AHEAD)
    batches = [launched(f'bounce Transport batch at block {i * AHEAD}',
                        lambda: tr.render(AHEAD),
                        {'timeline': BOUNCE_TIMELINE}, total)
               for i in range(ORACLE_BLOCKS // AHEAD)]
    within(f'bounce, {ORACLE_BLOCKS // AHEAD} Transport batches',
           np.concatenate(batches), want, TOL)
    tr.stats = LatencyStats()
    for _ in range(20):
        tr.render(AHEAD)
    print(f'[files] bounce render-ahead, p50 per block of 20 {AHEAD}-block '
          f'batches: {tr.stats.p50 * 1e3:.3f} ms against the '
          f'{F / RATE * 1e3:.1f} ms block ({tr.stats.headroom(F, RATE):.2f}x '
          f'realtime)  [{card}]')
    bounce.root._close()

    # (c) fault C1 and resampling: 48 kHz -> streaming -> swept -> Pan
    src48 = d / 'track48.wav'
    write_track(src48, seeded_track(int(SECONDS * SRC_RATE), 1,
                                    TRACK_SEED + 1, SRC_RATE),
                SRC_RATE, 'float32')
    chain = compile_node(build_swept_chain(src48, d / 'swept.wav'),
                         block_frames=F, rate=RATE, channels=2,
                         device='cuda')
    assert chain.plan(n60) == 'blocks' and chain.carry_seg_align == M
    want = pull_oracle(build_swept_chain(src48), ORACLE_BLOCKS, 2)
    got = launched(f'swept chain, {ORACLE_BLOCKS} blocks', lambda: chain.render(
        n_blocks=ORACLE_BLOCKS)[0], {'stream': ORACLE_BLOCKS,
                                     'segments': ORACLE_BLOCKS}, total)
    within(f'swept chain, {ORACLE_BLOCKS} blocks', got.cpu().numpy(), want,
           TOL)
    # a render that starts off the carry grid continues the carry of blocks
    # 0-2: the swept filter's segment from block 0 is served from the
    # streaming filter's history ring
    _, carry = launched('swept chain, blocks 0-2', lambda: chain.render(
        n_blocks=3), {'stream': 3, 'segments': 3}, total)
    part = launched('swept chain, 16 blocks from block 3 with the carry '
                    '(off the carry grid)',
                    lambda: chain.render(position=3 * F, n_blocks=16,
                                         carry=carry)[0],
                    {'stream': 16, 'segments': 16}, total)
    within('swept chain, 16 blocks from block 3', part.cpu().numpy(),
           want[3 * F:19 * F], TOL)
    t0 = time.perf_counter()
    launched(f'swept chain, {n60} blocks', lambda: chain.render(
        n_blocks=n60)[0].cpu(), {'stream': n60, 'segments': n60}, total)
    wall = time.perf_counter() - t0
    print(f'[files] swept chain, {n60} blocks: wall {wall:.2f} s = '
          f'{audio_s / wall:.2f}x realtime (host clock, the resampling and '
          f'the file included)  [{card}]')
    timed(f'swept chain, {N_BLOCKS} blocks (profiled)',
          lambda: chain.render(n_blocks=N_BLOCKS)[0].cpu(), N_BLOCKS)
    chain.root._close()

    # (d) the flagship with a swept Peak in place of its LowPass, mix plan
    poly = make_poly(peak=True)
    assert poly.compiled.mega_mix(N_BLOCKS) is not None
    mix = launched(f'flagship with a Peak, {N_BLOCKS} blocks, mix plan',
                   lambda: poly.render(n_blocks=N_BLOCKS)[0],
                   {'segments_gen': 1}, total)
    within(f'flagship with a Peak, first {ORACLE_BLOCKS}',
           mix[:ORACLE_BLOCKS * F].cpu().numpy(),
           oracle_mix(ORACLE_BLOCKS, peak=True), V * TOL)
    timed(f'flagship with a Peak, {n60} blocks, mix plan',
          lambda: poly.render(n_blocks=n60)[0], n60)

    # (e) the kernels on RBJ coefficients against their plain versions
    rbj_kernels(np.random.default_rng(TRACK_SEED), card, results)
    print(f'[files] phase 8: {time.perf_counter() - t_phase:.1f} s')
    return {'timeline': (total['timeline'], 'file bounce: 10 a stateless '
                         'batch (whole, from block 3, Transport batches), '
                         '10 a block of its 256 steps'),
            'stream': (total['stream'], 'swept chain after a 48 kHz file'),
            'segments': (total['segments'], 'swept chain after a 48 kHz '
                         'file (fault C1)'),
            'segments_gen': (total['segments_gen'], 'flagship with a Peak')}


# --- phase 9: sequenced polyphony and the modulation effects ------------------

SCORE_SEED = 9
SCORE_MELODY = 300        # one note every 0.2 s, MIDI 60-96
SCORE_CHORDS = 75         # four notes each, roots 36-72
SCORE_RELEASE = 0.25      # examples/midi_poly.py's release
SCORE_LATE = 1200         # the second oracle window's first block
SCORE_FIT_BLOCKS = 64
SCORE_FIT_CHECK = 16
SCORE_CUT = 1800.0        # examples/midi_poly.py's LowPass cutoff
IR_FRAMES = 88200         # 2 s at 44.1 kHz, 60 dB down at the tail
CONV_MIX = 0.35
CONV_GAIN = 0.5


def score_notes(seed=SCORE_SEED):
    """A seeded 600-note score over 60 s, ``(start_s, dur_s, midi,
    velocity)``: a melody of 300 notes, one every 0.2 s (a random walk over
    MIDI 60-96, 0.1-0.19 s long), and 75 four-note chords (a root 36-72
    with its third, fifth and octave) at random starts, 0.1-1.0 s long —
    10 notes a second."""
    rng = np.random.default_rng(seed)
    notes = []
    step = SECONDS / SCORE_MELODY
    pitch = 72
    for i in range(SCORE_MELODY):
        pitch = int(np.clip(pitch + rng.integers(-4, 5), 60, 96))
        notes.append((i * step, float(rng.uniform(0.1, 0.19)), pitch,
                      int(rng.integers(60, 128))))
    for _ in range(SCORE_CHORDS):
        start = float(rng.uniform(0.0, SECONDS - 1.0))
        dur = float(rng.uniform(0.1, 1.0))
        root = int(rng.integers(36, 73))
        third = 3 if rng.integers(2) else 4
        vel = int(rng.integers(40, 100))
        notes.extend((start, dur, root + k, vel) for k in (0, third, 7, 12))
    return notes


def write_score(path, notes):
    """``notes`` as a format-0 SMF at 120 bpm, 480 ticks a quarter (960 a
    second), one track, note-offs before note-ons at the same tick — the
    way ``examples/midi_poly.py``'s ``demo_midi`` writes its file."""
    import struct

    def varlen(v):
        out = [v & 0x7F]
        v >>= 7
        while v:
            out.append(0x80 | (v & 0x7F))
            v >>= 7
        return bytes(reversed(out))

    events = []
    for start, dur, midi, vel in notes:
        on = int(round(start * 960))
        off = max(on + 1, int(round((start + dur) * 960)))
        events.append((on, 1, bytes([0x90, midi, vel])))
        events.append((off, 0, bytes([0x80, midi, 0])))
    events.sort(key=lambda e: (e[0], e[1]))
    body, last = b'', 0
    for tick, _, msg in events:
        body += varlen(tick - last) + msg
        last = tick
    body += varlen(0) + b'\xff\x2f\x00'
    with open(path, 'wb') as f:
        f.write(b'MThd' + struct.pack('>IHHH', 6, 0, 1, 480))
        f.write(b'MTrk' + struct.pack('>I', len(body)) + body)


def build_score_voice():
    """``examples/midi_poly.py``'s voice: a saw at a ``PitchSeq`` pitch ->
    LowPass 1800 Hz (context 1024) -> RingMod with an ADSR gated by a
    ``GateSeq`` -> RingMod with a velocity ``PitchSeq``.  Returns ``(root,
    gate, pitch, velocity, cutoff)``."""
    from signals_tpu_torch.nodes.env import ADSR
    from signals_tpu_torch.nodes.fx import LowPass, RingMod
    from signals_tpu_torch.nodes.osc import Sawtooth
    from signals_tpu_torch.nodes.seq import GateSeq, PitchSeq
    gate, pitch, vel = GateSeq(), PitchSeq(), PitchSeq()
    osc = Sawtooth()
    osc.hertz = pitch
    cut = fixed(SCORE_CUT)
    lp = LowPass()
    lp.input = osc
    lp.cutoff = cut
    env = ADSR()
    st = env.get_state()
    st.attack, st.decay, st.sustain, st.release = 0.01, 0.15, 0.6, 0.25
    env.gate = gate
    voiced = RingMod()
    voiced.left = lp
    voiced.right = env
    out = RingMod()
    out.left = voiced
    out.right = vel
    return out, gate, pitch, vel, cut


def score_poly(notes, layout):
    from signals_tpu_torch.parallel.voices import sequenced_poly
    root, gate, pitch, vel, cut = build_score_voice()
    poly = sequenced_poly(root, gate=gate, pitch=pitch, velocity=vel,
                          notes=notes, n_voices=V, release=SCORE_RELEASE,
                          rate=RATE, block_frames=F, channels=1,
                          layout=layout, device='cuda')
    return poly, cut


def score_oracle(tracks, n_blocks, start):
    """The port's numpy pull oracle of the score: the voice V channels
    wide, its sequencers holding the voices' tracks as rows (the channels
    layout), blocks ``start - 86 .. start + n_blocks - 1`` pulled in order
    and summed over the voices; the first 86 (2 s: the ADSR's state, fresh
    at the first pulled block, has caught up by then) dropped."""
    root, gate, pitch, vel, _ = build_score_voice()
    rows = {k: v.reshape(V, -1) for k, v in tracks.items()}
    for node, values in ((gate, None), (pitch, 'values'),
                         (vel, 'velocities')):
        st = node.get_state()
        st.starts, st.ends = rows['starts'], rows['ends']
        if values:
            st.values = rows[values]
    lead = min(start, 86)
    out = pull_oracle(root, n_blocks + lead, V, start=start - lead)
    return out[lead * F:].sum(axis=1, keepdims=True)


def phase9_score(card, total, within, timed):
    """(a) the score in both layouts, (b) its fit."""
    import torch
    from signals_tpu_torch import learn
    from signals_tpu_torch.compiler import compile_node
    from signals_tpu_torch.compiler import kernels as K
    from signals_tpu_torch.parallel.voices import (allocate_voices,
                                                   score_tracks)
    from signals_tpu_torch.utils.midifile import read_midi
    n60 = n_blocks_60s()
    audio_s = n60 * F / RATE
    path = work_dir() / 'score.mid'
    write_score(path, score_notes())
    notes = read_midi(path)
    tracks = score_tracks(allocate_voices(notes, V, release=SCORE_RELEASE),
                          rate=RATE)
    E = tracks['starts'].shape[-1]
    busy = sum(1 for v in allocate_voices(notes, V, release=SCORE_RELEASE)
               if v)
    print(f'[score] {path.name}: {len(notes)} notes read back over '
          f'{max(n.end for n in notes):.2f} s, {busy} of {V} voices sound, '
          f'E = {E} events on the busiest voice (padded event count)')
    # the one-voice patch's own plan: what the vmap layout folds
    root, gate, pitch, vel, _ = build_score_voice()
    for node, values in ((gate, None), (pitch, 'values'),
                         (vel, 'velocities')):
        st = node.get_state()
        st.starts, st.ends = tracks['starts'][0], tracks['ends'][0]
        if values:
            st.values = tracks[values][0]
    solo = compile_node(root, block_frames=F, rate=RATE, channels=1,
                        device='cuda')
    solo_expect = {'batch': 1}
    launched(f'score, one voice alone, {n60} blocks, plan '
             f'{solo.plan(n60)}', lambda: solo.render(n_blocks=n60),
             solo_expect)
    mixes = {}
    for layout, expect in (('vmap', solo_expect),
                           ('channels', {'segments': 1})):
        poly, _ = score_poly(notes, layout)
        plan = poly.compiled.plan(n60)
        assert plan == 'mega', (layout, plan)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        mix = launched(f'score, {layout} layout, {n60} blocks, plan {plan}',
                       lambda: poly.render(n_blocks=n60)[0], expect, total)
        if layout == 'vmap':
            # one lane a voice: K3 writes each voice's rows consecutively
            assert K.ROWS_OUT == {'time_major': 1, 'lane_major': 0}, \
                K.ROWS_OUT
            print(f'[score] vmap layout: K3 calls by layout {K.ROWS_OUT}')
        peak = torch.cuda.max_memory_allocated() - base
        print(f'[score] {layout} layout: peak memory of the render '
              f'{peak / 2**30:.3f} GiB over {base / 2**30:.3f} GiB held  '
              f'[{card}]')
        mixes[layout] = mix.cpu().numpy()
        del mix
        timed(f'score, {layout} layout, {n60} blocks', lambda: poly.render(
            n_blocks=n60), audio_s)
    diff = float(np.abs(mixes['vmap'] - mixes['channels']).max())
    print(f'[score] vmap vs channels layout over {n60} blocks: max abs '
          f'{diff!r} (tol {V * TOL:g}, peak '
          f'{float(np.abs(mixes["vmap"]).max())!r})')
    assert diff <= V * TOL, diff
    t0 = time.perf_counter()
    for start in (0, SCORE_LATE):
        want = score_oracle(tracks, ORACLE_BLOCKS, start)
        for layout, mix in mixes.items():
            within(f'score, {layout} layout, blocks {start}-'
                   f'{start + ORACLE_BLOCKS - 1}',
                   mix[start * F:(start + ORACLE_BLOCKS) * F], want, V * TOL)
    print(f'[score] oracles, 2 x {ORACLE_BLOCKS} blocks: '
          f'{time.perf_counter() - t0:.1f} s')
    del mixes

    # (b) PolyPatch.fit of the shared cutoff, vmap layout
    t_poly, _ = score_poly(notes, 'vmap')
    tgt = t_poly.render(n_blocks=SCORE_FIT_BLOCKS)[0]
    poly, cut = score_poly(notes, 'vmap')
    cut.get_state().value = np.full((1, 1), 1200.0, np.float32)
    uid = poly.compiled.index.info(cut).uid
    render = poly.render_fn(SCORE_FIT_CHECK)
    short = tgt[:SCORE_FIT_CHECK * F]

    def grad():
        params, _ = poly.params()
        leaf = params[uid]['value'].requires_grad_()
        mix, _ = render(params, poly.init_carry(), 0)
        value = learn.spectral_loss(mix.reshape(-1, 1), short)
        return torch.autograd.grad(value, leaf)[0]

    g = launched(f'score, cutoff gradient, {SCORE_FIT_CHECK} blocks, vmap '
                 f'layout', grad, {'batch': 1, 'batch_vjp': 1}, total)
    with plain_kernels():
        g_p = grad()
    rel = rel_max(g, g_p)
    print(f'[score] cutoff gradient {g.item()!r} vs the plain kernels '
          f'{g_p.item()!r}: relative {rel!r} (tol 1e-4)')
    assert torch.isfinite(g).all() and rel <= 1e-4, rel
    res = fit_steps(f'score ({V} voices, {SCORE_FIT_BLOCKS} blocks), '
                    f'PolyPatch.fit, vmap layout',
                    lambda n: poly.fit(tgt, [(cut, 'value')], steps=n,
                                       learning_rate=0.05, relative_lr=True,
                                       apply=False),
                    10, {'batch': 1, 'batch_vjp': 1}, total, card,
                    SCORE_FIT_BLOCKS * F / RATE)
    print(f'[score] fit: loss {res.losses[0]!r} -> {res.losses[-1]!r} over '
          f'10 steps')
    assert np.isfinite(res.losses).all()


def build_modulation(writer_path=None):
    """``examples/modulation.py``'s chain: a 146.83 Hz saw -> a stereo
    chorus (``FracDelay`` up to 30 ms read at a ``Merge`` of two LFOs,
    12 ± 4 ms at 0.6 Hz and 17 ± 4 ms at 0.73 Hz) mixed 0.5 with the dry
    saw -> a 4-stage ``Phaser`` swept 1000 ± 700 Hz at 0.4 Hz -> Gain 0.7
    -> a ``FileWriter`` (float32) when ``writer_path`` is given."""
    from signals_tpu_torch.nodes.files import FileWriter
    from signals_tpu_torch.nodes.fx import Gain, Mix
    from signals_tpu_torch.nodes.moddelay import FracDelay
    from signals_tpu_torch.nodes.osc import Sawtooth, Sine
    from signals_tpu_torch.nodes.phaser import Phaser
    from signals_tpu_torch.nodes.shape import Merge

    def lfo_around(center, depth, hertz):
        osc = Sine()
        osc.hertz = fixed(hertz)
        d = Gain()
        d.left = osc
        d.right = fixed(2.0 * depth)
        m = Mix()
        m.left = d
        m.right = fixed(2.0 * center)
        m.mix = fixed(0.5)
        return m

    pad = Sawtooth()
    pad.hertz = fixed(146.83)
    spread = Merge()
    spread.left = lfo_around(0.012, 0.004, 0.6)
    spread.right = lfo_around(0.017, 0.004, 0.73)
    tap = FracDelay()
    tap.get_state().max_delay = 0.03
    tap.input = pad
    tap.delay = spread
    chorus = Mix()
    chorus.left = pad
    chorus.right = tap
    chorus.mix = fixed(0.5)
    swoosh = Phaser()
    swoosh.input = chorus
    swoosh.sweep = lfo_around(1000.0, 700.0, 0.4)
    out = Gain()
    out.left = swoosh
    out.right = fixed(0.7)
    if writer_path is None:
        return out
    writer = FileWriter()
    writer.get_state().path = str(writer_path)
    writer.input = out
    return writer


def phase9_modfx(card, total, within, timed):
    """(c) the modulation chain, (d) the convolution."""
    import torch
    from signals_tpu_torch.compiler import compile_node
    from signals_tpu_torch.core.xp import TorchXP
    from signals_tpu_torch.nodes.conv import Convolve, _next_pow2
    from signals_tpu_torch.nodes.fx import Gain
    from signals_tpu_torch.runtime import sndfile
    n60 = n_blocks_60s()
    audio_s = n60 * F / RATE

    # (c) examples/modulation.py's chain, stereo, on the whole-window plan
    out = work_dir() / 'modulation.wav'
    mod = compile_node(build_modulation(out), block_frames=F, rate=RATE,
                       channels=2, device='cuda')
    assert mod.plan(n60) == 'mega', mod.plan(n60)
    whole = launched(f'modulation, {n60} blocks, plan mega',
                     lambda: mod.render(n_blocks=n60)[0], {}, total)
    reader = sndfile.open_reader(out)
    assert (reader.frames, reader.channels) == (n60 * F, 2)
    err = float(np.abs(reader.read(0, n60 * F)
                       - whole.cpu().numpy()).max())
    reader.close()
    print(f'[modfx] modulation: {out.name} holds {n60 * F} frames, max abs '
          f'{err!r} from the returned audio')
    assert err == 0.0, err
    want = pull_oracle(build_modulation(), ORACLE_BLOCKS, 2)
    within(f'modulation, {n60} blocks, first {ORACLE_BLOCKS}',
           whole[:ORACLE_BLOCKS * F].cpu().numpy(), want, TOL)
    params, carry, steps = mod.params(), mod.carry0, []
    for i in range(ORACLE_BLOCKS):
        blk, carry = mod.step(params, carry, i * F)
        steps.append(blk)
    diff = float((torch.cat(steps) - whole[:ORACLE_BLOCKS * F]).abs().max())
    print(f'[modfx] modulation: the {n60}-block window vs {ORACLE_BLOCKS} '
          f'per-block steps: max abs {diff!r} (tol 1e-6)')
    assert diff <= 1e-6, diff
    a, c13 = mod.render(n_blocks=13, deliver_taps=False)
    b, _ = mod.render(position=13 * F, n_blocks=19, carry=c13,
                      deliver_taps=False)
    diff = float((torch.cat([a, b]) - whole[:32 * F]).abs().max())
    print(f'[modfx] modulation: 13 + 19 blocks with the carry vs the first '
          f'32 of {n60}: max abs {diff!r} (tol 1e-6)')
    assert diff <= 1e-6, diff
    del whole, steps
    mod.root._close()
    quiet = compile_node(build_modulation(), block_frames=F, rate=RATE,
                         channels=2, device='cuda')
    timed(f'modulation, {n60} blocks, plan mega', lambda: quiet.render(
        n_blocks=n60), audio_s)

    # (d) the mono subtractive voice through a 2 s convolution
    def build_conv():
        voice, _ = build_subtractive_voice(gain=1.0)
        cv = Convolve()
        st = cv.get_state()
        st.ir_frames, st.decay_db, st.mix = IR_FRAMES, 60.0, CONV_MIX
        cv.input = voice
        g = Gain()
        g.left = cv
        g.right = fixed(CONV_GAIN)
        return g, cv

    root, cv = build_conv()
    conv = compile_node(root, block_frames=F, rate=RATE, channels=1,
                        device='cuda')
    assert conv.plan(n60) == 'mega', conv.plan(n60)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    # K1 for the voice; K4 once over the IR's lookback before block 0 (the
    # context window, zeroed: it lies before the timeline)
    got = launched(f'convolution, {n60} blocks, plan mega',
                   lambda: conv.render(n_blocks=n60)[0],
                   {'segments_gen': 1, 'timeline': 1}, total).cpu().numpy()
    peak = torch.cuda.max_memory_allocated() - base
    K = cv._ir_len()
    M = _next_pow2(n60 * F + K - 1)
    print(f'[modfx] convolution: {K} taps, one transform pair of {M} '
          f'points (2^{M.bit_length() - 1}); peak memory of the render '
          f'{peak / 2**30:.3f} GiB  [{card}]')
    # the oracle: the voice by the port's pull oracle (from block 0, and
    # from 130 blocks before the last 32: its ADSR has caught up within
    # one gate cycle of a fresh start, and the IR reaches 86 blocks back),
    # convolved in float64 with the IR, mixed as Convolve mixes
    ir = cv._ir_for_channels(1)[:, 0].astype(np.float64)
    last = n60 - ORACLE_BLOCKS
    t0 = time.perf_counter()
    for start, lead in ((0, 0), (last, min(130, last))):
        dry = pull_oracle(build_subtractive_voice(gain=1.0)[0],
                          ORACLE_BLOCKS + lead, 1, start=start - lead)
        dry = dry[:, 0].astype(np.float64)
        wet = np.convolve(dry, ir)[:dry.size]
        want = CONV_GAIN * (CONV_MIX * wet + (1.0 - CONV_MIX) * dry)
        want = want[lead * F:].astype(np.float32)[:, None]
        within(f'convolution, {n60} blocks, blocks {start}-'
               f'{start + ORACLE_BLOCKS - 1}',
               got[start * F:(start + ORACLE_BLOCKS) * F], want, TOL)
    print(f'[modfx] convolution oracles, 2 x {ORACLE_BLOCKS} blocks: '
          f'{time.perf_counter() - t0:.1f} s')
    del got
    x = torch.randn(M, 1, device='cuda')
    spec = cv._spectrum(TorchXP(conv.device), M, 1)   # the cached spectrum
    ms = cuda_ms(lambda: torch.fft.irfft(torch.fft.rfft(x, n=M, dim=0)
                                         * spec, n=M, dim=0), 10)
    print(f'[modfx] convolution: rfft + product + irfft of {M} points, '
          f'{ms:.3f} ms (CUDA events)  [{card}]')
    timed(f'convolution, {n60} blocks, plan mega', lambda: conv.render(
        n_blocks=n60), audio_s)


def phase_sequencing():
    """Sequenced polyphony and the modulation effects through the port's
    entry points (``sequenced_poly``, ``PolyPatch`` in both layouts,
    ``compile_node``).  Returns, per kernel, ``(launches, what launched
    it)``."""
    card = card_line()
    total = collections.Counter()
    t_phase = time.perf_counter()

    def within(name, got, want, tol):
        got = np.asarray(got)
        assert got.shape == want.shape and np.isfinite(got).all(), name
        err = float(np.abs(got - want).max())
        print(f'[seq] {name}: vs oracle max abs {err!r} (tol {tol:g}, peak '
              f'{float(np.abs(want).max())!r})')
        assert err <= tol, (name, err)

    def timed(name, fn, audio_s):
        wall, dev_ms, events = profiled(fn)
        n = audio_s * RATE / F
        print(f'[seq] {name}: wall {wall:.3f} ms = '
              f'{audio_s / (wall / 1e3):.1f}x realtime, device {dev_ms:.3f} '
              f'ms in {events} kernels and copies ({events / n:.3f} a '
              f'block), busy share {dev_ms / wall:.3f}  [{card}]')

    phase9_score(card, total, within, timed)
    phase9_modfx(card, total, within, timed)
    print(f'[seq] phase 9: {time.perf_counter() - t_phase:.1f} s')
    return {'batch': (total['batch'], 'score, vmap layout: one folded '
                      'launch for 64 voices a render and a fit step'),
            'segments': (total['segments'], 'score, channels layout'),
            'segments_gen': (total['segments_gen'], 'convolution voice'),
            'timeline': (total['timeline'], "convolution voice: the IR's "
                         'lookback before block 0'),
            'rows_vjp': (total['batch_vjp'], 'score fit, vmap layout')}


# --- phase 10: the output path ----------------------------------------------

STREAM_SECONDS = 240.0      # (b) the streamed SLAC bounce
RING_SECONDS = 5.0          # (c) the mono voice in real time through the ring
NULL_SECONDS = 3.0          # (c) the static voice on the null sink
#: operations of one sample of csrc/codecs.cu's IMA encoder: the load and
#: quantization (5), the step (26: the three compare-subtract stages, the
#: quantized difference, the predictor update and its clamp), the index
#: update and clamp (4), the nibble packing (3), the loop (2)
IMA_OPS = 40
IMA_SHAPES = tuple((ch, spb) for ch in (1, 2, 16, 64) for spb in (1017, 505))
#: (ch, spb, frames) at the edges of the kernel's tiles: a wide block in
#: groups of 32 and 1 channels, 3 channels (10 whole blocks a tile, 2 lanes
#: idle), a short last block, renders shorter than one block
IMA_EDGES = ((33, 1017, 3 * 1017 - 339), (33, 505, 200), (3, 505, 40 * 505
             - 168), (1, 1017, 500), (40, 9, 9 * 70 - 3), (2, 1017, 33 *
             1017 - 1))


def device_encoders():
    """``{name: (device encoder, its numpy encoder, launches)}`` of the
    device codecs, each on a float32 ``(frames, ch)`` tensor."""
    from signals_tpu_torch.core.xp import TorchXP
    from signals_tpu_torch.runtime import codecs
    return {
        'pcm16': (lambda x: codecs.pcm16_encode(TorchXP(x.device), x),
                  lambda a: codecs.pcm16_encode(np, a), {}),
        'mulaw': (lambda x: codecs.mulaw_encode(TorchXP(x.device), x),
                  lambda a: codecs.mulaw_encode(np, a), {}),
        'alaw': (lambda x: codecs.alaw_encode(TorchXP(x.device), x),
                 lambda a: codecs.alaw_encode(np, a), {}),
        'adpcm': (codecs.ima_encode, lambda a: codecs.ima_encode_np(a)[0],
                  {'ima': 1}),
        'slac v1': (codecs.slac_encode,
                    lambda a: codecs.slac_encode_np(a)[0], {}),
        'slac v2': (codecs.slac2_encode,
                    lambda a: codecs.slac2_encode_np(a)[0], {}),
    }


def encode_np(audio, subtype):
    """The numpy encoding of ``audio`` a ``render_encoded(subtype)``
    payload must equal byte for byte."""
    name = {'slac': 'slac v2'}.get(subtype, subtype)
    return device_encoders()[name][1](np.asarray(audio, np.float32))


def fetch(payload):
    """An encoder's payload copied off the card: for SLAC the live length
    first (8 bytes), then that many bytes."""
    if isinstance(payload, tuple):
        buf, total = payload
        return buf[:int(total)].cpu().numpy()
    return payload.cpu().numpy()


def wall_ms(fn, reps=3):
    """Fastest of ``reps`` host-clock times of ``fn`` ending in a
    synchronise, after a warmup call."""
    import torch
    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        best = ms if best is None else min(best, ms)
    return best


def ima_kernel(mix, card):
    """The IMA kernel against its plain loop at ``IMA_SHAPES`` (the mix's
    frames less 7, scaled per channel past full scale), byte for byte and
    the same bytes twice, each with its device time beside its bound, and
    the chains alone (:func:`ima_chain_only`) at 1 and 64 channels; then at
    the tiles' edges (``IMA_EDGES``) and on NaN samples (encoded as 0),
    byte for byte.  Returns the kernel's record at the flagship mix (1
    channel, 1017), its chain floor in ``chain_floor_ms``."""
    import torch
    from signals_tpu_torch.compiler import kernels as K
    from signals_tpu_torch.runtime import codecs
    frames = mix.shape[0] - 7
    record = None
    for ch, spb in IMA_SHAPES:
        x = (mix[:frames] * torch.linspace(0.5, 2.5, ch, device=mix.device)
             ).contiguous()
        K.reset_launch_counts()
        got = codecs.ima_encode(x, samples_per_block=spb)
        again = codecs.ima_encode(x, samples_per_block=spb)
        torch.cuda.synchronize()
        assert K.LAUNCHES['ima'] == 2, K.LAUNCHES
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = codecs.ima_encode_plain(x, samples_per_block=spb)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        same = torch.equal(got, want) and torch.equal(got, again)
        nb = -(-frames // spb)
        assert got.numel() == nb * ((spb - 1) // 2 + 4) * ch
        dms, how = kernel_device_ms(
            lambda: codecs.ima_encode(x, samples_per_block=spb), 5,
            ('ima_encode',))
        b_ms, b_by = bound(IMA_OPS * nb * (spb - 1) * ch,
                           frames * ch * 4 + got.numel())
        print(f'[out] IMA kernel, {frames} frames x {ch} ch, '
              f'samples_per_block {spb} ({nb} blocks, {nb * ch} chains): '
              f'{"byte-identical" if same else "DIFFERS"} to the plain loop, '
              f'the same bytes twice; device {dms:.4f} ms ({how}), bound '
              f'{b_ms:.5f} ms ({b_by}), plain loop {plain_ms:.1f} ms (CUDA '
              f'events)  [{card}]')
        assert same, (ch, spb)
        if (ch, spb) == (1, 1017):
            ms = cuda_ms(lambda: codecs.ima_encode(x), 20)
            record = dict(err=0.0, ms=ms, plain_ms=plain_ms, device_ms=dms,
                          device_ms_by=how, bound_ms=b_ms, bound_by=b_by)
        if spb == 1017 and ch in (1, 64):
            floor = device_ms(lambda: ima_chain_only(x, spb), 5,
                              ('ima_encode',))
            print(f'[out] IMA kernel, {ch} ch x {spb}: the chains alone '
                  f'(samples from registers, nothing loaded; the serial '
                  f'floor) device {floor:.4f} ms  [{card}]')
            if ch == 1:
                record['chain_floor_ms'] = floor
        del x, got, again, want
    for ch, spb, n in IMA_EDGES:
        x = (mix[:n] * torch.linspace(0.5, 2.5, ch, device=mix.device)
             ).contiguous()
        got = launched(f'IMA kernel, tile edge: {n} frames x {ch} ch, '
                       f'samples_per_block {spb}',
                       lambda: codecs.ima_encode(x, samples_per_block=spb),
                       {'ima': 1}, quiet=True)
        want = codecs.ima_encode_plain(x, samples_per_block=spb)
        same = torch.equal(got, want)
        print(f'[out] IMA kernel, tile edge: {n} frames x {ch} ch, '
              f'samples_per_block {spb}: '
              f'{"byte-identical" if same else "DIFFERS"} to the plain loop')
        assert same, (ch, spb, n)
    for ch, spb in ((1, 1017), (33, 505)):
        # NaN samples: a block's first, its second and one inside it
        x = (mix[:3 * spb + 5] * torch.linspace(0.5, 2.5, ch,
                                                device=mix.device)
             ).contiguous()
        for at in (0, spb + 1, 2 * spb + spb // 2):
            x[at, 0] = float('nan')
            x[at + 3, -1] = float('nan')
        got = launched(f'IMA kernel, NaN samples, {ch} ch x {spb}',
                       lambda: codecs.ima_encode(x, samples_per_block=spb),
                       {'ima': 1}, quiet=True)
        want = codecs.ima_encode_plain(x, samples_per_block=spb)
        zeroed, _ = codecs.ima_encode_np(
            torch.nan_to_num(x, nan=0.0).cpu().numpy(),
            samples_per_block=spb)
        same = (torch.equal(got, want)
                and np.array_equal(got.cpu().numpy(), zeroed))
        print(f'[out] IMA kernel, NaN samples, {x.shape[0]} frames x {ch} '
              f'ch, samples_per_block {spb}: '
              f'{"byte-identical" if same else "DIFFERS"} to the plain loop '
              f'and to the numpy encoder of the input with its NaNs set to '
              f'0 (the JAX package\'s encoding of a NaN)')
        assert same, ('nan', ch, spb)
    return record


def ima_chain_only(x, spb):
    """The IMA kernel patched by ``scripts/torch_ima_variants.py``'s
    ``CHAIN_ONLY`` (its chains take their samples from registers and
    nothing is loaded: the kernel's serial floor; the bytes are no
    encoding), built at first call into ``build/ima_chain/``.  Returns its
    payload."""
    import ctypes
    import importlib.util
    import pathlib

    import torch
    from signals_tpu_torch.compiler import _build
    global _IMA_CHAIN
    if _IMA_CHAIN is None:
        root = pathlib.Path(__file__).resolve().parent
        spec = importlib.util.spec_from_file_location(
            'torch_ima_variants', root / 'scripts' / 'torch_ima_variants.py')
        variants = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(variants)
        src = variants.patched('chain')
        out = root / 'build' / 'ima_chain' / 'libima_chain.so'
        out.parent.mkdir(parents=True, exist_ok=True)
        run([_build.nvcc_path(), '-O3', '-std=c++17', *_build.ARCH_FLAGS,
             '-Xcompiler', '-fPIC', '-shared', '-o', str(out), str(src)])
        lib = ctypes.CDLL(str(out))
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.ima_encode_launch.argtypes = [p, q, i, i, i, p, p]
        lib.ima_encode_launch.restype = i
        _IMA_CHAIN = lib
    nb = -(-x.shape[0] // spb)
    out = torch.empty(nb * ((spb - 1) // 2 + 4) * x.shape[1],
                      dtype=torch.uint8, device=x.device)
    code = _IMA_CHAIN.ima_encode_launch(
        x.data_ptr(), x.shape[0], x.shape[1], spb, nb, out.data_ptr(),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert code == 0, f'chain-only IMA launch: CUDA error {code}'
    return out


_IMA_CHAIN = None


def phase10_encoders(card, total):
    """(a) Every device encoder on the flagship's 60 s 64-voice mix."""
    import torch
    from signals_tpu_torch.runtime import codecs
    n60 = n_blocks_60s()
    frames = n60 * F
    poly = make_poly()
    mix = launched(f'flagship mix, {n60} blocks, mix plan',
                   lambda: poly.render(n_blocks=n60)[0],
                   {'segments_gen': 1}, total)
    host = mix.cpu().numpy()
    assert host.shape == (frames, 1) and np.isfinite(host).all()
    f32_wall = wall_ms(lambda: poly.render(n_blocks=n60)[0].cpu())
    print(f'[out] flagship, {n60} blocks: render + f32 fetch wall '
          f'{f32_wall:.2f} ms ({host.nbytes} bytes, 4 a sample)  [{card}]')
    for name, (enc, enc_np, expect) in device_encoders().items():
        got = fetch(launched(f'{name} encode of the flagship mix',
                             lambda: enc(mix), expect, total))
        same = (np.array_equal(got, enc_np(host))
                and np.array_equal(fetch(enc(mix)), got))
        _, dev_ms, events = profiled(lambda: enc(mix))
        dtxt = (f'{dev_ms:.3f} ms in {events} kernels and copies' if events
                else 'not measured (the trace lost its events)')
        wall = wall_ms(lambda: fetch(enc(poly.render(n_blocks=n60)[0])))
        print(f'[out] flagship, {name}: {"byte-identical" if same else "DIFFERS"}'
              f' to its numpy encoder, the same bytes twice; {got.nbytes} '
              f'bytes ({got.nbytes / frames:.4f} a sample); encode device '
              f'{dtxt}; render + encode + fetch wall {wall:.2f} ms (f32: '
              f'{f32_wall:.2f})  [{card}]')
        assert same, name
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    buf, tot = codecs.slac2_encode(mix)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    nb = -(-frames // codecs.SLAC_BLOCK)
    table = nb * codecs.SLAC_BLOCK * (codecs._SLAC2_MAX_BITS // 32) * 4
    print(f'[out] SLAC v2 encode of the {frames}-sample mix: peak memory '
          f'{peak / 2**20:.1f} MiB over {base / 2**20:.1f} MiB held (a '
          f'(blocks, 256, 288) int32 table would be {table / 2**30:.2f} GiB)'
          f'  [{card}]')
    del buf, tot
    record = ima_kernel(mix, card)
    del mix, poly
    torch.cuda.empty_cache()
    return record


def stream_blocks(seconds):
    return int(np.ceil(seconds * RATE / F / M)) * M


def phase10_sink(card, total):
    """(b) ``SinkDevice`` offline: render, every encoding from block 0 and
    from block 3, the 240 s SLAC stream (and with every batch overshooting
    its cap), the stream beside a sequential render -> fetch."""
    import torch
    from signals_tpu_torch.compiler import CompiledPatch
    from signals_tpu_torch.nodes.dev import Rack, SinkDevice
    from signals_tpu_torch.runtime import codecs
    from signals_tpu_torch.runtime.sndfile import SlacReader, SlacWriter
    rack = Rack()
    rack.scan()
    sink = SinkDevice(rack.get_sink('default'), realtime=False,
                      device='cuda')
    sink.get_state().channels = 2
    sink.input = build_subtractive_voice(gain=1.0)[0]
    n60 = n_blocks_60s()
    audio = launched(f'sink render_offline, {n60} blocks, 2 channels',
                     lambda: sink.render_offline(n_blocks=n60),
                     {'segments_gen': 1}, total).cpu().numpy()
    want = pull_oracle(build_subtractive_voice(gain=1.0)[0], ORACLE_BLOCKS, 2)
    err = float(np.abs(audio[:ORACLE_BLOCKS * F] - want).max())
    print(f'[out] sink render_offline, first {ORACLE_BLOCKS} of {n60} '
          f'blocks: vs oracle max abs {err!r} (tol {TOL}, peak '
          f'{float(np.abs(want).max())!r})')
    assert np.isfinite(audio).all() and err <= TOL, err
    for start, nb in ((0, n60), (3, 64)):
        ref = (audio if start == 0 else launched(
            f'sink render_offline, {nb} blocks from block {start}',
            lambda: sink.render_offline(n_blocks=nb, position=start * F),
            {'segments_gen': 1}, total).cpu().numpy())
        for sub in codecs.DEVICE_SUBTYPES:
            payload, frames = launched(
                f'sink render_offline_encoded {sub}, {nb} blocks from '
                f'block {start}',
                lambda: sink.render_offline_encoded(
                    n_blocks=nb, position=start * F, subtype=sub),
                {'segments_gen': 1, **({'ima': 1} if sub == 'adpcm'
                                       else {})}, total, quiet=True)
            same = frames == nb * F and np.array_equal(
                payload, encode_np(ref, sub))
            print(f'[out] sink render_offline_encoded {sub}, {nb} blocks '
                  f'from block {start}: {payload.nbytes} bytes, '
                  f'{"byte-identical" if same else "DIFFERS"} to its numpy '
                  f'encoder on render_offline\'s audio')
            assert same, (sub, start)
    del audio

    # the 240 s stream in 60 s batches through the v3 container
    nS = stream_blocks(STREAM_SECONDS)
    path = work_dir() / 'stream.slac'

    def stream(n_batches_expect):
        parts = []
        t0 = time.perf_counter()
        for payload, frames in sink.render_offline_encoded_stream(
                n_blocks=nS, subtype='slac', batch_seconds=SECONDS):
            parts.append((payload, frames))
        wall = time.perf_counter() - t0
        assert len(parts) == n_batches_expect, len(parts)
        return parts, wall

    n_batches = -(-nS // n60)
    parts, wall = launched(
        f'sink render_offline_encoded_stream slac, {nS} blocks in '
        f'{n_batches} batches', lambda: stream(n_batches),
        {'segments_gen': n_batches}, total)
    w = SlacWriter(path, rate=RATE, channels=2)
    for payload, frames in parts:
        w.write_encoded(payload, frames)
    w.close()
    nbytes = sum(p.nbytes for p, _ in parts)
    whole = launched(f'sink render_offline, {nS} blocks',
                     lambda: sink.render_offline(n_blocks=nS),
                     {'segments_gen': 1}, total).cpu().numpy()
    pcm = np.clip(np.round(whole * np.float32(32767.0)), -32768, 32767)
    t0 = time.perf_counter()
    r = SlacReader(path)
    got = np.round(r.read(0, r.frames) * np.float32(32767.0))
    dec_s = time.perf_counter() - t0
    exact = r.frames == nS * F and np.array_equal(got, pcm)
    print(f'[out] stream slac, {nS} blocks ({nS * F / RATE:.1f} s, 2 ch) '
          f'in {n_batches} batches: wall {wall * 1e3:.1f} ms = '
          f'{nS * F / RATE / wall:.1f}x realtime, {nbytes} bytes fetched '
          f'({nbytes / (nS * F * 2):.4f} a sample); {path.name} (v3, '
          f'{path.stat().st_size} bytes) read back '
          f'{"bit-exact" if exact else "DIFFERENT"} to the PCM16 of one '
          f'{nS}-block render (decode {dec_s:.1f} s)  [{card}]')
    assert exact
    del whole, pcm, got, r

    # every batch overshooting its cap: the remainder copy
    saved = (CompiledPatch.STREAM_CAP_GUESS, CompiledPatch.STREAM_CAP_STEP)
    CompiledPatch.STREAM_CAP_GUESS, CompiledPatch.STREAM_CAP_STEP = 0.01, 256
    try:
        over, over_wall = launched(
            'the same stream, STREAM_CAP_GUESS 0.01', lambda: stream(
                n_batches), {'segments_gen': n_batches}, total)
    finally:
        CompiledPatch.STREAM_CAP_GUESS, CompiledPatch.STREAM_CAP_STEP = saved
    # the caps the stream used: the guess for the batches queued before the
    # first length is seen (three: two ahead, one more queued as the first
    # is taken), then 1.25x the last length seen (as the reference adapts)
    step = 256
    caps = [-(-int(n60 * F * 2 * 0.01) // step) * step] * min(3, n_batches)
    for p, _ in over[:n_batches - len(caps)]:
        caps.append(max(-(-int(p.nbytes * 1.25) // step) * step, step))
    overshot = sum(p.nbytes > c for (p, _), c in zip(over, caps))
    same = all(np.array_equal(a, b) for (a, _), (b, _) in zip(parts, over))
    print(f'[out] stream slac with STREAM_CAP_GUESS 0.01 (a cap of '
          f'{caps[0]} bytes): {overshot} of {n_batches} batches copied '
          f'their remainder after the capped slice; '
          f'{"the same bytes" if same else "DIFFERENT BYTES"}, wall '
          f'{over_wall * 1e3:.1f} ms')
    assert same and overshot >= min(3, n_batches)

    # the same batches rendered, encoded and fetched one after another
    patch = sink._compile()

    def sequential():
        out, carry = [], None
        for i in range(n_batches):
            nb = min(n60, nS - i * n60)
            p, _, carry = patch.render_encoded(position=i * n60 * F,
                                               n_blocks=nb, carry=carry,
                                               subtype='slac')
            out.append(p)
        return out

    seq = sequential()
    t0 = time.perf_counter()
    seq = sequential()
    seq_wall = time.perf_counter() - t0
    same = all(np.array_equal(a, b) for (a, _), b in zip(parts, seq))
    print(f'[out] the same {n_batches} batches render -> encode -> fetch in '
          f'turn: wall {seq_wall * 1e3:.1f} ms ({"the same bytes" if same else "DIFFERENT BYTES"})'
          f' vs the stream {wall * 1e3:.1f} ms  [{card}]')
    assert same


def ring_run(sink, seconds, expect_kernel, card, total, name):
    """``sink`` (realtime, pcm16 into a pipe, capturing) for ``seconds``:
    its launches (one ``expect_kernel`` a batch and one for the warmup),
    the consumer's frames and underruns, the render p50/p95 a block, the
    pipe's bytes against the PCM16 of the captured blocks
    (:func:`match_stream`), the captured audio against ``render_offline``
    over the same blocks."""
    import os
    import threading

    import torch
    from signals_tpu_torch.compiler import kernels as K
    r, w = os.pipe()
    chunks = []
    reader = threading.Thread(target=lambda: chunks.extend(
        iter(lambda: os.read(r, 1 << 16), b'')))
    reader.start()
    sink.output_fd, sink.output_format = w, 'pcm16'
    sink.capture(True)
    K.reset_launch_counts()
    sink.start()
    time.sleep(seconds)
    consumer = sink._consumer
    tr = sink._transport
    sink.stop()
    sink.close()
    torch.cuda.synchronize()
    counts = dict(K.LAUNCHES)
    os.close(w)
    reader.join(timeout=30)
    os.close(r)
    assert not reader.is_alive()
    batches = tr.stats.total_blocks // AHEAD
    want = {k: (batches + 1 if k == expect_kernel else 0) for k in counts}
    print(f'[launches] {name}: {counts}')
    assert counts == want, (counts, want)
    total.update(counts)
    ch = sink.get_state().channels
    raw = np.frombuffer(b''.join(chunks), dtype='<i2').reshape(-1, ch)
    cap = sink.captured()
    pcm = np.clip(np.rint(cap * np.float32(32767.0)), -32768,
                  32767).astype(np.int16)
    if consumer.underruns:
        at, und = match_stream(raw, pcm, F)
    else:                   # no zero-fill: the stream is a prefix, exactly
        assert np.array_equal(raw, pcm[:raw.shape[0]])
        at, und = raw.shape[0], 0
    st = tr.stats.summary(F, RATE)
    print(f'[out] {name}: {consumer.frames} frames consumed in {seconds} s, '
          f'{consumer.underruns} underruns after the warmup; {batches} '
          f'batches rendered ({cap.shape[0]} frames captured), p50 '
          f'{st["p50_ms"]:.3f} ms / p95 {st["p95_ms"]:.3f} ms a block '
          f'({st["x_realtime_p50"]:.1f}x realtime); the pipe\'s '
          f'{raw.shape[0]} frames are the captured PCM16 ({at} frames of '
          f'it) with {und} zero-filled blocks  [{card}]')
    assert raw.shape[0] == consumer.frames and at > 0
    assert und <= consumer.underruns
    offline = sink.render_offline(n_blocks=cap.shape[0] // F).cpu().numpy()
    err = float(np.abs(offline - cap).max())
    print(f'[out] {name}: captured vs render_offline over the same '
          f'{cap.shape[0] // F} blocks: max abs {err!r} (tol {TOL})')
    assert err <= TOL, err


def phase10_realtime(card, total):
    """(c) Real time through the native ring and the paced consumer."""
    from signals_tpu_torch.nodes.dev import Rack, SinkDevice
    from signals_tpu_torch.runtime.ring import native_available
    assert native_available(), 'the native ring does not build'
    rack = Rack()
    rack.scan()
    mono = SinkDevice(rack.get_sink('default'), realtime=True,
                      device='cuda')
    mono.get_state().channels = 2
    mono.input = build_subtractive_voice(gain=1.0)[0]
    ring_run(mono, RING_SECONDS, 'segments_gen', card, total,
             'mono voice, default sink, 2 ch, real time')
    static = SinkDevice(rack.get_sink('null'), realtime=True, device='cuda')
    static.get_state().channels = STATIC_CH
    static.input = build_static_voice()
    ring_run(static, NULL_SECONDS, 'batch', card, total,
             f'static voice, null sink, {STATIC_CH} ch, real time')


def phase10_edit(card, total):
    """(d) Edit latency on the null sink (``bench.py:654-728``): a cold
    structural swap (a new LowPass with a time-salted context) and a warm
    one (back), each program's own audio on both sides of each swap."""
    from signals_tpu_torch.compiler import compile_node
    from signals_tpu_torch.nodes.dev import Rack, SinkDevice
    from signals_tpu_torch.nodes.fx import Gain, LowPass
    from signals_tpu_torch.nodes.osc import Sine
    rack = Rack()
    rack.scan()
    hz = fixed(440.0)
    osc = Sine()
    osc.hertz = hz
    g = Gain()
    g.left = osc
    g.right = fixed(1.0)
    sink = SinkDevice(rack.get_sink('null'), block_frames=F, realtime=False,
                      device='cuda')
    sink.get_state().channels = 1
    sink.input = g
    sink.capture(True)
    sink.start()
    tr = sink._transport
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and tr.position < 8 * F:
        time.sleep(0.01)

    def wait_swap(t0):
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            ts = tr.last_swap_time
            if ts is not None and ts >= t0:
                return ts
            time.sleep(0.001)
        raise RuntimeError('structural swap never landed')

    lp = LowPass()
    lp.input = osc
    lp.cutoff = fixed(1200.0)
    lp.get_state().context = 128 * (int(time.time()) % 89 + 3)
    t0 = time.monotonic()
    pos0 = tr.position
    g.left = lp
    cold_ms = (wait_swap(t0) - t0) * 1e3
    blocks_during = (tr.position - pos0) // F
    time.sleep(0.2)
    t0 = time.monotonic()
    g.left = osc
    warm_ms = (wait_swap(t0) - t0) * 1e3
    time.sleep(0.1)
    sink.stop()
    sink.close()
    assert tr.error is None, tr.error
    cap = sink.captured()
    n = cap.shape[0] // F
    plain = compile_node(g, block_frames=F, rate=RATE, channels=1,
                         device='cuda').render(n_blocks=n)[0].cpu().numpy()
    g.left = lp
    filtered = compile_node(g, block_frames=F, rate=RATE, channels=1,
                            device='cuda').render(n_blocks=n)[0].cpu().numpy()
    g.left = osc
    owner = []
    for i in range(n):
        blk = cap[i * F:(i + 1) * F]
        a = float(np.abs(blk - plain[i * F:(i + 1) * F]).max())
        b = float(np.abs(blk - filtered[i * F:(i + 1) * F]).max())
        assert min(a, b) <= TOL, (i, a, b)
        owner.append('A' if a <= b else 'B')
    runs = ''.join(k for i, k in enumerate(owner) if i == 0
                   or k != owner[i - 1])
    print(f'[out] edit latency, null sink: cold structural swap '
          f'{cold_ms:.2f} ms ({blocks_during} blocks rendered by the old '
          f'program meanwhile), warm {warm_ms:.2f} ms; batch {AHEAD} blocks '
          f'= {AHEAD * F / RATE * 1e3:.1f} ms of audio; {n} captured blocks '
          f'are each program\'s own audio in the order {runs} '
          f'(A: the sine, B: through the LowPass)  [{card}]')
    assert runs == 'ABA', runs


def phase10_checkpoint(card, total):
    """(e) The saturated echo: 13 blocks, save, load on the card, 19 more,
    bit for bit the continuation from the device carry."""
    import torch
    from signals_tpu_torch.compiler import compile_node
    from signals_tpu_torch.utils import checkpoint
    echo = compile_node(build_saturated_echo(), block_frames=F, rate=RATE,
                        channels=1, device='cuda')
    _, c13 = launched('echo, 13 blocks', lambda: echo.render(n_blocks=13),
                      {'stream': 1}, total)
    path = work_dir() / 'echo_checkpoint.npz'
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save(path, position=13 * F, carry=c13,
                    graph_hash=echo.graph_hash)
    save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    loaded = checkpoint.load(path, expect_graph_hash=echo.graph_hash,
                             device='cuda')
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    resumed = launched('echo, 19 blocks from the loaded checkpoint',
                       lambda: echo.render(position=loaded['position'],
                                           n_blocks=19,
                                           carry=loaded['carry'])[0],
                       {'stream': 2}, total)
    direct = echo.render(position=13 * F, n_blocks=19, carry=c13)[0]
    leaves = sum(v.numel() for c in c13.values() for v in c.values())
    same = torch.equal(resumed, direct)
    print(f'[out] checkpoint of the saturated echo after 13 blocks: '
          f'{path.stat().st_size} bytes ({leaves} carry values), save '
          f'{save_ms:.2f} ms, load to the card {load_ms:.2f} ms; 19 blocks '
          f'resumed from it {"bit for bit" if same else "DIFFERENT from"} '
          f'the continuation from the device carry  [{card}]')
    assert same and torch.isfinite(resumed).all()


def phase_output():
    """The output path through the port's entry points: the device codecs,
    ``SinkDevice`` offline and in real time through the native ring, the
    background structural swap, a checkpoint.  Returns ``(per kernel
    (launches, what launched it), the IMA kernel's record)``."""
    card = card_line()
    total = collections.Counter()
    t_phase = time.perf_counter()
    record = phase10_encoders(card, total)
    print(f'[out] phase 10 (a) encoders: {time.perf_counter() - t_phase:.1f}'
          f' s')
    for part, run in (('(b) sink offline', phase10_sink),
                      ('(c) real time', phase10_realtime),
                      ('(d) edit latency', phase10_edit),
                      ('(e) checkpoint', phase10_checkpoint)):
        t0 = time.perf_counter()
        run(card, total)
        print(f'[out] phase 10 {part}: {time.perf_counter() - t0:.1f} s')
    print(f'[out] phase 10: {time.perf_counter() - t_phase:.1f} s')
    return ({'segments_gen': (total['segments_gen'], 'output path: the '
                              'flagship mix, the sink\'s mono voice offline, '
                              'streamed and in real time'),
             'batch': (total['batch'], 'output path: the static voice on '
                       'the null sink in real time, one a batch'),
             'stream': (total['stream'], 'output path: the echo around its '
                        'checkpoint'),
             'ima': (total['ima'], 'output path: ADPCM encodes of the '
                     'flagship mix and of the sink\'s renders')}, record)


# --- phase 11: the command layer ---------------------------------------------

SHELL_SECONDS = 60.0        # (a) the bounces
SHELL_ENCODED = ('pcm16', 'adpcm', 'slac')
FIT_SECONDS = 1.5           # (b) the fit's target
FIT_FROM, FIT_TO = 1400.0, 2000.0
SHELL_FIT_STEPS = 16
PLAY_SECONDS = 3.0          # (c) the static voice on the null sink
FIXTURE_SECONDS = 10.0      # (d) the reference fixture's bounce
REPL_SECONDS = 10.0         # (e) the REPL process's bounce
FIT_LINE = re.compile(r'fit target\.wav: loss (\S+) -> (\S+) over (\d+) '
                      r'steps; 3a\.value=(\S+)')
STATS_LINE = re.compile(r'9a null: blocks=(\d+) p50=(\S+)ms p95=(\S+)ms '
                        r'x_realtime=(\S+) underruns=(\d+)')


def static_voice_sigs(sink='null'):
    """:func:`build_static_voice` as the lines of a ``.sigs`` patch feeding
    a ``sink`` at 9a set to its STATIC_CH channels."""
    pitches = json.dumps(poly_freqs(STATIC_CH).reshape(1, -1).tolist(),
                         separators=(',', ':'))
    return [
        f'sink 9a {sink}', f'ed 9a channels={STATIC_CH}',
        f'+ 1a signals.chain.fixed.Fixed value={pitches}',
        '+ 1b signals.chain.osc.Sawtooth',
        '+ 2a signals.chain.fixed.Fixed value=[[2000]]',
        f'+ 2b signals.chain.fx.LowPass context={STATIC_C}',
        '+ 5a signals.chain.fixed.Fixed value=[[2]]',
        '+ 5b signals.chain.osc.Square',
        '+ 5c signals_tpu.nodes.env.ADSR attack=0.01 decay=0.08 sustain=0.6 '
        'release=0.1',
        '+ 6a signals.chain.fx.RingMod',
        '+ 6b signals.chain.fixed.Fixed value=[[0.015625]]',
        '+ 7a signals.chain.fx.Gain',
        '> 1a 1b.hertz', '> 1b 2b.input', '> 2a 2b.cutoff', '> 5a 5b.hertz',
        '> 5b 5c.gate', '> 2b 6a.left', '> 5c 6a.right', '> 6a 7a.left',
        '> 6b 7a.right', '> 7a 9a.input']


def shell(lines=()):
    """The port's ``Controller`` on its default device, the card, with
    ``lines`` applied; a failing command raises."""
    import io

    from signals_tpu_torch.map.control import Controller
    ctl = Controller(interactive=False, stdout=io.StringIO())
    assert str(ctl.device) == 'cuda'
    for line in lines:
        ctl.default(line)
    return ctl


def said(ctl):
    """What ``ctl`` printed since the last call."""
    out = ctl.stdout.getvalue()
    ctl.stdout.seek(0)
    ctl.stdout.truncate()
    return out.strip()


def timed_ms(fn):
    """``(result, wall ms)`` of ``fn`` ending in a synchronise."""
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def shell_bounce(card, total):
    """(a) The swept voice loaded from a ``.sigs`` file and bounced for
    60 s in float32 and in the encoded subtypes, each file held to the
    sink's own entry point."""
    from signals_tpu_torch.map import Coordinates
    from signals_tpu_torch.runtime import sndfile
    from signals_tpu_torch.runtime.wavio import read_wav, write_wav
    d = work_dir()
    patch = d / 'swept.sigs'
    patch.write_text('\n'.join(swept_voice_sigs()) + '\n')
    ctl = shell([f'load {patch}'])
    sink = ctl.map.find(Coordinates.parse('9a'))
    assert sink.device.type == 'cuda'
    n60 = sink._n_blocks(SHELL_SECONDS, None, F)
    path = d / 'shell.wav'
    launched(f'bounce 9a {path.name} {SHELL_SECONDS:g}',
             lambda: ctl.default(f'bounce 9a {path} {SHELL_SECONDS:g}'),
             {'segments_gen': 1}, total)
    print(f'[shell] {said(ctl)}')
    got, rate = read_wav(path)
    direct = launched(f'sink render_offline, {n60} blocks',
                      lambda: sink.render_offline(seconds=SHELL_SECONDS),
                      {'segments_gen': 1}, total).cpu().numpy()
    same = rate == RATE and got.dtype == np.float32 and np.array_equal(
        got, direct)
    want = pull_oracle(sink.input.sig, ORACLE_BLOCKS, 1)
    err = float(np.abs(got[:ORACLE_BLOCKS * F] - want).max())
    print(f'[shell] bounce float32, {got.shape[0]} frames: '
          f'{"the same bits as" if same else "DIFFERENT FROM"} the sink\'s '
          f'render_offline; first {ORACLE_BLOCKS} blocks vs oracle max abs '
          f'{err!r} (tol {TOL}, peak {float(np.abs(want).max())!r})')
    assert same and got.shape == (n60 * F, 1) and err <= TOL, err
    cmd_ms = wall_ms(lambda: ctl.default(f'bounce 9a {path} '
                                         f'{SHELL_SECONDS:g}'))
    said(ctl)
    direct_path = d / 'direct.wav'
    direct_ms = wall_ms(lambda: write_wav(
        direct_path, sink.render_offline(seconds=SHELL_SECONDS).cpu().numpy(),
        sink.rate))
    print(f'[shell] bounce float32 {SHELL_SECONDS:g} s: command wall '
          f'{cmd_ms:.2f} ms, the direct render_offline + copy + write_wav '
          f'{direct_ms:.2f} ms (fastest of 3 each; the shell\'s own cost '
          f'{cmd_ms - direct_ms:+.2f} ms)  [{card}]')
    for sub in SHELL_ENCODED:
        ext = 'slac' if sub == 'slac' else 'wav'
        out = d / f'shell_{sub}.{ext}'
        line = f'bounce 9a {out} {SHELL_SECONDS:g} {sub}'
        expect = {'segments_gen': 1, **({'ima': 1} if sub == 'adpcm'
                                        else {})}
        launched(line, lambda: ctl.default(line), expect, total)
        print(f'[shell] {said(ctl)}')
        ref = d / f'direct_{sub}.{ext}'

        def direct_write():
            w = sndfile.open_writer(ref, rate=RATE, channels=1, subtype=sub)
            if sub == 'adpcm':
                w.write_encoded(*sink.render_offline_encoded(
                    seconds=SHELL_SECONDS, subtype=sub))
            else:
                for p, f in sink.render_offline_encoded_stream(
                        seconds=SHELL_SECONDS, subtype=sub):
                    w.write_encoded(p, f)
            w.close()

        launched(f'the direct encoded entry point, {sub}', direct_write,
                 expect, total)
        same = out.read_bytes() == ref.read_bytes()
        cmd_ms = wall_ms(lambda: ctl.default(line))
        said(ctl)
        direct_ms = wall_ms(direct_write)
        print(f'[shell] bounce {sub} {SHELL_SECONDS:g} s: {out.stat().st_size} '
              f'bytes, {"byte for byte" if same else "DIFFERENT FROM"} the '
              f'direct entry point\'s file; command wall {cmd_ms:.2f} ms, '
              f'direct {direct_ms:.2f} ms (fastest of 3 each; the shell\'s '
              f'own cost {cmd_ms - direct_ms:+.2f} ms)  [{card}]')
        assert same, sub
    ctl.default('init')
    return patch


def shell_fit(card, total, patch):
    """(b) ``fit`` of the cutoff centre's ``Fixed`` from 1400 Hz to a
    target bounced at 2000 Hz, then ``undo`` / ``redo``."""
    from signals_tpu_torch.map import Coordinates
    ctl = shell([f'load {patch}'])
    target = work_dir() / 'target.wav'
    launched(f'bounce 9a {target.name} {FIT_SECONDS:g}',
             lambda: ctl.default(f'bounce 9a {target} {FIT_SECONDS:g}'),
             {'segments_gen': 1}, total)
    said(ctl)
    ctl.default(f'* 3a value=[[{FIT_FROM!r}]]')
    node = ctl.map.find(Coordinates.parse('3a'))
    before = np.array(node.get_state().value)
    line = f'fit 9a {target} 3a.value --steps {SHELL_FIT_STEPS}'
    _, wall = timed_ms(lambda: launched(
        line, lambda: ctl.default(line),
        {'segments_gen': SHELL_FIT_STEPS,
         'segments_gen_vjp': SHELL_FIT_STEPS}, total))
    out = said(ctl)
    print(f'[shell] {out}')
    m = FIT_LINE.search(out)
    assert m, out
    l0, l1, steps, shown = float(m[1]), float(m[2]), int(m[3]), float(m[4])
    fitted = np.array(node.get_state().value)
    ctl.default('undo')
    undone = np.array(node.get_state().value)
    ctl.default('redo')
    redone = np.array(node.get_state().value)
    exact = (np.array_equal(undone, before) and undone.dtype == before.dtype
             and np.array_equal(redone, fitted))
    # the same fit again from 1400 Hz: its compile, its loss's FFT plans
    # and its first autograd pass are warm now
    ctl.default('undo')
    _, warm = timed_ms(lambda: launched(
        f'{line} (again)', lambda: ctl.default(line),
        {'segments_gen': SHELL_FIT_STEPS,
         'segments_gen_vjp': SHELL_FIT_STEPS}, total))
    again = FIT_LINE.search(said(ctl))
    assert again and float(again[4]) == shown, again
    print(f'[shell] fit {steps} steps over {FIT_SECONDS:g} s: loss {l0!r} -> '
          f'{l1!r}, cutoff centre {FIT_FROM:g} -> {float(fitted.ravel()[0])!r}'
          f' Hz (target {FIT_TO:g}); undo gives back {FIT_FROM:g} '
          f'{"exactly" if exact else "NOT EXACTLY"}, redo the fitted value; '
          f'command wall {wall:.1f} ms = {wall / steps:.2f} ms a step '
          f'(compile and target read included), the same fit again '
          f'{warm:.1f} ms = {warm / steps:.2f} ms a step  [{card}]')
    assert steps == SHELL_FIT_STEPS and l1 < l0 and exact
    assert abs(float(fitted.ravel()[0]) - FIT_TO) < abs(FIT_FROM - FIT_TO)
    assert abs(shown - float(fitted.ravel()[0])) <= 1e-5 * shown


def shell_play(card, total):
    """(c) ``play`` / ``stats`` / ``stop`` of the static voice on the
    realtime ``null`` sink: the Transport renders 8-block batches into the
    native ring, the paced consumer drains it."""
    from signals_tpu_torch.compiler import kernels as K
    from signals_tpu_torch.map import Coordinates
    from signals_tpu_torch.runtime.ring import native_available
    import torch
    assert native_available(), 'the native ring does not build'
    ctl = shell(static_voice_sigs())
    sink = ctl.map.find(Coordinates.parse('9a'))
    assert sink.realtime and sink.get_state().channels == STATIC_CH
    K.reset_launch_counts()
    ctl.default('play 9a')
    time.sleep(PLAY_SECONDS)
    ctl.default('stats')
    stats = said(ctl)
    tr = sink._transport
    ctl.default('stop 9a')
    torch.cuda.synchronize()
    counts = dict(K.LAUNCHES)
    batches = tr.stats.total_blocks // AHEAD
    want = {k: (batches + 1 if k == 'batch' else 0) for k in counts}
    print(f'[launches] play 9a, {PLAY_SECONDS:g} s: {counts}')
    print(f'[shell] stats: {stats}')
    m = STATS_LINE.search(stats)
    assert m, stats
    blocks, underruns = int(m[1]), int(m[5])
    print(f'[shell] play {PLAY_SECONDS:g} s of the {STATIC_CH}-channel '
          f'static voice on the null sink: {blocks} blocks by stats, '
          f'{batches} batches rendered (one K3 launch each, one more for the '
          f'warmup), underruns {underruns}, p50 {m[2]} ms / p95 {m[3]} ms a '
          f'block  [{card}]')
    assert counts == want, (counts, want)
    assert blocks > 0 and underruns == 0
    total.update(counts)
    ctl.default('init')
    assert not sink.is_open


def shell_save_load(card, total, patch):
    """(d) ``save`` / ``load`` keeps the hash; the reference fixture loads
    and bounces."""
    ctl = shell([f'load {patch}'])
    saved = work_dir() / 'saved.sigs'
    ctl.default(f'save {saved}')
    again = shell([f'load {saved}'])
    same = again.hash() == ctl.hash()
    print(f'[shell] save / load {saved.name}: hash {ctl.hash()[:16]} '
          f'{"unchanged" if same else "CHANGED"}')
    assert same and list(again.dump()) == list(ctl.dump())
    import pathlib
    fixture = (pathlib.Path(__file__).resolve().parent / 'tests' / 'fixtures'
               / 'lowpass_test.sigs')
    if not fixture.is_file():
        raise FileNotFoundError(fixture)
    ref = shell([f'load {fixture}'])
    out = work_dir() / 'fixture.wav'
    # one lane of a static LowPass: the segment gate sends its window to
    # the batched replay
    launched(f'fixture lowpass_test.sigs, bounce 7a {FIXTURE_SECONDS:g}',
             lambda: ref.default(f'bounce 7a {out} {FIXTURE_SECONDS:g}'),
             {'batch': 1}, total)
    from signals_tpu_torch.runtime.wavio import read_wav
    audio, rate = read_wav(out)
    print(f'[shell] {said(ref)}; peak {float(np.abs(audio).max())!r}')
    assert rate == RATE and np.isfinite(audio).all()
    assert np.abs(audio).max() > 1e-3
    for c in (ctl, again, ref):
        c.default('init')


def shell_repl(card, total, patch):
    """(e) ``python -m signals_tpu_torch`` fed a command script on stdin."""
    import os
    import pathlib
    root = pathlib.Path(__file__).resolve().parent
    out = work_dir() / 'repl.wav'
    if out.exists():
        out.unlink()
    script = '\n'.join([f'load {patch}', 'hash',
                        f'bounce 9a {out} {REPL_SECONDS:g}', 'exit']) + '\n'
    env = dict(os.environ, PYTHONPATH=str(root))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, '-m', 'signals_tpu_torch'],
                          input=script, capture_output=True, text=True,
                          timeout=300, cwd=root, env=env)
    wall = time.perf_counter() - t0
    lines = [ln.replace('signals: ', '') for ln in proc.stdout.splitlines()]
    print(f'[shell] python -m signals_tpu_torch: rc {proc.returncode} in '
          f'{wall:.1f} s; said {[ln for ln in lines if ln.strip()]}')
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert 'Unexpected error' not in proc.stdout, proc.stdout[-2000:]
    from signals_tpu_torch.runtime.wavio import read_wav
    audio, rate = read_wav(out)
    n = int(round(REPL_SECONDS * RATE / F)) * F
    assert audio.shape == (n, 1) and rate == RATE, audio.shape
    assert np.isfinite(audio).all() and np.abs(audio).max() > 1e-3


def shell_entry(card, total):
    """(f) ``entry()``: two consecutive blocks of the 64-voice mix, the
    carry threaded, against the port's numpy pull oracle of the same voice
    at its 64 pitches."""
    from signals_tpu_torch import entry as E
    from signals_tpu_torch.core import BlockLoc, Request, Shape
    fwd, (params, carry, pos) = E.entry()
    blocks = []
    for i in range(2):
        mix, carry = launched(f'entry forward, block {i}',
                              lambda: fwd(params, carry, pos + i * F),
                              {'segments_gen': 1}, total)
        assert mix.device.type == 'cuda'
        blocks.append(mix.cpu().numpy())
    got = np.concatenate(blocks)
    root, hz = E.subtractive_voice()
    hz.get_state().value = (110.0 * 2 ** (np.arange(V) % 12 / 12.0)).astype(
        np.float32).reshape(1, V)
    want = np.concatenate([np.broadcast_to(root.respond(Request(
        requestor=None, port='oracle', loc=BlockLoc(
            position=i * F, rate=RATE, shape=Shape(F, V)))), (F, V))
        for i in range(2)]).sum(axis=1, keepdims=True)
    err = float(np.abs(got - want).max())
    wall, dev_ms, events = profiled(lambda: fwd(params, carry, 2 * F))
    print(f'[shell] entry(): 2 blocks of the 64-voice mix {got.shape}, vs '
          f'oracle max abs {err!r} (tol {V * TOL:g}, peak '
          f'{float(np.abs(want).max())!r}); a block: wall {wall:.3f} ms, '
          f'device {dev_ms:.4f} ms in {events} kernels and copies  [{card}]')
    assert np.isfinite(got).all() and err <= V * TOL, err


def phase_shell():
    """The command layer through the port's ``Controller``, the REPL
    process and ``entry()``.  Returns, per kernel, ``(launches, what
    launched it)``."""
    card = card_line()
    total = collections.Counter()
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    patch = shell_bounce(card, total)
    print(f'[shell] phase 11 (a) bounce: {time.perf_counter() - t0:.1f} s')
    for part, run in (('(b) fit', lambda: shell_fit(card, total, patch)),
                      ('(c) play', lambda: shell_play(card, total)),
                      ('(d) save / load', lambda: shell_save_load(
                          card, total, patch)),
                      ('(e) REPL', lambda: shell_repl(card, total, patch)),
                      ('(f) entry', lambda: shell_entry(card, total))):
        t0 = time.perf_counter()
        run()
        print(f'[shell] phase 11 {part}: {time.perf_counter() - t0:.1f} s')
    print(f'[shell] phase 11: {time.perf_counter() - t_phase:.1f} s')
    how = {'segments_gen': 'the bounces, the fit and entry()',
           'segments_gen_vjp': 'the fit', 'ima': 'the adpcm bounce',
           'batch': 'play on the null sink, one a batch, and the fixture'}
    return {name: (n, f'command layer: {how[name]}')
            for name, n in total.items() if n}


# --- phase 12: the reverb under autograd and vmap -----------------------------

#: f32 operations a frame-lane: fdn_advance's 8 r*g, 8 h*fed, 7 x 8 mix sums
#: and 8 inject sums; fdn_advance_vjp's chain 8 g*Hu, 8 cotangent sums, 7
#: for the inject cotangent, 24 for the Walsh-Hadamard transform, 8 h*;
#: fdn_vjp_gain's 8 multiply-adds (16 operations)
FDN_FLOP = 80
FDN_VJP_FLOP = 55
FDN_GAIN_FLOP = 16
FDN_VOICE_T60 = (0.5, 4.0)     # (b)'s per-voice decay times, linspace
#: the device times of commit b3cf912's design (one CTA a lane group, the
#: timeline read back d_j rows behind, the gain sums on the adjoint's
#: chain) on an H100 80GB HBM3 at 700 W (PERF.md), printed beside this
#: run's
B3CF912_FDN_MS = {
    ('fdn', 1): '15.03-15.20', ('fdn', V): '66.0-66.7',
    ('fdn_vjp', 1): '20.79-20.89 (with the gain sums)',
    ('fdn_vjp', V): '6.93-7.11 (256 blocks, with the gain sums)'}
#: Reverb(size=4.0): rings of 286 KiB a lane, past a block's shared memory
FDN_BIG_SIZE = 4.0


def fdn_lengths(size=1.0):
    from signals_tpu_torch.nodes.reverb import Reverb
    rv = Reverb()
    rv.get_state().size = float(size)
    return tuple(rv._lengths(RATE, F))


def fdn_gains(t60s, lengths=None):
    """``(8, lanes)`` float32 feedback gains of decay times ``t60s`` (the
    Schroeder relation of ``Reverb._gains``)."""
    lens = np.array(lengths or fdn_lengths(), np.float32)[:, None]
    t60s = np.asarray(t60s, np.float32)[None, :]
    return np.exp(lens * (np.float32(-3.0 * np.log(10.0))
                          / (t60s * np.float32(RATE)))).astype(np.float32)


def fdn_inputs(lanes, T, seed, lengths=None):
    """Seeded ``(lines, inject, g)`` on the card: carried lines and an
    input at a reverb's levels, per-lane decay times."""
    import torch
    lengths = lengths or fdn_lengths()
    rng = np.random.default_rng(seed)
    L = max(lengths)
    t60s = (np.full(1, 2.0) if lanes == 1
            else np.linspace(*FDN_VOICE_T60, lanes))
    arrays = (0.05 * rng.standard_normal((L, 8, lanes)),
              0.02 * rng.standard_normal((T, lanes)),
              fdn_gains(t60s, lengths))
    return [torch.tensor(np.asarray(a, np.float32), device='cuda')
            for a in arrays]


def fdn_case_name(lanes, size):
    return f'{lanes} lane(s)' + (f', size {size}' if size != 1.0 else '')


def b3cf912_ms(kernel, lanes, size):
    return B3CF912_FDN_MS.get((kernel, lanes), '-') if size == 1.0 else '-'


def fdn_rings_shared(lengths):
    """Whether the FDN kernels keep these delays' rings in shared memory
    on this card (else in a global scratch buffer)."""
    from signals_tpu_torch.compiler import _build
    from signals_tpu_torch.compiler import kernels as K
    return bool(_build.library().fdn_ring_shared(K._delays(lengths)))


def fdn_kernels(card):
    """Each FDN kernel against its plain version on the card: the forward
    at the master bus's shape (one lane, 60 s), at (b)'s (64 lanes,
    per-lane gains, 60 s: clusters) and at ``Reverb(size=4.0)``'s delays
    (one lane, 60 s: the rings in global memory), bit for bit, the audio
    rows and the carry rows; the adjoint's chain and gain kernel at the
    fit's shape (one lane, 60 s), at 64 lanes over 256 blocks and at size
    4.0, within 1e-5 of each output's largest value and the same bits
    twice, and the gain kernel alone on the same inputs as its plain
    version; each kernel's device time beside its bound, the plain
    version's time and commit b3cf912's design's.  Returns ``{'fdn': {...},
    'fdn_vjp': {...}, 'fdn_vjp_gain': {...}}`` at the master bus's shape,
    the 64-lane numbers under ``lanes64_*``, size 4.0's under ``size4_*``."""
    import torch
    from signals_tpu_torch.compiler import kernels as K
    n60 = n_blocks_60s()
    out = {}

    def keep(kernel, key, numbers):
        out.setdefault(kernel, {}).update(
            numbers if not key else {key + k: v for k, v in numbers.items()
                                     if k in ('err', 'ms', 'plain_ms',
                                              'bound_ms', 'bound_by')})

    for lanes, T, size, key in ((1, n60 * F, 1.0, ''),
                                (V, n60 * F, 1.0, 'lanes64_'),
                                (1, n60 * F, FDN_BIG_SIZE, 'size4_')):
        lengths = fdn_lengths(size)
        L = max(lengths)
        lines, inject, g = fdn_inputs(lanes, T, 11 + lanes, lengths)
        K.reset_launch_counts()
        tl = K.fdn_advance(lines, inject, g, lengths)
        torch.cuda.synchronize()
        assert K.LAUNCHES['fdn'] == 1
        tl_p = K.fdn_advance_plain(lines, inject, g, lengths)
        err = float((tl - tl_p).abs().max())
        same = torch.equal(tl, tl_p)
        del tl_p
        again = K.fdn_advance(lines, inject, g, lengths)
        twice = torch.equal(tl, again)
        del tl, again
        ms, how = kernel_device_ms(
            lambda: K.fdn_advance(lines, inject, g, lengths), 3,
            ('fdn_advance',))
        plain_ms = cuda_ms(
            lambda: K.fdn_advance_plain(lines, inject, g, lengths), 2)
        nbytes = 4 * lanes * (L * 8 + T + 8 + (L + T) * 8)
        b_ms, b_by = bound(FDN_FLOP * T * lanes, nbytes)
        cluster = K.fdn_cluster(lanes)
        shared = fdn_rings_shared(lengths)
        assert shared == (size == 1.0), (size, shared)
        turn = min(lengths)
        if cluster and shared:
            from signals_tpu_torch.compiler import _build
            resident = _build.library().fdn_cluster_occupancy(
                K._delays(lengths))
            design = f'clusters of 8 CTAs, {resident} resident at once'
        else:
            design = 'clusters of 8 CTAs' if cluster else 'one CTA a lane'
        print(f'[reverb] fdn_advance, {fdn_case_name(lanes, size)} x {T} '
              f'frames ({design}, rings in '
              f'{"shared" if shared else "global"} memory; '
              f'{-(-T // turn)} turns of {turn}): vs the plain turn loop max '
              f'abs {err!r}, the same bits {same}, twice {twice}; device '
              f'{ms:.3f} ms ({how}; commit b3cf912\'s design '
              f'{b3cf912_ms("fdn", lanes, size)} ms), bound {b_ms:.4f} ms by '
              f'{b_by} (share {b_ms / ms:.4f}), plain {plain_ms:.3f} ms  '
              f'[{card}]')
        assert same and twice, (lanes, size, err)
        keep('fdn', key, {'err': err, 'ms': ms, 'device_ms': ms,
                          'device_ms_by': how, 'plain_ms': plain_ms,
                          'bound_ms': b_ms, 'bound_by': b_by})
        del lines, inject, g
        torch.cuda.empty_cache()
    for lanes, T, size, key in ((1, n60 * F, 1.0, ''),
                                (V, N_BLOCKS * F, 1.0, 'lanes64_'),
                                (1, n60 * F, FDN_BIG_SIZE, 'size4_')):
        lengths = fdn_lengths(size)
        L = max(lengths)
        lines, inject, g = fdn_inputs(lanes, T, 21 + lanes, lengths)
        tl = K.fdn_advance(lines, inject, g, lengths)
        gtl = torch.randn(tl.shape, device='cuda', generator=torch.Generator(
            'cuda').manual_seed(lanes))
        K.reset_launch_counts()
        got = K.fdn_advance_vjp(tl, g, gtl, lengths, L)
        again = K.fdn_advance_vjp(tl, g, gtl, lengths, L)
        torch.cuda.synchronize()
        assert K.LAUNCHES['fdn_vjp'] == 2 and K.LAUNCHES['fdn_vjp_gain'] == 2
        want = K.fdn_advance_vjp_plain(tl, g, gtl, lengths, L)
        rel = max(rel_max(a, w) for a, w in zip(got, want))
        twice = all(torch.equal(a, b) for a, b in zip(got, again))
        del got, again, want
        ms, how = kernel_device_ms(
            lambda: K.fdn_advance_vjp(tl, g, gtl, lengths, L), 3,
            ('fdn_advance_vjp',))
        gain_in_call, _ = kernel_device_ms(
            lambda: K.fdn_advance_vjp(tl, g, gtl, lengths, L), 3,
            ('fdn_vjp_gain',))
        plain_ms = cuda_ms(
            lambda: K.fdn_advance_vjp_plain(tl, g, gtl, lengths, L), 1)
        nbytes = 4 * lanes * ((L + T) * 8 + 8 + T * 8 + L * 8 + T)
        b_ms, b_by = bound(FDN_VJP_FLOP * T * lanes, nbytes)
        print(f'[reverb] fdn_advance_vjp + fdn_vjp_gain, '
              f'{fdn_case_name(lanes, size)} x {T} frames: vs the plain '
              f'adjoint {rel!r} of the largest value (tol 1e-5), the same '
              f'bits twice {twice}; device: chain {ms:.3f} ms ({how}), gain '
              f'{gain_in_call:.4f} ms, together {ms + gain_in_call:.3f} ms '
              f'(commit b3cf912\'s design '
              f'{b3cf912_ms("fdn_vjp", lanes, size)} ms); '
              f'chain bound {b_ms:.4f} ms by {b_by} (share {b_ms / ms:.4f}), '
              f'plain adjoint {plain_ms:.3f} ms  [{card}]')
        assert rel <= 1e-5 and twice, (lanes, size, rel)
        keep('fdn_vjp', key, {'err': rel, 'ms': ms, 'device_ms': ms,
                              'device_ms_by': how, 'plain_ms': plain_ms,
                              'bound_ms': b_ms, 'bound_by': b_by})
        # the gain kernel alone against its plain version, same inputs
        ha = torch.randn((lanes, T, 8), device='cuda',
                         generator=torch.Generator('cuda').manual_seed(3))
        K.reset_launch_counts()
        gg = K.fdn_vjp_gain(tl, ha, lengths, L)
        twice = torch.equal(gg, K.fdn_vjp_gain(tl, ha, lengths, L))
        torch.cuda.synchronize()
        assert K.LAUNCHES['fdn_vjp_gain'] == 2
        gg_p = K.fdn_vjp_gain_plain(tl, ha, lengths, L)
        rel = rel_max(gg, gg_p)
        gms, ghow = kernel_device_ms(
            lambda: K.fdn_vjp_gain(tl, ha, lengths, L), 3, ('fdn_vjp_gain',))
        gplain = cuda_ms(lambda: K.fdn_vjp_gain_plain(tl, ha, lengths, L), 3)
        gb_ms, gb_by = bound(FDN_GAIN_FLOP * T * lanes,
                             4 * lanes * (2 * T * 8 + 8))
        chunks = K.fdn_gain_chunks(T, lanes, torch.cuda.get_device_properties(
            0).multi_processor_count)
        print(f'[reverb] fdn_vjp_gain (and its chunk sum), '
              f'{fdn_case_name(lanes, size)} x {T} frames, {chunks} chunks: '
              f'vs its plain version {rel!r} of the largest value '
              f'(tol 1e-5), the same bits twice {twice}; device {gms:.4f} ms '
              f'({ghow}), bound {gb_ms:.4f} ms by {gb_by} (share '
              f'{gb_ms / gms:.4f}), plain {gplain:.3f} ms  [{card}]')
        assert rel <= 1e-5 and twice, (lanes, size, rel)
        keep('fdn_vjp_gain', key, {'err': rel, 'ms': gms, 'device_ms': gms,
                                   'device_ms_by': ghow, 'plain_ms': gplain,
                                   'bound_ms': gb_ms, 'bound_by': gb_by})
        del lines, inject, g, tl, gtl, ha
        torch.cuda.empty_cache()
    return out


def build_reverb_voice():
    """The flagship voice into its own ``Reverb`` (phase 12 (b))."""
    from signals_tpu_torch.nodes.reverb import Reverb
    voice, hz = build_subtractive_voice()
    rv = Reverb()
    rv.input = voice
    return rv, hz


def phase_reverb():
    """The reverb under autograd and ``vmap`` through the port's entry
    points.  Returns ``(per kernel {err, ms, ...}, per kernel (launches,
    what launched it))``."""
    import torch
    from signals_tpu_torch import learn
    from signals_tpu_torch.compiler import compile_node
    from signals_tpu_torch.parallel import PolyPatch
    t_phase = time.perf_counter()
    card = card_line()
    total = collections.Counter()
    n60 = n_blocks_60s()
    audio_s = n60 * F / RATE
    kern = fdn_kernels(card)
    print(f'[reverb] kernels: {time.perf_counter() - t_phase:.1f} s')

    # (a) learn.fit of the 60 s master bus: the voice's output gain, its
    # cutoff centre, the reverb's t60 and mix, against a target rendered
    # at other values
    def bus_nodes(root):
        rv = port_sig(root, 'left', 'input')
        return {'gain': (port_sig(rv, 'input', 'right'), 'value'),
                'centre': (port_sig(rv, 'input', 'left', 'left', 'cutoff',
                                    'right'), 'value'),
                't60': (rv, 't60'), 'mix': (rv, 'mix')}

    t_root = build_master_bus()
    named = bus_nodes(t_root)
    named['gain'][0].get_state().value = np.full((1, 1), 1.3 / V,
                                                 np.float32)
    named['centre'][0].get_state().value = np.full((1, 1), 2300.0,
                                                   np.float32)
    rst = named['t60'][0].get_state()
    rst.t60, rst.mix = 1.5, 0.45
    tgt = compile_node(t_root, block_frames=F, rate=RATE, channels=1,
                       device='cuda').render(n_blocks=n60)[0]
    root = build_master_bus()
    named = bus_nodes(root)
    bus = compile_node(root, block_frames=F, rate=RATE, channels=1,
                       device='cuda')
    assert bus.plan(n60) == 'mega'
    loss_fn = learn.make_loss_fn(bus, tgt)
    step_launches = {'segments_gen': 1, 'fdn': 1, 'segments_gen_vjp': 1,
                     'fdn_vjp': 1, 'fdn_vjp_gain': 1}

    def value_and_grads():
        params, leaves = bus.params(), []
        for node, pname in named.values():
            uid = bus.index.info(node).uid
            params[uid][pname] = t = params[uid][pname].requires_grad_()
            leaves.append(t)
        value = loss_fn(params)
        return value, torch.autograd.grad(value, leaves)

    v, grads = launched(f'master_bus, loss and 4 gradients, {n60} blocks',
                        value_and_grads, step_launches, total)
    with plain_kernels():
        v_p, grads_p = value_and_grads()
    for k, g, g_p in zip(named, grads, grads_p):
        rel = rel_max(g, g_p)
        print(f'[reverb] master_bus fit: {k} gradient {g.item()!r} vs the '
              f'plain kernels {g_p.item()!r}: relative {rel!r} (tol 1e-4)')
        assert torch.isfinite(g).all() and rel <= 1e-4, (k, rel)
    print(f'[reverb] master_bus fit: loss {v.item()!r} (plain kernels '
          f'{v_p.item()!r})')
    torch.cuda.reset_peak_memory_stats()
    res = fit_steps(
        f'master_bus ({n60} blocks, 4 trainables), learn.fit', lambda n:
        learn.fit(root, tgt, list(named.values()), rate=RATE, block_frames=F,
                  steps=n, learning_rate=0.02, relative_lr=True,
                  apply=False),
        8, step_launches, total, card, audio_s)
    peak = torch.cuda.max_memory_allocated()
    print(f'[reverb] master_bus fit: loss {res.losses[0]!r} -> '
          f'{res.losses[-1]!r} over 8 steps; peak memory '
          f'{peak / 2**30:.3f} GiB  [{card}]')
    assert np.isfinite(res.losses).all() and res.losses[-1] < res.losses[0]
    del tgt
    torch.cuda.empty_cache()

    # (b) 64 voices, each into its own Reverb: the vmap layout against the
    # channels layout
    mixes = {}
    for layout in ('vmap', 'channels'):
        rv, hz = build_reverb_voice()
        poly = PolyPatch(rv, n_voices=V, overrides={(hz, 'value'):
                                                    poly_freqs(V)},
                         block_frames=F, rate=RATE, layout=layout,
                         device='cuda')
        assert poly.compiled.plan(n60) == 'mega'
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mixes[layout], carry = launched(
            f'{V} reverb voices, layout {layout}, {n60} blocks',
            lambda: poly.render(n_blocks=n60),
            {'segments_gen': 1, 'fdn': 1}, total)
        wall = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        (lines,) = [c['lines'] for c in carry.values()]
        print(f'[reverb] {V} reverb voices, layout {layout}, {n60} blocks: '
              f'wall {wall:.1f} ms (first call), peak memory '
              f'{peak / 2**30:.3f} GiB, carried lines '
              f'{tuple(lines.shape)}  [{card}]')
        del poly, carry, lines
        torch.cuda.empty_cache()
    diff = float((mixes['vmap'] - mixes['channels']).abs().max())
    print(f'[reverb] {V} reverb voices: vmap vs channels layout max abs '
          f'{diff!r} (tol {V} x {TOL}), peak '
          f'{float(mixes["channels"].abs().max())!r}')
    assert torch.isfinite(mixes['vmap']).all() and diff <= V * TOL, diff
    del mixes
    torch.cuda.synchronize()
    print(f'[reverb] phase 12: {time.perf_counter() - t_phase:.1f} s')
    how = {'segments_gen': 'the master-bus fit, the 64 reverb voices',
           'fdn': 'the master-bus fit, the 64 reverb voices (one 64-lane '
                  'launch a render in both layouts)',
           'segments_gen_vjp': 'the master-bus fit',
           'fdn_vjp': 'the master-bus fit',
           'fdn_vjp_gain': 'the master-bus fit'}
    return kern, {name: (total[name], f'phase 12: {how[name]}')
                  for name in how}


# --- phase 13: the voice mesh on the card ------------------------------------

MESH_BLOCKS = 256           # the sharded renders
MESH_FIT_BLOCKS = 64        # the sharded fit's target
MESH_FIT_STEPS = 3


def mesh_poly(layout, mesh=None):
    """``(PolyPatch, its pitch node, its output gain node)``: the flagship
    (:func:`build_subtractive_voice`, V voices) in ``layout``, sharded over
    ``mesh`` when given."""
    from signals_tpu_torch.parallel import PolyPatch
    root, hz = build_subtractive_voice()
    kw = {'channels': 1} if layout == 'vmap' else {}
    poly = PolyPatch(root, n_voices=V, overrides={(hz, 'value'):
                                                  poly_freqs(V)},
                     block_frames=F, rate=RATE, layout=layout, mesh=mesh,
                     device='cuda', **kw)
    return poly, hz, root._ports['right'].sig


def mesh_fit(mesh, target, total):
    """:data:`MESH_FIT_STEPS` steps of ``PolyPatch.fit`` (vmap layout, L2
    against ``target``) of the per-voice pitches and the shared output
    gain, with the launch counts asserted: ``(losses, {'hz': gradients a
    step, 'gain': ...})``, the gradients those the updates used."""
    import torch
    from signals_tpu_torch import learn
    poly, hz, gain = mesh_poly('vmap', mesh)
    index = poly.compiled.index
    role = {(index.info(hz).uid, 'value'): 'hz',
            (index.info(gain).uid, 'value'): 'gain'}
    seen = {'hz': [], 'gain': []}
    descent = learn.fused_descent

    def spy(loss_fn, train, **kw):
        # a hook on each trained leaf sees the gradient the update uses
        # (the shared one after the mesh's sum over the ranks)
        hooks = [train[uid][k].register_hook(
            lambda g, who=role[(uid, k)]:
                seen[who].append(g.detach().reshape(-1).clone()))
            for uid in train for k in train[uid]]
        try:
            return descent(loss_fn, train, **kw)
        finally:
            for h in hooks:
                h.remove()

    learn.fused_descent = spy
    try:
        res = launched(
            f'voice mesh: PolyPatch.fit, vmap layout, '
            f'{"sharded" if mesh is not None else "no mesh"}, '
            f'{MESH_FIT_STEPS} steps', lambda: poly.fit(
                target, [(hz, 'value'), (gain, 'value')],
                steps=MESH_FIT_STEPS, learning_rate=0.01,
                loss=lambda a, b: torch.mean((a - b) ** 2), apply=False),
            {'segments_gen': MESH_FIT_STEPS,
             'segments_gen_vjp': MESH_FIT_STEPS}, total)
    finally:
        learn.fused_descent = descent
    return res.losses, {k: torch.stack(v).cpu().numpy()
                        for k, v in seen.items()}


def reduce_device_ms(fn):
    """The device time of the mix's reduction in one call of ``fn`` (after a
    warmup call): ``(ms, the events' names)`` of the NCCL kernels in a
    ``torch.profiler`` trace, or of the device-to-device copies where NCCL
    ran none (one rank)."""
    import torch

    def call():
        fn()
        torch.cuda.synchronize()

    call()
    _, cuda = trace.profile(call)
    picked = [e for e in cuda if 'nccl' in e[0].lower()] or [
        e for e in cuda if 'memcpy dtod' in e[0].lower()]
    return (sum(us for _, _, us in picked) / 1e3,
            sorted({name[:60] for name, _, _ in picked}))


def phase_mesh():
    """The voice mesh on the card: a one-rank NCCL group (a ``file://``
    store under ``build/``), the flagship rendered through ``PolyPatch(
    mesh=voice_mesh(1))`` in both layouts and held bit for bit to the same
    patch without a mesh (a sum over one rank is a copy), a sharded
    ``PolyPatch.fit`` of a per-voice and a shared trainable against the
    unsharded fit (1e-4 relative), the reduction's device time and the
    walls.  Tears the group down.  Returns, per kernel, ``(launches, what
    launched it)``."""
    import os
    import pathlib

    import torch
    import torch.distributed as dist
    from signals_tpu_torch.parallel import voice_mesh
    card = card_line()
    total = collections.Counter()
    t_phase = time.perf_counter()
    store = (pathlib.Path(__file__).resolve().parent / 'build' /
             f'mesh_store_{os.getpid()}')
    store.parent.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    torch.cuda.set_device(0)
    dist.init_process_group('nccl', init_method=f'file://{store}',
                            world_size=1, rank=0)
    try:
        mesh = voice_mesh(1)
        assert mesh.device_type == 'cuda' and mesh.size() == 1
        print(f'[mesh] process group: {dist.get_backend()}, world size '
              f'{dist.get_world_size()}; mesh {mesh}  [{card}]')
        for layout in ('channels', 'vmap'):
            plain, _, _ = mesh_poly(layout)
            sharded, _, _ = mesh_poly(layout, mesh)
            name = f'flagship, {layout} layout, {MESH_BLOCKS} blocks'
            want = launched(f'voice mesh: {name}, no mesh',
                            lambda: plain.render(n_blocks=MESH_BLOCKS)[0],
                            {'segments_gen': 1})
            got = launched(f'voice mesh: {name}, sharded over 1 rank',
                           lambda: sharded.render(n_blocks=MESH_BLOCKS)[0],
                           {'segments_gen': 1}, total)
            assert got.shape == (MESH_BLOCKS * F, 1)
            assert bool(torch.isfinite(got).all())
            same = torch.equal(got, want)
            w_plain = wall_ms(lambda: plain.render(n_blocks=MESH_BLOCKS)[0])
            w_mesh = wall_ms(lambda: sharded.render(n_blocks=MESH_BLOCKS)[0])
            red_ms, red_names = reduce_device_ms(
                lambda: sharded.render(n_blocks=MESH_BLOCKS)[0])
            print(f'[mesh] {name}: sharded over voice_mesh(1) '
                  f'{"the same bits as" if same else "DIFFERS from"} the '
                  f'render without a mesh; wall {w_mesh:.3f} ms (no mesh '
                  f'{w_plain:.3f} ms, fastest of 3); the all_reduce of the '
                  f'({MESH_BLOCKS * F}, 1) mix: device {red_ms:.4f} ms '
                  f'({red_names})  [{card}]')
            assert same, name
            del plain, sharded, got, want
        target, _ = mesh_poly('channels')[0].render(n_blocks=MESH_FIT_BLOCKS)
        target = 0.5 * target
        t0 = time.perf_counter()
        losses, grads = mesh_fit(mesh, target, total)
        fit_s = time.perf_counter() - t0
        want_losses, want_grads = mesh_fit(None, target, collections.Counter())
        loss_rel = rel_max(torch.as_tensor(np.asarray(losses)),
                           torch.as_tensor(np.asarray(want_losses)))
        print(f'[mesh] sharded PolyPatch.fit, {MESH_FIT_STEPS} steps, '
              f'{MESH_FIT_BLOCKS} blocks: losses {list(losses)} vs no mesh '
              f'{list(want_losses)}: relative {loss_rel!r} (tol 1e-4); '
              f'{fit_s:.2f} s with the first step  [{card}]')
        assert loss_rel <= 1e-4, loss_rel
        for role in ('hz', 'gain'):
            err = rel_max(torch.as_tensor(grads[role]),
                          torch.as_tensor(want_grads[role]))
            print(f'[mesh] sharded PolyPatch.fit: {role} gradients of '
                  f'{MESH_FIT_STEPS} steps {grads[role].shape} vs no mesh: '
                  f'relative {err!r} (tol 1e-4)')
            assert err <= 1e-4, (role, err)
    finally:
        dist.destroy_process_group()
        if store.exists():
            store.unlink()
    print(f'[mesh] phase 13: {time.perf_counter() - t_phase:.1f} s')
    return {'segments_gen': (total['segments_gen'], 'voice mesh: the '
                             'sharded renders of both layouts and the '
                             'sharded fit'),
            'segments_gen_vjp': (total['segments_gen_vjp'],
                                 'voice mesh: the sharded fit')}



# --- phase 14: the realtime soak on the card ----------------------------------

SOAK_VOICE_S = 65.0     # tests/test_soak.py's lengths
SOAK_ECHO_S = 35.0
#: the kernels one render of each soak's patch launches: one render a
#: Transport batch and one for the warmup
SOAK_KERNELS = {'voice': {'segments_gen': 1},
                'echo': {'segments_gen': 1, 'stream': 1}}


def load_script(rel):
    """The module of the script at ``rel`` (from the repository root),
    imported by path: its ``__main__`` block does not run."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent / rel
    spec = importlib.util.spec_from_file_location(
        f'chip_smoke_{path.stem}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def soak_run(soak, seconds, patch, card, total):
    """``scripts/torch_soak.py``'s soak of ``patch`` on the card for
    ``seconds``, its launch counts reset just before it and held just
    after to :data:`SOAK_KERNELS` times the renders (the Transport's
    batches, counted, and the warmup).  Returns the report."""
    import torch
    from signals_tpu_torch.compiler import kernels as K
    from signals_tpu_torch.runtime import Transport
    batches = []
    render = Transport._render

    def counted(self, n_blocks):
        batches.append(n_blocks)
        return render(self, n_blocks)

    Transport._render = counted
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        report = soak.soak(seconds, patch=patch, device='cuda',
                           progress=lambda msg: None)
    finally:
        Transport._render = render
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = dict(K.LAUNCHES)
    renders = len(batches) + 1
    want = {k: SOAK_KERNELS[patch].get(k, 0) * renders for k in counts}
    print(f'[launches] soak, {patch}: {counts} ({len(batches)} batches of '
          f'{min(batches)}-{max(batches)} blocks, {sum(batches)} blocks, '
          f'and the warmup)')
    lat = report['latency']
    print(f'[soak] {patch}, {seconds} s ({wall:.1f} s wall): '
          f'{report["underruns_after_warmup"]} underruns after the warmup '
          f'(warmup {report["warmup_underruns"]}, seek windows '
          f'{report["seek_window_underruns"]}), {report["edits"]} edits, '
          f'seeks {report["seeks"]}, position {report["position_blocks"]} '
          f'blocks; {lat["blocks"]} blocks rendered, p50 '
          f'{lat["p50_ms"]!r} / p95 {lat["p95_ms"]!r} / worst '
          f'{lat["worst_ms"]!r} ms a block, x_realtime_p50 '
          f'{lat["x_realtime_p50"]!r}; kernels a batch '
          f'{SOAK_KERNELS[patch]}  [{card}]')
    print(f'[soak] report: {json.dumps(report)}')
    assert counts == want, (patch, counts, want)
    total.update(counts)
    return report


def phase_soak():
    """The realtime soak on the card (``scripts/torch_soak.py``): the mono
    voice for 65 s and the damped echo for 35 s through the realtime
    ``null`` sink, the native ring and the paced consumer, under live
    edits and two seeks, each held to ``tests/test_soak.py``'s whole
    contract and its launch counts asserted.  Returns, per kernel,
    ``(launches, what launched them)``."""
    card = card_line()
    total = collections.Counter()
    t_phase = time.perf_counter()
    soak = load_script('scripts/torch_soak.py')
    block_ms = 1000.0 * F / RATE
    voice = soak_run(soak, SOAK_VOICE_S, 'voice', card, total)
    lat = voice['latency']
    assert voice['underruns_after_warmup'] == 0, voice
    assert voice['edits'] >= 30, voice
    assert len(voice['seeks']) == 2, voice
    assert voice['position_blocks'] > SOAK_VOICE_S * RATE / F * 0.95, voice
    assert lat['blocks'] > 2000, lat
    assert lat['x_realtime_p50'] > 3.0, lat
    assert lat['p95_ms'] < block_ms, lat
    echo = soak_run(soak, SOAK_ECHO_S, 'echo', card, total)
    assert echo['underruns_after_warmup'] == 0, echo
    assert echo['position_blocks'] > 0, echo
    assert len(echo['seeks']) == 2, echo
    print(f'[soak] phase 14: {time.perf_counter() - t_phase:.1f} s')
    return {k: (n, 'realtime soak: the voice 65 s and the echo 35 s, one '
                   'a render') for k, n in total.items() if n}


# --- phase 15: the examples on the card ---------------------------------------

#: ``examples_torch/*.py``: the files each ``main`` writes, the patch's
#: voices (the tolerance against the CPU render is 1e-5 a voice; the pcm16
#: AIFF one LSB) and the kernels a run launches
#: (a static cutoff over fewer than 32 lanes takes K3, the segment gate)
EXAMPLES = {
    'feedback_echo': (['echo.wav'], 1, {'batch': 1}),
    'poly_bounce': (['poly_bounce.wav'], 16, {'batch': 1}),
    'melody': (['melody.wav'], 1, {'batch': 1}),
    'midi_poly': (['demo.mid', 'midi_poly.wav'], 8, {'batch': 1}),
    'modulation': (['modulation.wav'], 1, {}),
    'space_echo': (['space_echo.aiff'], 1, {'batch': 1, 'fdn': 1}),
    'fit_patch': ([], 1, {}),
    'play_sine': ([], 1, {}),
}


def read_sound(path):
    from signals_tpu_torch.runtime.sndfile import open_reader
    r = open_reader(str(path))
    try:
        return r.read(0, r.frames)
    finally:
        r.close()


@contextlib.contextmanager
def recorded_fits(mod):
    """Record each ``learn.fit`` and ``PolyPatch.fit`` that ``mod`` (the
    ``fit_patch`` example) makes: ``[{'losses', 'value'}]``, float64
    tensors of its losses and of the values fitted into its first
    trainable."""
    import torch
    from signals_tpu_torch.parallel import PolyPatch
    fits = []
    if not hasattr(mod, 'fit'):
        yield fits
        return
    fit, poly_fit = mod.fit, PolyPatch.fit

    def record(result, value):
        fits.append({k: torch.as_tensor(np.ravel(v).astype(np.float64))
                     for k, v in (('losses', result.losses),
                                  ('value', value))})
        return result

    def fit_recorded(root, target, trainable, **kw):
        result = fit(root, target, trainable, **kw)
        return record(result, trainable[0][0].get_state().value)

    def poly_fit_recorded(self, target, trainable, **kw):
        result = poly_fit(self, target, trainable, **kw)
        node = trainable[0][0]
        return record(result, next(s for n, _p, _a, s
                                   in self._channel_overrides if n is node))

    mod.fit, PolyPatch.fit = fit_recorded, poly_fit_recorded
    try:
        yield fits
    finally:
        mod.fit, PolyPatch.fit = fit, poly_fit


def example_run(name, card, total):
    """``examples_torch/<name>.py``'s ``main`` on the card, its outputs
    under ``build/chip_smoke/examples/cuda``, its launch counts reset just
    before it and checked just after; then on the CPU in this process
    (``build/.../cpu``), and the card's file held to the CPU's.  Returns
    the card run's wall (s)."""
    import io
    files, voices, expect = EXAMPLES[name]
    mod = load_script(f'examples_torch/{name}.py')
    out = {}
    for device in ('cuda', 'cpu'):
        d = work_dir() / 'examples' / device
        d.mkdir(parents=True, exist_ok=True)
        args = [str(d / f) for f in files]
        said = io.StringIO()
        with contextlib.redirect_stdout(said), \
                recorded_fits(mod) as fits:
            t0 = time.perf_counter()
            if device == 'cuda':
                got = launched(f'example {name}',
                               lambda: mod.main(*args, device=device),
                               expect, total)
            else:
                got = mod.main(*args, device=device)
            wall = time.perf_counter() - t0
        out[device] = (args, got, fits, wall)
        for line in said.getvalue().splitlines():
            print(f'[examples] {name} ({device}, {wall:.2f} s wall): {line}')
    (args, got, fits, wall), (cargs, cgot, cfits, _) = out['cuda'], out['cpu']
    if files:
        a, b = read_sound(args[-1]), read_sound(cargs[-1])
        assert a.shape == b.shape and a.shape[0] > RATE, (a.shape, b.shape)
        assert np.isfinite(a).all() and np.abs(b).max() > 0.1
        err = float(np.abs(a.astype(np.float64) - b).max())
        tol = 1.0 / 32768 if files[-1].endswith('.aiff') else voices * 1e-5
        print(f'[examples] {name}: {files[-1]} on the card vs the CPU '
              f'render: max abs {err!r} (tol {tol!r})  [{card}]')
        assert err <= tol, (name, err)
        if len(files) > 1:
            assert open(args[0], 'rb').read() == open(cargs[0], 'rb').read()
    elif name == 'fit_patch':
        assert len(fits) == len(cfits) == 3
        rels = [rel_max(g['value'], c['value'])
                for g, c in zip(fits[:2], cfits[:2])]
        rels.append(rel_max(fits[2]['losses'][:50], cfits[2]['losses'][:50]))
        print(f'[examples] fit_patch: the gain and the pitch fitted on the '
              f'card vs the CPU, and the poly fit\'s first 50 losses: '
              f'relative {rels!r} (tol 1e-4); the card\'s values '
              f'{[float(g["value"][0]) for g in fits[:2]]}, poly losses '
              f'{float(fits[2]["losses"][0])!r} -> '
              f'{float(fits[2]["losses"][-1])!r}  '
              f'[{card}]')
        assert max(rels) <= 1e-4, rels
    else:                                   # play_sine: the captured audio
        n = min(got.shape[0], cgot.shape[0])
        err = float(np.abs(got[:n] - cgot[:n]).max())
        print(f'[examples] play_sine: {got.shape[0]} frames captured on the '
              f'card ({cgot.shape[0]} on the CPU), the first {n} within '
              f'{err!r} of the CPU\'s (tol {TOL}), peak '
              f'{float(np.abs(got).max())!r}')
        assert n >= RATE and err <= TOL and np.abs(got).max() > 0.5
    return wall


def sink_fed_flagship(card, total):
    """The flagship whose root also feeds a sink: the mix epilogue's
    soundness walk stops at the sink (it raised there before) and rejects
    the epilogue, so the patch takes the per-voice plan (one K1 launch
    writing every lane, not the lanes' sums), within 64 x 1e-5 of the
    same patch without a sink on the mix plan (one K1 launch summing the
    lanes)."""
    from signals_tpu_torch.nodes.dev import Rack, SinkDevice
    from signals_tpu_torch.parallel import PolyPatch
    rack = Rack()
    rack.scan()
    mixed = make_poly()
    root, hz = build_subtractive_voice()
    sink = SinkDevice(rack.get_sink('default'), realtime=False,
                      device='cuda')
    sink.get_state().channels = 1
    sink.input = root
    fed = PolyPatch(root, n_voices=V, overrides={(hz, 'value'): poly_freqs(V)},
                    block_frames=F, rate=RATE, layout='channels',
                    device='cuda')
    assert fed._mix_epilogue and mixed.compiled.mega_mix(N_BLOCKS) is not None
    want = launched('flagship, mix plan', lambda: mixed.render(
        n_blocks=N_BLOCKS)[0], {'segments_gen': 1}, total)
    plan = 'mix' if fed.compiled.mega_mix(N_BLOCKS) is not None else \
        'per-voice'
    got = launched('flagship feeding a sink', lambda: fed.render(
        n_blocks=N_BLOCKS)[0], {'segments_gen': 1}, total)
    err = float((got - want).abs().max())
    print(f'[examples] the flagship feeding a sink, {N_BLOCKS} blocks: the '
          f'{plan} plan, K1 x1; vs the mix plan without the sink: max abs '
          f'{err!r} (tol {V * TOL})  [{card}]')
    assert plan == 'per-voice' and err <= V * TOL, (plan, err)


def phase_examples():
    """The eight examples on the card (``examples_torch/``), each with its
    launch counts asserted and its output held to the same script's CPU
    run, and the flagship feeding a sink.  Returns, per kernel,
    ``(launches, what launched them)``."""
    card = card_line()
    total = collections.Counter()
    t_phase = time.perf_counter()
    walls = {name: example_run(name, card, total) for name in EXAMPLES}
    flagship = collections.Counter()
    sink_fed_flagship(card, flagship)
    print(f'[examples] walls on the card (s): '
          f'{ {k: round(v, 3) for k, v in walls.items()} }  [{card}]')
    print(f'[examples] phase 15: {time.perf_counter() - t_phase:.1f} s')
    found = {k: (n, 'examples_torch: ' + ', '.join(
        name for name, (_f, _v, e) in EXAMPLES.items() if k in e))
        for k, n in total.items() if n}
    for k, n in flagship.items():
        if n:
            m, how = found.get(k, (0, ''))
            found[k] = (m + n, (how + '; ' if how else '') + 'the flagship '
                        'feeding a sink, and without it')
    return found


def kernel_ms(k):
    """``(ms, how)``: a kernel's own time, beside its bound — its device
    time by the profiler or by a CUDA graph of calls
    (:func:`kernel_device_ms`; a call's CUDA-events time, host dispatch
    included, is longer than the zero-state kernels), or that CUDA-events
    time where a segment kernel's traces lost events."""
    if k['device_ms'] is not None:
        return k['device_ms'], f"device, {k.get('device_ms_by', 'profiler')}"
    return k['ms'], 'CUDA events, wrapper included'


def main() -> int:
    try:
        import torch
        import signals_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f'chip_smoke: cannot import the port ({e}); run it from the '
              f'repository root', file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA GPU visible to torch', file=sys.stderr)
        return 2
    assert 'jax' not in sys.modules and 'signals_tpu' not in sys.modules
    phase_build()
    kern = phase_kernels()
    launches = {name: (n, f'flagship render, {how}')
                for name, (n, how) in phase_render().items()}
    launches.update(phase_paths())
    phases = [phase_state(), phase_checks()]
    vjp, fit_launches = phase_fit()
    kern.update(vjp)
    phases.append(phase_files(kern))
    phases.append(phase_sequencing())
    out_launches, kern['ima'] = phase_output()
    phases.append(out_launches)
    phases.append(phase_shell())
    fdn, reverb_launches = phase_reverb()
    kern.update(fdn)
    phases.append(reverb_launches)
    phases.append(phase_mesh())
    phases.append(phase_soak())
    phases.append(phase_examples())
    for found in phases + [fit_launches]:
        for name, (n, how) in found.items():
            if name in launches:     # a kernel on several phases' paths
                n, how = n + launches[name][0], f'{launches[name][1]}; {how}'
            launches[name] = (n, how)
    assert 'jax' not in sys.modules and 'signals_tpu' not in sys.modules
    csrc = 'signals_tpu_torch/compiler/csrc/'
    pk = 'signals_tpu/compiler/pallas_kernels.py:'
    where = {'segments_gen': ('segments.cu', '1228'),
             'segments': ('segments.cu', '519'),
             'batch': ('rows.cu', '288'),
             'timeline': ('rows.cu', '34'),
             # the carried-state entry of the timeline kernel's template;
             # the JAX package runs signals_tpu/compiler/filters.py:200
             # (an associative scan inside its XLA program)
             'stream': ('rows.cu', '34'),
             # the backward kernels: the analytic adjoint of the cascade
             # (signals_tpu/compiler/filters.py:620) under each entry's
             # custom VJP in pallas_kernels.py
             'segments_gen_vjp': ('adjoint.cu', '1788'),
             'segments_vjp': ('adjoint.cu', '1723'),
             'rows_vjp': ('adjoint.cu', '1632')}
    filters_adjoint = 'signals_tpu/compiler/filters.py:620 and '
    print(json.dumps({'kernels': [
        {'name': f'sosfilt_{name}', 'route': 'cuda',
         'source': csrc + where[name][0],
         'replaces': ((filters_adjoint if name.endswith('_vjp') else '')
                      + pk + where[name][1]),
         'launches': launches[name][0], 'launched_by': launches[name][1],
         'max_abs_err': kern[name]['err'],
         'ms': kernel_ms(kern[name])[0], 'ms_by': kernel_ms(kern[name])[1],
         'call_ms': kern[name]['ms'],
         'plain_ms': kern[name]['plain_ms'],
         'bound_ms': kern[name]['bound_ms'],
         'bound_by': kern[name]['bound_by'],
         # no PyTorch call computes a recursive biquad cascade
         'library_ms': None,
         **{k: v for k, v in kern[name].items() if k.startswith('noise_')}}
        for name in where] + [
        # new work, no port of a Pallas kernel: the JAX package's IMA
        # encoder is one lax.scan over the in-block samples
        {'name': 'ima_encode', 'route': 'cuda', 'source': csrc + 'codecs.cu',
         'replaces': 'signals_tpu/runtime/codecs.py:895',
         'launches': launches['ima'][0], 'launched_by': launches['ima'][1],
         'max_abs_err': kern['ima']['err'],
         'ms': kernel_ms(kern['ima'])[0], 'ms_by': kernel_ms(kern['ima'])[1],
         'call_ms': kern['ima']['ms'], 'plain_ms': kern['ima']['plain_ms'],
         'bound_ms': kern['ima']['bound_ms'],
         'bound_by': kern['ima']['bound_by'],
         'chain_floor_ms': kern['ima']['chain_floor_ms'],
         'library_ms': None}] + [
        # new work, no port of a Pallas kernel: the JAX package scans the
        # reverb's network block by block and differentiates the scan
        {'name': name, 'route': 'cuda', 'source': csrc + 'fdn.cu',
         'replaces': replaces, 'launches': launches[key][0],
         'launched_by': launches[key][1], 'max_abs_err': kern[key]['err'],
         'ms': kernel_ms(kern[key])[0], 'ms_by': kernel_ms(kern[key])[1],
         'plain_ms': kern[key]['plain_ms'],
         'bound_ms': kern[key]['bound_ms'],
         'bound_by': kern[key]['bound_by'],
         # no PyTorch call computes a feedback delay network
         'library_ms': None,
         **{k: v for k, v in kern[key].items()
            if k.startswith(('lanes64_', 'size4_'))}}
        for name, key, replaces in (
            ('fdn_advance', 'fdn', 'signals_tpu/nodes/reverb.py:189'),
            ('fdn_advance_vjp', 'fdn_vjp', 'signals_tpu/nodes/reverb.py:'
             '171-189 (JAX autodiff of the scan)'),
            ('fdn_vjp_gain', 'fdn_vjp_gain', 'signals_tpu/nodes/reverb.py:'
             '171-189 (JAX autodiff of the scan: the gains\' cotangent)'))]}))
    print(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
