"""The roofline arithmetic of the filter kernels, frozen here so that a
kernel that replaces one of them is held to the same count.

Operations and bytes count the work that a call's shapes need: each input
byte read once, each output byte written once, every row of every window
through every section (the context rows a segment or a block replays are
part of the filter's definition), the oscillator synthesised once a row.
The peaks are the H100 SXM's published ones (float32 outside the tensor
cores, HBM3), which assume its full 700 W.
"""

from __future__ import annotations

PEAK_F32 = 67e12          # FLOP/s
PEAK_BYTES = 3.35e12      # bytes/s
CASCADE_FLOP = 12         # per section and row: y (5), s1' (4), s2' (3)
VJP_FLOP = 38             # per section and row: the row again (12), its
                          # adjoint (14 gradient sums, 2 input, 10 lambda)
SAW_FLOP = 13             # the saw: 3 frac (2 each) and 7 mul/add
SAW_PH0_FLOP = 10         # the same at phase 0 with hz >= 0
F32 = 4


def bound_s(flops: float, nbytes: float) -> tuple[float, str]:
    """``(seconds, 'operations' | 'bytes')``: the least time the card could
    take, and which of the two sets it."""
    ops, by = flops / PEAK_F32, nbytes / PEAK_BYTES
    return (ops, 'operations') if ops >= by else (by, 'bytes')


def synth_rows(n_segments: int, rows: int, context: int, first_frame: int,
               lanes: int) -> int:
    """Rows with a frame index >= 0 (the rest are zeros, not synthesised)
    of ``n_segments`` segments of ``rows`` rows a lane, the first segment's
    first row at frame ``first_frame - context``."""
    total = 0
    for s in range(n_segments):
        start = first_frame - context + s * (rows - context)
        total += min(rows, max(0, start + rows))
    return total * lanes


def k1_work(*, blocks: int, voices: int, context: int, blocks_per_seg: int,
            block_frames: int, nsec: int = 1, summed: bool = True,
            first_frame: int = 0, phase0: bool = True) -> tuple[int, int]:
    """``(flops, bytes)`` of one generator-fed segment-kernel call (K1,
    ``seg_cascade<GEN=true>`` with its ``sum_partials``): ``blocks // m``
    segments of ``context + m F`` rows a lane, a sawtooth synthesised a
    row at frame >= 0, the cascade a section-row, one add a row into the
    voice sum when ``summed``; bytes: per-block coefficients of every lane
    (11 floats a section), the lanes' oscillator parameters (4 floats), the
    output once (the sum, or every lane)."""
    m, F = blocks_per_seg, block_frames
    segs = blocks // m
    rows = segs * voices * (context + m * F)
    synth = synth_rows(segs, context + m * F, context, first_frame, voices)
    flops = (rows * (CASCADE_FLOP * nsec + (1 if summed else 0))
             + synth * (SAW_PH0_FLOP if phase0 else SAW_FLOP))
    nbytes = (blocks * nsec * voices * 11 * F32 + 4 * voices * F32
              + blocks * F * (1 if summed else voices) * F32)
    return flops, nbytes


def k3_work(*, windows: int, lanes: int, context: int, tail: int,
            nsec: int = 1) -> tuple[int, int]:
    """``(flops, bytes)`` of one batched-replay call (K3, ``rows_cascade``)
    over ``windows`` windows of ``context + tail`` rows read in place from
    one timeline ``tail`` rows apart, ``lanes`` lanes, the last ``tail``
    rows of each kept: the timeline's distinct rows read, the kept rows
    written, the coefficients read."""
    L = context + tail
    flops = L * windows * lanes * CASCADE_FLOP * nsec
    timeline = (L - tail + windows * tail) * lanes
    nbytes = F32 * (timeline + tail * windows * lanes
                    + windows * nsec * lanes * 11)
    return flops, nbytes


def b3_work(*, windows: int, lanes: int, rows: int, tail: int,
            nsec: int = 1, timeline_rows: int = None,
            state: bool = False) -> tuple[int, int]:
    """``(flops, bytes)`` of one backward replay call (B3,
    ``rows_cascade_vjp``): every row of every window forward again and
    back; bytes: the input's distinct elements (``timeline_rows`` a lane,
    default every window's rows), the output cotangent, the input
    cotangent of every window row, the coefficients read and their
    gradient written, and with ``state`` the start state, the end state's
    cotangent and the start state's."""
    x = (rows * windows if timeline_rows is None else timeline_rows) * lanes
    flops = rows * windows * lanes * nsec * VJP_FLOP
    co = windows * nsec * lanes * 11
    nbytes = F32 * (x + tail * windows * lanes + rows * windows * lanes
                    + 2 * co + (3 * windows * nsec * 2 * lanes if state
                                else 0))
    return flops, nbytes
