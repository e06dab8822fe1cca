// Backward kernels for Hopper (sm_90a): the analytic adjoint of the
// coupled-form biquad cascade, behind every kernel entry.
//
// The JAX package wraps each kernel entry of
// signals_tpu/compiler/pallas_kernels.py in jax.custom_vjp (_make_cv and the
// _*_cv wrappers, :1574-1869): the forward is the Pallas kernel, the backward
// the VJP of the associative-scan reference under the analytic adjoint of
// signals_tpu/compiler/filters.py:620-700 (_make_cascade_sections).  Here the
// backward is a kernel too, one template per forward template:
//   * seg_cascade_vjp<GEN=true, OSC, NSEC> (B1) <- _segments_gen_cv, the
//     backward of sosfilt_segments_gen (K1); the section-0 input is
//     synthesized again in registers (synth.cuh, K1's own synthesis)
//   * seg_cascade_vjp<GEN=false, 0, NSEC>  (B2) <- _segments_cv, the
//     backward of sosfilt_segments (K2); the input is read from the timeline
//     through its strides (a lane stride of 0 is one channel)
//   * rows_cascade_vjp<NSEC>               (B3) <- _batch_cv / _pallas_cv,
//     the backward of sosfilt_batch (K3), sosfilt_timeline (K4) and the
//     carried-state entry sosfilt_stream: from a start state zi, with the
//     end state's cotangent gzf in and the start state's gzi out
//
// What computes.  Per section, with R = [[rc, -rs], [rs, rc]], the lagged
// state s_{t-1} (before row t) and the section's input v_t, the forward row
// is y_t = d0 v_t + d1 s1_{t-1} + d2 s2_{t-1}, s_t = R s_{t-1} + (v_t, 0).
// Its adjoint runs the same recurrence backwards in time with the rotation
// transposed: lambda_t, the cotangent of the state after row t, starts at
// gzf (zero for the segment kernels) and steps
//   lambda_{t-1} = R_t^T lambda_t + (d1, d2) ybar_t,
// the input's cotangent is vbar_t = d0 ybar_t + lambda1_t (the previous
// section's ybar), and the coefficient gradients are the sums
//   rcbar = sum lambda1_t s1_{t-1} + lambda2_t s2_{t-1},
//   rsbar = sum lambda2_t s1_{t-1} - lambda1_t s2_{t-1},
//   d0bar, d1bar, d2bar = sum ybar_t (v_t, s1_{t-1}, s2_{t-1}),
// per coefficient block; lambda after row 0 is gzi.  The segment kernels'
// context rows have ybar = 0 (the forward never writes them) but lambda
// runs through them under block 0's coefficients, so they add to block 0's
// gradients and to the input's cotangent.  With sum_groups = g lane l
// reads the cotangent of its group, l / g (the forward writes the sum of
// each g-lane group).  Columns 6-10 of the coefficients' gradient (rc rs d0
// d1 d2) are written; the caller zeroes the buffer, and no kernel reads
// columns 0-5.
//
// B1 / B2: a time-sliced adjoint scan, with no buffer in global memory.
// With s = s1 + i s2 and p = rc + i rs a forward row is s' = p s + v, and
// R^T is multiplication by conj(p), so with lambda = l1 + i l2 an adjoint
// row is lambda' = conj(p) lambda + (d1 + i d2) ybar: both are affine maps
// that compose over any run of rows (scan.cuh).  Each carry segment's C +
// m*F rows are cut into slices as the forward kernels cut them
// (plan_slices), one thread per (slice, lane), a block holding lt lanes x
// all the slices of one segment:
//   1. the forward states: per section, first to last, each slice's map
//      from zero state and slice_start's exclusive scan give its true start
//      (section s's pass replays the sections before it from theirs); the
//      last section's pass stores, at each kRows-row chunk's start, every
//      section's state and the last section's transfer so far, so that the
//      true state there is a fix-up (linear in the start state);
//   2. the adjoint's lambda, per section, last to first: each slice's map
//      from zero (its transfer is conj of the forward's), walked from the
//      slice's last row back, and the reversed scan (slice_start<true>)
//      gives lambda after the slice's last row; section s-1's ybar is
//      section s's input cotangent, so its pass replays section s's lambda
//      from its true value.  The lambda recurrence reads no forward state;
//   3. the replay, chunk by chunk from the last: each chunk's forward rows
//      recomputed from its stored start state (cascade_step, straight-line
//      code), then each section's adjoint rows back over them (bwd_row),
//      summing the gradients and writing the input's cotangent;
//   4. each slice keeps one partial gradient per coefficient block it
//      touches (in shared memory), and one thread per (block, section,
//      lane, column) sums the slices' partials in slice order and writes
//      it once: no atomics, the same bits on every call.
// A chunk that is one coefficient block and kRows rows of the slice runs
// without per-row tests; one that holds a block boundary or the segment's
// end tests each row.  The checkpoints cost (NSEC + 1) complex numbers a
// chunk and lane, lt x n_rows x (NSEC + 1) / 2 bytes a block in all: lt is
// halved until they fit the card's shared memory (a carry segment of more
// than ~150 000 rows at two sections is refused).  B2's overlapping
// windows are folded into the timeline by the caller
// (kernels._fold_windows: shifted adds, no atomics).
//
// What bounds B1 / B2 on this card.  Measured on an H100 80GB HBM3 at
// 700 W, against the serial walk they replaced in the same process
// (scripts/torch_vjp_variants.py, PERF.md): B1 at the flagship fit (64
// blocks, m 8, C 512, sum of 64) 0.0561 ms (3.209 before), at c8 (43
// blocks, C 1024, per lane) 0.0490 ms (1.114); B2 at c9 (517 windows x 64
// lanes, C 1024) 0.4288 ms (2.112), 778 MiB over its inputs (1296 with the
// scratch).  B1's bound is operations (one forward row and its adjoint a
// section-row, the saw once: 0.0032 ms at the flagship fit); the design
// spends more on recomputation — NSEC forward passes, NSEC lambda passes
// and the replay, ~50 instructions a section-row, the saw twice — with
// ~70 000 threads a launch, ~16 warps an SM at 126-128 registers (two
// sections spill ~400 bytes).  B2's bound is bytes (x, gy and gx once:
// 0.1224 ms at c9); the design moves 2.6x that (x and gy twice), 1.08 GB
// at ~2.5 TB/s.
//
// B3: one thread per (window, lane).  It walks its rows forward from zi
// and stores each section's lagged state and each later section's input in
// a scratch buffer in global memory, lane-minor (slot k of row r at (r *
// slots + k) * columns + column), so that a warp's stores and loads
// coalesce; then it walks the rows backwards, summing the gradients
// serially.  It is latency-bound: its time-sliced redesign is the next
// step (ROADMAP).
//
// Rounding: the cascade's and the scans' multiply-adds are left to nvcc's
// default contraction (--fmad=true), as in the forward kernels; the
// synthesis is synth.cuh's, with round-to-nearest intrinsics.  Neither
// design rounds as the plain adjoint's serial walk does, so each is held
// to it (compiler/filters.py, sosfilt_stream_vjp_plain) by tolerance.

#include <algorithm>
#include <climits>
#include <stdint.h>

#include "scan.cuh"
#include "synth.cuh"

namespace {

using signals::Cascade;
using signals::Cplx;
using signals::GenSpec;
using signals::cmul;
using signals::kMaxThreads;
using signals::kMinSlice;
using signals::kRows;
using signals::kSinTerms;
using signals::OSC_SAW;
using signals::OSC_SINE;
using signals::OSC_SQUARE;
using signals::OSC_TRIANGLE;
using signals::pow_rows;
using signals::set_state;
using signals::slice_start;
using signals::synth;
using signals::Taps;
using signals::cascade_step;

constexpr int kThreads = 128;        // threads per block (B3)

struct Grad { float rc, rs, d0, d1, d2; };

// Scratch slots per row and lane (B3): (s1, s2) of each section, then the
// input of each section after the first.
template <int NSEC>
__host__ __device__ constexpr int slots() { return 3 * NSEC - 1; }

// One section's adjoint row without the gradients: from the output's
// cotangent g, step lambda = (l1, l2) back over the row and return the
// input's cotangent.
__device__ __forceinline__ float lambda_row(const Taps& t, float g,
                                            float& l1, float& l2) {
    const float gv = t.d0 * g + l1;
    const float n1 = t.rc * l1 + t.rs * l2 + t.d1 * g;
    const float n2 = t.rc * l2 - t.rs * l1 + t.d2 * g;
    l1 = n1;
    l2 = n2;
    return gv;
}

// One section's backward row: from the output's cotangent g, the input v
// and the lagged state (s1p, s2p), add the row's terms to the coefficient
// gradients, step lambda = (l1, l2) back over the row and return the
// input's cotangent.
__device__ __forceinline__ float bwd_row(const Taps& t, float g, float v,
                                         float s1p, float s2p, float& l1,
                                         float& l2, Grad& acc) {
    acc.rc += l1 * s1p + l2 * s2p;
    acc.rs += l2 * s1p - l1 * s2p;
    acc.d0 += g * v;
    acc.d1 += g * s1p;
    acc.d2 += g * s2p;
    return lambda_row(t, g, l1, l2);
}

// Write the gradients of every section to columns 6-10 (section s at
// out + s * sec_stride) and clear them.
template <int NSEC>
__device__ __forceinline__ void flush(Grad (&acc)[NSEC],
                                      float* __restrict__ out,
                                      int64_t sec_stride) {
#pragma unroll
    for (int s = 0; s < NSEC; ++s) {
        float* r = out + s * sec_stride;
        r[6] = acc[s].rc;
        r[7] = acc[s].rs;
        r[8] = acc[s].d0;
        r[9] = acc[s].d1;
        r[10] = acc[s].d2;
        acc[s] = Grad{0.f, 0.f, 0.f, 0.f, 0.f};
    }
}

// The forward walk of one row through all sections (cascade.cuh's
// cascade_step, the forward kernels' expressions): store each section's
// lagged state and each later section's input at p (slot k at p[k * cols]).
template <int NSEC>
__device__ __forceinline__ void record_row(Cascade<NSEC>& cs, float v,
                                           float* __restrict__ p,
                                           int64_t cols) {
#pragma unroll
    for (int s = 0; s < NSEC; ++s) {
        p[(2 * s) * cols] = cs.s1[s];
        p[(2 * s + 1) * cols] = cs.s2[s];
        if (s > 0) p[(2 * NSEC + s - 1) * cols] = v;
        v = cascade_step(cs.tp[s], v, cs.s1[s], cs.s2[s]);
    }
}

// The backward walk of one row through all sections, the last first:
// returns the cotangent of the section-0 input v0.
template <int NSEC>
__device__ __forceinline__ float adjoint_row(const Taps (&tp)[NSEC],
                                             float g, float v0,
                                             const float* __restrict__ p,
                                             int64_t cols,
                                             float (&l1)[NSEC],
                                             float (&l2)[NSEC],
                                             Grad (&acc)[NSEC]) {
#pragma unroll
    for (int s = NSEC - 1; s >= 0; --s) {
        const float v = s > 0 ? p[(2 * NSEC + s - 1) * cols] : v0;
        g = bwd_row(tp[s], g, v, p[(2 * s) * cols], p[(2 * s + 1) * cols],
                    l1[s], l2[s], acc[s]);
    }
    return g;
}

// --- B1 / B2: the segment kernels' backward, a time-sliced adjoint scan ----

struct SegGeo {
    int lanes, F, C, m;
    int n_rows;        // C + m*F rows per carry segment
    int sum_groups;    // 0: per-lane output
    int gy_width;      // columns of gy: lanes, or lanes / sum_groups
    int64_t x_row, x_lane;   // the timeline's strides (GEN: unused)
    int lt, lt_log;    // lanes per block (a power of two, at most 32), log2
    int slice;         // rows per slice, a multiple of kRows
    int n_slices;      // slices per carry segment
    int n_chunks;      // kRows-row chunks per slice
    int nb_max;        // coefficient blocks one slice touches, at most
    int ck_off;        // the checkpoints' offset in shared memory, float4s
};

// The coefficient block (within the segment) of segment row r: the context
// rows run under block 0.
__host__ __device__ __forceinline__ int block_of(int r, const SegGeo& g) {
    if (r < g.C + g.F) return 0;
    const int b = (r - g.C) / g.F;
    return b < g.m - 1 ? b : g.m - 1;
}

// The first row of coefficient block b of a carry segment (block 0 also
// runs the context rows).
__host__ __device__ __forceinline__ int block_start(int b, const SegGeo& g) {
    return b == 0 ? 0 : g.C + b * g.F;
}

// What one thread owns: one lane of its carry segment's rows [row_a, row_b).
struct Lane {
    int unit, lane, lane_c;    // inactive lanes (past the last) read lane 0
    bool active;
    int row_a, row_b;
    int64_t row0;              // timeline row of the segment's row 0
    int grp;                   // the column of gy the lane reads
    int t0;                    // the generator's frame of row 0
    float hz, ph, amp;
    bool ph0;                  // synth<.., PH0 = true> applies
};

template <int S, int NSEC>
__device__ __forceinline__ Cplx pole(const Cascade<NSEC>& cs) {
    return {cs.tp[S].rc, cs.tp[S].rs};
}

// Every section's taps of coefficient block b in cs; tb is the block cs
// holds (-1: none), so a block already there is not loaded again.
template <int NSEC>
__device__ __forceinline__ void use_block(Cascade<NSEC>& cs, int& tb, int b,
                                          const float* __restrict__ coeffs,
                                          const Lane& ln, const SegGeo& g) {
    if (b == tb) return;
    cs.load(coeffs + ((int64_t)(ln.unit * g.m + b) * NSEC * g.lanes
                      + ln.lane_c) * 11,
            (int64_t)g.lanes * 11);
    tb = b;
}

// Whether the chunk at row r0 is kRows rows of the slice under one
// coefficient block (then its rows run without per-row tests).
__device__ __forceinline__ bool straight(int r0, const Lane& ln,
                                         const SegGeo& g) {
    return r0 + kRows <= ln.row_b
           && block_of(r0, g) == block_of(r0 + kRows - 1, g);
}

template <int OSC, bool PH0>
__device__ __forceinline__ void synth_rows(float (&v)[kRows], int r0,
                                           const Lane& ln,
                                           const GenSpec& gen) {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
        v[i] = synth<OSC, PH0>(ln.t0 + r0 + i, ln.hz, ln.ph, ln.amp, gen);
}

// The section-0 input of the chunk's rows, independent of each other:
// synthesized (GEN) or read from the timeline.
template <bool GEN, int OSC>
__device__ __forceinline__ void source_rows(float (&v)[kRows], int r0,
                                            const Lane& ln, const SegGeo& g,
                                            const float* __restrict__ x,
                                            const GenSpec& gen) {
    if constexpr (GEN) {
        if (ln.ph0) synth_rows<OSC, true>(v, r0, ln, gen);
        else synth_rows<OSC, false>(v, r0, ln, gen);
    } else {
        const float* xl = x + ln.row0 * g.x_row + ln.lane_c * g.x_lane;
#pragma unroll
        for (int i = 0; i < kRows; ++i)
            v[i] = r0 + i < ln.row_b ? xl[(int64_t)(r0 + i) * g.x_row] : 0.f;
    }
}

// The output's cotangent at the chunk's rows: zero on the context rows.
__device__ __forceinline__ void gy_rows(float (&gv)[kRows], int r0,
                                        const Lane& ln, const SegGeo& g,
                                        const float* __restrict__ gy) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int r = r0 + i;
        gv[i] = r >= g.C && r < ln.row_b
                    ? gy[(ln.row0 + r - g.C) * g.gy_width + ln.grp] : 0.f;
    }
}

// Step 1's pass over the thread's slice through sections 0..NS-1 from the
// states in cs (the sections before NS-1 from their true starts, section
// NS-1 from zero): returns section NS-1's transfer over the slice; cs ends
// on the slice's end states.  CK: at each chunk's start store every
// section's state and section NS-1's transfer so far (chunk c's slot j at
// ck[(c * (NSEC + 1) + j) * blockDim.x + threadIdx.x]).
template <bool GEN, int OSC, int NSEC, int NS, bool CK>
__device__ __forceinline__ Cplx forward_pass(Cascade<NSEC>& cs, int& tb,
                                             const Lane& ln, const SegGeo& g,
                                             const float* __restrict__ coeffs,
                                             const float* __restrict__ x,
                                             const GenSpec& gen, float2* ck) {
    Cplx a{1.f, 0.f}, pk{1.f, 0.f};
    int pk_b = -1;                   // the block pk was computed for
    for (int c = 0; c < g.n_chunks; ++c) {
        const int r0 = ln.row_a + c * kRows;
        if (r0 >= ln.row_b) break;
        if (CK) {
            float2* p = ck + c * (NSEC + 1) * blockDim.x + threadIdx.x;
#pragma unroll
            for (int s = 0; s < NSEC; ++s)
                p[s * blockDim.x] = make_float2(cs.s1[s], cs.s2[s]);
            p[NSEC * blockDim.x] = make_float2(a.re, a.im);
        }
        float v[kRows];
        source_rows<GEN, OSC>(v, r0, ln, g, x, gen);
        if (straight(r0, ln, g)) {
            const int b = block_of(r0, g);
            use_block(cs, tb, b, coeffs, ln, g);
            if (pk_b != b) {
                pk = pow_rows(pole<NS - 1>(cs));
                pk_b = b;
            }
#pragma unroll
            for (int i = 0; i < kRows; ++i) v[i] = cs.template step<NS>(v[i]);
            a = cmul(pk, a);
        } else {     // a block boundary or the segment's end
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
                const int r = r0 + i;
                if (r >= ln.row_b) continue;
                use_block(cs, tb, block_of(r, g), coeffs, ln, g);
                v[i] = cs.template step<NS>(v[i]);
                a = cmul(pole<NS - 1>(cs), a);
            }
        }
    }
    return a;
}

// Step 2's rows of one chunk, from its last row back: sections NSEC-1 ..
// S+1 from lambda's values after the chunk, section S too (from zero
// after the slice).
template <bool ST, int NSEC, int S>
__device__ __forceinline__ void lambda_chunk(Cascade<NSEC>& cs, int& tb,
                                             int r0, Cplx (&lam)[NSEC],
                                             const Lane& ln, const SegGeo& g,
                                             const float* __restrict__ coeffs,
                                             const float* __restrict__ gy) {
    float gv[kRows];
    gy_rows(gv, r0, ln, g, gy);
    if (ST) use_block(cs, tb, block_of(r0, g), coeffs, ln, g);
#pragma unroll
    for (int i = kRows - 1; i >= 0; --i) {
        if (!ST) {
            if (r0 + i >= ln.row_b) continue;
            use_block(cs, tb, block_of(r0 + i, g), coeffs, ln, g);
        }
        float gg = gv[i];
#pragma unroll
        for (int s = NSEC - 1; s >= S; --s)
            gg = lambda_row(cs.tp[s], gg, lam[s].re, lam[s].im);
    }
}

// Step 2's pass over the thread's slice, from its last row back: returns
// section S's lambda before the slice's first row.
template <int NSEC, int S>
__device__ __forceinline__ Cplx lambda_pass(Cascade<NSEC>& cs, int& tb,
                                            Cplx (&lam)[NSEC],
                                            const Lane& ln, const SegGeo& g,
                                            const float* __restrict__ coeffs,
                                            const float* __restrict__ gy) {
    for (int c = g.n_chunks - 1; c >= 0; --c) {
        const int r0 = ln.row_a + c * kRows;
        if (r0 >= ln.row_b) continue;
        if (straight(r0, ln, g))
            lambda_chunk<true, NSEC, S>(cs, tb, r0, lam, ln, g, coeffs, gy);
        else
            lambda_chunk<false, NSEC, S>(cs, tb, r0, lam, ln, g, coeffs, gy);
    }
    return lam[S];
}

// A slice's partial gradient of one section and coefficient block into
// shared memory (slot (k, b - b_first, s, l) of part, (n_slices, nb_max,
// NSEC, lt, 5)), and cleared.
template <int NSEC>
__device__ __forceinline__ void stash(Grad& acc, int s, int b, int b_first,
                                      const SegGeo& g, float* part) {
    const int k = threadIdx.x >> g.lt_log, l = threadIdx.x & (g.lt - 1);
    float* p = part + (((k * g.nb_max + b - b_first) * NSEC + s) * g.lt + l)
                      * 5;
    p[0] = acc.rc;
    p[1] = acc.rs;
    p[2] = acc.d0;
    p[3] = acc.d1;
    p[4] = acc.d2;
    acc = Grad{0.f, 0.f, 0.f, 0.f, 0.f};
}

// Step 3 on one chunk: the forward rows recomputed from the chunk's start
// states st (section s's inputs into vs[s]), then each section's adjoint
// rows back over them, the last section first, with the gradients summed
// into acc (section s's block in ab[s]; a block left behind is stashed)
// and gv turned from the last section's output cotangent into the
// section-0 input's.
template <bool ST, int NSEC>
__device__ __forceinline__ void replay_chunk(
        Cascade<NSEC>& cs, int& tb, int r0, const Cplx (&st)[NSEC],
        float (&vs)[NSEC][kRows], float (&gv)[kRows], Cplx (&lam)[NSEC],
        Grad (&acc)[NSEC], int (&ab)[NSEC], int b_first, const Lane& ln,
        const SegGeo& g, const float* __restrict__ coeffs, float* part) {
    if (ST) use_block(cs, tb, block_of(r0, g), coeffs, ln, g);
#pragma unroll
    for (int s = 0; s + 1 < NSEC; ++s) {
        float s1 = st[s].re, s2 = st[s].im;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            if (!ST) {
                vs[s + 1][i] = 0.f;
                if (r0 + i >= ln.row_b) continue;
                use_block(cs, tb, block_of(r0 + i, g), coeffs, ln, g);
            }
            vs[s + 1][i] = cascade_step(cs.tp[s], vs[s][i], s1, s2);
        }
    }
#pragma unroll
    for (int s = NSEC - 1; s >= 0; --s) {
        float p1[kRows], p2[kRows];
        float s1 = st[s].re, s2 = st[s].im;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            p1[i] = s1;
            p2[i] = s2;
            if (!ST) {
                if (r0 + i >= ln.row_b) continue;
                use_block(cs, tb, block_of(r0 + i, g), coeffs, ln, g);
            }
            cascade_step(cs.tp[s], vs[s][i], s1, s2);
        }
        if (ST) {
            const int b = block_of(r0, g);
            if (b != ab[s]) {
                stash<NSEC>(acc[s], s, ab[s], b_first, g, part);
                ab[s] = b;
            }
        }
#pragma unroll
        for (int i = kRows - 1; i >= 0; --i) {
            if (!ST) {
                if (r0 + i >= ln.row_b) continue;
                const int b = block_of(r0 + i, g);
                use_block(cs, tb, b, coeffs, ln, g);
                if (b != ab[s]) {
                    stash<NSEC>(acc[s], s, ab[s], b_first, g, part);
                    ab[s] = b;
                }
            }
            gv[i] = bwd_row(cs.tp[s], gv[i], vs[s][i], p1[i], p2[i],
                            lam[s].re, lam[s].im, acc[s]);
        }
    }
}

// grid: (carry segments, lane tiles of lt); block: lt lanes x n_slices
// slices, lanes fastest (padded to whole warps).  gy (n_blocks, F,
// gy_width); gx (n_units, n_rows, lanes), or null; gco (n_blocks, NSEC,
// lanes, 11), zeroed.  Shared memory: the scans' buffer, which the
// gradients' partials reuse after the scans, then the checkpoints.
template <bool GEN, int OSC, int NSEC>
__global__ void __launch_bounds__(kMaxThreads, 1)
seg_cascade_vjp(const float* __restrict__ coeffs,
                const float* __restrict__ x, const int* __restrict__ toff,
                const float* __restrict__ lanef, const GenSpec gen,
                const float* __restrict__ gy, float* __restrict__ gx,
                float* __restrict__ gco, const SegGeo g) {
    extern __shared__ float4 smem[];
    float* part = reinterpret_cast<float*>(smem);
    float2* ck = reinterpret_cast<float2*>(smem + g.ck_off);
    const int k = threadIdx.x >> g.lt_log;
    Lane ln;
    ln.unit = blockIdx.x;
    ln.lane = (blockIdx.y << g.lt_log) + (threadIdx.x & (g.lt - 1));
    ln.active = ln.lane < g.lanes;
    ln.lane_c = ln.active ? ln.lane : 0;
    ln.row_a = min(k * g.slice, g.n_rows);
    ln.row_b = min(ln.row_a + g.slice, g.n_rows);
    ln.row0 = (int64_t)ln.unit * g.m * g.F;
    ln.grp = g.sum_groups ? ln.lane_c / g.sum_groups : ln.lane_c;
    ln.t0 = 0;
    ln.hz = ln.ph = ln.amp = 0.f;
    ln.ph0 = false;
    if (GEN) {
        // int32 frame index exactly as the forward kernel
        ln.t0 = toff[ln.lane_c] + (int)ln.row0;
        ln.hz = lanef[ln.lane_c];
        ln.ph = lanef[g.lanes + ln.lane_c];
        ln.amp = lanef[2 * g.lanes + ln.lane_c];
        ln.ph0 = ln.ph == 0.f && ln.hz >= 0.f;
    }

    // 1. the forward states' true starts, section by section
    Cascade<NSEC> cs;
    cs.reset();
    int tb = -1;
    Cplx a[NSEC], start[NSEC];
    if constexpr (NSEC == 2) {
        a[0] = forward_pass<GEN, OSC, NSEC, 1, false>(cs, tb, ln, g, coeffs,
                                                      x, gen, ck);
        start[0] = slice_start(a[0], Cplx{cs.s1[0], cs.s2[0]}, smem, k,
                               g.n_slices, g.lt);
        set_state(cs, 0, start[0]);
        set_state(cs, 1, Cplx{0.f, 0.f});
    }
    a[NSEC - 1] = forward_pass<GEN, OSC, NSEC, NSEC, true>(cs, tb, ln, g,
                                                           coeffs, x, gen,
                                                           ck);
    start[NSEC - 1] = slice_start(
        a[NSEC - 1], Cplx{cs.s1[NSEC - 1], cs.s2[NSEC - 1]}, smem, k,
        g.n_slices, g.lt);

    // 2. lambda after each slice, section by section from the last; a
    // slice's lambda transfer is conj of its forward transfer
    Cplx lam[NSEC], lam_end[NSEC];
#pragma unroll
    for (int s = 0; s < NSEC; ++s) lam[s] = Cplx{0.f, 0.f};
    const Cplx e_last = lambda_pass<NSEC, NSEC - 1>(cs, tb, lam, ln, g,
                                                    coeffs, gy);
    lam_end[NSEC - 1] = slice_start<true>(
        Cplx{a[NSEC - 1].re, -a[NSEC - 1].im}, e_last, smem, k, g.n_slices,
        g.lt);
    if constexpr (NSEC == 2) {
        lam[1] = lam_end[1];
        lam[0] = Cplx{0.f, 0.f};
        const Cplx e0 = lambda_pass<NSEC, 0>(cs, tb, lam, ln, g, coeffs, gy);
        lam_end[0] = slice_start<true>(Cplx{a[0].re, -a[0].im}, e0, smem, k,
                                       g.n_slices, g.lt);
    }
#pragma unroll
    for (int s = 0; s < NSEC; ++s) lam[s] = lam_end[s];

    // 3. the replay from the last chunk back, the gradients summed per
    // coefficient block (the scans are done: part may take their buffer)
    Grad acc[NSEC];
    int ab[NSEC];
    const bool rows = ln.row_a < ln.row_b;
    const int b_first = block_of(ln.row_a, g);
#pragma unroll
    for (int s = 0; s < NSEC; ++s) {
        acc[s] = Grad{0.f, 0.f, 0.f, 0.f, 0.f};
        ab[s] = rows ? block_of(ln.row_b - 1, g) : 0;
    }
    for (int c = g.n_chunks - 1; c >= 0; --c) {
        const int r0 = ln.row_a + c * kRows;
        if (r0 >= ln.row_b) continue;
        const float2* p = ck + c * (NSEC + 1) * blockDim.x + threadIdx.x;
        Cplx st[NSEC];
#pragma unroll
        for (int s = 0; s < NSEC; ++s) {
            const float2 q = p[s * blockDim.x];
            st[s] = Cplx{q.x, q.y};
        }
        const float2 q = p[NSEC * blockDim.x];
        const Cplx fix = cmul(Cplx{q.x, q.y}, start[NSEC - 1]);
        st[NSEC - 1] = Cplx{st[NSEC - 1].re + fix.re,
                            st[NSEC - 1].im + fix.im};
        float vs[NSEC][kRows], gv[kRows];
        source_rows<GEN, OSC>(vs[0], r0, ln, g, x, gen);
        gy_rows(gv, r0, ln, g, gy);
        if (straight(r0, ln, g))
            replay_chunk<true, NSEC>(cs, tb, r0, st, vs, gv, lam, acc, ab,
                                     b_first, ln, g, coeffs, part);
        else
            replay_chunk<false, NSEC>(cs, tb, r0, st, vs, gv, lam, acc, ab,
                                      b_first, ln, g, coeffs, part);
        if (gx != nullptr && ln.active) {
            float* o = gx + ((int64_t)ln.unit * g.n_rows + r0) * g.lanes
                       + ln.lane;
#pragma unroll
            for (int i = 0; i < kRows; ++i)
                if (r0 + i < ln.row_b) o[(int64_t)i * g.lanes] = gv[i];
        }
    }
    if (rows) {
#pragma unroll
        for (int s = 0; s < NSEC; ++s)
            stash<NSEC>(acc[s], s, ab[s], b_first, g, part);
    }
    __syncthreads();

    // 4. each gradient: its slices' partials in slice order, written once
    const int n_out = g.m * NSEC * g.lt * 5;
    for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
        const int col = i % 5;
        const int l = (i / 5) & (g.lt - 1);
        const int s = (i / (5 * g.lt)) % NSEC;
        const int b = i / (5 * g.lt * NSEC);
        const int lane = (blockIdx.y << g.lt_log) + l;
        if (lane >= g.lanes) continue;
        const int ra = block_start(b, g);
        const int rb = b + 1 < g.m ? block_start(b + 1, g) : g.n_rows;
        float sum = 0.f;
        for (int kk = ra / g.slice; kk <= (rb - 1) / g.slice; ++kk) {
            const int jb = b - block_of(kk * g.slice, g);
            sum += part[(((kk * g.nb_max + jb) * NSEC + s) * g.lt + l) * 5
                        + col];
        }
        gco[(((int64_t)(ln.unit * g.m + b) * NSEC + s) * g.lanes + lane) * 11
            + 6 + col] = sum;
    }
}

// The slicing of plan_slices(), one carry segment per unit, with lt halved
// until the shared memory fits the card's: the block's threads and its
// bytes of shared memory (0: none fits).
size_t plan(SegGeo& g, int n_units, int nsec, int& threads) {
    int dev = 0, smem_max = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    for (int max_lt = 32; max_lt >= 1; max_lt /= 2) {
        const signals::Slicing s = signals::plan_slices(
            n_units, g.lanes, g.n_rows, kMinSlice, max_lt);
        g.lt = s.lt;
        g.lt_log = s.lt_log;
        g.slice = s.slice;
        g.n_slices = s.n_slices;
        g.n_chunks = s.slice / kRows;
        g.nb_max = 1;
        for (int k = 0; k < g.n_slices; ++k) {
            const int ra = k * g.slice;
            const int rb = std::min(ra + g.slice, g.n_rows) - 1;
            g.nb_max = std::max(g.nb_max, block_of(rb, g) - block_of(ra, g)
                                              + 1);
        }
        threads = (g.n_slices * g.lt + 31) / 32 * 32;
        const size_t scan = 2 * (size_t)threads * sizeof(float4);
        const size_t part = (size_t)g.n_slices * g.nb_max * nsec * g.lt * 5
                            * sizeof(float);
        const size_t head = (std::max(scan, part) + sizeof(float4) - 1)
                            / sizeof(float4);
        g.ck_off = (int)head;
        const size_t bytes = head * sizeof(float4)
                             + (size_t)threads * g.n_chunks * (nsec + 1)
                                   * sizeof(float2);
        if (bytes <= (size_t)smem_max) return bytes;
    }
    return 0;
}

template <bool GEN, int OSC, int NSEC>
int launch_seg(const float* coeffs, const float* x, const int* toff,
               const float* lanef, const GenSpec& gen, const float* gy,
               float* gx, float* gco, SegGeo g, int n_units,
               cudaStream_t stream) {
    int threads = 0;
    const size_t smem = plan(g, n_units, NSEC, threads);
    if (smem == 0) return (int)cudaErrorInvalidConfiguration;
    const auto kernel = seg_cascade_vjp<GEN, OSC, NSEC>;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid(n_units, (g.lanes + g.lt - 1) / g.lt);
    kernel<<<grid, threads, smem, stream>>>(coeffs, x, toff, lanef, gen, gy,
                                            gx, gco, g);
    return (int)cudaGetLastError();
}

template <bool GEN, int OSC>
int launch_seg_n(int nsec, const float* coeffs, const float* x,
                 const int* toff, const float* lanef, const GenSpec& gen,
                 const float* gy, float* gx, float* gco, const SegGeo& g,
                 int n_units, cudaStream_t stream) {
    switch (nsec) {
    case 1:
        return launch_seg<GEN, OSC, 1>(coeffs, x, toff, lanef, gen, gy, gx,
                                       gco, g, n_units, stream);
    case 2:
        return launch_seg<GEN, OSC, 2>(coeffs, x, toff, lanef, gen, gy, gx,
                                       gco, g, n_units, stream);
    default:
        return (int)cudaErrorInvalidValue;
    }
}

// --- B3: the zero-state and carried-state kernels' backward ---------------

struct RowsGeo {
    int ch, lanes;                  // lanes = windows * ch, lane = b*ch + c
    int n_rows;                     // rows per window
    int skip;                       // rows before the output (L - tail)
    int64_t x_row, x_win, x_ch;     // strides of x (L, B, ch)
    int64_t co_win, co_sec, co_ch;  // strides of coeffs (B, nsec, ch, 11)
};

// grid: ceil(lanes / kThreads) blocks of kThreads, one thread per (window,
// channel).  gy (tail, B, ch), gx (L, B, ch), gco (B, NSEC, ch, 11) zeroed,
// contiguous; zi, gzf, gzi (B, NSEC, 2, ch) contiguous or null; scratch
// n_rows * slots * lanes floats.
template <int NSEC>
__global__ void __launch_bounds__(kThreads)
rows_cascade_vjp(const float* __restrict__ coeffs,
                 const float* __restrict__ x, const float* __restrict__ zi,
                 const float* __restrict__ gy, const float* __restrict__ gzf,
                 float* __restrict__ gx, float* __restrict__ gco,
                 float* __restrict__ gzi, float* __restrict__ scratch,
                 const RowsGeo g) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= g.lanes) return;
    const int b = lane / g.ch, c = lane - b * g.ch;
    const int64_t cols = g.lanes;
    const float* xl = x + b * g.x_win + c * g.x_ch;
    const int64_t z_lane = (int64_t)b * NSEC * 2 * g.ch + c;
    constexpr int S = slots<NSEC>();
    float* sc = scratch + lane;

    Cascade<NSEC> cs;
    cs.load(coeffs + b * g.co_win + c * g.co_ch, g.co_sec);
#pragma unroll
    for (int s = 0; s < NSEC; ++s) {
        cs.s1[s] = zi != nullptr ? zi[z_lane + (int64_t)(2 * s) * g.ch]
                                 : 0.f;
        cs.s2[s] = zi != nullptr ? zi[z_lane + (int64_t)(2 * s + 1) * g.ch]
                                 : 0.f;
    }
    for (int r = 0; r < g.n_rows; ++r)
        record_row<NSEC>(cs, xl[r * g.x_row], sc + (int64_t)r * S * cols,
                         cols);

    float l1[NSEC], l2[NSEC];
    Grad acc[NSEC];
#pragma unroll
    for (int s = 0; s < NSEC; ++s) {
        l1[s] = gzf != nullptr ? gzf[z_lane + (int64_t)(2 * s) * g.ch] : 0.f;
        l2[s] = gzf != nullptr ? gzf[z_lane + (int64_t)(2 * s + 1) * g.ch]
                               : 0.f;
        acc[s] = Grad{0.f, 0.f, 0.f, 0.f, 0.f};
    }
    for (int r = g.n_rows - 1; r >= 0; --r) {
        const float gv = r >= g.skip
            ? gy[(int64_t)(r - g.skip) * cols + lane] : 0.f;
        gx[(int64_t)r * cols + lane] = adjoint_row<NSEC>(
            cs.tp, gv, xl[r * g.x_row], sc + (int64_t)r * S * cols, cols, l1,
            l2, acc);
    }
    flush<NSEC>(acc, gco + ((int64_t)b * NSEC * g.ch + c) * 11,
                (int64_t)g.ch * 11);
    if (gzi != nullptr) {
#pragma unroll
        for (int s = 0; s < NSEC; ++s) {
            gzi[z_lane + (int64_t)(2 * s) * g.ch] = l1[s];
            gzi[z_lane + (int64_t)(2 * s + 1) * g.ch] = l2[s];
        }
    }
}

template <int NSEC>
int launch_rows(const float* coeffs, const float* x, const float* zi,
                const float* gy, const float* gzf, float* gx, float* gco,
                float* gzi, float* scratch, const RowsGeo& g,
                cudaStream_t stream) {
    rows_cascade_vjp<NSEC><<<(g.lanes + kThreads - 1) / kThreads, kThreads,
                             0, stream>>>(coeffs, x, zi, gy, gzf, gx, gco,
                                          gzi, scratch, g);
    return (int)cudaGetLastError();
}
}  // namespace

extern "C" {

// The launchers return the cudaError_t of the launch (0 on success); a
// section count the templates do not hold is refused with
// cudaErrorInvalidValue.  Strides are in elements.

// B1 (gen != 0: the source synthesized from toff, lanef, osc, inv_rate and
// the sine's Horner coefficients, as sosfilt_segments_gen_launch takes
// them) and B2 (gen == 0: x read at x[r * x_row + l * x_lane]).  coeffs
// (n_blocks, nsec, lanes, 11) and gy (n_blocks, F, lanes or lanes /
// sum_groups) contiguous; writes gcoeffs (n_blocks, nsec, lanes, 11,
// zeroed by the caller) and, unless null, gx (n_blocks / m, C + m*F,
// lanes), the cotangent of each carry segment's input rows.  A carry
// segment whose checkpoints do not fit the card's shared memory even one
// lane a block is refused with cudaErrorInvalidConfiguration.
int sosfilt_segments_vjp_launch(const float* coeffs, const float* x,
                                int64_t x_row, int64_t x_lane,
                                const int* toff, const float* lanef,
                                float inv_rate, int osc,
                                const double* sin_coeffs, int gen,
                                const float* gy, float* gx, float* gcoeffs,
                                int n_blocks, int nsec, int lanes, int F,
                                int C, int m, int sum_groups, void* stream) {
    if (m < 1 || F < 1 || C < 0 || n_blocks % m
            || (sum_groups && lanes % sum_groups))
        return (int)cudaErrorInvalidValue;
    SegGeo g{};
    g.lanes = lanes;
    g.F = F;
    g.C = C;
    g.m = m;
    g.n_rows = C + m * F;
    g.sum_groups = sum_groups;
    g.gy_width = sum_groups ? lanes / sum_groups : lanes;
    g.x_row = x_row;
    g.x_lane = x_lane;
    const int n_units = n_blocks / m;
    if (n_units == 0 || lanes == 0) return 0;
    GenSpec spec{};
    const cudaStream_t st = (cudaStream_t)stream;
    if (!gen)
        return launch_seg_n<false, 0>(nsec, coeffs, x, nullptr, nullptr, spec,
                                      gy, gx, gcoeffs, g, n_units, st);
    for (int k = 0; k < kSinTerms; ++k) spec.sin_c[k] = sin_coeffs[k];
    spec.inv_rate = inv_rate;
    switch (osc) {
    case OSC_SINE:
        return launch_seg_n<true, OSC_SINE>(nsec, coeffs, nullptr, toff,
                                            lanef, spec, gy, gx, gcoeffs, g,
                                            n_units, st);
    case OSC_SQUARE:
        return launch_seg_n<true, OSC_SQUARE>(nsec, coeffs, nullptr, toff,
                                              lanef, spec, gy, gx, gcoeffs,
                                              g, n_units, st);
    case OSC_SAW:
        return launch_seg_n<true, OSC_SAW>(nsec, coeffs, nullptr, toff,
                                           lanef, spec, gy, gx, gcoeffs, g,
                                           n_units, st);
    default:
        return launch_seg_n<true, OSC_TRIANGLE>(nsec, coeffs, nullptr, toff,
                                                lanef, spec, gy, gx, gcoeffs,
                                                g, n_units, st);
    }
}

// B3: coeffs (n_windows, nsec, ch, 11) and x (n_rows, n_windows, ch) through
// their strides (the 11 columns contiguous); zi, gzf (n_windows, nsec, 2,
// ch) or null; gy (tail, n_windows, ch).  Writes gx (n_rows, n_windows, ch),
// gcoeffs (n_windows, nsec, ch, 11, zeroed by the caller) and, unless null,
// gzi (n_windows, nsec, 2, ch).
int sosfilt_rows_vjp_launch(const float* coeffs, int64_t co_win,
                            int64_t co_sec, int64_t co_ch, const float* x,
                            int64_t x_row, int64_t x_win, int64_t x_ch,
                            const float* zi, const float* gy,
                            const float* gzf, float* gx, float* gcoeffs,
                            float* gzi, float* scratch, int nsec,
                            int n_windows, int ch, int n_rows, int tail,
                            void* stream) {
    if (tail < 1 || tail > n_rows) return (int)cudaErrorInvalidValue;
    RowsGeo g{};
    g.ch = ch;
    g.lanes = n_windows * ch;
    g.n_rows = n_rows;
    g.skip = n_rows - tail;
    g.x_row = x_row;
    g.x_win = x_win;
    g.x_ch = x_ch;
    g.co_win = co_win;
    g.co_sec = co_sec;
    g.co_ch = co_ch;
    if (g.lanes == 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    switch (nsec) {
    case 1: return launch_rows<1>(coeffs, x, zi, gy, gzf, gx, gcoeffs, gzi,
                                  scratch, g, st);
    case 2: return launch_rows<2>(coeffs, x, zi, gy, gzf, gx, gcoeffs, gzi,
                                  scratch, g, st);
    case 3: return launch_rows<3>(coeffs, x, zi, gy, gzf, gx, gcoeffs, gzi,
                                  scratch, g, st);
    case 4: return launch_rows<4>(coeffs, x, zi, gy, gzf, gx, gcoeffs, gzi,
                                  scratch, g, st);
    default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
