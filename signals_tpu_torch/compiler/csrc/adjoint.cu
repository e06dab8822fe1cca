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
//     carried-state entry sosfilt_stream: windows read through their
//     strides, from a start state zi, with the end state's cotangent gzf in
//     and the start state's gzi out
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
// context rows and the row kernels' warmup rows (before L - tail) have
// ybar = 0 (the forward never writes them) but lambda runs through them, so
// they add to the gradients and to the input's cotangent.  With
// sum_groups = g lane l reads the cotangent of its group, l / g (the
// forward writes the sum of each g-lane group).  Columns 6-10 of the
// coefficients' gradient (rc rs d0 d1 d2) are written; the caller zeroes
// the buffer, and no kernel reads columns 0-5.
//
// The design, a time-sliced adjoint scan.  With s = s1 + i s2 and
// p = rc + i rs a forward row is s' = p s + v, and R^T is multiplication by
// conj(p), so with lambda = l1 + i l2 an adjoint row is
// lambda' = conj(p) lambda + (d1 + i d2) ybar: both are affine maps that
// compose over any run of rows (scan.cuh).  The rows of each run (a carry
// segment's C + m*F, a window's L) are cut into slices as the forward
// kernels cut them (plan_slices), one thread per (slice, lane), a block
// holding lt lanes x all the slices of one run.  The walks over a thread's
// rows are shared by both templates (forward_pass, lambda_pass, replay; a
// Rows policy says where the rows, the coefficients and the cotangents
// are):
//   1. the forward states (forward_scans): per section, first to last,
//      each slice's map from zero state (a window's first slice from zi)
//      and slice_start's exclusive scan give its true start (section s's
//      pass replays the sections before it from theirs); where a slice is
//      more than one kRows-row chunk, the last pass stores, at each
//      chunk's start, every section's state and the last section's
//      transfer so far, so that the true state there is a fix-up (linear
//      in the start state);
//   2. the adjoint's lambda (lambda_scans), per section, last to first:
//      each slice's map from zero (a window's last slice from gzf; its
//      transfer is conj of the forward's), walked from the slice's last
//      row back, and the reversed scan (slice_start<true>) gives lambda
//      after the slice's last row; section s-1's ybar is section s's input
//      cotangent, so its pass replays section s's lambda from its true
//      value.  The lambda recurrence reads no forward state;
//   3. the replay (replay), chunk by chunk from the last: each chunk's
//      forward rows recomputed from its start states (from the checkpoints,
//      or, for a slice of one chunk, the true starts held in registers)
//      with cascade_step, then each section's adjoint rows back over them
//      (bwd_row), summing the gradients and writing the input's cotangent;
//   4. each slice keeps one partial gradient per coefficient block it
//      touches (in shared memory), and one thread per (block, section,
//      lane, column) sums the slices' partials in slice order and writes
//      it once: no atomics, the same bits on every call.
// A chunk that is one coefficient block and kRows rows of the slice runs
// without per-row tests; one that holds a block boundary or the run's end
// tests each row.
//
// B1 / B2: slices of kMinSlice rows at least; the checkpoints (NSEC + 1
// complex numbers a chunk and lane) live in shared memory, lt halved until
// they fit (a carry segment of more than ~150 000 rows at two sections is
// refused).  B2's overlapping windows are folded into the timeline by the
// caller (kernels._fold_windows: shifted adds, no atomics).  Measured on an
// H100 80GB HBM3 at 700 W, against the serial walk they replaced in the
// same process (PERF.md section 6): B1 at the
// flagship fit (64 blocks, m 8, C 512, sum of 64) 0.0561 ms (3.209
// before), at c8 (43 blocks, C 1024, per lane) 0.0490 ms (1.114); B2 at c9
// (517 windows x 64 lanes, C 1024) 0.4288 ms (2.112), 778 MiB over its
// inputs (1296 with the scratch).  B1's bound is operations (one forward
// row and its adjoint a section-row, the saw once: 0.0032 ms at the
// flagship fit); the design spends more on recomputation — NSEC forward
// passes, NSEC lambda passes and the replay, ~50 instructions a
// section-row, the saw twice — with ~70 000 threads a launch, ~16 warps an
// SM at 126-128 registers (two sections spill ~400 bytes).  B2's bound is
// bytes (x, gy and gx once: 0.1224 ms at c9); the design moves 2.6x that
// (x and gy twice), 1.08 GB at ~2.5 TB/s.
//
// B3: rows.cu's slicing (slices of one kRows-row chunk at least, at most
// rows_vjp_threads(NSEC) threads a block), one coefficient set a window, so
// no per-block partials.  At the fits' shapes every slice is one chunk
// (the streaming fit's (8192, 16): 16 blocks of 512 one-lane slices; the
// render-ahead batch, 1152 rows: 72 slices) and nothing is stored: the
// true starts stay in registers.  Longer slices keep their checkpoints in
// shared memory where they fit, else in a per-call buffer in global memory
// that the caller allocates (sosfilt_rows_vjp_buffer; lane-minor, so a
// warp's loads coalesce): a window of any length runs, in one block.
// Measured on an H100 80GB HBM3 at 700 W against the serial walk it
// replaced (one thread per (window, lane) through a scratch buffer of
// 3 NSEC - 1 floats a row and lane), in the same process
// (PERF.md section 6): the render-ahead batch 0.0088
// ms (0.2742 before), the streaming fit's (8192, 16) 0.0334 ms (1.916),
// the echo's (16384, 1) 0.0563 ms (1.847), 2^20 rows at two sections
// 4.22 ms (285.2).  Its bound is bytes (x, gy and gx once: 0.00047 ms at
// (8192, 16)); what costs is the rows' layout: a block holds the slices
// of a few lanes (one at (8192, 16), lt = 1), so a warp's load or store
// of a row touches 32 cache lines, and the times follow those lines per
// SM at about one a cycle (41 000 at (8192, 16), 7.3 M at 2^20 rows on one
// SM).  Registers: 115 at one section, 128 and 80 bytes of spills at two,
// 254 and none at three and four (256 threads a block).
//
// Rounding: the cascade's and the scans' multiply-adds are left to nvcc's
// default contraction (--fmad=true), as in the forward kernels; the
// synthesis is synth.cuh's, with round-to-nearest intrinsics.  Neither
// design rounds as the plain adjoint's serial walk does, so each is held
// to it (compiler/filters.py, sosfilt_stream_vjp_plain) by tolerance.

#include <algorithm>
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
using signals::set_state;
using signals::slice_start;
using signals::synth;
using signals::Taps;
using signals::cascade_step;

struct Grad { float rc, rs, d0, d1, d2; };

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

template <int S, int NSEC>
__device__ __forceinline__ Cplx pole(const Cascade<NSEC>& cs) {
    return {cs.tp[S].rc, cs.tp[S].rs};
}

// p^kRows by squaring in double, rounded once: a chunk's transfer enters
// the scans as often as there are chunks, and pow_rows' float squarings
// give every chunk the same error of ~15 ulp (each squaring doubles the
// one before it), which the scans add up where the values have decayed
// (a long warmup's lambda).
__device__ __forceinline__ Cplx pow_rows_rn(Cplx p) {
    double re = p.re, im = p.im;
#pragma unroll
    for (int n = 1; n < kRows; n *= 2) {
        const double r = re * re - im * im;
        im = 2.0 * re * im;
        re = r;
    }
    return {(float)re, (float)im};
}

// --- the walks over one thread's rows, shared by B1 / B2 and B3 -----------
//
// A thread owns rows [row_a, row_b) of one lane, walked in n_chunks chunks
// of kRows from row_a.  What the walks read of them comes from a Rows
// policy (SegRows for B1 / B2, WinRows for B3) with the members row_a,
// row_b, n_chunks and
//   straight(r0)      the chunk at r0 is kRows rows of the thread's under
//                     one coefficient block (no per-row tests)
//   blk(r)            the coefficient block of row r
//   use(cs, tb, b)    every section's taps of block b into cs (tb: the
//                     block cs holds, so a block already there is kept)
//   source(v, r0)     the section-0 input of the chunk's rows
//   cotangent(g, r0)  the output's cotangent at the chunk's rows
//   stash(acc, s, b)  a left-behind block's partial gradient, cleared
// Checkpoints: chunk c's slot j (section j's state, j < NSEC, then the
// last section's transfer so far) at ck[(c * (NSEC + 1) + j) * blockDim.x
// + threadIdx.x], in shared or global memory.

// Step 1's pass over the thread's rows through sections 0..NS-1 from the
// states in cs: returns section NS-1's transfer over the rows; cs ends on
// the rows' end states.  Unless ck is null, store the checkpoints.
template <int NSEC, int NS, class W>
__device__ __forceinline__ Cplx forward_pass(Cascade<NSEC>& cs, int& tb,
                                             const W& w, float2* ck) {
    Cplx a{1.f, 0.f}, pk{1.f, 0.f};
    int pk_b = -1;                   // the block pk was computed for
    for (int c = 0; c < w.n_chunks; ++c) {
        const int r0 = w.row_a + c * kRows;
        if (r0 >= w.row_b) break;
        if (ck != nullptr) {
            float2* p = ck + c * (NSEC + 1) * blockDim.x + threadIdx.x;
#pragma unroll
            for (int s = 0; s < NSEC; ++s)
                p[s * blockDim.x] = make_float2(cs.s1[s], cs.s2[s]);
            p[NSEC * blockDim.x] = make_float2(a.re, a.im);
        }
        float v[kRows];
        w.source(v, r0);
        if (w.straight(r0)) {
            const int b = w.blk(r0);
            w.use(cs, tb, b);
            if (pk_b != b) {
                pk = pow_rows_rn(pole<NS - 1>(cs));
                pk_b = b;
            }
#pragma unroll
            for (int i = 0; i < kRows; ++i) v[i] = cs.template step<NS>(v[i]);
            a = cmul(pk, a);
        } else {     // a block boundary or the rows' end
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
                const int r = r0 + i;
                if (r >= w.row_b) continue;
                w.use(cs, tb, w.blk(r));
                v[i] = cs.template step<NS>(v[i]);
                a = cmul(pole<NS - 1>(cs), a);
            }
        }
    }
    return a;
}

// Step 1: per section S, first to last, each slice's map from the state
// init[S] (zero, but a window's first slice from zi) with the sections
// before S replayed from their true starts, and the exclusive scan: start
// holds every section's true start, last section NSEC-1's scanned start
// (zero in the first slice), a each section's transfer over the slice.
// The last pass stores the checkpoints unless ck is null.
template <int NSEC, int S = 0, class W>
__device__ __forceinline__ void forward_scans(
        Cascade<NSEC>& cs, int& tb, const W& w, const Cplx (&init)[NSEC],
        Cplx (&a)[NSEC], Cplx (&start)[NSEC], Cplx& last, float2* ck,
        float4* buf, int k, int n_slices, int lt) {
    if constexpr (S < NSEC) {
#pragma unroll
        for (int s = 0; s < S; ++s) set_state(cs, s, start[s]);
        set_state(cs, S, init[S]);
        a[S] = forward_pass<NSEC, S + 1>(cs, tb, w,
                                         S + 1 == NSEC ? ck : nullptr);
        last = slice_start(a[S], Cplx{cs.s1[S], cs.s2[S]}, buf, k, n_slices,
                           lt);
        start[S] = Cplx{last.re + init[S].re, last.im + init[S].im};
        forward_scans<NSEC, S + 1>(cs, tb, w, init, a, start, last, ck, buf,
                                   k, n_slices, lt);
    }
}

// Step 2's rows of one chunk, from its last row back: sections NSEC-1 ..
// S+1 from lambda's values after the chunk, section S too (from its value
// after the slice).
template <bool ST, int NSEC, int S, class W>
__device__ __forceinline__ void lambda_chunk(Cascade<NSEC>& cs, int& tb,
                                             int r0, Cplx (&lam)[NSEC],
                                             const W& w) {
    float gv[kRows];
    w.cotangent(gv, r0);
    if (ST) w.use(cs, tb, w.blk(r0));
#pragma unroll
    for (int i = kRows - 1; i >= 0; --i) {
        if (!ST) {
            if (r0 + i >= w.row_b) continue;
            w.use(cs, tb, w.blk(r0 + i));
        }
        float gg = gv[i];
#pragma unroll
        for (int s = NSEC - 1; s >= S; --s)
            gg = lambda_row(cs.tp[s], gg, lam[s].re, lam[s].im);
    }
}

// Step 2's pass over the thread's rows, from the last back: returns
// section S's lambda before the first row.
template <int NSEC, int S, class W>
__device__ __forceinline__ Cplx lambda_pass(Cascade<NSEC>& cs, int& tb,
                                            Cplx (&lam)[NSEC], const W& w) {
    for (int c = w.n_chunks - 1; c >= 0; --c) {
        const int r0 = w.row_a + c * kRows;
        if (r0 >= w.row_b) continue;
        if (w.straight(r0))
            lambda_chunk<true, NSEC, S>(cs, tb, r0, lam, w);
        else
            lambda_chunk<false, NSEC, S>(cs, tb, r0, lam, w);
    }
    return lam[S];
}

// Step 2: per section S, last to first, each slice's lambda map from
// ginit[S] (zero, but a window's last slice from gzf), its transfer the
// conjugate of a[S], and the reversed scan: lam_end holds every section's
// lambda after the slice's last row.
template <int NSEC, int S = NSEC - 1, class W>
__device__ __forceinline__ void lambda_scans(
        Cascade<NSEC>& cs, int& tb, const W& w, const Cplx (&a)[NSEC],
        const Cplx (&ginit)[NSEC], Cplx (&lam_end)[NSEC], float4* buf, int k,
        int n_slices, int lt) {
    Cplx lam[NSEC];
#pragma unroll
    for (int s = 0; s < NSEC; ++s)
        lam[s] = s > S ? lam_end[s] : s == S ? ginit[S] : Cplx{0.f, 0.f};
    const Cplx e = lambda_pass<NSEC, S>(cs, tb, lam, w);
    const Cplx r = slice_start<true>(Cplx{a[S].re, -a[S].im}, e, buf, k,
                                     n_slices, lt);
    lam_end[S] = Cplx{r.re + ginit[S].re, r.im + ginit[S].im};
    if constexpr (S > 0)
        lambda_scans<NSEC, S - 1>(cs, tb, w, a, ginit, lam_end, buf, k,
                                  n_slices, lt);
}

// Step 3 on one chunk: the forward rows recomputed from the chunk's start
// states st (section s's inputs into vs[s]), then each section's adjoint
// rows back over them, the last section first, with the gradients summed
// into acc (section s's block in ab[s]; a block left behind is stashed)
// and gv turned from the last section's output cotangent into the
// section-0 input's.
template <bool ST, int NSEC, class W>
__device__ __forceinline__ void replay_chunk(
        Cascade<NSEC>& cs, int& tb, int r0, const Cplx (&st)[NSEC],
        float (&vs)[NSEC][kRows], float (&gv)[kRows], Cplx (&lam)[NSEC],
        Grad (&acc)[NSEC], int (&ab)[NSEC], const W& w) {
    if (ST) w.use(cs, tb, w.blk(r0));
#pragma unroll
    for (int s = 0; s + 1 < NSEC; ++s) {
        float s1 = st[s].re, s2 = st[s].im;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            if (!ST) {
                vs[s + 1][i] = 0.f;
                if (r0 + i >= w.row_b) continue;
                w.use(cs, tb, w.blk(r0 + i));
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
                if (r0 + i >= w.row_b) continue;
                w.use(cs, tb, w.blk(r0 + i));
            }
            cascade_step(cs.tp[s], vs[s][i], s1, s2);
        }
        if (ST) {
            const int b = w.blk(r0);
            if (b != ab[s]) {
                w.stash(acc[s], s, ab[s]);
                ab[s] = b;
            }
        }
#pragma unroll
        for (int i = kRows - 1; i >= 0; --i) {
            if (!ST) {
                if (r0 + i >= w.row_b) continue;
                const int b = w.blk(r0 + i);
                w.use(cs, tb, b);
                if (b != ab[s]) {
                    w.stash(acc[s], s, ab[s]);
                    ab[s] = b;
                }
            }
            gv[i] = bwd_row(cs.tp[s], gv[i], vs[s][i], p1[i], p2[i],
                            lam[s].re, lam[s].im, acc[s]);
        }
    }
}

// Step 3 over the thread's rows, from the last chunk back, lambda starting
// from its values after the rows: each chunk's start states from the
// checkpoints ck (section NSEC-1's fixed up by its transfer so far times
// last, its scanned start) or, with ck null (one chunk), the true starts
// start; the input's cotangent written to gxl (row r at r * gx_row)
// unless it is null.
template <int NSEC, class W>
__device__ __forceinline__ void replay(Cascade<NSEC>& cs, int& tb,
                                       const W& w, const float2* ck,
                                       const Cplx (&start)[NSEC], Cplx last,
                                       Cplx (&lam)[NSEC], Grad (&acc)[NSEC],
                                       int (&ab)[NSEC], float* gxl,
                                       int64_t gx_row) {
    for (int c = w.n_chunks - 1; c >= 0; --c) {
        const int r0 = w.row_a + c * kRows;
        if (r0 >= w.row_b) continue;
        Cplx st[NSEC];
        if (ck == nullptr) {
#pragma unroll
            for (int s = 0; s < NSEC; ++s) st[s] = start[s];
        } else {
            const float2* p = ck + c * (NSEC + 1) * blockDim.x + threadIdx.x;
#pragma unroll
            for (int s = 0; s < NSEC; ++s) {
                const float2 q = p[s * blockDim.x];
                st[s] = Cplx{q.x, q.y};
            }
            const float2 q = p[NSEC * blockDim.x];
            const Cplx fix = cmul(Cplx{q.x, q.y}, last);
            st[NSEC - 1] = Cplx{st[NSEC - 1].re + fix.re,
                                st[NSEC - 1].im + fix.im};
        }
        float vs[NSEC][kRows], gv[kRows];
        w.source(vs[0], r0);
        w.cotangent(gv, r0);
        if (w.straight(r0))
            replay_chunk<true, NSEC>(cs, tb, r0, st, vs, gv, lam, acc, ab, w);
        else
            replay_chunk<false, NSEC>(cs, tb, r0, st, vs, gv, lam, acc, ab,
                                      w);
        if (gxl != nullptr) {
            float* o = gxl + (int64_t)r0 * gx_row;
#pragma unroll
            for (int i = 0; i < kRows; ++i)
                if (r0 + i < w.row_b) o[(int64_t)i * gx_row] = gv[i];
        }
    }
}

// --- B1 / B2: the segment kernels' backward --------------------------------

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

// One thread's lane of its carry segment.
struct Lane {
    int unit, lane, lane_c;    // inactive lanes (past the last) read lane 0
    bool active;
    int64_t row0;              // timeline row of the segment's row 0
    int grp;                   // the column of gy the lane reads
    int t0;                    // the generator's frame of row 0
    float hz, ph, amp;
    bool ph0;                  // synth<.., PH0 = true> applies
};

template <int OSC, bool PH0>
__device__ __forceinline__ void synth_rows(float (&v)[kRows], int r0,
                                           const Lane& ln,
                                           const GenSpec& gen) {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
        v[i] = synth<OSC, PH0>(ln.t0 + r0 + i, ln.hz, ln.ph, ln.amp, gen);
}

// The Rows policy of B1 / B2: one lane's rows of one carry segment, with a
// coefficient block per F rows (the context rows under block 0), the
// section-0 input synthesized (GEN) or read from the timeline, the
// cotangent zero on the context rows, and the partials of the blocks a
// slice touches in shared memory (slot (k, b - b_first, s, l) of part,
// (n_slices, nb_max, NSEC, lt, 5)).
template <bool GEN, int OSC, int NSEC>
struct SegRows {
    const SegGeo& g;
    const Lane& ln;
    const float* coeffs;
    const float* x;
    const GenSpec& gen;
    const float* gy;
    float* part;
    int row_a, row_b, n_chunks;
    int b_first;               // the block of row_a

    __device__ __forceinline__ int blk(int r) const { return block_of(r, g); }

    __device__ __forceinline__ bool straight(int r0) const {
        return r0 + kRows <= row_b && blk(r0) == blk(r0 + kRows - 1);
    }

    __device__ __forceinline__ void use(Cascade<NSEC>& cs, int& tb,
                                        int b) const {
        if (b == tb) return;
        cs.load(coeffs + ((int64_t)(ln.unit * g.m + b) * NSEC * g.lanes
                          + ln.lane_c) * 11,
                (int64_t)g.lanes * 11);
        tb = b;
    }

    __device__ __forceinline__ void source(float (&v)[kRows], int r0) const {
        if constexpr (GEN) {
            if (ln.ph0) synth_rows<OSC, true>(v, r0, ln, gen);
            else synth_rows<OSC, false>(v, r0, ln, gen);
        } else {
            const float* xl = x + ln.row0 * g.x_row + ln.lane_c * g.x_lane;
#pragma unroll
            for (int i = 0; i < kRows; ++i)
                v[i] = r0 + i < row_b ? xl[(int64_t)(r0 + i) * g.x_row]
                                      : 0.f;
        }
    }

    __device__ __forceinline__ void cotangent(float (&gv)[kRows],
                                              int r0) const {
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            const int r = r0 + i;
            gv[i] = r >= g.C && r < row_b
                        ? gy[(ln.row0 + r - g.C) * g.gy_width + ln.grp]
                        : 0.f;
        }
    }

    __device__ __forceinline__ void stash(Grad& acc, int s, int b) const {
        const int k = threadIdx.x >> g.lt_log, l = threadIdx.x & (g.lt - 1);
        float* p = part + (((k * g.nb_max + b - b_first) * NSEC + s) * g.lt
                           + l) * 5;
        p[0] = acc.rc;
        p[1] = acc.rs;
        p[2] = acc.d0;
        p[3] = acc.d1;
        p[4] = acc.d2;
        acc = Grad{0.f, 0.f, 0.f, 0.f, 0.f};
    }
};

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
    const int row_a = min(k * g.slice, g.n_rows);
    const int row_b = min(row_a + g.slice, g.n_rows);
    const SegRows<GEN, OSC, NSEC> w{g, ln, coeffs, x, gen, gy, part, row_a,
                                    row_b, g.n_chunks,
                                    block_of(row_a, g)};

    // 1-2. the forward states' true starts and lambda after each slice,
    // section by section, every slice from zero
    Cascade<NSEC> cs;
    cs.reset();
    int tb = -1;
    Cplx zero[NSEC], a[NSEC], start[NSEC], last, lam[NSEC];
#pragma unroll
    for (int s = 0; s < NSEC; ++s) zero[s] = Cplx{0.f, 0.f};
    forward_scans<NSEC>(cs, tb, w, zero, a, start, last, ck, smem, k,
                        g.n_slices, g.lt);
    lambda_scans<NSEC>(cs, tb, w, a, zero, lam, smem, k, g.n_slices, g.lt);

    // 3. the replay from the last chunk back, the gradients summed per
    // coefficient block (the scans are done: part may take their buffer)
    Grad acc[NSEC];
    int ab[NSEC];
    const bool rows = row_a < row_b;
#pragma unroll
    for (int s = 0; s < NSEC; ++s) {
        acc[s] = Grad{0.f, 0.f, 0.f, 0.f, 0.f};
        ab[s] = rows ? block_of(row_b - 1, g) : 0;
    }
    float* gxl = gx != nullptr && ln.active
                     ? gx + (int64_t)ln.unit * g.n_rows * g.lanes + ln.lane
                     : nullptr;
    replay<NSEC>(cs, tb, w, ck, start, last, lam, acc, ab, gxl, g.lanes);
    if (rows) {
#pragma unroll
        for (int s = 0; s < NSEC; ++s) w.stash(acc[s], s, ab[s]);
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
    int lt, lt_log;    // lanes per block (a power of two, at most 32), log2
    int slice;         // rows per slice, a multiple of kRows
    int n_slices;      // slices per window
    int n_chunks;      // kRows-row chunks per slice (1: no checkpoints)
    int ck_off;        // the checkpoints' offset in shared memory, float4s;
                       // -1: in the global buffer
};

// Threads a block, at most: two sections' replay holds ~80 floats of rows
// in registers, which 512 threads (128 registers each) leave room for;
// three and four sections get 256 threads and 255 registers.
__host__ __device__ constexpr int rows_vjp_threads(int nsec) {
    return nsec <= 2 ? kMaxThreads : kMaxThreads / 2;
}

// Section s of a lane's edge state (zi, gzf): zl points at the lane's
// (nsec, 2, ch) entry, or is null for zero.
__device__ __forceinline__ Cplx edge_state(const float* __restrict__ zl,
                                           int s, int ch) {
    if (zl == nullptr) return Cplx{0.f, 0.f};
    return Cplx{zl[(int64_t)(2 * s) * ch], zl[(int64_t)(2 * s + 1) * ch]};
}

// The Rows policy of B3: one lane's rows of one window under one
// coefficient set (loaded once), the input read through its row stride,
// the cotangent zero before the window's output rows.
template <int NSEC>
struct WinRows {
    const float* xl;     // the lane's input column (row 0)
    const float* gyl;    // the lane's cotangent column (window row skip)
    int64_t x_row;
    int gy_row;          // gy's row stride: the lanes
    int skip;
    int row_a, row_b, n_chunks;

    __device__ __forceinline__ int blk(int) const { return 0; }

    __device__ __forceinline__ bool straight(int r0) const {
        return r0 + kRows <= row_b;
    }

    __device__ __forceinline__ void use(Cascade<NSEC>&, int&, int) const {}

    __device__ __forceinline__ void source(float (&v)[kRows], int r0) const {
        const float* xr = xl + (int64_t)r0 * x_row;
#pragma unroll
        for (int i = 0; i < kRows; ++i)
            v[i] = r0 + i < row_b ? xr[(int64_t)i * x_row] : 0.f;
    }

    __device__ __forceinline__ void cotangent(float (&gv)[kRows],
                                              int r0) const {
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            const int r = r0 + i;
            gv[i] = r >= skip && r < row_b
                        ? gyl[(int64_t)(r - skip) * gy_row] : 0.f;
        }
    }

    __device__ __forceinline__ void stash(Grad&, int, int) const {}
};

// grid: lane tiles of lt over the windows' lanes; block: lt lanes x
// n_slices slices, lanes fastest (padded to whole warps).  gy (tail, B,
// ch), gx (L, B, ch), gco (B, NSEC, ch, 11) zeroed, contiguous; zi, gzf,
// gzi (B, NSEC, 2, ch) contiguous or null; ck_buf the checkpoints where
// they are not in shared memory (ck_off -1), a block's n_chunks * (NSEC +
// 1) * blockDim.x float2s after the block before it.  Shared memory: the
// scans' buffer, which the partials reuse after the scans, then the
// checkpoints (ck_off >= 0).
template <int NSEC>
__global__ void __launch_bounds__(rows_vjp_threads(NSEC), 1)
rows_cascade_vjp(const float* __restrict__ coeffs,
                 const float* __restrict__ x, const float* __restrict__ zi,
                 const float* __restrict__ gy, const float* __restrict__ gzf,
                 float* __restrict__ gx, float* __restrict__ gco,
                 float* __restrict__ gzi, float2* __restrict__ ck_buf,
                 const RowsGeo g) {
    extern __shared__ float4 smem[];
    const int k = threadIdx.x >> g.lt_log, l = threadIdx.x & (g.lt - 1);
    const int lane = (blockIdx.x << g.lt_log) + l;
    const bool active = lane < g.lanes;
    const int lane_c = active ? lane : 0;          // inactive lanes read 0
    const int b = lane_c / g.ch, c = lane_c - b * g.ch;
    WinRows<NSEC> w;
    w.xl = x + b * g.x_win + c * g.x_ch;
    w.gyl = gy + lane_c;
    w.x_row = g.x_row;
    w.gy_row = g.lanes;
    w.skip = g.skip;
    w.row_a = min(k * g.slice, g.n_rows);
    w.row_b = min(w.row_a + g.slice, g.n_rows);
    w.n_chunks = g.n_chunks;
    Cascade<NSEC> cs;
    cs.load(coeffs + b * g.co_win + c * g.co_ch, g.co_sec);
    int tb = 0;
    // the window's first slice starts from zi, its last slice's lambda
    // from gzf
    const int64_t z_lane = (int64_t)b * NSEC * 2 * g.ch + c;
    const float* zl = zi != nullptr && k == 0 ? zi + z_lane : nullptr;
    const float* gl = gzf != nullptr && k == g.n_slices - 1 ? gzf + z_lane
                                                            : nullptr;
    Cplx init[NSEC], ginit[NSEC];
#pragma unroll
    for (int s = 0; s < NSEC; ++s) {
        init[s] = edge_state(zl, s, g.ch);
        ginit[s] = edge_state(gl, s, g.ch);
    }
    float2* ck = nullptr;
    if (g.n_chunks > 1)
        ck = g.ck_off >= 0
                 ? reinterpret_cast<float2*>(smem + g.ck_off)
                 : ck_buf + (int64_t)blockIdx.x * g.n_chunks * (NSEC + 1)
                                * blockDim.x;

    // 1-2. the forward states' true starts and lambda after each slice
    Cplx a[NSEC], start[NSEC], last, lam[NSEC];
    forward_scans<NSEC>(cs, tb, w, init, a, start, last, ck, smem, k,
                        g.n_slices, g.lt);
    lambda_scans<NSEC>(cs, tb, w, a, ginit, lam, smem, k, g.n_slices, g.lt);

    // 3. the replay from the last chunk back; gzi is lambda before the
    // window's first row
    Grad acc[NSEC];
    int ab[NSEC];
#pragma unroll
    for (int s = 0; s < NSEC; ++s) {
        acc[s] = Grad{0.f, 0.f, 0.f, 0.f, 0.f};
        ab[s] = 0;
    }
    replay<NSEC>(cs, tb, w, ck, start, last, lam, acc, ab,
                 active ? gx + lane : nullptr, g.lanes);
    if (gzi != nullptr && active && k == 0) {
#pragma unroll
        for (int s = 0; s < NSEC; ++s) {
            gzi[z_lane + (int64_t)(2 * s) * g.ch] = lam[s].re;
            gzi[z_lane + (int64_t)(2 * s + 1) * g.ch] = lam[s].im;
        }
    }

    // 4. one partial per (slice, section, lane) (the scans are done: the
    // partials take their buffer), summed in slice order and written once
    float* part = reinterpret_cast<float*>(smem);
    if (w.row_a < w.row_b) {
#pragma unroll
        for (int s = 0; s < NSEC; ++s) {
            float* p = part + ((k * NSEC + s) * g.lt + l) * 5;
            p[0] = acc[s].rc;
            p[1] = acc[s].rs;
            p[2] = acc[s].d0;
            p[3] = acc[s].d1;
            p[4] = acc[s].d2;
        }
    }
    __syncthreads();
    const int n_out = NSEC * g.lt * 5;
    for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
        const int col = i % 5;
        const int lo = (i / 5) & (g.lt - 1);
        const int s = i / (5 * g.lt);
        const int ln = (blockIdx.x << g.lt_log) + lo;
        if (ln >= g.lanes) continue;
        float sum = 0.f;
        for (int kk = 0; kk < g.n_slices; ++kk)
            sum += part[((kk * NSEC + s) * g.lt + lo) * 5 + col];
        const int bo = ln / g.ch, co = ln - bo * g.ch;
        gco[(((int64_t)bo * NSEC + s) * g.ch + co) * 11 + 6 + col] = sum;
    }
}

// B3's slicing, rows.cu's (plan_slices with slices of one chunk at least),
// at most rows_vjp_threads(nsec) threads a block: the block's threads and
// its bytes of shared memory; buf the global buffer's float2s (0: the
// checkpoints, if any, fit in shared memory).
size_t plan_rows(RowsGeo& g, int nsec, int& threads, int64_t& buf) {
    const signals::Slicing s = signals::plan_slices(
        1, g.lanes, g.n_rows, kRows, 32, rows_vjp_threads(nsec));
    g.lt = s.lt;
    g.lt_log = s.lt_log;
    g.slice = s.slice;
    g.n_slices = s.n_slices;
    g.n_chunks = s.slice / kRows;
    threads = (g.n_slices * g.lt + 31) / 32 * 32;
    const size_t scan = 2 * (size_t)threads * sizeof(float4);
    const size_t part = (size_t)g.n_slices * g.lt * nsec * 5 * sizeof(float);
    const size_t head = (std::max(scan, part) + sizeof(float4) - 1)
                        / sizeof(float4);
    const int64_t ck = g.n_chunks > 1
                           ? (int64_t)threads * g.n_chunks * (nsec + 1) : 0;
    int dev = 0, smem_max = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    const size_t bytes = head * sizeof(float4) + ck * sizeof(float2);
    g.ck_off = (int)head;
    buf = 0;
    if (bytes <= (size_t)smem_max) return bytes;
    g.ck_off = -1;
    buf = (int64_t)((g.lanes + g.lt - 1) / g.lt) * ck;
    return head * sizeof(float4);
}

template <int NSEC>
int launch_rows(const float* coeffs, const float* x, const float* zi,
                const float* gy, const float* gzf, float* gx, float* gco,
                float* gzi, float* ck_buf, int64_t ck_floats, RowsGeo g,
                cudaStream_t stream) {
    int threads = 0;
    int64_t buf = 0;
    const size_t smem = plan_rows(g, NSEC, threads, buf);
    if (2 * buf > ck_floats) return (int)cudaErrorInvalidValue;
    const auto kernel = rows_cascade_vjp<NSEC>;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<(g.lanes + g.lt - 1) / g.lt, threads, smem, stream>>>(
        coeffs, x, zi, gy, gzf, gx, gco, gzi,
        reinterpret_cast<float2*>(ck_buf), g);
    return (int)cudaGetLastError();
}

RowsGeo rows_geo(int n_windows, int ch, int n_rows) {
    RowsGeo g{};
    g.ch = ch;
    g.lanes = n_windows * ch;
    g.n_rows = n_rows;
    return g;
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

// B3's checkpoint buffer for one call: the floats the caller allocates and
// passes to sosfilt_rows_vjp_launch as ck_buf (0: the checkpoints fit in
// shared memory, or a slice is one chunk and there are none).
int64_t sosfilt_rows_vjp_buffer(int nsec, int n_windows, int ch,
                                int n_rows) {
    if (nsec < 1 || nsec > 4 || n_windows < 1 || ch < 1 || n_rows < 1)
        return 0;
    RowsGeo g = rows_geo(n_windows, ch, n_rows);
    int threads = 0;
    int64_t buf = 0;
    plan_rows(g, nsec, threads, buf);
    return 2 * buf;
}

// B3: coeffs (n_windows, nsec, ch, 11) and x (n_rows, n_windows, ch) through
// their strides (the 11 columns contiguous); zi, gzf (n_windows, nsec, 2,
// ch) or null; gy (tail, n_windows, ch).  Writes gx (n_rows, n_windows, ch),
// gcoeffs (n_windows, nsec, ch, 11, zeroed by the caller) and, unless null,
// gzi (n_windows, nsec, 2, ch).  ck_buf holds ck_floats floats, at least
// sosfilt_rows_vjp_buffer()'s (else cudaErrorInvalidValue).
int sosfilt_rows_vjp_launch(const float* coeffs, int64_t co_win,
                            int64_t co_sec, int64_t co_ch, const float* x,
                            int64_t x_row, int64_t x_win, int64_t x_ch,
                            const float* zi, const float* gy,
                            const float* gzf, float* gx, float* gcoeffs,
                            float* gzi, float* ck_buf, int64_t ck_floats,
                            int nsec, int n_windows, int ch, int n_rows,
                            int tail, void* stream) {
    if (tail < 1 || tail > n_rows) return (int)cudaErrorInvalidValue;
    RowsGeo g = rows_geo(n_windows, ch, n_rows);
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
                                  ck_buf, ck_floats, g, st);
    case 2: return launch_rows<2>(coeffs, x, zi, gy, gzf, gx, gcoeffs, gzi,
                                  ck_buf, ck_floats, g, st);
    case 3: return launch_rows<3>(coeffs, x, zi, gy, gzf, gx, gcoeffs, gzi,
                                  ck_buf, ck_floats, g, st);
    case 4: return launch_rows<4>(coeffs, x, zi, gy, gzf, gx, gcoeffs, gzi,
                                  ck_buf, ck_floats, g, st);
    default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
