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
// per coefficient block; lambda after row 0 is gzi.  All sections of a row
// go back together (the last section first), so no section's ybar is kept.
// The segment kernels' context rows have ybar = 0 (the forward never
// writes them) but lambda runs through them under block 0's coefficients,
// so they add to block 0's gradients and to the input's cotangent.  With
// sum_groups = g lane l reads the cotangent of its group, l / g (the
// forward writes the sum of each g-lane group).  Columns 6-10 of the
// coefficients' gradient (rc rs d0 d1 d2) are written; the caller zeroes
// the buffer, and no kernel reads columns 0-5.
//
// The design: one thread per (carry segment or window, lane).  It walks its
// rows forward under the forward kernel's coefficient schedule (the segment
// kernels: the C context rows under the segment's block-0 coefficients,
// then block j's over its F rows; B3 from zi) and stores each section's
// lagged state and each later section's input in a scratch buffer in
// global memory, lane-minor (slot k of row r at (r * slots + k) * columns
// + column), so that a warp's stores and loads coalesce.  Then it walks the
// rows backwards.  Each thread owns its rows and its coefficient blocks, so
// it sums the gradients serially in the walk's order and writes them once:
// no atomics, the same bits on every call.  The forward walk runs
// cascade.cuh's Cascade and cascade_step, the forward kernels' own
// expressions, but a serial walk does not round as their time-sliced scans
// do, so the
// backward is held to the plain adjoint (compiler/filters.py,
// sosfilt_stream_vjp_plain) by tolerance.  The folding of B2's overlapping
// windows into the timeline is done by the caller (kernels._fold_windows:
// shifted adds, no atomics).
//
// What bounds it on this card.  The serial walk's latency: each thread
// runs its rows twice (12 f32 operations and 2-3 words of scratch per
// section and row forward, 26 operations back, each backward row waiting
// on its scratch loads), and there are only as many threads as (segments
// x lanes): 33 088 at c9's shape (517 windows x 64 lanes), 512 for the
// flagship fit over 64 blocks (8 carry segments of 8 704 rows).  Its
// bound is bytes at c9 (x, the cotangents and the folded input cotangent)
// and operations elsewhere; the scratch traffic (c9: 2 x 542 MB) is not
// part of either.  A time-sliced adjoint scan in the manner of
// segments.cu is the next step (ROADMAP).
//
// Rounding: the cascade's multiply-adds are left to nvcc's default
// contraction (--fmad=true), as in the forward kernels; the synthesis is
// synth.cuh's, with round-to-nearest intrinsics.

#include <climits>
#include <stdint.h>

#include "cascade.cuh"
#include "synth.cuh"

namespace {

using signals::Cascade;
using signals::GenSpec;
using signals::kSinTerms;
using signals::OSC_SAW;
using signals::OSC_SINE;
using signals::OSC_SQUARE;
using signals::OSC_TRIANGLE;
using signals::synth;
using signals::Taps;
using signals::cascade_step;

constexpr int kThreads = 128;        // threads per block

struct Grad { float rc, rs, d0, d1, d2; };

// Scratch slots per row and lane: (s1, s2) of each section, then the input
// of each section after the first.
template <int NSEC>
__host__ __device__ constexpr int slots() { return 3 * NSEC - 1; }

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
    const float gv = t.d0 * g + l1;
    const float n1 = t.rc * l1 + t.rs * l2 + t.d1 * g;
    const float n2 = t.rc * l2 - t.rs * l1 + t.d2 * g;
    l1 = n1;
    l2 = n2;
    return gv;
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

// --- B1 / B2: the segment kernels' backward ------------------------------

struct SegGeo {
    int lanes, F, C, m;
    int n_rows;        // C + m*F rows per carry segment
    int n_units;       // carry segments
    int sum_groups;    // 0: per-lane output
    int gy_width;      // columns of gy: lanes, or lanes / sum_groups
    int64_t x_row, x_lane;   // the timeline's strides (GEN: unused)
};

// What a thread needs to make the section-0 input of its rows.
struct Source {
    const float* x;    // the lane's column of the timeline, row 0
    int t0;            // the generator's frame of row 0
    float hz, ph, amp;
    bool ph0;
};

template <bool GEN, int OSC>
__device__ __forceinline__ float source(const Source& src, int r,
                                        int64_t x_row, const GenSpec& gen) {
    if (GEN) {
        return src.ph0 ? synth<OSC, true>(src.t0 + r, src.hz, src.ph,
                                          src.amp, gen)
                       : synth<OSC, false>(src.t0 + r, src.hz, src.ph,
                                           src.amp, gen);
    }
    return src.x[r * x_row];
}

// The first row of coefficient block b of a carry segment (block 0 also
// runs the context rows).
__device__ __forceinline__ int block_start(int b, const SegGeo& g) {
    return b == 0 ? 0 : g.C + b * g.F;
}

// grid: ceil(n_units * lanes / kThreads) blocks of kThreads; thread (unit,
// lane), lanes fastest.  gy (n_blocks, F, gy_width); gx (n_units, n_rows,
// lanes), or null; gco (n_blocks, NSEC, lanes, 11), zeroed; scratch
// n_rows * slots * n_units * lanes floats.
template <bool GEN, int OSC, int NSEC>
__global__ void __launch_bounds__(kThreads)
seg_cascade_vjp(const float* __restrict__ coeffs,
                const float* __restrict__ x, const int* __restrict__ toff,
                const float* __restrict__ lanef, const GenSpec gen,
                const float* __restrict__ gy, float* __restrict__ gx,
                float* __restrict__ gco, float* __restrict__ scratch,
                const SegGeo g) {
    const int64_t cols = (int64_t)g.n_units * g.lanes;
    const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= cols) return;
    const int unit = (int)(col / g.lanes);
    const int lane = (int)(col - (int64_t)unit * g.lanes);
    const int64_t row0 = (int64_t)unit * g.m * g.F;   // timeline row of row 0
    Source src{};
    if (GEN) {
        // int32 frame index exactly as the forward kernel
        src.t0 = toff[lane] + (int)row0;
        src.hz = lanef[lane];
        src.ph = lanef[g.lanes + lane];
        src.amp = lanef[2 * g.lanes + lane];
        src.ph0 = src.ph == 0.f && src.hz >= 0.f;
    } else {
        src.x = x + row0 * g.x_row + lane * g.x_lane;
    }
    const int64_t sec = (int64_t)g.lanes * 11;
    const auto coeff_row = [&](int b) {
        return ((int64_t)(unit * g.m + b) * NSEC * g.lanes + lane) * 11;
    };
    constexpr int S = slots<NSEC>();
    float* sc = scratch + col;

    Cascade<NSEC> cs;
    cs.reset();
    int b = 0;
    cs.load(coeffs + coeff_row(0), sec);
    int next = g.m > 1 ? block_start(1, g) : INT_MAX;
    for (int r = 0; r < g.n_rows; ++r) {
        if (r == next) {
            ++b;
            cs.load(coeffs + coeff_row(b), sec);
            next = b + 1 < g.m ? block_start(b + 1, g) : INT_MAX;
        }
        record_row<NSEC>(cs, source<GEN, OSC>(src, r, g.x_row, gen),
                         sc + (int64_t)r * S * cols, cols);
    }

    float l1[NSEC], l2[NSEC];
    Grad acc[NSEC];
#pragma unroll
    for (int s = 0; s < NSEC; ++s) {
        l1[s] = l2[s] = 0.f;
        acc[s] = Grad{0.f, 0.f, 0.f, 0.f, 0.f};
    }
    const int grp = g.sum_groups ? lane / g.sum_groups : lane;
    const float* gyl = gy + grp;
    float* gxl = gx == nullptr ? nullptr
                               : gx + (int64_t)unit * g.n_rows * g.lanes + lane;
    int start = block_start(b, g);
    for (int r = g.n_rows - 1; r >= 0; --r) {
        if (r < start) {
            flush<NSEC>(acc, gco + coeff_row(b), sec);
            --b;
            cs.load(coeffs + coeff_row(b), sec);
            start = block_start(b, g);
        }
        const float gv = r >= g.C
            ? gyl[(row0 + r - g.C) * g.gy_width] : 0.f;
        const float gx0 = adjoint_row<NSEC>(
            cs.tp, gv, source<GEN, OSC>(src, r, g.x_row, gen),
            sc + (int64_t)r * S * cols, cols, l1, l2, acc);
        if (gxl != nullptr) gxl[(int64_t)r * g.lanes] = gx0;
    }
    flush<NSEC>(acc, gco + coeff_row(b), sec);
}

template <bool GEN, int OSC, int NSEC>
int launch_seg(const float* coeffs, const float* x, const int* toff,
               const float* lanef, const GenSpec& gen, const float* gy,
               float* gx, float* gco, float* scratch, const SegGeo& g,
               cudaStream_t stream) {
    const int64_t cols = (int64_t)g.n_units * g.lanes;
    const int64_t grid = (cols + kThreads - 1) / kThreads;
    if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
    seg_cascade_vjp<GEN, OSC, NSEC><<<(unsigned)grid, kThreads, 0, stream>>>(
        coeffs, x, toff, lanef, gen, gy, gx, gco, scratch, g);
    return (int)cudaGetLastError();
}

template <bool GEN, int OSC>
int launch_seg_n(int nsec, const float* coeffs, const float* x,
                 const int* toff, const float* lanef, const GenSpec& gen,
                 const float* gy, float* gx, float* gco, float* scratch,
                 const SegGeo& g, cudaStream_t stream) {
    switch (nsec) {
    case 1:
        return launch_seg<GEN, OSC, 1>(coeffs, x, toff, lanef, gen, gy, gx,
                                       gco, scratch, g, stream);
    case 2:
        return launch_seg<GEN, OSC, 2>(coeffs, x, toff, lanef, gen, gy, gx,
                                       gco, scratch, g, stream);
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
// lanes), the cotangent of each carry segment's input rows.
int sosfilt_segments_vjp_launch(const float* coeffs, const float* x,
                                int64_t x_row, int64_t x_lane,
                                const int* toff, const float* lanef,
                                float inv_rate, int osc,
                                const double* sin_coeffs, int gen,
                                const float* gy, float* gx, float* gcoeffs,
                                float* scratch, int n_blocks, int nsec,
                                int lanes, int F, int C, int m,
                                int sum_groups, void* stream) {
    if (m < 1 || n_blocks % m || (sum_groups && lanes % sum_groups))
        return (int)cudaErrorInvalidValue;
    SegGeo g{};
    g.lanes = lanes;
    g.F = F;
    g.C = C;
    g.m = m;
    g.n_rows = C + m * F;
    g.n_units = n_blocks / m;
    g.sum_groups = sum_groups;
    g.gy_width = sum_groups ? lanes / sum_groups : lanes;
    g.x_row = x_row;
    g.x_lane = x_lane;
    if (g.n_units == 0 || lanes == 0) return 0;
    GenSpec spec{};
    const cudaStream_t st = (cudaStream_t)stream;
    if (!gen)
        return launch_seg_n<false, 0>(nsec, coeffs, x, nullptr, nullptr, spec,
                                      gy, gx, gcoeffs, scratch, g, st);
    for (int k = 0; k < kSinTerms; ++k) spec.sin_c[k] = sin_coeffs[k];
    spec.inv_rate = inv_rate;
    switch (osc) {
    case OSC_SINE:
        return launch_seg_n<true, OSC_SINE>(nsec, coeffs, nullptr, toff,
                                            lanef, spec, gy, gx, gcoeffs,
                                            scratch, g, st);
    case OSC_SQUARE:
        return launch_seg_n<true, OSC_SQUARE>(nsec, coeffs, nullptr, toff,
                                              lanef, spec, gy, gx, gcoeffs,
                                              scratch, g, st);
    case OSC_SAW:
        return launch_seg_n<true, OSC_SAW>(nsec, coeffs, nullptr, toff,
                                           lanef, spec, gy, gx, gcoeffs,
                                           scratch, g, st);
    default:
        return launch_seg_n<true, OSC_TRIANGLE>(nsec, coeffs, nullptr, toff,
                                                lanef, spec, gy, gx, gcoeffs,
                                                scratch, g, st);
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
