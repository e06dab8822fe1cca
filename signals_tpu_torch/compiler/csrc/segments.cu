// Segment-cascade kernels for Hopper (sm_90a): a time-sliced scan.
//
// Replace the Pallas TPU kernels of signals_tpu/compiler/pallas_kernels.py:
//   * seg_cascade<GEN=true, OSC, NSEC>  <- _seg_kernel_gen /
//     sosfilt_segments_gen (the oscillator input is synthesized in registers
//     from the frame index)
//   * seg_cascade<GEN=false, 0, NSEC>   <- _seg_kernel, _seg_kernel_reuse /
//     sosfilt_segments (the input is read from a timeline in memory)
// Both run the one coupled-form cascade (signals::Cascade in cascade.cuh, the
// counterpart of _run_cascade) and the one lane-group sum (sum_rows, the
// counterpart of _group_sum_chunk), so their numerics cannot drift apart.
//
// What computes: for each carry segment u (m coefficient blocks of F frames)
// and lane, C context rows warm the state up from zero under block u*m's
// coefficients, then m*F rows run with per-block coefficients and the state
// carried; only those m*F rows are written, block-major (n_blocks, F, lanes),
// or, with sum_groups = g, the sum of each g-lane group (n_blocks, F,
// lanes / g).
// One or two order-2 sections per lane (NSEC, as the Butterworth designs give:
// low/high-pass 1, band-pass/band-stop 2), all in registers.
//
// What bounds it on this card.  The recurrence is serial in time.  The
// row-loop kernel this one replaced gave one thread each (segment, lane) and
// walked C + m*F rows (8,704 for the flagship), with no local memory in its
// SASS: latency-bound, sum of 64 over 256 blocks x 64 lanes 1.193 ms, over
// 2584 blocks 0.805 ms alone and 1.26 ms inside the 60 s flagship render.
// This kernel runs ~10x more threads and is bound by instruction issue: the
// saw's synthesis (10 ops a row at phase 0, 13 otherwise), two cascade
// passes (7 + 6 ops) and the group sums (a shared-memory store and load per
// lane-row and pass).  Measured on an H100 SXM (700 W), sum of 64: 256
// blocks 0.061 ms, 2584 blocks 0.353 ms (0.345 ms in the render); its
// roofline bound is 0.0061 / 0.0618 ms of f32 operations (chip_smoke.py
// phase 2, scripts/torch_profile_flagship.py).
//
// The design: one section is a complex first-order recurrence.  With
// s = s1 + i*s2 and p = rc + i*rs, cascade.cuh's step is s' = p*s + x, an
// affine map that composes over any run of rows, across coefficient changes
// too.  So each carry segment's rows are cut into slices of `slice` rows (a
// multiple of kRows), one thread per (slice, lane):
//   1. each thread runs its slice from zero state and keeps its end state e
//      and its transfer a, the product of the rows' p (per kRows-row chunk
//      p^kRows, computed when the coefficients change);
//   2. a Hillis-Steele scan of the pairs (a, e) in shared memory over the
//      segment's slices, (a2, e2) after (a1, e1) = (a2*a1, a2*e1 + e2), gives
//      each slice its true start state;
//   3. each thread replays its slice from that state and writes its rows.
// With two sections, 1-2 run per section: section 2's scan pass replays
// section 1 from its true start.  Group sums of one section take another
// step 3: the cascade is linear in (state, input), so step 1 also writes the
// sums of the zero-start outputs and step 3 adds the sums of the true start
// state's zero-input response (free_step), which makes or reads no input.
// A block holds lt lanes (a power of two up to 32, lanes fastest, so row
// loads and stores coalesce) x all the slices of one segment; plan() picks
// lt and the slice length from the geometry and the card's SMs so that a
// launch has ~fill_threads() threads and slices of at least kMinSlice
// rows.  The maps, the scan and the slicing are scan.cuh's, shared with
// rows.cu.  Rows go in chunks of kRows: first the chunk's inputs (independent
// of each other, straight-line code), then the serial cascade; the
// coefficient switch is tested once per chunk, and only a chunk that holds a
// block boundary checks per row.
//
// Group sums: each warp writes a chunk's rows to shared memory and sums each
// row's h-lane subgroup (h = the largest power of two dividing g, at most lt)
// with serial adds in lane order, split over at most two threads joined by a
// fixed shuffle: no atomics, so a render is the same bits every time.  A group
// wider than h is written as h-lane partials that sum_partials finishes.
//
// Rounding: the generator's phase chain uses the __f*_rn intrinsics, which
// nvcc never contracts into an FMA (the saw's one explicit FMA and the
// floor-free fractions round as the op sequence does, see synth), so it
// rounds exactly like signals_tpu_torch/nodes/osc.py (a one-ulp phase error
// at a saw wrap is a 2.0 spike).  The cascade and the scan are left to
// nvcc's default contraction (--fmad=true): that changes results only at f32
// round-off.

#include <algorithm>
#include <climits>

#include "scan.cuh"
#include "synth.cuh"

namespace {

using signals::Cascade;
using signals::Cplx;
using signals::GenSpec;
using signals::OSC_SAW;
using signals::OSC_SINE;
using signals::OSC_SQUARE;
using signals::OSC_TRIANGLE;
using signals::cmul;
using signals::kMaxThreads;
using signals::kRows;
using signals::kRowsLog;
using signals::kSinTerms;
using signals::pow_rows;
using signals::set_state;
using signals::slice_start;
using signals::synth;

constexpr int kPad = 33;             // padded shared row of the group sums

// The geometry of one launch (plan() on the host).
struct Geo {
    int lanes, F, C, m;
    int n_rows;      // C + m*F rows per carry segment
    int lt, lt_log;  // lanes per block (a power of two, at most 32), log2
    int slice;       // rows per slice, a multiple of kRows
    int n_slices;    // slices per carry segment
    int h, h_log;    // lanes per summed subgroup (0: per-lane output), log2
    int out_width;   // columns of out: lanes, or lanes / h
    // the input timeline's strides in elements (GEN: unused); a lane stride
    // of 0 is one channel that every lane reads
    int x_row, x_lane;
};

// What one thread owns: one lane of its carry segment's rows [row_a, row_b).
struct Slice {
    int64_t seg;
    int lane, lane_c;          // inactive lanes read lane 0
    bool active;
    int row_a, row_b;
    int t0;                    // the generator's frame of row 0
    float hz, ph, amp;
    bool ph0;                  // synth<.., PH0 = true> applies
};

// Coefficient block blk of one lane; coeffs is (n_blocks, NSEC, lanes, 11).
template <int NSEC>
__device__ __forceinline__ void load_taps(Cascade<NSEC>& cas,
                                          const float* __restrict__ coeffs,
                                          int64_t blk, int lanes, int lane) {
    cas.load(coeffs + ((blk * NSEC) * lanes + lane) * 11,
             (int64_t)lanes * 11);
}

// The coefficient block (within the segment) of segment row r: the context
// rows run under block 0.
__device__ __forceinline__ int block_of(int r, const Geo& g) {
    return r < g.C + g.F ? 0 : min((r - g.C) / g.F, g.m - 1);
}

// The first row of block b + 1, or INT_MAX after the last block.
__device__ __forceinline__ int switch_after(int b, const Geo& g) {
    return b + 1 < g.m ? g.C + (b + 1) * g.F : INT_MAX;
}

template <int NSEC, int S>
__device__ __forceinline__ Cplx pole(const Cascade<NSEC>& cas) {
    return {cas.tp[S].rc, cas.tp[S].rs};
}

// The chunk's synthesized rows (r0 .. r0 + kRows - 1), one branch-free run.
template <int OSC, bool PH0>
__device__ __forceinline__ void synth_rows(float (&v)[kRows], int r0,
                                           const Slice& sl,
                                           const GenSpec& gen) {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
        v[i] = synth<OSC, PH0>(sl.t0 + r0 + i, sl.hz, sl.ph, sl.amp, gen);
}

// The chunk's inputs (rows r0 .. r0 + kRows - 1), independent of each other.
template <bool GEN, int OSC>
__device__ __forceinline__ void inputs(float (&v)[kRows], int r0,
                                       const Slice& sl, const Geo& g,
                                       const float* __restrict__ x,
                                       const GenSpec& gen) {
    if (GEN) {
        if (sl.ph0) synth_rows<OSC, true>(v, r0, sl, gen);
        else synth_rows<OSC, false>(v, r0, sl, gen);
        return;
    }
    const int64_t row0 = sl.seg * g.m * g.F;     // timeline row of row 0
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int r = r0 + i;
        v[i] = (sl.active && r < sl.row_b)
                   ? x[(row0 + r) * g.x_row + sl.lane * g.x_lane] : 0.f;
    }
}

// Per-lane output: the chunk's rows past the context.
__device__ __forceinline__ void store_rows(const float (&v)[kRows], int r0,
                                           const Slice& sl, const Geo& g,
                                           float* __restrict__ out) {
    const int64_t out0 = sl.seg * g.m * g.F - g.C;   // out row of row 0
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int r = r0 + i;
        if (sl.active && r >= g.C && r < sl.row_b)
            out[(out0 + r) * g.lanes + sl.lane] = v[i];
    }
}

// Group sums of one chunk (chunk offset c0 within every slice of the warp):
// the warp's rows go through its shared tile red (kRows x kPad), then each
// (row, slice, h-lane subgroup) unit is summed in lane order by `tpu`
// threads of h / tpu lanes each, joined by a fixed shuffle tree, and
// written (ADD: added to what out holds; the same thread wrote it).  Every
// thread of the warp calls this with the same c0.
template <bool ADD>
__device__ __forceinline__ void sum_rows(const float (&v)[kRows], int c0,
                                         const Slice& sl, const Geo& g,
                                         float* red,
                                         float* __restrict__ out) {
    const int w = threadIdx.x & 31;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kRows; ++i) red[i * kPad + w] = v[i];
    __syncwarp();
    // every count here is a power of two: (row, slice, subgroup) units of
    // the warp, threads per unit (tpu), units per thread (upt)
    const int spw_log = 5 - g.lt_log, subs_log = g.lt_log - g.h_log;
    const int units_log = kRowsLog + spw_log + subs_log;
    const int tpu_log = max(5 - units_log, 0);
    const int upt = 1 << max(units_log - 5, 0);
    const int per = 1 << (g.h_log - tpu_log);      // lanes a thread adds
    const int part = w & ((1 << tpu_log) - 1);
    const int k0 = (threadIdx.x >> 5) << spw_log;  // the warp's first slice
    const int64_t out0 = sl.seg * g.m * g.F - g.C;
    for (int u = 0; u < upt; ++u) {
        const int q = (u << (5 - tpu_log)) + (w >> tpu_log);
        const int j = q & ((1 << subs_log) - 1);
        const int s = (q >> subs_log) & ((1 << spw_log) - 1);
        const int i = q >> (subs_log + spw_log);
        const float* src = red + i * kPad + (s << g.lt_log) + (j << g.h_log)
                           + part * per;
        float acc = 0.f;
        for (int l = 0; l < per; ++l) acc = __fadd_rn(acc, src[l]);
        for (int o = (1 << tpu_log) / 2; o > 0; o /= 2)
            acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, o));
        const int k = k0 + s;
        const int r = k * g.slice + c0 + i;
        const int col = (blockIdx.y << subs_log) + j;   // lane0 / h
        if (part == 0 && r >= g.C && r < min(k * g.slice + g.slice, g.n_rows)
                && (col << g.h_log) < g.lanes) {
            float* o = out + (out0 + r) * g.out_width + col;
            *o = ADD ? __fadd_rn(*o, acc) : acc;
        }
    }
}

enum { EMIT_NONE, EMIT_SET, EMIT_ADD };

// One pass over the thread's slice through the first NS sections from the
// states already in cas.  TRACK: return the transfer of section NS-1 over
// the slice (its end state is then cas.s*[NS-1]).  EMIT: write the rows (or
// their group sums), or add the group sums to out.  FREE: the zero-input
// response of one section instead (no inputs are made or read).
template <bool GEN, int OSC, int NSEC, int NS, bool TRACK, int EMIT,
          bool FREE = false>
__device__ __forceinline__ Cplx walk(Cascade<NSEC>& cas, const Slice& sl,
                                     const Geo& g,
                                     const float* __restrict__ coeffs,
                                     const float* __restrict__ x,
                                     const GenSpec& gen, float* red,
                                     float* __restrict__ out) {
    Cplx a{1.f, 0.f}, pk{1.f, 0.f};
    // slice 0 starts from zero state: its zero-input response is zero
    if (FREE && __all_sync(0xffffffffu, sl.row_a == 0)) return a;
    int b = block_of(sl.row_a, g);
    load_taps(cas, coeffs, sl.seg * g.m + b, g.lanes, sl.lane_c);
    int next_switch = switch_after(b, g);
    if (TRACK) pk = pow_rows(pole<NSEC, NS - 1>(cas));
    const int n_chunks = g.slice / kRows;
    for (int c = 0; c < n_chunks; ++c) {
        const int r0 = sl.row_a + c * kRows;
        float v[kRows];
        if (r0 < sl.row_b) {
            if (!FREE) inputs<GEN, OSC>(v, r0, sl, g, x, gen);
            if (r0 + kRows <= min(next_switch, sl.row_b)) {
#pragma unroll
                for (int i = 0; i < kRows; ++i)
                    v[i] = FREE ? cas.free_step()
                                : cas.template step<NS>(v[i]);
                if (TRACK) a = cmul(pk, a);
            } else {   // a block boundary or the segment's end
#pragma unroll
                for (int i = 0; i < kRows; ++i) {
                    const int r = r0 + i;
                    if (r >= sl.row_b) continue;
                    if (r == next_switch) {
                        load_taps(cas, coeffs, sl.seg * g.m + ++b, g.lanes,
                                  sl.lane_c);
                        next_switch = switch_after(b, g);
                        if (TRACK) pk = pow_rows(pole<NSEC, NS - 1>(cas));
                    }
                    v[i] = FREE ? cas.free_step()
                                : cas.template step<NS>(v[i]);
                    if (TRACK) a = cmul(pole<NSEC, NS - 1>(cas), a);
                }
            }
        } else {
#pragma unroll
            for (int i = 0; i < kRows; ++i) v[i] = 0.f;
        }
        if (EMIT == EMIT_NONE) continue;
        if (!g.h) {
            store_rows(v, r0, sl, g, out);
            continue;
        }
        // the warp's group sums, unless no slice of it has output rows here
        if (!__any_sync(0xffffffffu, r0 + kRows > g.C && r0 < sl.row_b))
            continue;
        sum_rows<EMIT == EMIT_ADD>(v, c * kRows, sl, g, red, out);
    }
    return a;
}

// grid: (carry segments, lane tiles of lt); block: lt lanes x n_slices
// slices, lanes fastest.  With g.h, each h-lane subgroup is summed per row
// into out (rows, lanes / h): the final sums when h is the group, else the
// partials sum_partials finishes.
template <bool GEN, int OSC, int NSEC>
__global__ void __launch_bounds__(kMaxThreads, 2)
seg_cascade(const float* __restrict__ coeffs, const float* __restrict__ x,
            const int* __restrict__ toff, const float* __restrict__ lanef,
            const GenSpec gen, float* __restrict__ out, const Geo g) {
    extern __shared__ float4 smem[];
    const int k = threadIdx.x >> g.lt_log;
    Slice sl;
    sl.seg = blockIdx.x;
    sl.lane = (blockIdx.y << g.lt_log) + (threadIdx.x & (g.lt - 1));
    sl.active = sl.lane < g.lanes;
    sl.lane_c = sl.active ? sl.lane : 0;
    sl.row_a = min(k * g.slice, g.n_rows);
    sl.row_b = min(sl.row_a + g.slice, g.n_rows);
    sl.t0 = 0;
    sl.hz = sl.ph = sl.amp = 0.f;
    sl.ph0 = false;
    if (GEN) {
        // int32 frame index exactly as the TPU kernel: toff + seg*seg_total
        sl.t0 = toff[sl.lane_c] + (int)(sl.seg * g.m * g.F);
        sl.hz = lanef[sl.lane_c];
        sl.ph = lanef[g.lanes + sl.lane_c];
        sl.amp = sl.active ? lanef[2 * g.lanes + sl.lane_c] : 0.f;
        sl.ph0 = sl.ph == 0.f && sl.hz >= 0.f;
    }
    float* red = reinterpret_cast<float*>(smem)
                 + (threadIdx.x >> 5) * kRows * kPad;

    Cascade<NSEC> cas;
    cas.reset();
    if constexpr (NSEC == 1) {
        if (g.h) {
            // group sums of one section: the sums of the zero-start outputs,
            // then those of the true start state's zero-input response added
            // -- pass 2 makes and reads no input.  It trades the replay's
            // pass of inputs for a second pass of group sums: a win for K2
            // at every geometry measured and for K1 from h = 16 on; at
            // h = 8 K1's replay is faster, but a test of h here slowed K1
            // at h = 32 (scripts/torch_seg_variants.py, PERF.md).
            const Cplx a = walk<GEN, OSC, 1, 1, true, EMIT_SET>(
                cas, sl, g, coeffs, x, gen, red, out);
            set_state(cas, 0, slice_start(a, Cplx{cas.s1[0], cas.s2[0]},
                                          smem, k, g.n_slices, g.lt));
            walk<GEN, OSC, 1, 1, false, EMIT_ADD, true>(cas, sl, g, coeffs, x,
                                                       gen, red, out);
            return;
        }
    }
    Cplx start[NSEC];
    // scan pass of section 0: from zero state
    Cplx a = walk<GEN, OSC, NSEC, 1, true, EMIT_NONE>(cas, sl, g, coeffs, x,
                                                     gen, red, out);
    start[0] = slice_start(a, Cplx{cas.s1[0], cas.s2[0]}, smem, k,
                           g.n_slices, g.lt);
    if constexpr (NSEC == 2) {
        // scan pass of section 1: section 0 replayed from its true start
        set_state(cas, 0, start[0]);
        set_state(cas, 1, Cplx{0.f, 0.f});
        a = walk<GEN, OSC, NSEC, 2, true, EMIT_NONE>(cas, sl, g, coeffs, x,
                                                    gen, red, out);
        start[1] = slice_start(a, Cplx{cas.s1[1], cas.s2[1]}, smem, k,
                               g.n_slices, g.lt);
    }
    // the replay from the true starts, writing the rows
#pragma unroll
    for (int s = 0; s < NSEC; ++s) set_state(cas, s, start[s]);
    walk<GEN, OSC, NSEC, NSEC, false, EMIT_SET>(cas, sl, g, coeffs, x, gen,
                                               red, out);
}

// Finishes the sums of groups wider than h lanes: out[i] is the sum of the k
// partials partial[i*k .. i*k + k), serial f32 adds in lane order.
__global__ void __launch_bounds__(256)
sum_partials(const float* __restrict__ partial, float* __restrict__ out,
             int64_t n_out, int k) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_out) return;
    const float* src = partial + i * k;
    float acc = 0.f;
    for (int j = 0; j < k; ++j) acc = __fadd_rn(acc, src[j]);
    out[i] = acc;
}

// The slicing of plan_slices(), one carry segment per unit; h: the largest
// power of two dividing the sum group, at most lt.
Geo plan(int n_units, int lanes, int F, int C, int m, int sum_groups) {
    Geo g{};
    g.lanes = lanes;
    g.F = F;
    g.C = C;
    g.m = m;
    g.n_rows = C + m * F;
    const signals::Slicing s = signals::plan_slices(n_units, lanes, g.n_rows);
    g.lt = s.lt;
    g.lt_log = s.lt_log;
    g.slice = s.slice;
    g.n_slices = s.n_slices;
    g.h = 0;
    g.out_width = lanes;
    if (sum_groups) {
        g.h = 1;
        while (g.h < g.lt && sum_groups % (2 * g.h) == 0) {
            g.h *= 2;
            ++g.h_log;
        }
        g.out_width = lanes / g.h;
    }
    return g;
}

template <bool GEN, int OSC, int NSEC>
int launch_n(const float* coeffs, const float* x, const int* toff,
             const float* lanef, const GenSpec& gen, float* out,
             float* partial, int n_blocks, int lanes, int F, int C, int m,
             int sum_groups, int64_t x_row, int64_t x_lane,
             cudaStream_t stream) {
    if (x_row < 0 || x_row > INT_MAX || x_lane < 0 || x_lane > INT_MAX)
        return (int)cudaErrorInvalidValue;
    Geo g = plan(n_blocks / m, lanes, F, C, m, sum_groups);
    g.x_row = (int)x_row;
    g.x_lane = (int)x_lane;
    const bool wide = sum_groups > g.h;
    if (wide && partial == nullptr) return (int)cudaErrorInvalidValue;
    const int threads = (g.n_slices * g.lt + 31) / 32 * 32;
    const size_t smem = std::max(
        2 * threads * sizeof(float4),
        (size_t)(threads / 32) * kRows * kPad * sizeof(float));
    const dim3 grid(n_blocks / m, (lanes + g.lt - 1) / g.lt);
    seg_cascade<GEN, OSC, NSEC><<<grid, threads, smem, stream>>>(
        coeffs, x, toff, lanef, gen, wide ? partial : out, g);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || !wide) return (int)e;
    const int64_t n_out = (int64_t)n_blocks * F * (lanes / sum_groups);
    sum_partials<<<(unsigned)((n_out + 255) / 256), 256, 0, stream>>>(
        partial, out, n_out, sum_groups / g.h);
    return (int)cudaGetLastError();
}

template <bool GEN, int OSC>
int launch(const float* coeffs, const float* x, const int* toff,
           const float* lanef, const GenSpec& gen, float* out,
           float* partial, int n_blocks, int nsec, int lanes, int F, int C,
           int m, int sum_groups, int64_t x_row, int64_t x_lane,
           cudaStream_t stream) {
    switch (nsec) {
    case 1:
        return launch_n<GEN, OSC, 1>(coeffs, x, toff, lanef, gen, out,
                                     partial, n_blocks, lanes, F, C, m,
                                     sum_groups, x_row, x_lane, stream);
    case 2:
        return launch_n<GEN, OSC, 2>(coeffs, x, toff, lanef, gen, out,
                                     partial, n_blocks, lanes, F, C, m,
                                     sum_groups, x_row, x_lane, stream);
    default:
        return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// Width of the partial-sum buffer (n_blocks, F, width) a launch with this
// geometry and sum group needs, or 0 when the kernel writes the sums itself.
int signals_partial_width(int n_blocks, int lanes, int F, int C, int m,
                          int sum_groups) {
    if (sum_groups == 0) return 0;
    const Geo g = plan(n_blocks / m, lanes, F, C, m, sum_groups);
    return sum_groups > g.h ? g.out_width : 0;
}

// The launchers return the cudaError_t of the launch (0 on success).
// x is read through its strides (in elements): row r of lane l is
// x[r * x_row + l * x_lane], so a one-channel timeline under many lanes
// (x_lane = 0) is read in place, never copied out to the lanes.
int sosfilt_segments_launch(const float* coeffs, const float* x,
                            int64_t x_row, int64_t x_lane, float* out,
                            float* partial, int n_blocks, int nsec, int lanes,
                            int F, int C, int m, int sum_groups,
                            void* stream) {
    GenSpec gen{};
    return launch<false, 0>(coeffs, x, nullptr, nullptr, gen, out, partial,
                            n_blocks, nsec, lanes, F, C, m, sum_groups,
                            x_row, x_lane, (cudaStream_t)stream);
}

int sosfilt_segments_gen_launch(const float* coeffs, const int* toff,
                                const float* lanef, float inv_rate, int osc,
                                const double* sin_coeffs, float* out,
                                float* partial, int n_blocks, int nsec,
                                int lanes, int F, int C, int m,
                                int sum_groups, void* stream) {
    GenSpec gen{};
    for (int k = 0; k < kSinTerms; ++k) gen.sin_c[k] = sin_coeffs[k];
    gen.inv_rate = inv_rate;
    const cudaStream_t st = (cudaStream_t)stream;
    switch (osc) {
    case OSC_SINE:
        return launch<true, OSC_SINE>(coeffs, nullptr, toff, lanef, gen, out,
                                      partial, n_blocks, nsec, lanes, F, C,
                                      m, sum_groups, 0, 0, st);
    case OSC_SQUARE:
        return launch<true, OSC_SQUARE>(coeffs, nullptr, toff, lanef, gen,
                                        out, partial, n_blocks, nsec, lanes,
                                        F, C, m, sum_groups, 0, 0, st);
    case OSC_SAW:
        return launch<true, OSC_SAW>(coeffs, nullptr, toff, lanef, gen, out,
                                     partial, n_blocks, nsec, lanes, F, C,
                                     m, sum_groups, 0, 0, st);
    default:
        return launch<true, OSC_TRIANGLE>(coeffs, nullptr, toff, lanef, gen,
                                          out, partial, n_blocks, nsec,
                                          lanes, F, C, m, sum_groups, 0, 0,
                                          st);
    }
}

const char* signals_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
