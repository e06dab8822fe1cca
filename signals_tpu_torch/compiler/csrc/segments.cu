// Segment-cascade kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of signals_tpu/compiler/pallas_kernels.py:
//   * seg_cascade<.., GEN=true>  <- _seg_kernel_gen / sosfilt_segments_gen
//     (the oscillator input is synthesized in registers from the frame index)
//   * seg_cascade<.., GEN=false> <- _seg_kernel, _seg_kernel_reuse /
//     sosfilt_segments (the input is read from a timeline in memory)
// Both run the one coupled-form cascade (signals::Cascade in cascade.cuh, the
// counterpart of _run_cascade) and the one lane-group sum (flush_group_sums,
// the counterpart of _group_sum_chunk), so their numerics cannot drift apart.
//
// What computes: for each carry segment u (m coefficient blocks of F frames)
// and lane, C context rows warm the state up from zero under block u*m's
// coefficients, then m*F rows run with per-block coefficients and the state
// carried; only those m*F rows are written, block-major (n_blocks, F, lanes),
// or, with sum_groups = g, the sum of each g-lane group (n_blocks, F, lanes/g).
// One or two order-2 sections per lane (NSEC, as the Butterworth designs give:
// low/high-pass 1, band-pass/band-stop 2), all in registers.  A block holds at
// most kMaxTile lanes; a group wider than that is summed as
// tile-wide partials, which a second small kernel (sum_partials) adds up.
//
// What bounds it on this card: the recurrence is serial in time, so one
// thread owns one (segment, lane) and walks C + m*F rows; with few warps per
// SM the row loop is latency-bound, not bound by bytes or FLOPs.  Parallelism
// comes from segments x lanes, which replaces the TPU's 1024-lane packing.
// Rows go in chunks of kChunk: first every input of the chunk (kChunk
// independent oscillator evaluations, which the scheduler overlaps, or the
// chunk's rows, whose loads were issued one chunk ahead), then the serial
// cascade over the chunk in registers, then one store or one lane-group
// flush for the chunk.  The TPU's 8-row causal-combination form, DMA rings
// and 128-lane tiling are not carried over.
//
// Rounding: the generator's phase chain uses the __f*_rn intrinsics, which
// nvcc never contracts into an FMA, so it rounds exactly like
// signals_tpu_torch/nodes/osc.py (a one-ulp phase error at a saw wrap is a
// 2.0 spike).  The cascade itself is left to nvcc's default contraction
// (--fmad=true): that changes results only at f32 round-off.

#include "cascade.cuh"

namespace {

using signals::Cascade;
using signals::kChunk;
using signals::kMaxTile;

constexpr int kSinTerms = 7;   // Horner terms of sin(2*pi*y), mathx.sin2pi

enum { OSC_SINE = 0, OSC_SQUARE = 1, OSC_SAW = 2, OSC_TRIANGLE = 3 };

struct GenSpec {
    double sin_c[kSinTerms];   // mathx._SIN2PI_COEFFS, passed from Python
    float inv_rate;            // 1/rate as a runtime value, never folded
};

__device__ __forceinline__ float frac_rn(float v) {
    return __fsub_rn(v, floorf(v));
}

__device__ __forceinline__ float sign_f(float v) {
    return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

// sin(2*pi*t) for t in [0, 1): the f32 quadrant fold and the f64 Horner
// chain of mathx.sin2pi, rounded to f32 once (bit-identical to numpy).
__device__ __forceinline__ float sin2pi_f64(float t, const GenSpec& g) {
    const float r = __fsub_rn(t, 0.5f);
    const float y = r > 0.25f ? __fsub_rn(0.5f, r)
                  : (r < -0.25f ? __fsub_rn(-0.5f, r) : r);
    const double z = (double)__fmul_rn(y, y);
    double acc = g.sin_c[kSinTerms - 1];
#pragma unroll
    for (int k = kSinTerms - 2; k >= 0; --k)
        acc = __dadd_rn(g.sin_c[k], __dmul_rn(z, acc));
    return -__fmul_rn(y, __double2float_rn(acc));
}

// One oscillator sample at absolute frame t: nodes/osc.py's op sequence,
// (t * inv_rate) * hz reduced with x - floor(x), then the phase offset.
template <int OSC>
__device__ __forceinline__ float synth(int t, float hz, float ph, float amp,
                                       const GenSpec& g) {
    if (t < 0) return 0.f;
    const float tf = __int2float_rn(t);
    const float turns = frac_rn(__fmul_rn(__fmul_rn(tf, g.inv_rate), hz));
    const float tt = frac_rn(__fadd_rn(turns, ph));
    float x;
    if (OSC == OSC_SINE) {
        x = sin2pi_f64(tt, g);
    } else if (OSC == OSC_SQUARE) {
        x = sign_f(__fsub_rn(0.5f, frac_rn(tt)));
    } else if (OSC == OSC_SAW) {
        x = __fsub_rn(__fmul_rn(2.f, frac_rn(__fsub_rn(tt, 0.5f))), 1.f);
    } else {  // OSC_TRIANGLE
        const float t3 = __fsub_rn(tt, 0.25f);
        const float half = __fmul_rn(0.5f, frac_rn(__fmul_rn(t3, 2.f)));
        x = __fmul_rn(__fsub_rn(__fmul_rn(4.f, half), 1.f),
                      sign_f(__fsub_rn(frac_rn(t3), 0.5f)));
    }
    return __fmul_rn(amp, x);
}

// Coefficient block blk of one lane; coeffs is (n_blocks, NSEC, lanes, 11).
template <int NSEC>
__device__ __forceinline__ void load_taps(Cascade<NSEC>& cas,
                                          const float* __restrict__ coeffs,
                                          int64_t blk, int lanes, int lane) {
    cas.load(coeffs + ((blk * NSEC) * lanes + lane) * 11,
             (int64_t)lanes * 11);
}

// kChunk timeline rows of one lane from row r0 (zeros past n_rows).
__device__ __forceinline__ void load_rows(float (&dst)[kChunk],
                                          const float* __restrict__ x,
                                          int64_t row0, int r0, int n_rows,
                                          int lanes, int lane, bool active) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
        const int r = r0 + i;
        dst[i] = (active && r < n_rows) ? x[(row0 + r) * lanes + lane] : 0.f;
    }
}

// The mix epilogue: reduce each g-lane group of the chunk's output rows
// [i_lo, i_hi) (buffered in sbuf, one padded row per chunk row) to its sum,
// serial f32 adds in lane order, and write them to out (rows, n_groups).
__device__ __forceinline__ void flush_group_sums(
        const float* sbuf, int i_lo, int i_hi, int stride, int g,
        int64_t out_row0, int n_groups, float* __restrict__ out) {
    __syncthreads();
    const int per_tile = blockDim.x / g;
    const int group0 = (blockIdx.y * blockDim.x) / g;
    for (int k = threadIdx.x; k < (i_hi - i_lo) * per_tile;
         k += blockDim.x) {
        const int i = i_lo + k / per_tile;
        const int grp = k % per_tile;
        if (group0 + grp >= n_groups) continue;
        const float* src = sbuf + i * stride + grp * g;
        float acc = 0.f;
        for (int j = 0; j < g; ++j) acc = __fadd_rn(acc, src[j]);
        out[(out_row0 + i) * n_groups + group0 + grp] = acc;
    }
    __syncthreads();
}

// grid: (n_segments, lane tiles); block: one thread per lane of the tile.
// With sum_groups = g, each g-lane group of the tile is summed per row into
// out (rows, lanes / g) (g never exceeds the tile here: launch() turns a
// wider group into tile-wide partial groups that sum_partials finishes).
template <bool GEN, int OSC, int NSEC>
__global__ void __launch_bounds__(kMaxTile)
seg_cascade(const float* __restrict__ coeffs, const float* __restrict__ x,
            const int* __restrict__ toff, const float* __restrict__ lanef,
            const GenSpec gen, float* __restrict__ out, int lanes, int F,
            int C, int m, int sum_groups) {
    extern __shared__ float sbuf[];
    const int64_t seg = blockIdx.x;
    const int lane = blockIdx.y * blockDim.x + threadIdx.x;
    const bool active = lane < lanes;
    const int lane_c = active ? lane : 0;   // inactive lanes read lane 0
    const int seg_total = m * F;
    const int n_rows = C + seg_total;
    const int64_t row0 = seg * seg_total;   // first timeline/output row
    const int stride = blockDim.x + 1;      // padded sbuf row

    Cascade<NSEC> cas;
    cas.reset();
    int64_t blk = seg * m;
    load_taps(cas, coeffs, blk, lanes, lane_c);
    int next_switch = C + F;

    int t0 = 0;
    float hz = 0.f, ph = 0.f, amp = 0.f;
    if (GEN) {
        // int32 frame index exactly as the TPU kernel: toff + seg*seg_total
        t0 = toff[lane_c] + (int)(seg * seg_total);
        hz = lanef[lane_c];
        ph = lanef[lanes + lane_c];
        amp = active ? lanef[2 * lanes + lane_c] : 0.f;
    }

    // timeline rows are double-buffered in registers: the next chunk's
    // loads are issued before this chunk's serial cascade and land during it
    float v[kChunk], next[kChunk];
    if (!GEN) load_rows(next, x, row0, 0, n_rows, lanes, lane, active);
    for (int r0 = 0; r0 < n_rows; r0 += kChunk) {
        // 1. the chunk's inputs: independent of each other and of the state
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
            v[i] = GEN ? synth<OSC>(t0 + r0 + i, hz, ph, amp, gen) : next[i];
        if (!GEN)
            load_rows(next, x, row0, r0 + kChunk, n_rows, lanes, lane,
                      active);
        // 2. the serial cascade over the chunk (rows past n_rows only
        //    advance a state nothing reads)
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
            if (r0 + i == next_switch && next_switch < n_rows) {
                load_taps(cas, coeffs, ++blk, lanes, lane_c);
                next_switch += F;
            }
            v[i] = cas.step(v[i]);
        }
        // 3. the chunk's output rows [i_lo, i_hi): stores or group sums
        const int i_lo = max(C - r0, 0);
        const int i_hi = min(n_rows - r0, kChunk);
        if (i_lo >= i_hi) continue;                  // context only
        const int64_t out_row0 = row0 + r0 - C;
        if (sum_groups == 0) {
#pragma unroll
            for (int i = 0; i < kChunk; ++i)
                if (active && i >= i_lo && i < i_hi)
                    out[(out_row0 + i) * lanes + lane] = v[i];
        } else {
#pragma unroll
            for (int i = 0; i < kChunk; ++i)
                sbuf[i * stride + threadIdx.x] = active ? v[i] : 0.f;
            flush_group_sums(sbuf, i_lo, i_hi, stride, sum_groups, out_row0,
                             lanes / sum_groups, out);
        }
    }
}

// Finishes the sums of groups wider than a tile: out[i] is the sum of the k
// tile partials partial[i*k .. i*k + k), serial f32 adds in lane order.
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

// Threads per block: at most kMaxTile, never more lanes than the call has
// (rounded up to a warp).  With a sum group of g <= kMaxTile lanes, a whole
// number of groups (no group straddles two blocks); with a wider group, the
// widest divisor of g that fits, whose partial sums sum_partials finishes.
int tile_lanes(int lanes, int sum_groups) {
    const int cap = lanes < kMaxTile ? lanes : kMaxTile;
    if (sum_groups == 0) return (cap + 31) / 32 * 32;
    if (sum_groups <= kMaxTile) return (cap / sum_groups) * sum_groups;
    int t = kMaxTile;
    while (sum_groups % t) --t;
    return t;
}

template <bool GEN, int OSC, int NSEC>
int launch_n(const float* coeffs, const float* x, const int* toff,
             const float* lanef, const GenSpec& gen, float* out,
             float* partial, int n_blocks, int lanes, int F, int C, int m,
             int sum_groups, cudaStream_t stream) {
    const int tile = tile_lanes(lanes, sum_groups);
    const bool wide = sum_groups > tile;
    if (wide && partial == nullptr) return (int)cudaErrorInvalidValue;
    const dim3 grid(n_blocks / m, (lanes + tile - 1) / tile);
    const size_t smem =
        sum_groups ? (size_t)kChunk * (tile + 1) * sizeof(float) : 0;
    seg_cascade<GEN, OSC, NSEC><<<grid, tile, smem, stream>>>(
        coeffs, x, toff, lanef, gen, wide ? partial : out, lanes, F, C, m,
        wide ? tile : sum_groups);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || !wide) return (int)e;
    const int64_t n_out = (int64_t)n_blocks * F * (lanes / sum_groups);
    sum_partials<<<(unsigned)((n_out + 255) / 256), 256, 0, stream>>>(
        partial, out, n_out, sum_groups / tile);
    return (int)cudaGetLastError();
}

template <bool GEN, int OSC>
int launch(const float* coeffs, const float* x, const int* toff,
           const float* lanef, const GenSpec& gen, float* out,
           float* partial, int n_blocks, int nsec, int lanes, int F, int C,
           int m, int sum_groups, cudaStream_t stream) {
    switch (nsec) {
    case 1:
        return launch_n<GEN, OSC, 1>(coeffs, x, toff, lanef, gen, out,
                                     partial, n_blocks, lanes, F, C, m,
                                     sum_groups, stream);
    case 2:
        return launch_n<GEN, OSC, 2>(coeffs, x, toff, lanef, gen, out,
                                     partial, n_blocks, lanes, F, C, m,
                                     sum_groups, stream);
    default:
        return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// Width of the partial-sum buffer (n_blocks, F, width) a launch with this
// lane count and sum group needs, or 0 when the group fits one tile.
int signals_partial_width(int lanes, int sum_groups) {
    const int tile = tile_lanes(lanes, sum_groups);
    return sum_groups > tile ? lanes / tile : 0;
}

// The launchers return the cudaError_t of the launch (0 on success).
int sosfilt_segments_launch(const float* coeffs, const float* x, float* out,
                            float* partial, int n_blocks, int nsec, int lanes,
                            int F, int C, int m, int sum_groups,
                            void* stream) {
    GenSpec gen{};
    return launch<false, 0>(coeffs, x, nullptr, nullptr, gen, out, partial,
                            n_blocks, nsec, lanes, F, C, m, sum_groups,
                            (cudaStream_t)stream);
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
                                      m, sum_groups, st);
    case OSC_SQUARE:
        return launch<true, OSC_SQUARE>(coeffs, nullptr, toff, lanef, gen,
                                        out, partial, n_blocks, nsec, lanes,
                                        F, C, m, sum_groups, st);
    case OSC_SAW:
        return launch<true, OSC_SAW>(coeffs, nullptr, toff, lanef, gen, out,
                                     partial, n_blocks, nsec, lanes, F, C,
                                     m, sum_groups, st);
    default:
        return launch<true, OSC_TRIANGLE>(coeffs, nullptr, toff, lanef, gen,
                                          out, partial, n_blocks, nsec,
                                          lanes, F, C, m, sum_groups, st);
    }
}

const char* signals_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
