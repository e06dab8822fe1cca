// Zero-state cascade kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of signals_tpu/compiler/pallas_kernels.py:
//   * batch_cascade<NSEC>    <- _batch_kernel / sosfilt_batch (K3): B
//     independent windows of L rows, (L, B, ch); only the last `tail` rows
//     of each window are written, the first L - tail only warm the state up
//   * timeline_cascade<NSEC> <- _section_kernel / sosfilt_pallas (K4): one
//     whole (N, ch) timeline, every row written
// Both run the shared row loop (run_rows) over the coupled-form cascade of
// cascade.cuh, all NSEC sections per row in registers, from zero state.  The
// TPU ran one section per sosfilt_pallas call and an 8-row causal-combination
// form per chunk; the result is the same up to rounding.
//
// What bounds them on this card: the recurrence is serial in time, so one
// thread owns one lane (one channel of one window) and walks its rows; the
// launch is latency-bound (a mono per-block step is ONE thread running
// C + F rows), not bound by bytes or FLOPs.  Rows go in chunks of kChunk
// whose loads are issued one chunk ahead, so they land during the previous
// chunk's serial cascade.  Neighbouring threads hold neighbouring channels,
// so each row's loads and stores coalesce.  The TPU's (8, 128) tiling,
// 1024-lane groups, row padding and ROW_CHUNK grid are not carried over.

#include "cascade.cuh"

namespace {

using signals::Cascade;
using signals::kChunk;
using signals::kMaxTile;
using signals::lane_tile;

// kChunk rows of one lane from row r0 (zeros past n_rows or when inactive).
__device__ __forceinline__ void load_chunk(float (&dst)[kChunk],
                                           const float* __restrict__ x,
                                           int64_t row_stride, int r0,
                                           int n_rows, bool active) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
        const int r = r0 + i;
        dst[i] = (active && r < n_rows) ? x[(int64_t)r * row_stride] : 0.f;
    }
}

// One lane: x[r * row_stride] for r < n_rows through the cascade from zero
// state; rows r >= skip are written to out[(r - skip) * row_stride].
template <int NSEC>
__device__ __forceinline__ void run_rows(Cascade<NSEC>& cas,
                                         const float* __restrict__ x,
                                         float* __restrict__ out,
                                         int64_t row_stride, int n_rows,
                                         int skip, bool active) {
    cas.reset();
    float v[kChunk], next[kChunk];
    load_chunk(next, x, row_stride, 0, n_rows, active);
    for (int r0 = 0; r0 < n_rows; r0 += kChunk) {
#pragma unroll
        for (int i = 0; i < kChunk; ++i) v[i] = next[i];
        load_chunk(next, x, row_stride, r0 + kChunk, n_rows, active);
#pragma unroll
        for (int i = 0; i < kChunk; ++i) v[i] = cas.step(v[i]);
        if (!active || r0 + kChunk <= skip) continue;    // warmup rows only
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
            const int r = r0 + i;
            if (r >= skip && r < n_rows)
                out[(int64_t)(r - skip) * row_stride] = v[i];
        }
    }
}

// grid: lane tiles; block: one thread per channel.  coeffs (nsec, ch, 11),
// x and out (n_rows, ch).
template <int NSEC>
__global__ void __launch_bounds__(kMaxTile)
timeline_cascade(const float* __restrict__ coeffs,
                 const float* __restrict__ x, float* __restrict__ out,
                 int ch, int n_rows) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    const bool active = lane < ch;
    const int lane_c = active ? lane : 0;
    Cascade<NSEC> cas;
    cas.load(coeffs + (int64_t)lane_c * 11, (int64_t)ch * 11);
    run_rows(cas, x + lane_c, out + lane_c, ch, n_rows, 0, active);
}

// grid: lane tiles over the B * ch lanes of a row; block: one thread per
// (window b, channel c), lane = b * ch + c.  coeffs (B, nsec, ch, 11),
// x (n_rows, B, ch), out (tail, B, ch).
template <int NSEC>
__global__ void __launch_bounds__(kMaxTile)
batch_cascade(const float* __restrict__ coeffs, const float* __restrict__ x,
              float* __restrict__ out, int n_windows, int ch, int n_rows,
              int tail) {
    const int lanes = n_windows * ch;
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    const bool active = lane < lanes;
    const int lane_c = active ? lane : 0;
    const int b = lane_c / ch, c = lane_c % ch;
    Cascade<NSEC> cas;
    cas.load(coeffs + ((int64_t)b * NSEC * ch + c) * 11, (int64_t)ch * 11);
    run_rows(cas, x + lane_c, out + lane_c, lanes, n_rows, n_rows - tail,
             active);
}

template <int NSEC>
int launch_timeline(const float* coeffs, const float* x, float* out, int ch,
                    int n_rows, cudaStream_t stream) {
    const int tile = lane_tile(ch);
    timeline_cascade<NSEC><<<(ch + tile - 1) / tile, tile, 0, stream>>>(
        coeffs, x, out, ch, n_rows);
    return (int)cudaGetLastError();
}

template <int NSEC>
int launch_batch(const float* coeffs, const float* x, float* out,
                 int n_windows, int ch, int n_rows, int tail,
                 cudaStream_t stream) {
    const int lanes = n_windows * ch;
    const int tile = lane_tile(lanes);
    batch_cascade<NSEC><<<(lanes + tile - 1) / tile, tile, 0, stream>>>(
        coeffs, x, out, n_windows, ch, n_rows, tail);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The launchers return the cudaError_t of the launch (0 on success);
// nsec outside 1..4 is refused with cudaErrorInvalidValue.
int sosfilt_timeline_launch(const float* coeffs, const float* x, float* out,
                            int nsec, int ch, int n_rows, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    switch (nsec) {
    case 1: return launch_timeline<1>(coeffs, x, out, ch, n_rows, st);
    case 2: return launch_timeline<2>(coeffs, x, out, ch, n_rows, st);
    case 3: return launch_timeline<3>(coeffs, x, out, ch, n_rows, st);
    case 4: return launch_timeline<4>(coeffs, x, out, ch, n_rows, st);
    default: return (int)cudaErrorInvalidValue;
    }
}

int sosfilt_batch_launch(const float* coeffs, const float* x, float* out,
                         int nsec, int n_windows, int ch, int n_rows,
                         int tail, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    switch (nsec) {
    case 1:
        return launch_batch<1>(coeffs, x, out, n_windows, ch, n_rows, tail,
                               st);
    case 2:
        return launch_batch<2>(coeffs, x, out, n_windows, ch, n_rows, tail,
                               st);
    case 3:
        return launch_batch<3>(coeffs, x, out, n_windows, ch, n_rows, tail,
                               st);
    case 4:
        return launch_batch<4>(coeffs, x, out, n_windows, ch, n_rows, tail,
                               st);
    default:
        return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
