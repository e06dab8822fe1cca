// Zero-state cascade kernels for Hopper (sm_90a): a time-sliced scan.
//
// Replace the Pallas TPU kernels of signals_tpu/compiler/pallas_kernels.py
// with one template, rows_cascade<NSEC>, behind two launchers:
//   * sosfilt_batch_launch    <- _batch_kernel / sosfilt_batch (K3): B
//     independent windows of L rows, x_t (L, B, ch) read through its element
//     strides (overlapping windows of one timeline, a broadcast channel);
//     only the last `tail` rows of each window are written, (tail, B, ch)
//     through the output's element strides; the first L - tail only warm
//     the state up
//   * sosfilt_timeline_launch <- _section_kernel / sosfilt_pallas (K4): one
//     window, tail = L: a whole (N, ch) timeline, every row written
// Both run the coupled-form cascade of cascade.cuh, 1-4 sections per lane in
// registers, from zero state.  The TPU ran one section per sosfilt_pallas
// call and an 8-row causal-combination form per chunk; the result is the
// same up to rounding.
//
// Carried state.  Either launcher takes an optional start state zi and an
// optional end-state output zf, both (windows, nsec, 2, ch) contiguous
// (the pair s1, s2 of every section of every lane).  With zi, slice 0 of
// each window starts every section from it instead of from zero; its map's
// end state is then the true one, so the same scan gives every later slice
// its true start.  zf is the state of every section after the window's last
// row (the last slice's final replay ends there).  Null pointers give the
// zero-state behaviour, bit for bit.  This is how a streaming (exact IIR)
// filter steps a block and how its whole-window form gets the end state of
// every block.
//
// What bounds them on this card.  The work is small: the render-ahead batch
// (8 windows x 16 lanes x 1152 rows) is 147k lane-rows and 1.1 MB, whose
// roofline bound (0.3 us of bytes) is below a launch's own cost.  What
// costs is the serial chain: the row loop this kernel replaced gave one
// thread per lane and walked all L rows (16 threads for a 16-channel step,
// one for a mono step), ~80 cycles a row (PERF.md section 6).  So the
// rows are cut into slices, as segments.cu does (the
// scan's pieces are scan.cuh's): one section is s' = p*s + x over complex
// numbers, so a slice of rows is an affine map.  One thread per (slice,
// lane), lanes fastest so that row loads and stores coalesce:
//   1. the scan pass of section 0: each thread runs its slice from zero
//      state and keeps the map (transfer, end state); slice_start's
//      Hillis-Steele scan in shared memory gives each slice its true start;
//   2. the scan pass of section k replays sections 0..k-1 from their true
//      starts and runs section k from zero state, then scans again;
//   3. the final replay runs all sections from the true starts and writes
//      the rows -- only in slices that hold rows past L - tail: a slice
//      wholly in the warmup takes part in the scans only.
// Slices are one chunk of kRows rows or more: plan_slices() with a minimum
// slice of kRows picks lanes per block and the slice length, and at these
// shapes the slices of a window carry the parallelism (a mono step runs 72
// threads of 16 rows, not one of 1152).  Per row a thread issues a load, the
// cascade and a store, so its rows per pass set the time at every shape
// measured: 64-row slices (segments.cu's minimum) ran 2.4x slower.  A
// window of fewer than 2 * kRows rows is one slice: the plain row loop from
// zero state, without a scan.  Rows go in chunks of kRows: first the chunk's
// loads (independent of each other), then the serial cascade; the passes
// after the first read their rows again from L1.
//
// Output layout.  Row r of lane (b, c) goes to out + r*o_row + b*o_win +
// c*o_ch.  Lane-major, (tail, B, ch) contiguous, a warp's 32 lanes store one
// row as 128 contiguous bytes.  Time-major (o_row = 1: each lane's rows
// consecutive, as the vmap layout of PolyPatch wants one voice's blocks) a
// thread's kept rows of a full chunk are 64 contiguous bytes: it stores them
// as four 16-byte vector stores where that address is 16-byte aligned (a
// chunk wholly past the warmup, the lane's base and the chunk's first
// output row multiples of 4 floats), else row by row.  The kept rows are
// half the bytes a whole-window call needs (677 MB in the 64-voice score's
// 60 s; the other half is the timeline its overlapping windows read), so
// the store pattern is what the layout may cost; writing time-major saves
// the caller a transposing copy of all of them.  At that shape (its input
// voice-major too) the time-major stores took 2.46 ms against 2.16
// lane-major, and the copy they save took 5.5 ms (PERF.md section 6).  The
// cascade, the scan and every stored value are the same in both layouts:
// only addresses change.
//
// Rounding: the cascade and the scan are left to nvcc's default contraction
// (--fmad=true), which changes results only at f32 round-off.

#include "scan.cuh"

namespace {

using signals::Cascade;
using signals::Cplx;
using signals::cmul;
using signals::kMaxThreads;
using signals::kRows;
using signals::pow_rows;
using signals::set_state;
using signals::slice_start;

// Section s of a lane's start state: zl points at the lane's (nsec, 2, ch)
// entry of zi, or is null for a zero start (no zi, or not the window's first
// slice).
__device__ __forceinline__ Cplx init_state(const float* __restrict__ zl,
                                           int s, int ch) {
    if (zl == nullptr) return Cplx{0.f, 0.f};
    return Cplx{zl[(int64_t)(2 * s) * ch], zl[(int64_t)(2 * s + 1) * ch]};
}

// One launch: the windows, their element strides, and the slicing.
struct RowsGeo {
    int ch, lanes;                  // lanes = windows * ch, lane = b*ch + c
    int n_rows;                     // rows per window
    int skip;                       // rows before the output (L - tail)
    int64_t x_row, x_win, x_ch;     // strides of x_t (L, B, ch)
    int64_t o_row, o_win, o_ch;     // strides of out (tail, B, ch)
    int64_t co_win, co_sec, co_ch;  // strides of coeffs (B, nsec, ch, 11)
    int lt, lt_log, slice, n_slices;
};

// One pass over rows [row_a, row_b) of one lane (its input column xl)
// through the first NS sections from the states in cas.  TRACK: return the
// transfer of section NS-1 over the rows (its end state is then in cas).
// EMIT: write the rows from g.skip on to out, the lane's output column
// (row r at out + (r - g.skip) * g.o_row).  Rows are addressed by pointers
// that step by their strides, and an inactive lane reads lane 0's rows
// (valid memory) and writes nothing.
template <int NSEC, int NS, bool TRACK, bool EMIT>
__device__ __forceinline__ Cplx walk(Cascade<NSEC>& cas,
                                     const float* __restrict__ xl,
                                     float* __restrict__ out, int row_a,
                                     int row_b, bool active,
                                     const RowsGeo& g) {
    Cplx a{1.f, 0.f};
    const Cplx p{cas.tp[NS - 1].rc, cas.tp[NS - 1].rs};
    const Cplx pk = TRACK ? pow_rows(p) : a;
    const float* xr = xl + (int64_t)row_a * g.x_row;
    for (int r0 = row_a; r0 < row_b; r0 += kRows) {
        const int n = min(kRows, row_b - r0);        // rows of the chunk
        float v[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            v[i] = i < n ? *xr : 0.f;
            xr += g.x_row;
        }
        if (n == kRows) {
#pragma unroll
            for (int i = 0; i < kRows; ++i) v[i] = cas.template step<NS>(v[i]);
            if (TRACK) a = cmul(pk, a);
        } else {   // the slice's last rows
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
                if (i >= n) continue;
                v[i] = cas.template step<NS>(v[i]);
                if (TRACK) a = cmul(p, a);
            }
        }
        if (!EMIT || !active) continue;
        const int lo = max(g.skip - r0, 0);          // the first output row
        float* o = out + (int64_t)(r0 + lo - g.skip) * g.o_row;
        if (g.o_row == 1 && lo == 0 && n == kRows
                && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
            float4* o4 = reinterpret_cast<float4*>(o);   // time-major, whole
#pragma unroll
            for (int i = 0; i < kRows / 4; ++i)
                o4[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                                    v[4 * i + 3]);
            continue;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            if (i < lo || i >= n) continue;
            *o = v[i];
            o += g.o_row;
        }
    }
    return a;
}

// The scan passes of sections S.. NSEC-1: section S's replays sections
// 0..S-1 from their true starts and runs section S from zero state (the
// window's first slice from its start state zl); the scan gives each later
// slice section S's true start.
template <int NSEC, int S = 0>
__device__ __forceinline__ void scan_sections(Cascade<NSEC>& cas,
                                              Cplx (&start)[NSEC],
                                              const float* __restrict__ xl,
                                              int row_a, int row_b,
                                              bool active, int k,
                                              float4* buf,
                                              const float* __restrict__ zl,
                                              const RowsGeo& g) {
    if constexpr (S < NSEC) {
#pragma unroll
        for (int s = 0; s < S; ++s) set_state(cas, s, start[s]);
        set_state(cas, S, init_state(zl, S, g.ch));
        const Cplx a = walk<NSEC, S + 1, true, false>(cas, xl, nullptr, row_a,
                                                      row_b, active, g);
        const Cplx st = slice_start(a, Cplx{cas.s1[S], cas.s2[S]}, buf, k,
                                    g.n_slices, g.lt);
        start[S] = zl != nullptr ? init_state(zl, S, g.ch) : st;
        scan_sections<NSEC, S + 1>(cas, start, xl, row_a, row_b, active, k,
                                   buf, zl, g);
    }
}

// grid: lane tiles of lt over the windows' lanes; block: lt lanes x
// n_slices slices, lanes fastest.  out (tail, B, ch) through the strides
// (o_row, o_win, o_ch); zi and zf (windows, NSEC, 2, ch) contiguous, or
// null.  The explicit minimum of one block per SM lets ptxas use up to 128
// registers: without it, it held 1-2 sections to 64 and spilled at 2 (a few
// blocks on the whole card run here, so occupancy buys nothing).
template <int NSEC>
__global__ void __launch_bounds__(kMaxThreads, 1)
rows_cascade(const float* __restrict__ coeffs, const float* __restrict__ x,
             float* __restrict__ out, const float* __restrict__ zi,
             float* __restrict__ zf, const RowsGeo g) {
    extern __shared__ float4 smem[];
    const int k = threadIdx.x >> g.lt_log;
    const int lane = (blockIdx.x << g.lt_log) + (threadIdx.x & (g.lt - 1));
    const bool active = lane < g.lanes;
    const int lane_c = active ? lane : 0;          // inactive lanes read 0
    const int b = lane_c / g.ch, c = lane_c - b * g.ch;
    const float* xl = x + b * g.x_win + c * g.x_ch;
    const int row_a = min(k * g.slice, g.n_rows);
    const int row_b = min(row_a + g.slice, g.n_rows);
    Cascade<NSEC> cas;
    cas.load(coeffs + b * g.co_win + c * g.co_ch, g.co_sec);
    const int64_t z_lane = (int64_t)b * NSEC * 2 * g.ch + c;
    // the start state, in the first slice of an active lane only
    const float* zl = (zi != nullptr && k == 0 && active) ? zi + z_lane
                                                          : nullptr;
    if (g.n_slices > 1) {
        Cplx start[NSEC];
        scan_sections<NSEC>(cas, start, xl, row_a, row_b, active, k, smem, zl,
                            g);
#pragma unroll
        for (int s = 0; s < NSEC; ++s) set_state(cas, s, start[s]);
    } else {
#pragma unroll
        for (int s = 0; s < NSEC; ++s)
            set_state(cas, s, init_state(zl, s, g.ch));
    }
    // the final replay, in the slices that hold output rows
    if (row_b > g.skip)
        walk<NSEC, NSEC, false, true>(cas, xl,
                                      out + b * g.o_win + c * g.o_ch, row_a,
                                      row_b, active, g);
    // the last slice's replay ends on the window's end state
    if (zf != nullptr && active && k == g.n_slices - 1) {
#pragma unroll
        for (int s = 0; s < NSEC; ++s) {
            zf[z_lane + (int64_t)(2 * s) * g.ch] = cas.s1[s];
            zf[z_lane + (int64_t)(2 * s + 1) * g.ch] = cas.s2[s];
        }
    }
}

template <int NSEC>
int launch_n(const float* coeffs, const float* x, float* out, const float* zi,
             float* zf, RowsGeo g, cudaStream_t stream) {
    // slices of one chunk at least: a shorter slice's thread walks fewer
    // rows, which set the time at every shape measured (PERF.md)
    const signals::Slicing s = signals::plan_slices(1, g.lanes, g.n_rows,
                                                    kRows);
    g.lt = s.lt;
    g.lt_log = s.lt_log;
    g.slice = s.slice;
    g.n_slices = s.n_slices;
    const int threads = (g.n_slices * g.lt + 31) / 32 * 32;
    const size_t smem = g.n_slices > 1 ? 2 * threads * sizeof(float4) : 0;
    rows_cascade<NSEC><<<(g.lanes + g.lt - 1) / g.lt, threads, smem,
                         stream>>>(coeffs, x, out, zi, zf, g);
    return (int)cudaGetLastError();
}

int launch(const float* coeffs, const float* x, float* out, const float* zi,
           float* zf, const RowsGeo& g, int nsec, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    switch (nsec) {
    case 1: return launch_n<1>(coeffs, x, out, zi, zf, g, st);
    case 2: return launch_n<2>(coeffs, x, out, zi, zf, g, st);
    case 3: return launch_n<3>(coeffs, x, out, zi, zf, g, st);
    case 4: return launch_n<4>(coeffs, x, out, zi, zf, g, st);
    default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// The launchers return the cudaError_t of the launch (0 on success);
// nsec outside 1..4 is refused with cudaErrorInvalidValue.  Strides are in
// elements; the 11 coefficient columns are contiguous.  The output's
// elements must not overlap.  zi (the start state) and zf (the end state,
// written) are (windows, nsec, 2, ch) contiguous, each null for none.

// coeffs (nsec, ch, 11), x (n_rows, ch) -> out (n_rows, ch).
int sosfilt_timeline_launch(const float* coeffs, int64_t co_sec,
                            int64_t co_ch, const float* x, int64_t x_row,
                            int64_t x_ch, float* out, int64_t o_row,
                            int64_t o_ch, const float* zi, float* zf,
                            int nsec, int ch, int n_rows, void* stream) {
    RowsGeo g{};
    g.ch = ch;
    g.lanes = ch;
    g.n_rows = n_rows;
    g.skip = 0;
    g.x_row = x_row;
    g.x_ch = x_ch;
    g.o_row = o_row;
    g.o_ch = o_ch;
    g.co_sec = co_sec;
    g.co_ch = co_ch;
    return launch(coeffs, x, out, zi, zf, g, nsec, stream);
}

// coeffs (n_windows, nsec, ch, 11), x (n_rows, n_windows, ch) -> out (tail,
// n_windows, ch): lane-major (n_windows * ch, ch, 1) or time-major (1,
// tail, tail * n_windows), or any strides.
int sosfilt_batch_launch(const float* coeffs, int64_t co_win, int64_t co_sec,
                         int64_t co_ch, const float* x, int64_t x_row,
                         int64_t x_win, int64_t x_ch, float* out,
                         int64_t o_row, int64_t o_win, int64_t o_ch,
                         const float* zi, float* zf, int nsec, int n_windows,
                         int ch, int n_rows, int tail, void* stream) {
    RowsGeo g{};
    g.ch = ch;
    g.lanes = n_windows * ch;
    g.n_rows = n_rows;
    g.skip = n_rows - tail;
    g.x_row = x_row;
    g.x_win = x_win;
    g.x_ch = x_ch;
    g.o_row = o_row;
    g.o_win = o_win;
    g.o_ch = o_ch;
    g.co_win = co_win;
    g.co_sec = co_sec;
    g.co_ch = co_ch;
    return launch(coeffs, x, out, zi, zf, g, nsec, stream);
}

}  // extern "C"
