// The time-sliced scan shared by the kernels of this directory (segments.cu,
// rows.cu, adjoint.cu): the pieces that cut a run of rows into slices, one
// thread per (slice, lane), and give every slice its true start state.
//
// One section of cascade.cuh is a complex first-order recurrence: with
// s = s1 + i*s2 and p = rc + i*rs, a row is s' = p*s + x, an affine map that
// composes over any run of rows.  A thread runs its slice from zero state
// and keeps the slice's map (transfer a, the product of the rows' p; end
// state e); an exclusive scan of the maps over the slices gives each slice
// its start.  The scan's multiply-adds are left to nvcc's default
// contraction, as the cascade's are.

#pragma once

#include <algorithm>
#include <atomic>

#include "cascade.cuh"

namespace signals {

constexpr int kRows = 16;            // rows per register chunk
constexpr int kRowsLog = 4;
static_assert(kRows == 1 << kRowsLog, "kRows is 2^kRowsLog");
constexpr int kMaxThreads = 512;     // threads per block, at most
constexpr int kMinSlice = 64;        // rows per slice, at least

struct Cplx { float re, im; };

__device__ __forceinline__ Cplx cmul(Cplx a, Cplx b) {
    return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

// p^kRows by squaring (kRows is a power of two).
__device__ __forceinline__ Cplx pow_rows(Cplx p) {
#pragma unroll
    for (int n = 1; n < kRows; n *= 2) p = cmul(p, p);
    return p;
}

template <int NSEC>
__device__ __forceinline__ void set_state(Cascade<NSEC>& cas, int s, Cplx v) {
    cas.s1[s] = v.re;
    cas.s2[s] = v.im;
}

// The true state at the slice's first row: an exclusive scan of the slices'
// maps s -> a*s + e over the n_slices slices of a run (Hillis-Steele,
// double-buffered in shared memory buf of 2 * blockDim.x; slice k's lane l
// is thread k*lt + l).  (a2, e2) after (a1, e1) is (a2*a1, a2*e1 + e2).
// Slice 0 starts from zero.  Every thread of the block calls it.
// REV: the mirror for a recurrence run from the last row back (the
// adjoint's lambda): the maps compose from the last slice down, the last
// slice starts from zero, and the result is the value after slice k's last
// row.
template <bool REV = false>
__device__ __forceinline__ Cplx slice_start(Cplx a, Cplx e, float4* buf,
                                            int k, int n_slices, int lt) {
    const int t = threadIdx.x, n = blockDim.x;
    const int j = REV ? n_slices - 1 - k : k;     // position in scan order
    const int step = REV ? -lt : lt;              // to the previous position
    float4 mine = make_float4(a.re, a.im, e.re, e.im);
    int cur = 0;
    __syncthreads();                  // earlier users of buf are done
    buf[t] = mine;
    __syncthreads();
    for (int d = 1; d < n_slices; d *= 2) {
        if (j >= d) {
            const float4 prev = buf[cur * n + t - d * step];
            const Cplx ma{mine.x, mine.y};
            const Cplx na = cmul(ma, Cplx{prev.x, prev.y});
            const Cplx ne = cmul(ma, Cplx{prev.z, prev.w});
            mine = make_float4(na.re, na.im, ne.re + mine.z, ne.im + mine.w);
        }
        cur ^= 1;
        buf[cur * n + t] = mine;
        __syncthreads();
    }
    Cplx s{0.f, 0.f};
    if (j > 0) {
        const float4 p = buf[cur * n + t - step];
        s = Cplx{p.z, p.w};
    }
    __syncthreads();                  // buf is free for the next user
    return s;
}

// The threads a launch aims for: a quarter of what the current device's SMs
// hold at once (132 x 2048 / 4 on an H100 SXM), read once per device.
inline int64_t fill_threads() {
    constexpr int kDevices = 64;     // devices cached; any others are read
    static std::atomic<int64_t> cached[kDevices];
    int dev = 0;
    cudaGetDevice(&dev);
    int64_t n = dev < kDevices ? cached[dev].load(std::memory_order_relaxed)
                               : 0;
    if (n == 0) {
        int sms = 0, per_sm = 0;
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor,
                               dev);
        n = (int64_t)sms * per_sm / 4;
        if (dev < kDevices) cached[dev].store(n, std::memory_order_relaxed);
    }
    return n;
}

// How a launch cuts its runs: lanes per block (lt, a power of two, at most
// 32) and rows per slice (a multiple of kRows).
struct Slicing {
    int lt, lt_log;
    int slice, n_slices;
};

// n_units x lanes independent runs of n_rows rows each, a block holding lt
// lanes x all the slices of one unit's run.  Start from lt = the lanes (a
// power of two, at most max_lt <= 32) and halve it, which doubles the
// slices per run, while the launch has fewer than fill_threads() threads
// and halving still adds slices (at most max_threads threads a block, at
// least min_slice rows a slice: a run of up to 2 * min_slice - 1 rows is
// one slice).
inline Slicing plan_slices(int n_units, int lanes, int n_rows,
                           int min_slice = kMinSlice, int max_lt = 32,
                           int max_threads = kMaxThreads) {
    const int64_t fill = fill_threads();
    const auto slices = [&](int lt) {
        return std::max(1, std::min(max_threads / lt, n_rows / min_slice));
    };
    int lt = 1;
    while (lt < lanes && lt < max_lt) lt *= 2;
    while (lt > 1) {
        const int64_t threads = (int64_t)n_units * ((lanes + lt - 1) / lt)
                                * lt * slices(lt);
        if (threads >= fill || slices(lt / 2) <= slices(lt)) break;
        lt /= 2;
    }
    const int w = slices(lt);
    Slicing s{};
    s.lt = lt;
    while ((1 << s.lt_log) < lt) ++s.lt_log;
    s.slice = ((n_rows + w - 1) / w + kRows - 1) / kRows * kRows;
    s.n_slices = (n_rows + s.slice - 1) / s.slice;
    return s;
}

}  // namespace signals
