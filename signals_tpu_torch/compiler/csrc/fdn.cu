// The Reverb's feedback delay network for Hopper (sm_90a): its advance over
// a window and the adjoint of that advance.
//
// No port of a Pallas kernel: these replace the lax.scan of the JAX
// package's Reverb.mega_step (signals_tpu/nodes/reverb.py:171-189) and
// JAX's autodiff of it.  Eager PyTorch would issue ~18 small kernels per
// turn of the recurrence (tens of thousands for a minute of audio), and
// neither autograd nor torch.func.vmap can see through a timeline written
// in place; these two kernels are the forward and backward of one
// autograd.Function with a vmap rule (compiler/kernels.py, _FdnFn).
//
// The recurrence, per lane c, line i, frame t of the window:
//     r_j[t]      = tl[L + t - d_j, j]
//     tl[L+t, i]  = sum_{j=0..7} H[i,j] * (g_j * r_j[t])  +  inject[t]
// with tl (L + T, 8, lanes) the timeline (rows [0, L) the carried lines),
// d_j the eight static delays (1 <= d_j <= L), H the 8x8 Sylvester Hadamard
// matrix scaled by h = 1/sqrt(8) (H[i,j] = (-1)^popcount(i & j) * h).
//
// fdn_advance keeps the reference's rounding: each product and each sum is
// its own f32 operation (__fmul_rn / __fadd_rn, never contracted into an
// FMA), the terms added in the order j = 0..7 -- the operations of
// kernels.hadamard_mix and the plain turn loop, so the kernel gives the
// plain version's bits.  H[i,j] * fed_j is +-(h * fed_j): a sign flip is
// exact, so each line's product is formed once and shared by the eight
// rows of the mix.
//
// What bounds it.  A frame reads rows at least min(d) frames back, so a
// TURN of min(d) frames reads only rows that earlier turns wrote: frames
// within a turn are independent, turns are sequential.  At 44.1 kHz min(d)
// is 1310 frames, so 60 s is a chain of ~2020 dependent turns.  The bytes
// (36 B a frame-lane: the inject sample and the eight rows written) are
// ~0.03 ms at 3.35 TB/s for one lane and the operations (80 a frame-lane:
// 8 r*g, 8 h*fed, 56 sums of the mix, 8 of the inject) ~0.003 ms at 67
// TFLOP/s: neither sets the time, the chain of turns does -- a turn's
// loads of the rows the previous turns wrote and a block-wide barrier.
// The design keeps the chain on one SM: one CTA owns a group of lanes over
// the whole window, so a turn ends with __syncthreads() and not a kernel
// launch or a grid-wide barrier, and the turn's frames are spread over all
// 1024 threads (at one lane, ~1.3 frames a thread).  A CTA works one lane
// while the lanes do not outnumber the SMs, else up to 8 lanes side by
// side (a warp's loads of one line then fill 32-byte sectors).  At one
// lane a warp's load of one line touches 32 sectors for 128 useful bytes,
// and so does each row store: every turn moves its reads and writes
// through one SM's cache path 8-fold.  A ring of the last L rows in shared
// memory (112.5 KB a lane at 44.1 kHz) would keep them on the SM; that is
// not done here.
//
// fdn_advance_vjp is the same network run backwards in time.  With G the
// cotangent of the whole timeline and u the total cotangent of its rows
// (H is symmetric):
//     u[p, j] = G[p, j] + [L <= p + d_j < L + T] * g_j * (H u[p + d_j])_j
//     inject cotangent [t] = sum_i u[L + t, i]
//     g cotangent     _j   = sum_t r_j[t] * (H u[L + t])_j
//     carried lines' cotangent = u[0 : L]
// u at p reads u at p + d_j >= p + min(d), so the adjoint runs in turns of
// min(d) rows from the end.  Each row >= L stores Hu (computed once, with
// an 8-point Walsh-Hadamard transform) into a scratch buffer, which the
// rows d_j earlier read one value of.  The g sum over time runs in per-
// thread registers in a fixed frame order, then a fixed-order sum over
// the CTA's threads in shared memory: no atomics, the same bits on every
// run.  Its bound is the same chain of turns.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLines = 8;
constexpr int kThreads = 1024;

struct Delays {
    int d[kLines];
};

__device__ __forceinline__ float hsign(int i, int j, float v) {
    return (__popc(i & j) & 1) ? -v : v;
}

__device__ __forceinline__ int64_t at(int64_t row, int j, int lanes,
                                      int lane) {
    return (row * kLines + j) * lanes + lane;
}

// One CTA per group of `group` lanes (blockDim.x a multiple of group);
// thread k works lane c0 + k % group and frames k / group + n * fstep.
__global__ void __launch_bounds__(kThreads)
fdn_advance(const float* __restrict__ lines, const float* __restrict__ inject,
            const float* __restrict__ g, float* tl, int L, int T, int lanes,
            int group, float h, Delays dl) {
    const int lane = blockIdx.x * group + (int)threadIdx.x % group;
    const bool active = lane < lanes;
    const int fstep = blockDim.x / group;
    const int f0 = threadIdx.x / group;
    int turn = dl.d[0];
    for (int j = 1; j < kLines; ++j) turn = min(turn, dl.d[j]);

    float gj[kLines];
    if (active) {
        for (int j = 0; j < kLines; ++j) gj[j] = g[j * lanes + lane];
        for (int64_t p = f0; p < L; p += fstep)
            for (int j = 0; j < kLines; ++j)
                tl[at(p, j, lanes, lane)] = lines[at(p, j, lanes, lane)];
    }
    __syncthreads();

    for (int t0 = 0; t0 < T; t0 += turn) {
        const int t1 = min(t0 + turn, T);
        if (active) {
            for (int t = t0 + f0; t < t1; t += fstep) {
                float hf[kLines];
#pragma unroll
                for (int j = 0; j < kLines; ++j) {
                    const float r = tl[at((int64_t)L + t - dl.d[j], j, lanes,
                                          lane)];
                    hf[j] = __fmul_rn(h, __fmul_rn(r, gj[j]));
                }
                const float inj = inject[(int64_t)t * lanes + lane];
#pragma unroll
                for (int i = 0; i < kLines; ++i) {
                    float acc = hf[0];               // column 0 is all +h
#pragma unroll
                    for (int j = 1; j < kLines; ++j)
                        acc = __fadd_rn(acc, hsign(i, j, hf[j]));
                    tl[at((int64_t)L + t, i, lanes, lane)] =
                        __fadd_rn(acc, inj);
                }
            }
        }
        __syncthreads();
    }
}

// (H v) / h in place: the 8-point Walsh-Hadamard transform in natural
// (Sylvester) order.
__device__ __forceinline__ void fwht8(float* v) {
#pragma unroll
    for (int s = 1; s < kLines; s <<= 1)
#pragma unroll
        for (int i = 0; i < kLines; ++i)
            if (!(i & s)) {
                const float a = v[i], b = v[i + s];
                v[i] = a + b;
                v[i + s] = a - b;
            }
}

__global__ void __launch_bounds__(kThreads)
fdn_advance_vjp(const float* __restrict__ tl, const float* __restrict__ g,
                const float* __restrict__ gtl, float* ha,
                float* __restrict__ glines, float* __restrict__ ginject,
                float* __restrict__ gg, int L, int T, int lanes, int group,
                float h, Delays dl) {
    __shared__ float partial[kThreads * kLines];
    const int lane = blockIdx.x * group + (int)threadIdx.x % group;
    const bool active = lane < lanes;
    const int fstep = blockDim.x / group;
    const int f0 = threadIdx.x / group;
    int turn = dl.d[0];
    for (int j = 1; j < kLines; ++j) turn = min(turn, dl.d[j]);

    float gj[kLines], acc[kLines];
    for (int j = 0; j < kLines; ++j) {
        gj[j] = active ? g[j * lanes + lane] : 0.0f;
        acc[j] = 0.0f;
    }
    // rows [p0, p1) of the timeline, the turns from the end
    for (int p1 = L + T; p1 > 0; p1 -= turn) {
        const int p0 = max(p1 - turn, 0);
        if (active) {
            for (int p = p1 - 1 - f0; p >= p0; p -= fstep) {
                float u[kLines];
#pragma unroll
                for (int j = 0; j < kLines; ++j) {
                    const int q = p + dl.d[j];
                    float v = gtl[at(p, j, lanes, lane)];
                    if (q >= L && q < L + T)
                        v += gj[j] * ha[at((int64_t)q - L, j, lanes, lane)];
                    u[j] = v;
                }
                if (p < L) {
#pragma unroll
                    for (int j = 0; j < kLines; ++j)
                        glines[at(p, j, lanes, lane)] = u[j];
                    continue;
                }
                const int t = p - L;
                float s = 0.0f;
#pragma unroll
                for (int j = 0; j < kLines; ++j) s += u[j];
                ginject[(int64_t)t * lanes + lane] = s;
                fwht8(u);
#pragma unroll
                for (int j = 0; j < kLines; ++j) {
                    const float hu = h * u[j];
                    ha[at(t, j, lanes, lane)] = hu;
                    acc[j] += tl[at((int64_t)p - dl.d[j], j, lanes, lane)]
                        * hu;
                }
            }
        }
        __syncthreads();
    }
    // the g sum: thread partials, then one thread per (line, lane of the
    // group) adds them in frame order
    for (int j = 0; j < kLines; ++j)
        partial[j * blockDim.x + threadIdx.x] = acc[j];
    __syncthreads();
    const int j = threadIdx.x / group;
    const int sub = threadIdx.x % group;
    const int out_lane = blockIdx.x * group + sub;
    if (j < kLines && out_lane < lanes) {
        float s = 0.0f;
        for (int f = 0; f < fstep; ++f)
            s += partial[j * blockDim.x + f * group + sub];
        gg[j * lanes + out_lane] = s;
    }
}

bool delays_ok(const int* delays, int L) {
    for (int j = 0; j < kLines; ++j)
        if (delays[j] < 1 || delays[j] > L) return false;
    return true;
}

Delays pack(const int* delays) {
    Delays dl;
    for (int j = 0; j < kLines; ++j) dl.d[j] = delays[j];
    return dl;
}

}  // namespace

extern "C" {

// lines (L, 8, lanes), inject (T, lanes), g (8, lanes) float32 contiguous;
// writes tl (L + T, 8, lanes): the lines, then the window's rows.  `group`
// lanes a CTA, a power of two <= 32.  Returns the cudaError_t of the
// launch.
int fdn_advance_launch(const float* lines, const float* inject,
                       const float* g, float* tl, int L, int T, int lanes,
                       int group, float h, const int* delays, void* stream) {
    if (L < 1 || T < 0 || lanes < 1 || group < 1 || group > 32
            || kThreads % group || !delays_ok(delays, L))
        return (int)cudaErrorInvalidValue;
    const int grid = (lanes + group - 1) / group;
    fdn_advance<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        lines, inject, g, tl, L, T, lanes, group, h, pack(delays));
    return (int)cudaGetLastError();
}

// tl and its cotangent gtl (L + T, 8, lanes), g (8, lanes) float32
// contiguous; ha (T, 8, lanes) scratch; writes glines (L, 8, lanes),
// ginject (T, lanes) and gg (8, lanes).
int fdn_advance_vjp_launch(const float* tl, const float* g, const float* gtl,
                           float* ha, float* glines, float* ginject,
                           float* gg, int L, int T, int lanes, int group,
                           float h, const int* delays, void* stream) {
    if (L < 1 || T < 0 || lanes < 1 || group < 1 || group > 32
            || kThreads % group || !delays_ok(delays, L))
        return (int)cudaErrorInvalidValue;
    const int grid = (lanes + group - 1) / group;
    fdn_advance_vjp<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        tl, g, gtl, ha, glines, ginject, gg, L, T, lanes, group, h,
        pack(delays));
    return (int)cudaGetLastError();
}

}  // extern "C"
