// The Reverb's feedback delay network for Hopper (sm_90a): its advance over
// a window and the adjoint of that advance.
//
// No port of a Pallas kernel: these replace the lax.scan of the JAX
// package's Reverb.mega_step (signals_tpu/nodes/reverb.py:171-189) and
// JAX's autodiff of it.  Eager PyTorch would issue ~18 small kernels per
// turn of the recurrence (tens of thousands for a minute of audio), and
// neither autograd nor torch.func.vmap can see through a timeline written
// in place; these kernels are the forward and backward of one
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
// ~0.03 ms at 3.35 TB/s for one lane and the operations (80 a frame-lane)
// ~0.003 ms at 67 TFLOP/s: neither sets the time, the chain of turns on one
// SM does.  One CTA owns a lane over the whole window, so a turn ends with
// a block barrier, not a launch; its threads split a turn into the fewest
// rounds of at most 1024 frames, evenly (672 threads for 1310 frames).
//
// The design keeps the chain's memory traffic on the SM.  Line j is only
// ever read d_j frames back, so it lives in a RING of d_j slots in shared
// memory, line-major: frame t reads slot t mod d_j (row t - d_j, written by
// an earlier turn or filled from the carried lines) and, after the mix,
// writes its own value to that same slot.  No other frame of the turn
// touches the slot (a turn is shorter than every d_j), so a thread's read
// then write needs no barrier, and a warp's 32 frames hit 32 consecutive
// banks.  The eight rings hold sum(d) floats: 73.3 KB a lane at 44.1 kHz,
// size 1.0 (the last L rows would take 112.5 KB).  A turn then costs its
// ~105 k f32 operations and 16 shared accesses a frame; device memory sees
// each output row once, stored whole: at one lane two float4 stores a frame,
// 1 KB contiguous a warp.  Where the rings exceed the opt-in shared memory
// of a block (Reverb(size=4.0) at 44.1 kHz: 293 KB), the same kernel keeps
// them, line-major as well, in a global scratch buffer the wrapper
// allocates (a template parameter, the same bits).
//
// Several lanes: a ring of 73 KB a lane leaves room for at most three lanes
// a CTA, so a CTA still works one lane.  Below 8 lanes each CTA stores its
// lane's rows itself (4-byte stores, lanes apart).  From 8 lanes on, where
// a lane's 4-byte stores would each touch a sector of their own, 8 CTAs
// form a thread-block CLUSTER (8 lanes): a CTA stages its turn's rows whole
// (float4) in a small global buffer of two turns (L2-resident), and after
// the cluster's barrier each CTA reads an eighth of the finished turn's
// rows of all 8 lanes back, whole, and stores them as 32-byte runs of 8
// lanes.  The export of a turn overlaps the next turn, which stages into
// the other buffer, so one cluster barrier a turn orders both.
//
// fdn_advance_vjp is the same network run backwards in time.  With G the
// cotangent of the whole timeline and u the total cotangent of its rows
// (H is symmetric):
//     u[p, j] = G[p, j] + [L <= p + d_j < L + T] * g_j * (H u[p + d_j])_j
//     inject cotangent [t] = sum_i u[L + t, i]
//     g cotangent     _j   = sum_t r_j[t] * (H u[L + t])_j
//     carried lines' cotangent = u[0 : L]
// u at p reads u at p + d_j >= p + min(d), so the adjoint runs in turns of
// min(d) rows from the end, one CTA a lane.  (H u)_j at row
// q is read once, by row q - d_j, so it too lives in a ring of d_j slots:
// row p reads slot (p - L) mod d_j (written by row p + d_j) and then
// writes its own (H u)_j there, zero for a carried row (so that rows d_j
// earlier, whose q lies before L, read zero).  The rings start at zero,
// which stands for every q >= L + T.  The chain reads the timeline's
// cotangent a row ahead, writes H u as whole rows into hu (lanes, T, 8),
// lane-major so that a row is 32 contiguous bytes at any lane count, and
// reads nothing else from device memory.  The g sums then run in a
// second, fully parallel kernel, fdn_vjp_gain: per chunk of rows a
// fixed-order sum of tl[L + t - d_j, j] * hu[t, j] per thread, then over
// the CTA's threads, then fdn_vjp_gain_sum adds the chunks in order.  No
// atomics: the same bits on every run.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLines = 8;
constexpr int kThreads = 1024;    // fdn_vjp_gain; the others' most
constexpr int kCluster = 8;        // lanes (CTAs) a cluster of fdn_advance

// The delays and each line's ring: slots [off[j], off[j] + d[j]) of a
// lane's sum(d) floats.
struct Ring {
    int d[kLines];
    int off[kLines];
    int total;
};

__device__ __forceinline__ float hsign(int i, int j, float v) {
    return (__popc(i & j) & 1) ? -v : v;
}

// A row's eight values of one lane: two float4 accesses where they are
// contiguous (stride 1, 16-byte aligned), else eight 4-byte accesses
// `stride` apart (a timeline row of `stride` lanes).
__device__ __forceinline__ void store_row(float* dst, const float* v,
                                          int stride) {
    if (stride == 1) {
        reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2],
                                                        v[3]);
        reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6],
                                                        v[7]);
    } else {
#pragma unroll
        for (int i = 0; i < kLines; ++i) dst[(int64_t)i * stride] = v[i];
    }
}

__device__ __forceinline__ void load_row(float* v, const float* src,
                                         int stride) {
    if (stride == 1) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(src));
        const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
        for (int i = 0; i < kLines; ++i)
            v[i] = __ldg(src + (int64_t)i * stride);
    }
}

// The barrier of a cluster's turn: every thread of the cluster's CTAs
// arrives, releasing the rows it staged to its peers, and waits.
__device__ __forceinline__ void cluster_barrier() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// CLUSTER: the rows of one finished turn (frames [ts, ts + n)) for the
// cluster's 8 lanes, this CTA's share of them: (frame, lane of the
// cluster) pairs of a contiguous eighth of the turn's frames.  A thread
// reads its lane's row whole from the lane's staging buffer `buf` (two
// float4, from L2) and stores its eight values, so 8 consecutive threads
// store one 32-byte run of 8 lanes of each line.
__device__ __forceinline__ void export_turn(
        float* __restrict__ tl, const float* stage, int L, int ts, int n,
        int turn, int buf, int lanes, int c0, unsigned rank) {
    const int64_t row = (int64_t)kLines * lanes;
    const int e0 = (int)((int64_t)n * rank / kCluster) * kCluster;
    const int e1 = (int)((int64_t)n * (rank + 1) / kCluster) * kCluster;
    for (int e = e0 + (int)threadIdx.x; e < e1; e += (int)blockDim.x) {
        const int f = e / kCluster;
        const int lane = c0 + e % kCluster;
        if (lane >= lanes) continue;
        const float4* src = reinterpret_cast<const float4*>(
            stage + (((int64_t)lane * 2 + buf) * turn + f) * kLines);
        const float4 a = __ldcg(src), b = __ldcg(src + 1);
        float* dst = tl + (int64_t)(L + ts + f) * row + lane;
        dst[0] = a.x;
        dst[lanes] = a.y;
        dst[2 * (int64_t)lanes] = a.z;
        dst[3 * (int64_t)lanes] = a.w;
        dst[4 * (int64_t)lanes] = b.x;
        dst[5 * (int64_t)lanes] = b.y;
        dst[6 * (int64_t)lanes] = b.z;
        dst[7 * (int64_t)lanes] = b.w;
    }
}

// One CTA a lane (blockIdx.x; CTAs past the lanes only copy and export).
// CLUSTER: grid a multiple of 8, clusters of 8 along x; each CTA stages
// its turn's rows whole in stage (ctas, 2, turn, 8), by the turn's parity.
template <bool SHARED, bool CLUSTER>
__global__ void __launch_bounds__(kThreads)
fdn_advance(const float* __restrict__ lines, const float* __restrict__ inject,
            const float* __restrict__ g, float* __restrict__ tl,
            float* __restrict__ gring, float* __restrict__ stage, int L,
            int T, int lanes, int turn, float h, Ring rg) {
    extern __shared__ float smem[];
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const int lane = blockIdx.x;
    const bool active = lane < lanes;
    float* ring = SHARED ? smem : gring + (int64_t)lane * rg.total;
    const int64_t row = (int64_t)kLines * lanes;

    // rows [0, L): the carried lines, one coalesced pass over the grid
    {
        const int64_t n = (int64_t)L * row;
        for (int64_t e = (int64_t)blockIdx.x * nt + tid; e < n;
             e += (int64_t)gridDim.x * nt)
            tl[e] = lines[e];
    }
    // line j's slot s holds row L - d_j + s, the row frame s reads
    if (active) {
        for (int e = tid; e < rg.total; e += nt) {
            int j = 0;
#pragma unroll
            for (int k = 1; k < kLines; ++k) j += e >= rg.off[k];
            const int s = e - rg.off[j];
            ring[e] = lines[((int64_t)(L - rg.d[j] + s) * kLines + j) * lanes
                            + lane];
        }
    }
    float gj[kLines];
    int base[kLines];                   // slot of the turn's first frame
#pragma unroll
    for (int j = 0; j < kLines; ++j) {
        gj[j] = active ? g[j * lanes + lane] : 0.0f;
        base[j] = 0;
    }
    __syncthreads();

    int c0 = 0;
    unsigned rank = 0;
    if (CLUSTER) {
        rank = cg::this_cluster().block_rank();
        c0 = lane - (int)rank;
    }
    // each thread's next inject sample, loaded a frame ahead
    float inj_next = 0.0f;
    if (active && tid < min(turn, T))
        inj_next = inject[(int64_t)tid * lanes + lane];
    int k = 0;
    for (int t0 = 0; t0 < T; t0 += turn, ++k) {
        const int t1 = min(t0 + turn, T);
        const int t2 = min(t1 + turn, T);
        if (CLUSTER && k > 0)   // the previous turn's rows, staged
            export_turn(tl, stage, L, t0 - turn, turn, turn, (k - 1) & 1,
                        lanes, c0, rank);
        if (active) {
            for (int t = t0 + tid; t < t1; t += nt) {
                const float inj = inj_next;
                int tn = t + nt;
                if (tn >= t1) tn = t1 + tid;
                if (tn < t2) inj_next = inject[(int64_t)tn * lanes + lane];
                const int f = t - t0;
                int slot[kLines];
                float hf[kLines];
#pragma unroll
                for (int j = 0; j < kLines; ++j) {
                    int s = base[j] + f;
                    if (s >= rg.d[j]) s -= rg.d[j];
                    slot[j] = rg.off[j] + s;
                    hf[j] = __fmul_rn(h, __fmul_rn(ring[slot[j]], gj[j]));
                }
                float y[kLines];
#pragma unroll
                for (int i = 0; i < kLines; ++i) {
                    float acc = hf[0];               // column 0 is all +h
#pragma unroll
                    for (int j = 1; j < kLines; ++j)
                        acc = __fadd_rn(acc, hsign(i, j, hf[j]));
                    y[i] = __fadd_rn(acc, inj);
                    ring[slot[i]] = y[i];
                }
                if (CLUSTER)
                    store_row(stage + (((int64_t)lane * 2 + (k & 1)) * turn
                                       + f) * kLines, y, 1);
                else
                    store_row(tl + (int64_t)(L + t) * row + lane, y, lanes);
            }
        }
#pragma unroll
        for (int j = 0; j < kLines; ++j) {
            base[j] += turn;
            if (base[j] >= rg.d[j]) base[j] -= rg.d[j];
        }
        if (CLUSTER)
            cluster_barrier();
        else
            __syncthreads();
    }
    if (CLUSTER && k > 0) {
        const int ts = (k - 1) * turn;
        export_turn(tl, stage, L, ts, T - ts, turn, (k - 1) & 1, lanes, c0,
                    rank);
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

// One CTA a lane; rows [p1 - turn, p1) a turn, from the end.  ha is hu,
// lane-major (lanes, T, 8): each row stored whole at any lane count.
template <bool SHARED>
__global__ void __launch_bounds__(kThreads)
fdn_advance_vjp(const float* __restrict__ gtl, const float* __restrict__ g,
                float* __restrict__ gring, float* __restrict__ ha,
                float* __restrict__ glines, float* __restrict__ ginject,
                int L, int T, int lanes, int turn, float h, Ring rg) {
    extern __shared__ float smem[];
    const int tid = threadIdx.x;
    const int lane = blockIdx.x;
    float* ring = SHARED ? smem : gring + (int64_t)lane * rg.total;
    const int64_t row = (int64_t)kLines * lanes;
    const int nt = blockDim.x;
    for (int e = tid; e < rg.total; e += nt) ring[e] = 0.0f;
    float gj[kLines];
    int top[kLines];                    // slot of the turn's last row
#pragma unroll
    for (int j = 0; j < kLines; ++j) {
        gj[j] = g[j * lanes + lane];
        const int x = (T - 1) % rg.d[j];
        top[j] = x < 0 ? x + rg.d[j] : x;
    }
    __syncthreads();
    const int P = L + T;
    // each thread's next row of the cotangent, loaded a row ahead
    float gn[kLines];
    if (tid < min(turn, P))
        load_row(gn, gtl + (int64_t)(P - 1 - tid) * row + lane, lanes);
    for (int p1 = P; p1 > 0; p1 -= turn) {
        const int n = min(turn, p1);        // rows [p1 - n, p1)
        const int nn = min(turn, p1 - n);   // rows of the next turn
        for (int r = tid; r < n; r += nt) {
            const int p = p1 - 1 - r;
            float u[kLines];
#pragma unroll
            for (int j = 0; j < kLines; ++j) u[j] = gn[j];
            if (r + nt < n)
                load_row(gn, gtl + (int64_t)(p - nt) * row + lane,
                         lanes);
            else if (tid < nn)
                load_row(gn, gtl + (int64_t)(p1 - n - 1 - tid) * row + lane,
                         lanes);
            int slot[kLines];
#pragma unroll
            for (int j = 0; j < kLines; ++j) {
                int s = top[j] - r;
                if (s < 0) s += rg.d[j];
                slot[j] = rg.off[j] + s;
                u[j] += gj[j] * ring[slot[j]];
            }
            if (p < L) {
                store_row(glines + (int64_t)p * row + lane, u, lanes);
#pragma unroll
                for (int j = 0; j < kLines; ++j) ring[slot[j]] = 0.0f;
                continue;
            }
            const int t = p - L;
            float s = u[0];
#pragma unroll
            for (int j = 1; j < kLines; ++j) s += u[j];
            ginject[(int64_t)t * lanes + lane] = s;
            fwht8(u);
#pragma unroll
            for (int j = 0; j < kLines; ++j) {
                u[j] = h * u[j];
                ring[slot[j]] = u[j];
            }
            store_row(ha + ((int64_t)lane * T + t) * kLines, u, 1);
        }
#pragma unroll
        for (int j = 0; j < kLines; ++j) {
            top[j] -= turn;
            if (top[j] < 0) top[j] += rg.d[j];
        }
        __syncthreads();
    }
}

// The g sums' partials: partial[c, q] = sum over the rows t of chunk c of
// tl[L + t - d_j, j, lane] * hu[lane, t, j], q = lane * 8 + j the pair
// (hu lane-major, as fdn_advance_vjp writes it).  A CTA takes up to 1024
// pairs (blockIdx.y) and splits its chunk's rows into S = 1024 / pairs
// slices: thread (slice, pair) sums rows slice, slice + S, ... in order,
// then one thread a pair adds the slices in order.
__global__ void __launch_bounds__(kThreads)
fdn_vjp_gain(const float* __restrict__ tl, const float* __restrict__ hu,
             float* __restrict__ partial, int L, int T, int lanes,
             int chunks, Ring rg) {
    __shared__ float acc_s[kThreads];
    const int P = kLines * lanes;
    const int q0 = blockIdx.y * kThreads;
    const int np = min(kThreads, P - q0);
    const int S = kThreads / np;
    const int tid = threadIdx.x;
    const int q = q0 + tid % np;
    const int sl = tid / np;
    const int c = blockIdx.x;
    const int a = (int)((int64_t)T * c / chunks);
    const int b = (int)((int64_t)T * (c + 1) / chunks);
    float acc = 0.0f;
    if (sl < S) {
        const int lane = q / kLines, j = q % kLines;
        const float* x = tl + ((int64_t)(L - rg.d[j]) * kLines + j) * lanes
                         + lane;
        const float* y = hu + (int64_t)lane * T * kLines + j;
        for (int t = a + sl; t < b; t += S)
            acc = fmaf(__ldg(x + (int64_t)t * P), __ldg(y + (int64_t)t * kLines),
                       acc);
    }
    acc_s[tid] = acc;
    __syncthreads();
    if (tid < np) {
        float s = 0.0f;
        for (int k = 0; k < S; ++k) s += acc_s[k * np + tid];
        partial[(int64_t)c * P + q] = s;
    }
}

// gg[j, lane] = the chunks' partials of pair (lane, j) added in chunk
// order.
__global__ void fdn_vjp_gain_sum(const float* __restrict__ partial,
                                 float* __restrict__ gg, int lanes,
                                 int chunks) {
    const int q = blockIdx.x * blockDim.x + threadIdx.x;
    const int P = kLines * lanes;
    if (q >= P) return;
    float s = 0.0f;
    for (int c = 0; c < chunks; ++c) s += partial[(int64_t)c * P + q];
    gg[(q % kLines) * lanes + q / kLines] = s;
}

bool pack(const int* delays, int L, Ring* rg) {
    int total = 0;
    for (int j = 0; j < kLines; ++j) {
        if (delays[j] < 1 || delays[j] > L) return false;
        rg->d[j] = delays[j];
        rg->off[j] = total;
        total += delays[j];
    }
    rg->total = total;
    return true;
}

int min_delay(const Ring& rg) {
    int m = rg.d[0];
    for (int j = 1; j < kLines; ++j) m = rg.d[j] < m ? rg.d[j] : m;
    return m;
}

// Threads a CTA of the chain kernels: a turn in the fewest rounds of at
// most 1024 threads, its frames split evenly over the rounds, in whole
// warps (672 for a 1310-frame turn: two rounds all but full; a 1024-thread
// CTA would run its second round 286 frames deep, behind a barrier).
int turn_threads(int turn) {
    const int rounds = (turn + kThreads - 1) / kThreads;
    const int per = (turn + rounds - 1) / rounds;
    return (per + 31) / 32 * 32;
}

int shared_limit() {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
        return 0;
    return v;
}

// Opt a kernel in to `bytes` of dynamic shared memory, once per (kernel,
// size) on the current device.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes, int* done) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 16 && done[dev] >= bytes) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err == cudaSuccess && dev < 16) done[dev] = bytes;
    return err;
}

template <bool SHARED, bool CLUSTER>
cudaError_t launch_advance(const float* lines, const float* inject,
                           const float* g, float* tl, float* gring,
                           float* stage, int L, int T, int lanes, float h,
                           const Ring& rg, cudaStream_t stream) {
    static int done[16] = {0};
    auto kernel = fdn_advance<SHARED, CLUSTER>;
    const int bytes = SHARED ? rg.total * (int)sizeof(float) : 0;
    if (SHARED) {
        const cudaError_t err = allow_shared(kernel, bytes, done);
        if (err != cudaSuccess) return err;
    }
    const int turn = min_delay(rg);
    const int grid = CLUSTER ? (lanes + kCluster - 1) / kCluster * kCluster
                             : lanes;
    if (!CLUSTER) {
        kernel<<<grid, turn_threads(turn), bytes, stream>>>(
            lines, inject, g, tl, gring, stage, L, T, lanes, turn, h, rg);
        return cudaGetLastError();
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(turn_threads(turn));
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, lines, inject, g,
                                               tl, gring, stage, L, T, lanes,
                                               turn, h, rg);
    return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool SHARED>
cudaError_t launch_vjp(const float* gtl, const float* g, float* gring,
                       float* ha, float* glines, float* ginject, int L,
                       int T, int lanes, int turn, float h, const Ring& rg,
                       cudaStream_t stream) {
    static int done[16] = {0};
    auto kernel = fdn_advance_vjp<SHARED>;
    const int bytes = SHARED ? rg.total * (int)sizeof(float) : 0;
    if (SHARED) {
        const cudaError_t err = allow_shared(kernel, bytes, done);
        if (err != cudaSuccess) return err;
    }
    kernel<<<lanes, turn_threads(turn), bytes, stream>>>(
        gtl, g, gring, ha, glines, ginject, L, T, lanes, turn, h, rg);
    return cudaGetLastError();
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// Whether the rings of these eight delays (sum(d) floats a lane) fit a
// block's opt-in shared memory on the current device: 1 if so, else 0
// (the wrapper then allocates the global rings).
int fdn_ring_shared(const int* delays) {
    long total = 0;
    for (int j = 0; j < kLines; ++j) total += delays[j];
    return total * (long)sizeof(float) <= shared_limit();
}

// Clusters of fdn_advance (8 CTAs, the rings of these delays in shared
// memory) that the current device can hold at once; 0 if none.
int fdn_cluster_occupancy(const int* delays) {
    Ring rg;
    if (!pack(delays, 1 << 30, &rg)) return 0;
    static int done[16] = {0};
    auto kernel = fdn_advance<true, true>;
    const int bytes = rg.total * (int)sizeof(float);
    if (allow_shared(kernel, bytes, done) != cudaSuccess) return 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster * 16);
    cfg.blockDim = dim3(turn_threads(min_delay(rg)));
    cfg.dynamicSmemBytes = bytes;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
        return 0;
    return n;
}

// lines (L, 8, lanes), inject (T, lanes), g (8, lanes) float32 contiguous;
// writes tl (L + T, 8, lanes): the lines, then the window's rows, in turns
// of min(d) frames.  `cluster` 0: one CTA a lane; 1 (lanes >= 8): clusters
// of 8 CTAs, stage (ctas, 2, min(d), 8) float32 scratch, ctas the lanes
// rounded up to 8.  gring: null for rings in shared memory, else sum(d)
// floats for each CTA.  tl at one lane and stage must be 16-byte aligned.
// Returns the cudaError_t of the launch.
int fdn_advance_launch(const float* lines, const float* inject,
                       const float* g, float* tl, float* gring, float* stage,
                       int L, int T, int lanes, int cluster, float h,
                       const int* delays, void* stream) {
    Ring rg;
    if (L < 1 || T < 0 || lanes < 1 || !pack(delays, L, &rg)
            || (lanes == 1 && !aligned16(tl))
            || (cluster && (lanes < kCluster || stage == nullptr
                            || !aligned16(stage))))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    const bool shared = gring == nullptr;
    cudaError_t err;
    if (cluster)
        err = shared ? launch_advance<true, true>(lines, inject, g, tl, gring,
                                                  stage, L, T, lanes, h, rg, s)
                     : launch_advance<false, true>(lines, inject, g, tl,
                                                   gring, stage, L, T, lanes,
                                                   h, rg, s);
    else
        err = shared ? launch_advance<true, false>(lines, inject, g, tl,
                                                   gring, stage, L, T, lanes,
                                                   h, rg, s)
                     : launch_advance<false, false>(lines, inject, g, tl,
                                                    gring, stage, L, T, lanes,
                                                    h, rg, s);
    return (int)err;
}

// gtl (L + T, 8, lanes), the timeline's cotangent, g (8, lanes) float32
// contiguous; gring null or sum(d) floats a lane (as fdn_advance_launch);
// writes ha (lanes, T, 8) (H u of the window's rows, lane-major), glines
// (L, 8, lanes) and ginject (T, lanes).  ha, and at one lane gtl and
// glines, must be 16-byte aligned.
int fdn_advance_vjp_launch(const float* gtl, const float* g, float* gring,
                           float* ha, float* glines, float* ginject, int L,
                           int T, int lanes, float h, const int* delays,
                           void* stream) {
    Ring rg;
    if (L < 1 || T < 0 || lanes < 1 || !pack(delays, L, &rg)
            || !aligned16(ha)
            || (lanes == 1 && !(aligned16(gtl) && aligned16(glines))))
        return (int)cudaErrorInvalidValue;
    const int turn = min_delay(rg);
    const cudaStream_t s = (cudaStream_t)stream;
    const cudaError_t err =
        gring == nullptr
            ? launch_vjp<true>(gtl, g, gring, ha, glines, ginject, L, T,
                               lanes, turn, h, rg, s)
            : launch_vjp<false>(gtl, g, gring, ha, glines, ginject, L, T,
                                lanes, turn, h, rg, s);
    return (int)err;
}

// tl (L + T, 8, lanes) and hu (lanes, T, 8) float32 contiguous; partial
// (chunks, lanes, 8) scratch; writes gg (8, lanes), the gains' cotangent.
// Two launches: the chunks' partials, then their sum in chunk order.
int fdn_vjp_gain_launch(const float* tl, const float* hu, float* partial,
                        float* gg, int L, int T, int lanes, int chunks,
                        const int* delays, void* stream) {
    Ring rg;
    if (L < 1 || T < 0 || lanes < 1 || chunks < 1 || !pack(delays, L, &rg))
        return (int)cudaErrorInvalidValue;
    const int P = kLines * lanes;
    const cudaStream_t s = (cudaStream_t)stream;
    const dim3 grid(chunks, (P + kThreads - 1) / kThreads);
    fdn_vjp_gain<<<grid, kThreads, 0, s>>>(tl, hu, partial, L, T, lanes,
                                           chunks, rg);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    fdn_vjp_gain_sum<<<(P + 255) / 256, 256, 0, s>>>(partial, gg, lanes,
                                                     chunks);
    return (int)cudaGetLastError();
}

}  // extern "C"
