// IMA ADPCM encoder for Hopper (sm_90a).
//
// No port of a Pallas kernel: it is the form the JAX package's
// ima_encode_jax (signals_tpu/runtime/codecs.py:839-907) takes on this card.
// There, one lax.scan over the in-block sample index runs every block and
// channel in lanes and XLA compiles it to one device loop; eager PyTorch
// would issue ~30 small kernels per in-block sample (~30 000 an encode).
//
// The WAV IMA layout makes each block independent (its header holds the
// first sample and a starting step index) and each (block, channel) one
// serial chain: the step index and the predictor of sample k depend on
// sample k-1's code.  Nothing in the format lets a chain's samples run in
// parallel, so one thread walks one chain from start to end:
//   * the chain's samples are x[b*spb + k, c] (frames past the end repeat
//     the last frame), quantized as rint(x * 32768) clipped to int16 --
//     numpy's round(x * 32768), half to even (x * 32768 is exact);
//   * the starting index is the largest index whose step does not exceed
//     |s1 - s0| (numpy's searchsorted(steps, d, 'right') - 1, clipped to
//     0..88): a 7-step binary search;
//   * the 4-byte header [s0 as int16 LE, index, 0] and, per 8 codes, one
//     32-bit word of nibbles (code j at bits 4*(j % 8)): the channels'
//     words interleave 4 bytes at a time, so word w of channel c lands at
//     byte 4*ch + (w*ch + c)*4 of the block.  Every store is one aligned
//     32-bit word (block_align is a multiple of 4: (spb - 1) % 8 == 0).
//
// What bounds it.  At the flagship's 60 s mono mix there are 2602 chains
// of 1016 dependent steps; the traffic (10.6 MB in, 1.3 MB out) is ~3.6 us
// at 3.35 TB/s, so the chain's latency sets the time.  At 64 channels
// (677 MB in) the bytes bound it (0.23 ms), and the walk's instructions
// come close.  The design keeps everything but the chain's own arithmetic
// off the chain:
//   * A warp owns a tile of 32 chains: narrow inputs (ch < 32) tile 32 / ch
//     whole blocks, wide ones 32 consecutive channels of one block (the last
//     group of a block may be narrower).  A CTA holds kWarps tiles.
//   * The warp stages its tile's samples in chunks of kChunk steps, double-
//     buffered in shared memory, [step][chain]: cp.async copies (32
//     consecutive frames of one chain a copy instruction when narrow, 32
//     consecutive channels of one frame when wide), issued at the top of
//     a chunk for the next one.  They take no registers (staging through
//     registers took ~100 of them and lost the loads' overlap with the
//     walk) and land while the chains walk this chunk.
//   * A step reads its sample at [k][chain] (one 128-byte row: no bank
//     conflict), quantizes it (off the chain; one saturating conversion,
//     fewer instructions a step than a round and two clamps), and reads one
//     table entry, the step size; the index moves by arithmetic (code & 4 ?
//     2 * (code & 3) + 2 : -1, clamped), not a second table.  A staged row
//     is kRow = 33 floats, so the copies of one chain's 32 samples fall in
//     32 banks.
// Each chain stores its header and its nibble words itself, one aligned
// word every 8 steps.  Narrow and wide tiles are two instances of one
// template, so neither carries the other's addressing.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

__constant__ int kSteps[89] = {
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767};

constexpr int kLanes = 32;            // chains a tile: one warp walks them
constexpr int kChunk = 32;            // steps a staged chunk
constexpr int kRow = kLanes + 1;      // floats a staged row
constexpr int kWarps = 4;             // tiles a CTA, one a warp

// rint(v * 32768) clipped to int16 in one saturating conversion (a NaN
// gives 0)
__device__ __forceinline__ int quantize(float v) {
    short q;
    asm("cvt.rni.sat.s16.f32 %0, %1;"
        : "=h"(q) : "f"(__fmul_rn(v, 32768.0f)));
    return q;
}

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void copies_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void copies_wait() {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Tile t: chains j < n are (block b0 + j / ch, channel j % ch) when narrow,
// (block b0, channel c0 + j) when wide.
struct Tile {
    int64_t b0;
    int c0;
    int n;
};

template <bool kWide>
__device__ __forceinline__ Tile tile_of(int64_t t, int ch, int n_blocks) {
    Tile T;
    if (kWide) {
        const int groups = (ch + kLanes - 1) / kLanes;
        T.b0 = t / groups;
        T.c0 = (int)(t % groups) * kLanes;
        T.n = min(kLanes, ch - T.c0);
    } else {
        const int per = kLanes / ch;
        T.b0 = t * per;
        T.c0 = 0;
        const int64_t left = (int64_t)n_blocks - T.b0;
        T.n = (int)(left < per ? left : per) * ch;
    }
    return T;
}

template <bool kWide>
__global__ void __launch_bounds__(kWarps * kLanes)
ima_encode(const float* __restrict__ x, int64_t frames, int ch, int spb,
           int n_blocks, int64_t n_tiles, uint32_t* __restrict__ out) {
    // The step table: int16 for narrow tiles (45 words, at most two
    // entries a bank, for the walk's one scattered read a step: faster on
    // an H100 at 1 and 2 channels), int for wide ones (faster there).
    using Step = typename std::conditional<kWide, int, int16_t>::type;
    __shared__ Step steps[89];
    __shared__ float buf[kWarps][2][kChunk * kRow];
    for (int i = threadIdx.x; i < 89; i += blockDim.x) steps[i] = kSteps[i];
    __syncthreads();
    const int warp = threadIdx.x / kLanes;
    const int lane = threadIdx.x % kLanes;
    const int64_t t = (int64_t)blockIdx.x * kWarps + warp;
    if (t >= n_tiles) return;
    const Tile T = tile_of<kWide>(t, ch, n_blocks);
    const int n_chunks = (spb + kChunk - 1) / kChunk;
    const int64_t last = frames - 1;
    const int64_t tile_blocks = kWide ? 1 : T.n / ch;

    // Chunk n's copies into dst: copy l of a lane is step k of chain j,
    // (k, j) = (l, lane) when wide, (lane, l) when narrow.  Frames past the
    // last are clamped to it.
    auto stage = [&](int n, float* dst) {
        const int64_t k0 = (int64_t)n * kChunk;
        const bool inside = (T.b0 + tile_blocks - 1) * spb + k0 + kChunk - 1
            <= last;
        if (kWide) {
            if (lane < T.n) {
                const int64_t f = T.b0 * spb + k0;
#pragma unroll 4
                for (int l = 0; l < kChunk; ++l) {
                    const int64_t fl = inside || f + l < last ? f + l : last;
                    copy_async(dst + l * kRow + lane,
                               x + fl * ch + T.c0 + lane);
                }
            }
        } else {
            int64_t f = T.b0 * spb + k0 + lane;   // chain l's frame
            int c = 0;                            // chain l's channel
#pragma unroll 4
            for (int l = 0; l < T.n; ++l) {
                copy_async(dst + lane * kRow + l,
                           x + (inside || f < last ? f : last) * ch + c);
                if (++c == ch) {
                    c = 0;
                    f += spb;
                }
            }
        }
        copies_commit();
    };

    // The walk: chain `lane`.
    const bool active = lane < T.n;
    const int64_t b = kWide ? T.b0 : T.b0 + lane / ch;
    const int c = kWide ? T.c0 + lane : lane % ch;
    // words of a block: block_align / 4 = (spb - 1) / 8 * ch + ch
    uint32_t* blk = out + b * ((int64_t)((spb - 1) / 8 + 1) * ch);
    uint32_t* words = blk + ch + c;
    int pred = 0, index = 0;
    uint32_t word = 0;
    auto sample = [&](const float* col, int i) -> int {
        return quantize(col[i * kRow]);
    };
    // step k: encode sample s; code k - 1 goes to bits 4 * ((k - 1) % 8)
    // of the word, stored when it holds its 8th code
    auto step_k = [&](int s, int k) {
        const int step = steps[index];
        const int diff = s - pred;
        int adiff = abs(diff);
        const bool b4 = adiff >= step;
        adiff -= b4 ? step : 0;
        const bool b2 = adiff >= (step >> 1);
        adiff -= b2 ? (step >> 1) : 0;
        const bool b1 = adiff >= (step >> 2);
        const int diffq = (step >> 3) + (b4 ? step : 0)
            + (b2 ? (step >> 1) : 0) + (b1 ? (step >> 2) : 0);
        pred = min(max(pred + (diff < 0 ? -diffq : diffq), -32768), 32767);
        // kIndex[code & 7]: -1 below 4, else 2 * (code & 3) + 2
        index = min(max(b4 ? index + 2 + (b2 ? 4 : 0) + (b1 ? 2 : 0)
                           : index - 1, 0), 88);
        const uint32_t code = (diff < 0 ? 8u : 0u) | (b4 ? 4u : 0u)
            | (b2 ? 2u : 0u) | (b1 ? 1u : 0u);
        const int j = k - 1;
        word |= code << (4 * (j & 7));
        if ((j & 7) == 7) {
            if (active) words[(int64_t)(j >> 3) * ch] = word;
            word = 0;
        }
    };
    stage(0, buf[warp][0]);
    for (int n = 0; n < n_chunks; ++n) {
        copies_wait();       // this chunk's copies (this lane's) landed
        __syncwarp();        // ... and every lane's
        const bool next = n + 1 < n_chunks;
        const int lo = n == 0 ? 1 : 0;
        const int hi = min(kChunk, spb - n * kChunk);
        // the next chunk's copies, in flight over this chunk's walk
        if (next) stage(n + 1, buf[warp][(n + 1) & 1]);
        const float* col = buf[warp][n & 1] + lane;
        if (n == 0) {
            pred = sample(col, 0);
            if (spb > 1) {
                const int d = abs(sample(col, 1) - pred);
#pragma unroll
                for (int half = 64; half > 0; half >>= 1) {
                    const int i = index + half;
                    index = (i <= 88 && steps[i] <= d) ? i : index;
                }
            }
            if (active)
                blk[c] = ((uint32_t)pred & 0xFFFFu) | ((uint32_t)index << 16);
        }
        if (lo == 0 && hi == kChunk) {
            // 8 steps (one word) at a time
#pragma unroll 1
            for (int q = 0; q < kChunk; q += 8) {
#pragma unroll
                for (int u = 0; u < 8; ++u)
                    step_k(sample(col, q + u), n * kChunk + q + u);
            }
        } else {
            for (int i = lo; i < hi; ++i)
                step_k(sample(col, i), n * kChunk + i);
        }
        __syncwarp();        // every lane is done with this chunk's buffer
    }
}

}  // namespace

extern "C" {

// x (frames, ch) float32 contiguous -> out, n_blocks * block_align bytes
// (block_align = ((spb - 1) / 2 + 4) * ch), 4-byte aligned.  spb odd with
// (spb - 1) % 8 == 0 (the caller checks).  Returns the cudaError_t of the
// launch.
int ima_encode_launch(const float* x, int64_t frames, int ch, int spb,
                      int n_blocks, uint8_t* out, void* stream) {
    if (ch < 1 || spb < 1 || (spb - 1) % 8 || n_blocks < 1 || frames < 1)
        return (int)cudaErrorInvalidValue;
    const bool wide = ch >= kLanes;
    const int64_t tiles = wide
        ? (int64_t)n_blocks * ((ch + kLanes - 1) / kLanes)
        : ((int64_t)n_blocks + kLanes / ch - 1) / (kLanes / ch);
    const int64_t grid = (tiles + kWarps - 1) / kWarps;
    if (grid > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
    auto* kernel = wide ? ima_encode<true> : ima_encode<false>;
    kernel<<<(unsigned)grid, kWarps * kLanes, 0, (cudaStream_t)stream>>>(
        x, frames, ch, spb, n_blocks, tiles,
        reinterpret_cast<uint32_t*>(out));
    return (int)cudaGetLastError();
}

}  // extern "C"
