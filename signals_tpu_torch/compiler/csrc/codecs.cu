// IMA ADPCM encoder for Hopper (sm_90a).
//
// No port of a Pallas kernel: it is the form the JAX package's
// ima_encode_jax (signals_tpu/runtime/codecs.py:839-907) takes on this card.
// There, one lax.scan over the in-block sample index runs every block and
// channel in lanes and XLA compiles it to one device loop; eager PyTorch
// would issue ~30 small kernels per in-block sample (~30 000 an encode).
//
// The WAV IMA layout makes each block independent (its header holds the
// first sample and a starting step index) and each block's samples one
// serial chain: the step index and the predictor of sample k depend on
// sample k-1's code.  So one thread walks one (block, channel) from start
// to end:
//   * the block's samples are x[b*spb + k, c] (frames past the end repeat
//     the last frame), quantized as rint(x * 32768) clipped to int16 --
//     numpy's round(x * 32768), half to even (x * 32768 is exact);
//   * the starting index is the largest index whose step does not exceed
//     |s1 - s0| (numpy's searchsorted(steps, d, 'right') - 1, clipped to
//     0..88);
//   * the 4-byte header [s0 as int16 LE, index, 0] and, per 8 codes, one
//     32-bit word of nibbles (code j at bits 4*(j % 8)): the channels'
//     words interleave 4 bytes at a time, so word w of channel c lands at
//     byte 4*ch + (w*ch + c)*4 of the block.  Every store is one aligned
//     32-bit word (block_align is a multiple of 4: (spb - 1) % 8 == 0).
// The step table (89 entries) and the index table (8) sit in shared
// memory: threads of a warp read different entries.
//
// What bounds it.  At the flagship's 60 s mono mix there are 2602 blocks:
// 2602 threads, under one warp an SM, each a chain of 1016 dependent
// steps (~35 integer operations each).  The traffic (10.6 MB in, 1.3 MB
// out) is ~3.6 us at 3.35 TB/s and the operations ~1.3 us at 67 T/s; the
// serial chain's latency sets the time, not either.  Nothing in the format
// lets a block's samples run in parallel.

#include <cstdint>
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

__constant__ int kIndex[8] = {-1, -1, -1, -1, 2, 4, 6, 8};

constexpr int kThreads = 128;

__device__ __forceinline__ int quantize(float v) {
    float q = rintf(__fmul_rn(v, 32768.0f));
    q = fminf(fmaxf(q, -32768.0f), 32767.0f);
    return (int)q;
}

__global__ void __launch_bounds__(kThreads)
ima_encode(const float* __restrict__ x, int64_t frames, int ch, int spb,
           int n_blocks, uint32_t* __restrict__ out) {
    __shared__ int steps[89];
    __shared__ int index_tab[8];
    for (int i = threadIdx.x; i < 89; i += blockDim.x) steps[i] = kSteps[i];
    if (threadIdx.x < 8) index_tab[threadIdx.x] = kIndex[threadIdx.x];
    __syncthreads();

    const int64_t unit = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (unit >= (int64_t)n_blocks * ch) return;
    const int64_t b = unit / ch;
    const int c = (int)(unit % ch);
    const int64_t first = b * spb;
    const int64_t last = frames - 1;
    auto sample = [&](int k) {
        int64_t t = first + k;
        t = t < last ? t : last;
        return quantize(__ldg(x + t * ch + c));
    };

    // words of the block: block_align / 4 = (spb - 1) / 8 * ch + ch
    uint32_t* blk = out + b * ((int64_t)((spb - 1) / 8 + 1) * ch);
    int pred = sample(0);
    int index = 0;
    int next = pred;
    if (spb > 1) {
        next = sample(1);
        const int d = abs(next - pred);
        for (int i = 0; i < 89; ++i) index = steps[i] <= d ? i : index;
    }
    blk[c] = ((uint32_t)pred & 0xFFFFu) | ((uint32_t)index << 16);

    uint32_t word = 0;
    for (int k = 1; k < spb; ++k) {
        const int s = next;
        if (k + 1 < spb) next = sample(k + 1);
        const int step = steps[index];
        const int diff = s - pred;
        int code = diff < 0 ? 8 : 0;
        int adiff = abs(diff);
        const bool b4 = adiff >= step;
        adiff -= b4 ? step : 0;
        const bool b2 = adiff >= (step >> 1);
        adiff -= b2 ? (step >> 1) : 0;
        const bool b1 = adiff >= (step >> 2);
        code |= (b4 ? 4 : 0) | (b2 ? 2 : 0) | (b1 ? 1 : 0);
        const int diffq = (step >> 3) + (b4 ? step : 0)
            + (b2 ? (step >> 1) : 0) + (b1 ? (step >> 2) : 0);
        pred += (code & 8) ? -diffq : diffq;
        pred = min(max(pred, -32768), 32767);
        index = min(max(index + index_tab[code & 7], 0), 88);
        const int j = k - 1;
        word |= (uint32_t)code << (4 * (j & 7));
        if ((j & 7) == 7) {
            blk[ch + (int64_t)(j >> 3) * ch + c] = word;
            word = 0;
        }
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
    const int64_t units = (int64_t)n_blocks * ch;
    const int grid = (int)((units + kThreads - 1) / kThreads);
    ima_encode<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        x, frames, ch, spb, n_blocks, reinterpret_cast<uint32_t*>(out));
    return (int)cudaGetLastError();
}

}  // extern "C"
