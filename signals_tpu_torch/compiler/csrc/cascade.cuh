// The coupled-form biquad cascade shared by every kernel of this directory
// (the counterpart of _run_cascade in signals_tpu/compiler/pallas_kernels.py),
// so that their numerics cannot drift apart.
//
// Per section and row:
//   y = d0 x + d1 s1 + d2 s2;  s1' = rc s1 - rs s2 + x;  s2' = rs s1 + rc s2
// NSEC sections run back to back on each row with all taps and state in
// registers.  The multiply-adds are left to nvcc's default contraction
// (--fmad=true), which changes results only at f32 round-off.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace signals {

struct Taps { float rc, rs, d0, d1, d2; };

template <int NSEC>
struct Cascade {
    Taps tp[NSEC];
    float s1[NSEC], s2[NSEC];

    __device__ __forceinline__ void reset() {
#pragma unroll
        for (int s = 0; s < NSEC; ++s) s1[s] = s2[s] = 0.f;
    }

    // Taps of every section from an 11-column design_coupled row layout:
    // section s of this lane starts at c + s * sec_stride.
    __device__ __forceinline__ void load(const float* __restrict__ c,
                                         int64_t sec_stride) {
#pragma unroll
        for (int s = 0; s < NSEC; ++s) {
            const float* r = c + s * sec_stride;
            tp[s] = Taps{r[6], r[7], r[8], r[9], r[10]};
        }
    }

    // One row through the first NS sections (the others keep their state).
    template <int NS = NSEC>
    __device__ __forceinline__ float step(float v) {
#pragma unroll
        for (int s = 0; s < NS; ++s) {
            const Taps& t = tp[s];
            const float y = t.d0 * v + t.d1 * s1[s] + t.d2 * s2[s];
            const float n1 = t.rc * s1[s] - t.rs * s2[s] + v;
            const float n2 = t.rs * s1[s] + t.rc * s2[s];
            s1[s] = n1;
            s2[s] = n2;
            v = y;
        }
        return v;
    }

    // One row of the first section's zero-input response: step(0.f) of a
    // one-section cascade without the input's terms.
    __device__ __forceinline__ float free_step() {
        const Taps& t = tp[0];
        const float y = t.d1 * s1[0] + t.d2 * s2[0];
        const float n1 = t.rc * s1[0] - t.rs * s2[0];
        s2[0] = t.rs * s1[0] + t.rc * s2[0];
        s1[0] = n1;
        return y;
    }
};

}  // namespace signals
