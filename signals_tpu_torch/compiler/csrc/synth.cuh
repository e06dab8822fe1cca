// The in-kernel oscillator synthesis of the generator-fed segment kernels
// (segments.cu's seg_cascade<GEN=true>, adjoint.cu's seg_cascade_vjp<GEN =
// true>): one sample at absolute frame t, signals_tpu_torch/nodes/osc.py's op
// sequence with round-to-nearest intrinsics, which nvcc never contracts into
// an FMA, so that it rounds exactly like the plain PyTorch synthesis (a
// one-ulp phase error at a saw wrap is a 2.0 spike).

#pragma once

#include <cuda_runtime.h>

namespace signals {

constexpr int kSinTerms = 7;         // Horner terms of sin(2*pi*y), mathx.sin2pi

enum { OSC_SINE = 0, OSC_SQUARE = 1, OSC_SAW = 2, OSC_TRIANGLE = 3 };

struct GenSpec {
    double sin_c[kSinTerms];   // mathx._SIN2PI_COEFFS, passed from Python
    float inv_rate;            // 1/rate as a runtime value, never folded
};

__device__ __forceinline__ float frac_rn(float v) {
    return __fsub_rn(v, floorf(v));
}

// frac_rn(v) for |v| <= 0.5 without floorf (a conversion instruction, at a
// quarter of the FMA rate): v, or v + 1 where v < 0; adding 0 turns a -0
// into the +0 that v - floor(v) gives.
__device__ __forceinline__ float frac_small(float v) {
    return __fadd_rn(v, v < 0.f ? 1.f : 0.f);
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
// Straight-line code (a select, not a branch, for t < 0), so that the
// scheduler can interleave the independent rows of a chunk.  PH0: the lane
// has ph == 0 and hz >= 0, where (for t >= 0) turns is exact in [0, 1), so
// frac_rn(turns + ph) is turns itself.
template <int OSC, bool PH0>
__device__ __forceinline__ float synth(int t, float hz, float ph, float amp,
                                       const GenSpec& g) {
    const float tf = __int2float_rn(t);
    const float turns = frac_rn(__fmul_rn(__fmul_rn(tf, g.inv_rate), hz));
    const float tt = PH0 ? turns : frac_rn(__fadd_rn(turns, ph));
    float x;
    if (OSC == OSC_SINE) {
        x = sin2pi_f64(tt, g);
    } else if (OSC == OSC_SQUARE) {
        x = sign_f(__fsub_rn(0.5f, frac_rn(tt)));
    } else if (OSC == OSC_SAW) {
        // 2 * frac is exact, so the fused 2 * frac - 1 rounds as the two ops
        x = __fmaf_rn(2.f, frac_small(__fsub_rn(tt, 0.5f)), -1.f);
    } else {  // OSC_TRIANGLE
        const float t3 = __fsub_rn(tt, 0.25f);
        const float half = __fmul_rn(0.5f, frac_rn(__fmul_rn(t3, 2.f)));
        x = __fmul_rn(__fsub_rn(__fmul_rn(4.f, half), 1.f),
                      sign_f(__fsub_rn(frac_rn(t3), 0.5f)));
    }
    return t < 0 ? 0.f : __fmul_rn(amp, x);
}

}  // namespace signals
