// The u16 texel taps shared by the texture kernels (texshade.cu,
// texfilter.cu): a (12, n) pool gather of [t00, t01, t10, t11] x RGB,
// linear-light u16 held in int16 bits, read as unsigned short.
#pragma once

#include <cuda_runtime.h>

namespace rt {

// the JAX kernels' f32 constant: (1.0 / 65535.0) rounded to float
constexpr float TAP_SCALE = (float)(1.0 / 65535.0);

// The 12 taps of ray i as floats in [0, 1].
__device__ __forceinline__ void load_taps(const unsigned short* __restrict__ taps,
                                          int n, int i, float tap[12]) {
#pragma unroll
  for (int k = 0; k < 12; ++k) tap[k] = (float)(int)taps[(size_t)k * n + i] * TAP_SCALE;
}

// Bilinear mix of channel ch, in _texfilter_kernel's operation order.
__device__ __forceinline__ float bilinear(const float tap[12], int ch, float fx,
                                          float fy) {
  const float top = tap[ch] * (1.0f - fx) + tap[3 + ch] * fx;
  const float bot = tap[6 + ch] * (1.0f - fx) + tap[9 + ch] * fx;
  return top * (1.0f - fy) + bot * fy;
}

}  // namespace rt
