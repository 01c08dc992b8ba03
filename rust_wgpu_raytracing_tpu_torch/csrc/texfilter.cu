// Bilinear texture mix, one thread per ray.
//
// Replaces the TPU kernel rust_wgpu_raytracing_tpu/ops/megakernel.py
// _texfilter_kernel (reached from sample_packed_texture: the bump map of
// normal mapping): taps (12, R) u16 linear texels [t00, t01, t10, t11]
// x RGB and the weights fx/fy in; the mixed r, g, b planes out, written
// as one (3, R) tensor.
//
// What bounds it on the H100: memory bandwidth. Per ray it reads 24 B of
// taps and 8 B of weights and writes 12 B, against ~30 FP32 operations,
// far below the card's operations-per-byte balance. The design is one
// coalesced pass (neighbouring threads on neighbouring rays, every tap
// row read once); the tap decode and the mix are texel.cuh's, shared
// with texshade.cu. Operation order follows _texfilter_kernel;
// -fmad=false.
#include "texel.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
texfilter_kernel(const unsigned short* __restrict__ taps, const float* __restrict__ fx_p,
                 const float* __restrict__ fy_p, int n, float* __restrict__ out) {
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n; i += gridDim.x * THREADS) {
    const float fx = fx_p[i], fy = fy_p[i];
    float tap[12];
    rt::load_taps(taps, n, i, tap);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) out[(size_t)ch * n + i] = rt::bilinear(tap, ch, fx, fy);
  }
}

}  // namespace

extern "C" int rt_texfilter(const unsigned short* taps, const float* fx, const float* fy,
                            int n, float* out, void* stream) {
  if (n > 0) {
    int blocks = (n + THREADS - 1) / THREADS;
    if (blocks > 65535 * 8) blocks = 65535 * 8;
    texfilter_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(taps, fx, fy, n, out);
  }
  return (int)cudaGetLastError();
}
