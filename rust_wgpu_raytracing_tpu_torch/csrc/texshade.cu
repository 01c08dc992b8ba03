// Bilinear texture mix + Blinn-Phong combine, one thread per ray.
//
// Replaces the TPU kernel rust_wgpu_raytracing_tpu/ops/megakernel.py
// _texshade_kernel (reached from _texshade_pallas): taps (12, R) u16
// linear-light texels [t00, t01, t10, t11] x RGB, weights fx/fy, the
// Blinn factors lam/spec and the per-ray ambient and specular colours
// in; p = ambient + tex * lam + specular * spec per channel out.
//
// What bounds it on the H100: memory bandwidth. Per ray it reads 24 B of
// taps and 40 B of planes and writes 12 B, against ~40 FP32 operations,
// far below the card's operations-per-byte balance. The design is one
// coalesced pass: every input is read once, the three output planes are
// written once, nothing is staged. The taps arrive as int16 holding the
// u16 bits and are read as unsigned short. Operation order follows
// _texshade_kernel; -fmad=false. The tap decode and the bilinear mix
// are texel.cuh's, shared with texfilter.cu.
#include "texel.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
texshade_kernel(const unsigned short* __restrict__ taps,
                const float* __restrict__ fx_p, const float* __restrict__ fy_p,
                const float* __restrict__ lam_p, const float* __restrict__ spec_p,
                const float* __restrict__ ar, const float* __restrict__ ag,
                const float* __restrict__ ab, const float* __restrict__ sr,
                const float* __restrict__ sg, const float* __restrict__ sb, int n,
                float* __restrict__ pr, float* __restrict__ pg,
                float* __restrict__ pb) {
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n;
       i += gridDim.x * THREADS) {
    const float fx = fx_p[i], fy = fy_p[i], lam = lam_p[i], spec = spec_p[i];
    float tap[12];
    rt::load_taps(taps, n, i, tap);
    const float* amb[3] = {ar, ag, ab};
    const float* spc[3] = {sr, sg, sb};
    float* out[3] = {pr, pg, pb};
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float tex = rt::bilinear(tap, ch, fx, fy);
      out[ch][i] = (amb[ch][i] + tex * lam) + spc[ch][i] * spec;
    }
  }
}

}  // namespace

extern "C" int rt_texshade(const unsigned short* taps, const float* fx,
                           const float* fy, const float* lam, const float* spec,
                           const float* ar, const float* ag, const float* ab,
                           const float* sr, const float* sg, const float* sb,
                           int n, float* pr, float* pg, float* pb, void* stream) {
  if (n > 0) {
    int blocks = (n + THREADS - 1) / THREADS;
    if (blocks > 65535 * 8) blocks = 65535 * 8;
    texshade_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        taps, fx, fy, lam, spec, ar, ag, ab, sr, sg, sb, n, pr, pg, pb);
  }
  return (int)cudaGetLastError();
}
