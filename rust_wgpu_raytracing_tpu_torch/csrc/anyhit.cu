// Shadow any-hit for per-ray origins.
//
// Replaces the TPU kernel rust_wgpu_raytracing_tpu/ops/megakernel.py
// _make_anyhit_kernel + _ah_block (reached from anyhit_pallas, VMEM
// branch): the same inputs (schedule tlb/order, ray direction and origin
// planes, the activity plane `act`, root-exit caps, the (F, 40) face
// pack and the (F, 8) plane constants dc = [d, c0, c1, c2]) and the same
// output: occ (R,) f32 in {0, 1}, set where some face is hit at
// t >= 1e-3 by an active ray.
//
// What bounds it on the H100: face-visit compute, as for the
// closest-hit kernel (~25 FP32 operations and a divide per visited
// (face, ray) pair with per-ray origins). The design stages each visited
// block's planes once per tile in shared memory, skips the arithmetic
// for rays that are inactive or already occluded (their result cannot
// change), and stops the walk once no live ray's root exit reaches the
// next block (bound -1 when every ray is occluded or inactive).
// Expressions follow _ah_block term for term (rt_common.cuh
// anyhit_block, shared with frame.cu); -fmad=false.
#include "rt_common.cuh"

namespace {

using namespace rt;

__global__ void __launch_bounds__(THREADS)
anyhit_kernel(const float* __restrict__ tlb, const int* __restrict__ order,
              const float* __restrict__ dx, const float* __restrict__ dy,
              const float* __restrict__ dz, const float* __restrict__ ox,
              const float* __restrict__ oy, const float* __restrict__ oz,
              const float* __restrict__ act, const float* __restrict__ texit,
              const float* __restrict__ fpack, const float* __restrict__ dc,
              int nb, int block_f, int fpack_cols, float* __restrict__ occ_out) {
  __shared__ float faces[MAX_BLOCK_F * STAGE_COLS];
  __shared__ float red[THREADS / 32];

  const int tile = blockIdx.x;
  const size_t base = (size_t)tile * TILE_R + threadIdx.x;
  float rdx[RPT], rdy[RPT], rdz[RPT], rox[RPT], roy[RPT], roz[RPT];
  float ract[RPT], cap[RPT], occ[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const size_t r = base + (size_t)k * THREADS;
    rdx[k] = dx[r];
    rdy[k] = dy[r];
    rdz[k] = dz[r];
    rox[k] = ox[r];
    roy[k] = oy[r];
    roz[k] = oz[r];
    ract[k] = act[r];
    cap[k] = texit[r];
    occ[k] = 0.0f;
  }

  auto bound = [&]() {
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < RPT; ++k)
      m = fmaxf(m, ract[k] * (1.0f - occ[k]) > 0.0f ? cap[k] : -1.0f);
    return block_max(m, red);
  };

  const float* tl = tlb + (size_t)tile * nb;
  const int* ord = order + (size_t)tile * nb;
  float b = bound();
  for (int p = 0; p < nb; ++p) {
    const int ci = ord[p];
    if (!(tl[ci] <= b)) break;  // uniform across the block
    __syncthreads();
    stage_faces(faces, fpack, fpack_cols, dc, ci, block_f);
    __syncthreads();
    anyhit_block(faces, block_f, rdx, rdy, rdz, rox, roy, roz, ract, occ);
    if ((p + 1) % REFRESH == 0) b = bound();
  }

#pragma unroll
  for (int k = 0; k < RPT; ++k) occ_out[base + (size_t)k * THREADS] = occ[k];
}

}  // namespace

extern "C" int rt_anyhit(const float* tlb, const int* order, const float* dx,
                         const float* dy, const float* dz, const float* ox,
                         const float* oy, const float* oz, const float* act,
                         const float* texit, const float* fpack, const float* dc,
                         int n_tiles, int nb, int block_f, int fpack_cols,
                         float* occ, void* stream) {
  if (block_f < 1 || block_f > rt::MAX_BLOCK_F) return (int)cudaErrorInvalidValue;
  if (n_tiles > 0)
    anyhit_kernel<<<n_tiles, rt::THREADS, 0, (cudaStream_t)stream>>>(
        tlb, order, dx, dy, dz, ox, oy, oz, act, texit, fpack, dc, nb, block_f,
        fpack_cols, occ);
  return (int)cudaGetLastError();
}
