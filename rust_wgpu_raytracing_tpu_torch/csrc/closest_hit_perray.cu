// Closest hit for rays with per-ray origins (the path tracer's bounce
// rays).
//
// Replaces the TPU kernel rust_wgpu_raytracing_tpu/ops/megakernel.py
// _make_closest_hit_perray_kernel + _chp_block_slim (reached from
// gbuffer_perray_pallas, VMEM branch): the same inputs (schedule
// tlb/order, direction and origin planes, root-exit caps, the (F, 40)
// face pack and the (F, 8) plane constants dc = [d, c0, c1, c2]) and the
// same outputs: the lexicographic (t, face) winner over the admitted
// faces at t >= 1e-3 (misses keep t = +inf, face = 0; rays with a zero
// direction never hit, their root-exit cap is -1).
//
// What bounds it on the H100: face-visit compute. Each visited
// (face, ray) pair costs ~52 FP32 operations and a divide (the origin
// terms are per ray, so twice K1's plane work), against 64 B per face
// block row and 28 B per ray of memory traffic.
// The design is K1's: each ray's (t, face) stays in registers for the
// whole walk, each admitted 32-face block is staged once per 1024-ray
// tile in shared memory (plane columns 0-11 and dc 0-3), and the
// front-to-back walk stops at the first block whose entry bound exceeds
// every ray's min(best t, root exit) (rt_common.cuh sweep_closest_by).
// The face test is rt_common.cuh perray_hit, shared with K3 and K8;
// -fmad=false so every product rounds, as in the plain version.
#include "rt_common.cuh"

namespace {

using namespace rt;

__global__ void __launch_bounds__(THREADS)
closest_hit_perray_kernel(const float* __restrict__ tlb,
                          const int* __restrict__ order,
                          const float* __restrict__ dx, const float* __restrict__ dy,
                          const float* __restrict__ dz, const float* __restrict__ ox,
                          const float* __restrict__ oy, const float* __restrict__ oz,
                          const float* __restrict__ texit,
                          const float* __restrict__ fpack, const float* __restrict__ dc,
                          int nb, int block_f, int fpack_cols,
                          float* __restrict__ t_out, int* __restrict__ face_out) {
  __shared__ float faces[MAX_BLOCK_F * STAGE_COLS];
  __shared__ float red[THREADS / 32];

  const int tile = blockIdx.x;
  const size_t base = (size_t)tile * TILE_R + threadIdx.x;
  float rdx[RPT], rdy[RPT], rdz[RPT], rox[RPT], roy[RPT], roz[RPT];
  float cap[RPT], bt[RPT];
  int bf[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const size_t r = base + (size_t)k * THREADS;
    rdx[k] = dx[r];
    rdy[k] = dy[r];
    rdz[k] = dz[r];
    rox[k] = ox[r];
    roy[k] = oy[r];
    roz[k] = oz[r];
    cap[k] = texit[r];
  }
  sweep_closest_by(tlb + (size_t)tile * nb, order + (size_t)tile * nb, nb,
                   block_f, fpack, fpack_cols, dc, cap, bt, bf, faces, red,
                   [&](const float* g, int k) {
                     float t;
                     const bool valid = perray_hit(g, rdx[k], rdy[k], rdz[k],
                                                   rox[k], roy[k], roz[k], t);
                     return valid ? t : INFINITY;
                   });
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const size_t r = base + (size_t)k * THREADS;
    t_out[r] = bt[k];
    face_out[r] = bf[k];
  }
}

}  // namespace

extern "C" int rt_closest_hit_perray(const float* tlb, const int* order,
                                     const float* dx, const float* dy,
                                     const float* dz, const float* ox,
                                     const float* oy, const float* oz,
                                     const float* texit, const float* fpack,
                                     const float* dc, int n_tiles, int nb,
                                     int block_f, int fpack_cols, float* t,
                                     int* face, void* stream) {
  if (block_f < 1 || block_f > rt::MAX_BLOCK_F) return (int)cudaErrorInvalidValue;
  if (n_tiles > 0)
    closest_hit_perray_kernel<<<n_tiles, rt::THREADS, 0, (cudaStream_t)stream>>>(
        tlb, order, dx, dy, dz, ox, oy, oz, texit, fpack, dc, nb, block_f,
        fpack_cols, t, face);
  return (int)cudaGetLastError();
}
