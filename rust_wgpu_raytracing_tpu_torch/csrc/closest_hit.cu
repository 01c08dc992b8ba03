// Closest hit for shared-origin rays, with the scene's spheres fused.
//
// Replaces the TPU kernel rust_wgpu_raytracing_tpu/ops/megakernel.py
// _make_closest_hit_kernel (reached from gbuffer_pallas, VMEM branch):
// the same inputs (schedule tlb/order, ray planes, root-exit caps, the
// (F, 40) face pack, the (F, 8) per-frame origin terms, the sphere
// block) and the same outputs: the lexicographic (t, face) winner and
// the winning sphere's (t, id, unit normal), picked by strict
// nonlinear depth.
//
// What bounds it on the H100: face-visit compute. Each visited
// (face, ray) pair costs ~20 FP32 operations and one divide, and a
// dense 1080p view visits tens of faces per ray, so the arithmetic
// rather than memory traffic sets the time (a tile reads ~2 KB of face
// planes per visited 32-face block and 16 B per ray).
// The design keeps each ray's (t, face) in registers for the whole
// walk, stages each visited block's 16 plane columns once into shared
// memory for all 1024 rays of the tile, and stops the front-to-back walk
// early (rt_common.cuh sweep_closest, shared with frame.cu).
// Expressions follow _ch_block_tv and the sphere tail term for term;
// compiled with -fmad=false so every product rounds, as in the plain
// PyTorch version.
#include "rt_common.cuh"

namespace {

using namespace rt;

__global__ void __launch_bounds__(THREADS)
closest_hit_kernel(const float* __restrict__ tlb, const int* __restrict__ order,
                   const float* __restrict__ dx, const float* __restrict__ dy,
                   const float* __restrict__ dz, const float* __restrict__ texit,
                   const float* __restrict__ fpack, const float* __restrict__ oterm,
                   const float* __restrict__ sph, int nb, int block_f,
                   int fpack_cols, int n_spheres, float inv_near,
                   float rcp_span, float* __restrict__ t_out,
                   int* __restrict__ face_out, float* __restrict__ st_out,
                   float* __restrict__ sid_out, float* __restrict__ snx_out,
                   float* __restrict__ sny_out, float* __restrict__ snz_out) {
  __shared__ float faces[MAX_BLOCK_F * STAGE_COLS];
  __shared__ float red[THREADS / 32];

  const int tile = blockIdx.x;
  const size_t base = (size_t)tile * TILE_R + threadIdx.x;
  float rx[RPT], ry[RPT], rz[RPT], cap[RPT], bt[RPT];
  int bf[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const size_t r = base + (size_t)k * THREADS;
    rx[k] = dx[r];
    ry[k] = dy[r];
    rz[k] = dz[r];
    cap[k] = texit[r];
  }
  sweep_closest(tlb + (size_t)tile * nb, order + (size_t)tile * nb, nb, block_f,
                fpack, fpack_cols, oterm, rx, ry, rz, cap, bt, bf, faces, red);

#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const size_t r = base + (size_t)k * THREADS;
    t_out[r] = bt[k];
    face_out[r] = bf[k];
  }
  if (n_spheres == 0) return;

  // sphere tail: the winner by strict nonlinear depth, in config order
  const float ox = sph[0], oy = sph[1], oz = sph[2];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const float x = rx[k], y = ry[k], z = rz[k];
    const float a = x * x + y * y + z * z;
    float best_d = INFINITY, best_t = INFINITY, best_id = 0.0f;
    float best_cx = 0.0f, best_cy = 0.0f, best_cz = 0.0f;
    for (int i = 0; i < n_spheres; ++i) {
      const float cx = sph[3 + 4 * i], cy = sph[4 + 4 * i];
      const float cz = sph[5 + 4 * i], radius = sph[6 + 4 * i];
      const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
      const float bq = 2.0f * (ocx * x + ocy * y + ocz * z);
      const float c = (ocx * ocx + ocy * ocy + ocz * ocz) - radius * radius;
      const float disc = bq * bq - 4.0f * a * c;
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float t1 = (-bq - sq) / (2.0f * a);
      const float t2 = (-bq + sq) / (2.0f * a);
      float t = t1 >= 0.0f ? t1 : (t2 >= 0.0f ? t2 : INFINITY);
      t = disc < 0.0f ? INFINITY : t;
      const float d = isfinite(t) ? ((1.0f / t) - inv_near) * rcp_span : INFINITY;
      if (d < best_d) {
        best_d = d;
        best_t = t;
        best_id = (float)i;
        best_cx = cx;
        best_cy = cy;
        best_cz = cz;
      }
    }
    const float ts = isfinite(best_t) ? best_t : 0.0f;
    const float nx = (ox + x * ts) - best_cx;
    const float ny = (oy + y * ts) - best_cy;
    const float nz = (oz + z * ts) - best_cz;
    float l = sqrtf(nx * nx + ny * ny + nz * nz);
    l = l > 0.0f ? l : 1.0f;
    const size_t r = base + (size_t)k * THREADS;
    st_out[r] = best_t;
    sid_out[r] = best_id;
    snx_out[r] = nx / l;
    sny_out[r] = ny / l;
    snz_out[r] = nz / l;
  }
}

}  // namespace

extern "C" int rt_closest_hit(const float* tlb, const int* order, const float* dx,
                              const float* dy, const float* dz, const float* texit,
                              const float* fpack, const float* oterm, const float* sph,
                              int n_tiles, int nb, int block_f, int fpack_cols,
                              int n_spheres, float inv_near, float rcp_span,
                              float* t, int* face, float* st, float* sid, float* snx,
                              float* sny, float* snz, void* stream) {
  if (block_f < 1 || block_f > rt::MAX_BLOCK_F) return (int)cudaErrorInvalidValue;
  if (n_tiles > 0)
    closest_hit_kernel<<<n_tiles, rt::THREADS, 0, (cudaStream_t)stream>>>(
        tlb, order, dx, dy, dz, texit, fpack, oterm, sph, nb, block_f, fpack_cols,
        n_spheres, inv_near, rcp_span, t, face, st, sid, snx, sny, snz);
  return (int)cudaGetLastError();
}
