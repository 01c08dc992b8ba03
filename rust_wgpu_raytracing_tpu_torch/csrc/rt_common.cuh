// Shared pieces of the ray-tracing kernels (closest_hit.cu, anyhit.cu,
// frame.cu, closest_hit_perray.cu, extend_shadow.cu, stream_sweep.cu;
// the per-ray culled walk of all but frame.cu and closest_hit_perray.cu
// is cull_walk.cuh).
//
// The register sweeps (frame.cu, closest_hit_perray.cu) walk one
// 1024-ray schedule tile per CUDA block:
// 256 threads x 4 rays each, rays r = tile*1024 + threadIdx.x + k*256 so
// that neighbouring threads load neighbouring floats. The per-tile face
// blocks are visited in the order the host schedule gives (ascending
// entry-t lower bound `tlb`, culled blocks at +inf), and the walk stops
// at the first block whose bound exceeds the block-wide max of each
// ray's own cap. The cap is refreshed every REFRESH visits; a stale cap
// is the max over an older, larger state, so the visited set only
// grows and the result is unchanged (the merges are idempotent).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rt {

constexpr int THREADS = 256;
constexpr int TILE_R = 1024;            // rays per schedule tile
constexpr int RPT = TILE_R / THREADS;   // rays per thread
constexpr int MAX_BLOCK_F = 32;         // faces per face block (8 or 32)
constexpr int STAGE_COLS = 16;          // plane columns 0-11 + 4 per-face terms
constexpr int REFRESH = 4;              // visits between bound refreshes
constexpr float K_EPSILON = 1e-6f;      // reference kEpsilon (f32)

// Block-wide max of one float per thread; every thread gets the result.
// `red` holds THREADS/32 floats of shared memory. All threads must call.
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // previous readers of red are done
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < THREADS / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}

// Stage columns 0-11 of `pack` (row stride pack_cols) and columns 0-3 of
// `extra` (row stride extra_cols) for faces [ci*block_f, (ci+1)*block_f)
// into shared memory, STAGE_COLS floats per face.
__device__ __forceinline__ void stage_faces(float* dst, const float* pack,
                                            int pack_cols,
                                            const float* extra, int ci,
                                            int block_f, int extra_cols = 8) {
  for (int i = threadIdx.x; i < block_f * STAGE_COLS; i += THREADS) {
    const int f = i / STAGE_COLS;
    const int c = i % STAGE_COLS;
    const size_t row = (size_t)ci * block_f + f;
    dst[i] = c < 12 ? pack[row * pack_cols + c]
                    : extra[row * extra_cols + (c - 12)];
  }
}

// The closest-hit (t, face) sweep of one tile (JAX _merge_tf's
// lexicographic merge): for each of the thread's RPT rays, the smallest
// t over the admitted faces and, on a tie, the smallest face id; misses
// keep t = +inf, face = 0. `test(g, k)` returns ray k's t for the staged
// face g, +inf where it misses. `extra` (row stride 8) supplies staged
// columns 12-15. `faces` holds MAX_BLOCK_F * STAGE_COLS floats of shared
// memory, `red` THREADS/32 floats.
template <class Test>
__device__ __forceinline__ void sweep_closest_by(
    const float* __restrict__ tl, const int* __restrict__ ord, int nb,
    int block_f, const float* __restrict__ fpack, int fpack_cols,
    const float* __restrict__ extra, const float (&cap)[RPT],
    float (&bt)[RPT], int (&bf)[RPT], float* faces, float* red, Test test) {
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    bt[k] = INFINITY;
    bf[k] = 0;
  }
  auto bound = [&]() {
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < RPT; ++k) m = fmaxf(m, fminf(bt[k], cap[k]));
    return block_max(m, red);
  };
  float b = bound();
  for (int p = 0; p < nb; ++p) {
    const int ci = ord[p];
    if (!(tl[ci] <= b)) break;  // uniform: every thread reads the same values
    __syncthreads();            // the previous block's planes are consumed
    stage_faces(faces, fpack, fpack_cols, extra, ci, block_f);
    __syncthreads();
    const int face_base = ci * block_f;
    for (int j = 0; j < block_f; ++j) {
      const float* g = faces + j * STAGE_COLS;
      const int fid = face_base + j;
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const float tm = test(g, k);
        if (tm < bt[k] || (tm == bt[k] && fid < bf[k])) {
          bt[k] = tm;
          bf[k] = fid;
        }
      }
    }
    if ((p + 1) % REFRESH == 0) b = bound();
  }
}

// The shared-origin face test (JAX _ch_block_tv): staged columns 12-15
// are the frame's origin terms [t_num, hc0, hc1, hc2] from oterm.
__device__ __forceinline__ float shared_origin_t(const float* g, float x,
                                                float y, float z) {
  const float ndotd = g[0] * x + g[1] * y + g[2] * z;
  const float t = g[12] / ndotd;
  const float h0 = g[13] + t * (g[3] * x + g[4] * y + g[5] * z);
  const float h1 = g[14] + t * (g[6] * x + g[7] * y + g[8] * z);
  const float h2 = g[15] + t * (g[9] * x + g[10] * y + g[11] * z);
  // NaN (padding faces: 0/0) fails every comparison -> rejected
  const bool valid = fabsf(ndotd) >= K_EPSILON && t >= 0.0f && h0 >= 0.0f &&
                     h1 >= 0.0f && h2 >= 0.0f;
  return valid ? t : INFINITY;
}

// The per-ray-origin face test (JAX _chp_block_tv and _ah_block, term
// for term): staged columns 12-15 are the plane constants [d, c0, c1,
// c2] from dc. Sets t and returns whether the ray (origin u, v, w;
// direction x, y, z) hits the face at t >= 1e-3.
__device__ __forceinline__ bool perray_hit(const float* g, float x, float y,
                                           float z, float u, float v, float w,
                                           float& t) {
  const float ndotd = g[0] * x + g[1] * y + g[2] * z;
  const float ndoto = g[0] * u + g[1] * v + g[2] * w;
  t = -(ndoto + g[12]) / ndotd;
  const float h0 = (g[3] * u + g[4] * v + g[5] * w - g[13]) +
                   t * (g[3] * x + g[4] * y + g[5] * z);
  const float h1 = (g[6] * u + g[7] * v + g[8] * w - g[14]) +
                   t * (g[6] * x + g[7] * y + g[8] * z);
  const float h2 = (g[9] * u + g[10] * v + g[11] * w - g[15]) +
                   t * (g[9] * x + g[10] * y + g[11] * z);
  return fabsf(ndotd) >= K_EPSILON && t >= 1e-3f && h0 >= 0.0f &&
         h1 >= 0.0f && h2 >= 0.0f;
}

// The shared-origin sweep of K4 (rays rx, ry, rz; origin terms
// from oterm).
__device__ __forceinline__ void sweep_closest(
    const float* __restrict__ tl, const int* __restrict__ ord, int nb,
    int block_f, const float* __restrict__ fpack, int fpack_cols,
    const float* __restrict__ oterm, const float (&rx)[RPT],
    const float (&ry)[RPT], const float (&rz)[RPT], const float (&cap)[RPT],
    float (&bt)[RPT], int (&bf)[RPT], float* faces, float* red) {
  sweep_closest_by(tl, ord, nb, block_f, fpack, fpack_cols, oterm, cap, bt,
                   bf, faces, red, [&](const float* g, int k) {
                     return shared_origin_t(g, rx[k], ry[k], rz[k]);
                   });
}

// perray_hit over a column-major staging: column c of the face at
// g[c * stride] (cull_walk.cuh stages a chunk's faces so, one face per
// lane). The same expression, term for term.
__device__ __forceinline__ bool perray_hit_cols(const float* g, int stride,
                                                float x, float y, float z,
                                                float u, float v, float w,
                                                float& t) {
  const float* c = g;
  auto col = [c, stride](int k) { return c[k * stride]; };
  const float ndotd = col(0) * x + col(1) * y + col(2) * z;
  const float ndoto = col(0) * u + col(1) * v + col(2) * w;
  t = -(ndoto + col(12)) / ndotd;
  const float h0 = (col(3) * u + col(4) * v + col(5) * w - col(13)) +
                   t * (col(3) * x + col(4) * y + col(5) * z);
  const float h1 = (col(6) * u + col(7) * v + col(8) * w - col(14)) +
                   t * (col(6) * x + col(7) * y + col(8) * z);
  const float h2 = (col(9) * u + col(10) * v + col(11) * w - col(15)) +
                   t * (col(9) * x + col(10) * y + col(11) * z);
  return fabsf(ndotd) >= K_EPSILON && t >= 1e-3f && h0 >= 0.0f &&
         h1 >= 0.0f && h2 >= 0.0f;
}

// shared_origin_t over a column-major staging (cull_walk.cuh, as
// perray_hit_cols): column c of the face at g[c * stride], columns 12-15
// the origin terms. The same expression, term for term.
__device__ __forceinline__ float shared_origin_t_cols(const float* g,
                                                      int stride, float x,
                                                      float y, float z) {
  const float* c = g;
  auto col = [c, stride](int k) { return c[k * stride]; };
  const float ndotd = col(0) * x + col(1) * y + col(2) * z;
  const float t = col(12) / ndotd;
  const float h0 = col(13) + t * (col(3) * x + col(4) * y + col(5) * z);
  const float h1 = col(14) + t * (col(6) * x + col(7) * y + col(8) * z);
  const float h2 = col(15) + t * (col(9) * x + col(10) * y + col(11) * z);
  const bool valid = fabsf(ndotd) >= K_EPSILON && t >= 0.0f && h0 >= 0.0f &&
                     h1 >= 0.0f && h2 >= 0.0f;
  return valid ? t : INFINITY;
}

// The per-ray box test of K1, K3 and K8-K11 (the port's ops/traverse.py
// ray_box_enter, bit for bit with -fmad=false and IEEE division): does
// the forward line of the ray (origin o, direction d) meet the AABB [lo,
// hi], and where does it enter? The box is widened in space on each axis:
// by |bound| * 1e-5 + 1e-6 (widen_lo / widen_hi, once per box) and by the
// ray's |o| * 1e-5 (folded into the origin: p = o + |o| 1e-5 meets the
// low side, q = o - |o| 1e-5 the high side). Then the JAX perray_super_any
// slab test: the exit inflated by |t| * 1e-5 + 1e-6, the entry deflated
// to t_in * (1 - 1e-5) - 1e-6, an axis whose |d| is below FLT_MIN
// admitted only where the origin lies inside the widened slab; the slab
// parameters are products with 1/d. The widening covers the face test's
// spatial rounding (a hit accepted just outside its triangle, a t just
// before the box for an origin near the plane), which margins in t do
// not for a ray nearly parallel to a slab; a component below FLT_MIN
// would need t > 1e31 to cross the 1e-6 margin. Padding boxes (lo > hi)
// must be dropped by the caller (their widened bounds are NaN).
__device__ __forceinline__ float widen_lo(float lo) {
  return lo - (fabsf(lo) * 1e-5f + 1e-6f);
}
__device__ __forceinline__ float widen_hi(float hi) {
  return hi + (fabsf(hi) * 1e-5f + 1e-6f);
}

// a ray prepared for box tests (once per ray, shared by its tests)
struct BoxRay {
  float p[3], q[3], inv[3];
  bool flat[3];  // |d| < FLT_MIN: the inside rule
};

__device__ __forceinline__ BoxRay box_ray(float ox, float oy, float oz,
                                          float dx, float dy, float dz) {
  const float o[3] = {ox, oy, oz};
  const float d[3] = {dx, dy, dz};
  BoxRay r;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float om = fabsf(o[a]) * 1e-5f;
    r.p[a] = o[a] + om;
    r.q[a] = o[a] - om;
    r.flat[a] = fabsf(d[a]) < 1.17549435e-38f;  // FLT_MIN
    r.inv[a] = r.flat[a] ? 0.0f : 1.0f / d[a];
  }
  return r;
}

// Whether ray r's forward line meets the widened box [wlo, whi] (from
// widen_lo / widen_hi); entry (set either way) is at most the line's
// entry t when it does.
__device__ __forceinline__ bool ray_box_enter(const float* wlo, const float* whi,
                                              const BoxRay& r, float& entry) {
  float tn = 0.0f, tf = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float na, fa;
    if (r.flat[a]) {
      const bool inside = r.p[a] >= wlo[a] && r.q[a] <= whi[a];
      na = inside ? 0.0f : INFINITY;
      fa = inside ? INFINITY : -INFINITY;
    } else {
      const float ta = (wlo[a] - r.p[a]) * r.inv[a];
      const float tb = (whi[a] - r.q[a]) * r.inv[a];
      na = fminf(ta, tb);
      fa = fmaxf(ta, tb);
    }
    tn = fmaxf(tn, na);
    tf = fminf(tf, fa);
  }
  entry = tn * (float)(1.0 - 1e-5) - 1e-6f;
  return (tf + fabsf(tf) * 1e-5f + 1e-6f) >= entry;
}

// The any-hit test of one staged face block (JAX _ah_block) for rays
// with per-ray origins: occ = max(occ, act) where an active ray hits a
// face at t >= 1e-3. `faces` as staged by stage_faces from (fpack, dc).
// Rays that are inactive or already occluded skip the arithmetic: their
// result cannot change.
__device__ __forceinline__ void anyhit_block(
    const float* faces, int block_f, const float (&rdx)[RPT],
    const float (&rdy)[RPT], const float (&rdz)[RPT], const float (&rox)[RPT],
    const float (&roy)[RPT], const float (&roz)[RPT], const float (&ract)[RPT],
    float (&occ)[RPT]) {
  for (int j = 0; j < block_f; ++j) {
    const float* g = faces + j * STAGE_COLS;
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      if (!(ract[k] > 0.0f && occ[k] < ract[k])) continue;
      float t;
      if (perray_hit(g, rdx[k], rdy[k], rdz[k], rox[k], roy[k], roz[k], t))
        occ[k] = fmaxf(occ[k], ract[k]);
    }
  }
}

}  // namespace rt
