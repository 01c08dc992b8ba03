// Shared pieces of the ray-tracing kernels: the face tests and the
// per-ray box test (closest_hit.cu, anyhit.cu, frame.cu,
// closest_hit_perray.cu, extend_shadow.cu, stream_sweep.cu; their
// per-ray culled walk is cull_walk.cuh).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rt {

constexpr int TILE_R = 1024;            // rays per schedule tile
constexpr int MAX_BLOCK_F = 32;         // faces per face block (8 or 32)
constexpr int STAGE_COLS = 16;          // plane columns 0-11 + 4 per-face terms
constexpr float K_EPSILON = 1e-6f;      // reference kEpsilon (f32)

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
// for term) over a column-major staging: column c of the face at
// g[c * stride] (cull_walk.cuh stages a chunk's faces so, one face per
// lane); columns 12-15 are the plane constants [d, c0, c1, c2] from dc.
// Sets t and returns whether the ray (origin u, v, w; direction x, y, z)
// hits the face at t >= 1e-3.
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

// The per-ray box test of K1, K3, K4 and K8-K11 (the port's ops/traverse.py
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

}  // namespace rt
