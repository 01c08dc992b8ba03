// Two-level LBVH-cut cull: the packed (tile, cluster) activity words of
// accel="bvh".
//
// Replaces the TPU kernel rust_wgpu_raytracing_tpu/ops/traverse_pallas.py
// _make_smem_kernel (reached from hier_cull_words, called by
// _mask_words): the same inputs (the superblock AABB unions (S, 6), the
// widened cluster AABBs (32 S, 6), each [lo xyz, hi xyz], and the tiles'
// ray-cone bounds as 12 planes omin xyz, omax xyz, dmin xyz, dmax xyz of
// (T,)) and the same output: words (T, S) i32, bit c of word s set when
// tile t's cone passes the slab test of superblock s's box and then of
// its cluster 32 s + c. The slab test is _box_test's, term for term: the
// direction reciprocals 1/dp and 1/dn are IEEE divides (no fast math) and
// every product rounds alone (-fmad=false); max and min propagate NaN as
// jnp.maximum / jnp.minimum do.
//
// What bounds it on the H100: the slab tests (~30 FP32 operations and
// selects per box and tile; a superblock that passes costs 32 more box
// tests), not memory: a tile reads 48 B of cone bounds and writes 4 B per
// superblock, the box tables are a few hundred KB and stay in L2.
// The design: one thread per (tile, superblock), 256 tiles of one
// superblock per CUDA block, the superblock's 33 boxes staged once in
// shared memory and read as broadcasts; the per-tile cone terms
// (predicates and reciprocals) are computed once per thread. The TPU
// kernel descends into a superblock's clusters when any of its 1024
// tiles enters the superblock; here a tile descends when it enters it
// itself. The slab test is monotone in the box (a cluster box lies inside
// its superblock's union), so the words are the same.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CLUSTERS = 32;  // clusters per superblock = bits per word

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? NAN : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? NAN : fminf(a, b);
}

struct Cone {
  float omin[3], omax[3], inv_dp[3], inv_dn[3];
  bool mixed[3], zero[3], pos[3];
};

// JAX _box_test on one box [lo xyz, hi xyz]
__device__ __forceinline__ bool box_test(const float* box, const Cone& c) {
  bool ok = true;
  float lo_t = 0.0f, hi_t = INFINITY;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float A = box[k] - c.omax[k];
    const float B = box[3 + k] - c.omin[k];
    ok = ok & (B >= A);
    const float lo_pos = A > 0.0f ? A * c.inv_dp[k] : 0.0f;
    const float hi_pos = B >= 0.0f ? B * c.inv_dn[k] : -1.0f;
    const float lo_neg = B < 0.0f ? B * c.inv_dn[k] : 0.0f;
    const float hi_neg = A <= 0.0f ? A * c.inv_dp[k] : -1.0f;
    const float l = c.mixed[k] ? 0.0f : (c.pos[k] ? lo_pos : lo_neg);
    float h = c.mixed[k] ? INFINITY : (c.pos[k] ? hi_pos : hi_neg);
    if (c.zero[k] && !((A <= 0.0f) & (B >= 0.0f))) h = -1.0f;
    lo_t = nan_max(lo_t, l);
    hi_t = nan_min(hi_t, h);
  }
  return ok & (hi_t >= 0.0f) & (hi_t >= lo_t);
}

__global__ void __launch_bounds__(THREADS)
hier_cull_kernel(const float* __restrict__ sup, const float* __restrict__ clus,
                 const float* __restrict__ bounds, int n_tiles, int n_super,
                 int* __restrict__ words) {
  __shared__ float boxes[(CLUSTERS + 1) * 6];
  const int s = blockIdx.y;
  for (int i = threadIdx.x; i < (CLUSTERS + 1) * 6; i += THREADS)
    boxes[i] = i < 6 ? sup[(size_t)s * 6 + i]
                     : clus[(size_t)s * CLUSTERS * 6 + (i - 6)];
  __syncthreads();
  const int tile = blockIdx.x * THREADS + threadIdx.x;
  if (tile >= n_tiles) return;

  Cone c;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c.omin[k] = bounds[(size_t)k * n_tiles + tile];
    c.omax[k] = bounds[(size_t)(3 + k) * n_tiles + tile];
    const float dn = bounds[(size_t)(6 + k) * n_tiles + tile];
    const float dp = bounds[(size_t)(9 + k) * n_tiles + tile];
    c.mixed[k] = (dn <= 0.0f) & (dp >= 0.0f);
    c.zero[k] = (dn == 0.0f) & (dp == 0.0f);
    c.pos[k] = dn > 0.0f;
    const float dp_s = fabsf(dp) > 1e-30f ? dp : 1e-30f;
    const float dn_s = fabsf(dn) > 1e-30f ? dn : 1e-30f;
    c.inv_dp[k] = 1.0f / dp_s;
    c.inv_dn[k] = 1.0f / dn_s;
  }
  uint32_t word = 0u;
  if (box_test(boxes, c)) {
    for (int b = 0; b < CLUSTERS; ++b)
      word |= (uint32_t)box_test(boxes + 6 * (b + 1), c) << b;
  }
  words[(size_t)tile * n_super + s] = (int)word;
}

}  // namespace

extern "C" int rt_hier_cull(const float* sup, const float* clus,
                            const float* bounds, int n_tiles, int n_super,
                            int* words, void* stream) {
  if (n_super > 65535) return (int)cudaErrorInvalidValue;
  if (n_tiles > 0 && n_super > 0) {
    const dim3 grid((n_tiles + THREADS - 1) / THREADS, n_super);
    hier_cull_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        sup, clus, bounds, n_tiles, n_super, words);
  }
  return (int)cudaGetLastError();
}
