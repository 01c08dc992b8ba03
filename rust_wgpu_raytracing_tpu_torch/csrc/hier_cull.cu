// Two-level LBVH-cut cull: the packed (tile, cluster) activity words of
// accel="bvh" (K5).
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
// What bounds it on the H100: writing the words (4 B per tile and
// superblock, 4.2 MB at the 1080p bvh frame) against the slab tests (~18
// FP32 operations per box and tile, 32 more boxes for a superblock that
// passes); the bytes bound it, ~1.4 us at 3.35 TB/s. What the card's time
// goes to instead: the latency of the loads a passing superblock needs,
// and the cone terms, which every warp needs before its first test.
//
// The design: one warp per (tile, group of 32 superblocks), 8 tiles of
// one group per CUDA block (the grid's y walks the groups). The warp
// computes its tile's cone terms once: 12 lanes load the 12 bounds and 6
// lanes take the six reciprocals, and shuffles hand them to every lane.
// Lane l tests superblock s0 + l against its union box (the 8 warps of a
// block read the same 32 boxes, from L1 after the first). For each
// superblock of the ballot of passes, in a warp-uniform loop, lane c
// tests cluster 32 s + c, and a second ballot is the word, which lane
// s - s0 keeps; the warp writes its 32 words as one coalesced 128-byte
// store. A warp that walks all of a tile's groups waits on one dependent
// L2 load per superblock the tile enters, and the few tiles of a shadow
// wavefront that enter many set the launch's time; one group a warp
// spreads them over the card. The TPU kernel descends into a superblock's
// clusters when any of its 1024 tiles enters the superblock; here a tile
// descends when it enters it itself. The slab test is monotone in the box
// (a cluster box lies inside its superblock's union), so the words are
// the same.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;               // tiles per CUDA block
constexpr int THREADS = 32 * WARPS;
constexpr int CLUSTERS = 32;           // clusters per superblock = bits per word
constexpr unsigned FULL = 0xffffffffu;

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

// JAX _box_test on one box: lo xyz at box(0..2), hi xyz at box(3..5)
template <class Box>
__device__ __forceinline__ bool box_test(Box box, const Cone& c) {
  bool ok = true;
  float lo_t = 0.0f, hi_t = INFINITY;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float A = box(k) - c.omax[k];
    const float B = box(3 + k) - c.omin[k];
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
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;  // the ragged last block: a whole warp

  // the tile's cone terms (JAX _dir_pre), the same in every lane
  const float bv = lane < 12 ? bounds[(size_t)lane * n_tiles + tile] : 0.0f;
  Cone c;
  float dn[3], dp[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c.omin[k] = __shfl_sync(FULL, bv, k);
    c.omax[k] = __shfl_sync(FULL, bv, 3 + k);
    dn[k] = __shfl_sync(FULL, bv, 6 + k);
    dp[k] = __shfl_sync(FULL, bv, 9 + k);
    c.mixed[k] = (dn[k] <= 0.0f) & (dp[k] >= 0.0f);
    c.zero[k] = (dn[k] == 0.0f) & (dp[k] == 0.0f);
    c.pos[k] = dn[k] > 0.0f;
  }
  float x = 1.0f;  // lanes 0-2: dp, lanes 3-5: dn
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (lane == k) x = dp[k];
    if (lane == 3 + k) x = dn[k];
  }
  const float rcp = 1.0f / (fabsf(x) > 1e-30f ? x : 1e-30f);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c.inv_dp[k] = __shfl_sync(FULL, rcp, k);
    c.inv_dn[k] = __shfl_sync(FULL, rcp, 3 + k);
  }

  const int s0 = blockIdx.y * 32, s = s0 + lane;
  const bool in = s < n_super;  // the ragged last group
  bool pass = false;
  if (in) {
    const float* box = sup + (size_t)s * 6;
    pass = box_test([box](int k) { return __ldg(box + k); }, c);
  }
  uint32_t word = 0u;
  for (unsigned m = __ballot_sync(FULL, pass); m; m &= m - 1u) {
    const int q = __ffs((int)m) - 1;  // warp-uniform
    const float* box = clus + ((size_t)(s0 + q) * CLUSTERS + lane) * 6;
    const uint32_t bits = __ballot_sync(
        FULL, box_test([box](int k) { return __ldg(box + k); }, c));
    if (lane == q) word = bits;
  }
  if (in) words[(size_t)tile * n_super + s] = (int)word;
}

}  // namespace

extern "C" int rt_hier_cull(const float* sup, const float* clus,
                            const float* bounds, int n_tiles, int n_super,
                            int* words, void* stream) {
  if (n_tiles > 0 && n_super > 0) {
    const dim3 grid((n_tiles + WARPS - 1) / WARPS, (n_super + 31) / 32);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    hier_cull_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        sup, clus, bounds, n_tiles, n_super, words);
  }
  return (int)cudaGetLastError();
}

// out[0..3] = registers a thread, spilled bytes a thread, shared memory a
// block (none) and blocks an SM.
extern "C" int rt_hier_cull_resources(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, hier_cull_kernel);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, hier_cull_kernel,
                                                        THREADS, 0);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = 0;
  out[3] = ctas;
  return (int)err;
}
