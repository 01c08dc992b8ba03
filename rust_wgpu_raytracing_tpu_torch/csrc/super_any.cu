// The per-ray union superblock admission of the streamed bounce sweep:
// out[t, s] = some live ray of tile t has a forward line (t >= 0) that
// meets superblock s's AABB.
//
// Replaces no Pallas kernel. The JAX package computes it in plain jnp
// (rust_wgpu_raytracing_tpu/ops/traverse.py perray_super_any, called by
// gbuffer_perray_pallas's streamed branch), which XLA fuses into one loop
// that keeps its (rays x superblocks) temporaries out of memory. Its plain
// PyTorch twin (ops/traverse.py perray_super_any) materialises every
// intermediate: at the 540p bounce wavefront of a 522k-face mesh (524,288
// rays, 511 superblocks) one call is ~1,340 launches and ~110 GB of
// traffic, ~49 ms on the H100. This kernel is that fusion, written by
// hand.
//
// The arithmetic is the plain function's, term for term, each operation
// rounded on its own (-fmad=false, no fast math): d_safe = d == 0 ? 1 :
// d; ta = (lo - o) / d_safe and tb = (hi - o) / d_safe, IEEE divides;
// na = min(ta, tb), fa = max(ta, tb), propagating NaN as torch.minimum
// and torch.maximum do; where d == 0, na = inside ? 0 : +inf and fa =
// inside ? +inf : -inf (inside: lo <= o <= hi); tn from 0 and tf from
// +inf folded x, y, z by NaN-propagating max and min. The test is
// ((tf + |tf| * 1e-5) + 1e-6) >= (tn * (1 - 1e-5) - 1e-6) with the f32
// constants torch gives Python scalars on an f32 tensor (1 - 1e-5 folded
// in double first); a NaN fails it (-inf + inf). Then & act, and any over
// the tile. Only the result's bool leaves the pair, so the sign of a zero
// tn or tf cannot matter.
//
// What bounds it on the H100: operations. A (live ray, superblock) pair
// is 37 FP32 operations, 6 of them correctly rounded divides, which the
// card runs as several instructions each; a tile rejects a superblock
// only after all its live rays. At the 540p bounce-1 wavefront (67,820
// live rays of 524,288) every live pair is 1.3 GFLOP, ~0.02 ms at 67
// TFLOP/s; the bytes (six ray planes and act in once, 13.1 MB, and T x S
// flags out) take ~4 us at 3.35 TB/s. The kernel takes ~0.44 ms there:
// the divides, and the serial walk over the superblocks of a warp whose
// rays admit none.
//
// The design: a block per (tile, group of SB superblocks), 256 threads.
// The group's boxes are staged in shared memory; a thread holds up to 4
// rays of the tile in registers (a tile of more than 1024 rays is walked
// 1024 rays at a time), inactive lanes skip all arithmetic. For each
// superblock a warp tests its live rays (a thread stops at its first
// admitting ray), __any_sync combines them and lane 0 raises the
// superblock's shared flag. A warp skips a superblock whose flag is
// already up; the warps start at staggered superblocks so that they skip
// each other's finds. A flag only rises, so the output does not depend on
// the order. After a barrier the block writes its flags coalesced.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RAYS = 4;                // rays a thread
constexpr int GROUP = THREADS * RAYS;  // rays a pass over the group
constexpr int SB = 128;                // superblocks a block
constexpr unsigned FULL = 0xffffffffu;

// torch.minimum / torch.maximum: NaN wins
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? NAN : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? NAN : fminf(a, b);
}

struct Ray {
  float o[3], ds[3];
  bool flat[3];
};

__device__ __forceinline__ bool admits(const Ray& r, const float* lo,
                                       const float* hi) {
  float tn = 0.0f, tf = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float na, fa;
    if (r.flat[a]) {
      const bool inside = (r.o[a] >= lo[a]) & (r.o[a] <= hi[a]);
      na = inside ? 0.0f : INFINITY;
      fa = inside ? INFINITY : -INFINITY;
    } else {
      const float ta = __fdiv_rn(lo[a] - r.o[a], r.ds[a]);
      const float tb = __fdiv_rn(hi[a] - r.o[a], r.ds[a]);
      na = nan_min(ta, tb);
      fa = nan_max(ta, tb);
    }
    tn = nan_max(tn, na);
    tf = nan_min(tf, fa);
  }
  const float exit_ = __fadd_rn(__fadd_rn(tf, __fmul_rn(fabsf(tf),
                                                        (float)1e-5)),
                                (float)1e-6);
  const float entry = __fsub_rn(__fmul_rn(tn, (float)(1.0 - 1e-5)),
                                (float)1e-6);
  return exit_ >= entry;
}

__global__ void __launch_bounds__(THREADS)
super_any_kernel(const float* __restrict__ slo, const float* __restrict__ shi,
                 const float* __restrict__ ox, const float* __restrict__ oy,
                 const float* __restrict__ oz, const float* __restrict__ dx,
                 const float* __restrict__ dy, const float* __restrict__ dz,
                 const uint8_t* __restrict__ act, int tile_r, int n_super,
                 uint8_t* __restrict__ out) {
  __shared__ float box[6][SB];  // lo xyz, hi xyz
  __shared__ int flag[SB];
  const int tile = blockIdx.x;
  const int s0 = blockIdx.y * SB;
  const int ns = min(SB, n_super - s0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < ns; i += THREADS) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      box[a][i] = slo[(size_t)(s0 + i) * 3 + a];
      box[3 + a][i] = shi[(size_t)(s0 + i) * 3 + a];
    }
    flag[i] = 0;
  }
  __syncthreads();
  volatile int* vflag = flag;
  const float* const po[3] = {ox, oy, oz};
  const float* const pd[3] = {dx, dy, dz};
  const size_t base = (size_t)tile * tile_r;
  // staggered starts: warps skip each other's finds
  const int start = warp * ns / WARPS;
  for (int g = 0; g < tile_r; g += GROUP) {
    Ray ray[RAYS];
    bool live[RAYS];
#pragma unroll
    for (int k = 0; k < RAYS; ++k) {
      const int i = g + k * THREADS + threadIdx.x;
      live[k] = i < tile_r && (act == nullptr || act[base + i] != 0);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float o = live[k] ? po[a][base + i] : 0.0f;
        const float d = live[k] ? pd[a][base + i] : 1.0f;
        ray[k].o[a] = o;
        ray[k].flat[a] = d == 0.0f;
        ray[k].ds[a] = d == 0.0f ? 1.0f : d;
      }
    }
    const bool any_live = __any_sync(FULL, live[0] | live[1] | live[2]
                                     | live[3]);
    if (!any_live) continue;  // warp-uniform
    for (int j = 0; j < ns; ++j) {
      int s = start + j;
      s = s >= ns ? s - ns : s;
      if (__any_sync(FULL, vflag[s] != 0)) continue;  // warp-uniform
      const float lo[3] = {box[0][s], box[1][s], box[2][s]};
      const float hi[3] = {box[3][s], box[4][s], box[5][s]};
      bool hit = false;
#pragma unroll
      for (int k = 0; k < RAYS; ++k)
        if (live[k] && !hit) hit = admits(ray[k], lo, hi);
      if (__any_sync(FULL, hit) && lane == 0) vflag[s] = 1;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ns; i += THREADS)
    out[(size_t)tile * n_super + s0 + i] = flag[i] != 0;
}

}  // namespace

// out (n_tiles, n_super) u8 (a bool tensor's bytes); act may be null
// (every ray live). n_rays = n_tiles * tile_r.
extern "C" int rt_super_any(const float* slo, const float* shi,
                            const float* ox, const float* oy, const float* oz,
                            const float* dx, const float* dy, const float* dz,
                            const uint8_t* act, int n_tiles, int tile_r,
                            int n_super, uint8_t* out, void* stream) {
  if (n_tiles > 0 && n_super > 0) {
    const dim3 grid(n_tiles, (n_super + SB - 1) / SB);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    super_any_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        slo, shi, ox, oy, oz, dx, dy, dz, act, tile_r, n_super, out);
  }
  return (int)cudaGetLastError();
}

// out[0..3] = registers a thread, spilled bytes a thread, shared memory a
// block and blocks an SM.
extern "C" int rt_super_any_resources(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, super_any_kernel);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, super_any_kernel,
                                                        THREADS, 0);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = ctas;
  return (int)err;
}
