// Closest hit for rays with per-ray origins (the path tracer's bounce
// rays), K7.
//
// Replaces the TPU kernel rust_wgpu_raytracing_tpu/ops/megakernel.py
// _make_closest_hit_perray_kernel + _chp_block_slim (reached from
// gbuffer_perray_pallas, VMEM branch): the same inputs (schedule
// tlb/order, direction and origin planes, root-exit caps, the (F, 40)
// face pack and the (F, 8) plane constants dc = [d, c0, c1, c2]) and the
// same outputs: the lexicographic (t, face) winner over the admitted
// faces at t >= 1e-3 (misses keep t = +inf, face = 0; rays with a zero
// direction never hit, their root-exit cap is -1). It also takes the
// face blocks' boxes blo / bhi (nb, 3).
//
// The walk: K1's (closest_hit.cu) with K8's ray policy. One block of
// CT = 512 threads per 1024-ray tile, the rays (origins and directions)
// in shared memory, each ray's winner one 64-bit key (t's bits << 32 |
// face; every hit has t >= 1e-3, PerRayExt) merged by a shared-memory
// atomicMin. The tile's `order` row is taken in chunks of
// slots_for(block_f) blocks while their entry bound tlb is at most the
// bound b (cull_walk.cuh fill_sched_chunk), each chunk through
// run_chunk<EXT> with the per-ray-origin policy PerRayExt, by (ray,
// block) pairs: a block's faces are tested only for the aimed rays whose
// own line enters its box at or below their best t. Bounce rays are
// hemisphere samples with no coherence, so a warp's rays rarely enter
// the same blocks, and the walk takes no ray-major chunk (K1's HYBRID).
// b is the block-wide max of min(best t, root exit), refreshed after
// each chunk. A block past every ray's bound, one a ray's line misses,
// or one entered beyond its best t cannot change its winner, and the
// lexicographic merge does not depend on the order of visits, so the
// winner is the TPU kernel's.
//
// What bounds it on the H100: the face tests (51 FP32 operations each,
// a divide counted as one) of the (ray, block) pairs whose line enters
// the block's box at or below the ray's best t, and the box tests (29
// operations) of the admitted pairs of aimed rays. The TPU kernel tests
// every lane of the tile against every admitted block; a bounce tile
// admits hundreds of blocks, a ray enters a few. The face test is
// rt_common.cuh perray_hit_cols, _chp_block_tv term for term
// (-fmad=false).
#include "cull_walk.cuh"

namespace {

using namespace rt;
using namespace rt::cull;

__global__ void __launch_bounds__(CT, 2)
closest_hit_perray_kernel(const float* __restrict__ tlb,
                          const int* __restrict__ order,
                          const float* __restrict__ dx, const float* __restrict__ dy,
                          const float* __restrict__ dz, const float* __restrict__ ox,
                          const float* __restrict__ oy, const float* __restrict__ oz,
                          const float* __restrict__ texit,
                          const float* __restrict__ fpack, const float* __restrict__ dc,
                          const float* __restrict__ blo,
                          const float* __restrict__ bhi, int nb, int block_f,
                          int fpack_cols, float* __restrict__ t_out,
                          int* __restrict__ face_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Walk& W = *reinterpret_cast<Walk*>(smem_raw);
  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * TILE_R;
  load_rays(W.ext, dx, dy, dz, ox, oy, oz, base);
  float cap[RPC];
#pragma unroll
  for (int k = 0; k < RPC; ++k) {
    const int i = tid + k * CT;
    W.best[i] = NO_HIT;
    cap[k] = texit[base + i];
  }
  const Tile<PerRayExt> T{W.ch,     W.faces, W.list,  W.best, {W.ext},
                          nullptr,  nullptr, nullptr, nullptr};
  // the block-wide max of min(best t, root exit) over the rays
  auto bound = [&]() {
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < RPC; ++k)
      m = fmaxf(m, fminf(__uint_as_float((unsigned)(
                             W.best[tid + k * CT] >> 32)), cap[k]));
    return walk_max(m, W.ch.red);
  };
  const float* tl = tlb + (size_t)blockIdx.x * nb;
  const int* ord = order + (size_t)blockIdx.x * nb;
  const int slots = slots_for(block_f);
  float b = bound();
  for (int p = 0;; p += slots) {
    const int n = fill_sched_chunk(W.ch, tl, ord, nb, p, b, EXT, slots, blo,
                                   bhi);
    if (n == 0) break;
    run_chunk<EXT>(T, fpack, fpack_cols, dc, 8, block_f);
    if (n < slots) break;
    b = bound();
  }

#pragma unroll
  for (int k = 0; k < RPC; ++k) {
    const int i = tid + k * CT;
    const unsigned long long key = W.best[i];
    t_out[base + i] = __uint_as_float((unsigned)(key >> 32));
    face_out[base + i] = (int)(unsigned)key;
  }
}

}  // namespace

extern "C" int rt_closest_hit_perray(const float* tlb, const int* order,
                                     const float* dx, const float* dy,
                                     const float* dz, const float* ox,
                                     const float* oy, const float* oz,
                                     const float* texit, const float* fpack,
                                     const float* dc, const float* blo,
                                     const float* bhi, int n_tiles, int nb,
                                     int block_f, int fpack_cols, float* t,
                                     int* face, void* stream) {
  if (block_f < 1 || block_f > rt::MAX_BLOCK_F) return (int)cudaErrorInvalidValue;
  const int bytes = (int)sizeof(rt::cull::Walk);
  cudaError_t err = cudaFuncSetAttribute(
      closest_hit_perray_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0)
    closest_hit_perray_kernel<<<n_tiles, rt::cull::CT, bytes,
                                (cudaStream_t)stream>>>(
        tlb, order, dx, dy, dz, ox, oy, oz, texit, fpack, dc, blo, bhi, nb,
        block_f, fpack_cols, t, face);
  return (int)cudaGetLastError();
}

extern "C" int rt_closest_hit_perray_resources(int* out) {
  return rt::cull::resources(closest_hit_perray_kernel,
                             (int)sizeof(rt::cull::Walk), out);
}
