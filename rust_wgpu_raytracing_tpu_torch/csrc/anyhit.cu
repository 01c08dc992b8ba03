// Shadow any-hit for per-ray origins (K3).
//
// Replaces the TPU kernel rust_wgpu_raytracing_tpu/ops/megakernel.py
// _make_anyhit_kernel + _ah_block (reached from anyhit_pallas, VMEM
// branch): the same inputs (schedule tlb/order, ray direction and origin
// planes, the activity plane `act`, root-exit caps, the (F, 40) face
// pack and the (F, 8) plane constants dc = [d, c0, c1, c2]) and the same
// output: occ (R,) f32 = act where an active ray hits some face at
// t >= 1e-3, else 0. It also takes the face blocks' boxes blo / bhi
// (nb, 3) (the union of the cluster AABBs a block holds).
//
// The walk: one block of CT = 512 threads per 1024-ray tile, the shadow
// rays in shared memory, each ray's state (off, live, occluded) from
// `act`, and the live rays in a list compacted after each chunk
// (cull_walk.cuh compact_live, as K11 keeps it). The tile's `order` row
// is taken in chunks of slots_for(block_f) blocks while their entry
// bound tlb is at most the bound b (fill_sched_chunk), each chunk through
// cull_walk.cuh run_chunk<SHADOW>: a block's faces are tested only for
// the live rays whose line enters its box, by (ray, block) pairs or, in a
// dense chunk (ray_major: shadow rays toward one light are coherent), by
// each thread for the live rays it holds in the list (ray_major_chunk).
// b is the largest root exit of
// a live ray, -1 when none is left (the walk then stops), refreshed after
// each chunk: the TPU kernel's rule, which refreshes every few visits. A
// block past every live ray's bound, or one a ray's line misses, cannot
// occlude it, and an OR does not depend on the order of visits, so occ
// is the TPU kernel's, bit for bit.
//
// What bounds it on the H100: the face tests (51 FP32 operations each,
// a divide counted as one) of the (ray, block) pairs whose line enters
// the block's box, and the box tests (29 operations) of the admitted
// pairs of live rays. The TPU kernel tests every active lane of the tile
// against every admitted block; a shadow tile of a frame admits tens of
// blocks but a ray enters a few of their boxes, and a ray leaves the
// walk once occluded. The face test is rt_common.cuh perray_hit_cols,
// _ah_block term for term (-fmad=false).
#include "cull_walk.cuh"

namespace {

using namespace rt;
using namespace rt::cull;

// shared memory: the shadow rays, their caps and states, the live list
struct Smem {
  Rays sh;
  float cap[TILE_R];
  unsigned short live[TILE_R];
  unsigned char state[TILE_R];
  float faces[STAGE_FLOATS];
  unsigned short list[CAP];
  Chunk ch;
  int n_live;
};

__global__ void __launch_bounds__(CT, 2)
anyhit_kernel(const float* __restrict__ tlb, const int* __restrict__ order,
              const float* __restrict__ dx, const float* __restrict__ dy,
              const float* __restrict__ dz, const float* __restrict__ ox,
              const float* __restrict__ oy, const float* __restrict__ oz,
              const float* __restrict__ act, const float* __restrict__ texit,
              const float* __restrict__ fpack, const float* __restrict__ dc,
              const float* __restrict__ blo, const float* __restrict__ bhi,
              int nb, int block_f, int fpack_cols, int ray_major,
              float* __restrict__ occ_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& A = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * TILE_R;
  load_rays(A.sh, dx, dy, dz, ox, oy, oz, base);
  for (int i = tid; i < TILE_R; i += CT) {
    A.cap[i] = texit[base + i];
    A.state[i] = act[base + i] > 0.0f ? S_LIVE : S_OFF;
  }
  const Tile<NoExt> T{A.ch, A.faces, A.list,  nullptr,   {},
                      &A.sh, A.state, A.live, &A.n_live};
  const float* tl = tlb + (size_t)blockIdx.x * nb;
  const int* ord = order + (size_t)blockIdx.x * nb;
  const int slots = slots_for(block_f);
  float b = compact_live(A, true);
  // b is uniform: every thread holds the same
  for (int p = 0; b >= 0.0f; p += slots) {
    const int n = fill_sched_chunk(A.ch, tl, ord, nb, p, b, SHADOW, slots,
                                   blo, bhi);
    if (n == 0) break;
    run_chunk<SHADOW, NoExt, true>(T, fpack, fpack_cols, dc, 8, block_f,
                                   ray_major);
    if (n < slots) break;
    b = compact_live(A, false);
  }
  for (int i = tid; i < TILE_R; i += CT)
    occ_out[base + i] = A.state[i] == S_OCC ? act[base + i] : 0.0f;
}

}  // namespace

extern "C" int rt_anyhit(const float* tlb, const int* order, const float* dx,
                         const float* dy, const float* dz, const float* ox,
                         const float* oy, const float* oz, const float* act,
                         const float* texit, const float* fpack, const float* dc,
                         const float* blo, const float* bhi, int n_tiles,
                         int nb, int block_f, int fpack_cols, int ray_major,
                         float* occ, void* stream) {
  if (block_f < 1 || block_f > rt::MAX_BLOCK_F) return (int)cudaErrorInvalidValue;
  const int bytes = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      anyhit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0)
    anyhit_kernel<<<n_tiles, rt::cull::CT, bytes, (cudaStream_t)stream>>>(
        tlb, order, dx, dy, dz, ox, oy, oz, act, texit, fpack, dc, blo, bhi,
        nb, block_f, fpack_cols, ray_major, occ);
  return (int)cudaGetLastError();
}

extern "C" int rt_anyhit_resources(int* out) {
  return rt::cull::resources(anyhit_kernel, (int)sizeof(Smem), out);
}
