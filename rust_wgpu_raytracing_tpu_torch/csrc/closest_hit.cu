// Closest hit for shared-origin rays, with the scene's spheres fused (K1).
//
// Replaces the TPU kernel rust_wgpu_raytracing_tpu/ops/megakernel.py
// _make_closest_hit_kernel (reached from gbuffer_pallas, VMEM branch):
// the same inputs (schedule tlb/order, ray planes, root-exit caps, the
// (F, 40) face pack, the (F, 8) per-frame origin terms, the sphere
// block: the camera origin, then (center, radius) per sphere) and the
// same outputs: the lexicographic (t, face) winner and the winning
// sphere's (t, id, unit normal), picked by strict nonlinear depth. It
// also takes the face blocks' boxes blo / bhi (nb, 3).
//
// The walk: one block of CT = 512 threads per 1024-ray tile, the ray
// directions in shared memory beside the camera origin (three scalars),
// each ray's winner one 64-bit key (SharedExt::pack) merged by a
// shared-memory atomicMin. The tile's `order` row is taken in chunks of
// slots_for(block_f) blocks while their entry bound tlb is at most the
// bound b (cull_walk.cuh fill_sched_chunk), each chunk through
// run_chunk<EXT> with the shared-origin ray policy SharedExt (K9's): a
// block's faces are tested only for the aimed rays whose line from the
// camera enters its box at or below their best t, by (ray, block) pairs
// or, in a dense chunk (ray_major: primary rays are coherent), by each
// thread for its own rays (cull_walk.cuh ray_major_chunk). b is the
// block-wide max of min(best t, root exit), refreshed after each chunk
// (the TPU kernel refreshes it every few visits). A block past every ray's bound,
// one a ray's line misses, or one entered beyond its best t cannot
// change its winner, and the lexicographic merge does not depend on the
// order of visits, so the winner is the TPU kernel's. A zero t (a camera
// on a face's plane) keeps its sign, the winning face's own (SharedExt
// packs it beside the face id).
//
// The sphere tail runs after the walk on the directions in shared
// memory, term for term as the TPU kernel's.
//
// What bounds it on the H100: the face tests (27 FP32 operations each, a
// divide counted as one) of the (ray, block) pairs whose line enters the
// block's box at or below the ray's best t, and the box tests (29
// operations) of the admitted pairs of aimed rays. The TPU kernel tests
// every lane of the tile against every admitted block. The face test is
// rt_common.cuh shared_origin_t_cols, _ch_block_tv term for term
// (-fmad=false).
#include "cull_walk.cuh"

namespace {

using namespace rt;
using namespace rt::cull;

// shared memory: the keys, the directions
struct Smem {
  unsigned long long best[TILE_R];
  Dirs dirs;
  float faces[STAGE_FLOATS];
  unsigned short list[CAP];
  Chunk ch;
};

__global__ void __launch_bounds__(CT, 2)
closest_hit_kernel(const float* __restrict__ tlb, const int* __restrict__ order,
                   const float* __restrict__ dx, const float* __restrict__ dy,
                   const float* __restrict__ dz, const float* __restrict__ texit,
                   const float* __restrict__ fpack, const float* __restrict__ oterm,
                   const float* __restrict__ sph, const float* __restrict__ blo,
                   const float* __restrict__ bhi, int nb, int block_f,
                   int fpack_cols, int n_spheres, float inv_near,
                   float rcp_span, int ray_major, float* __restrict__ t_out,
                   int* __restrict__ face_out, float* __restrict__ st_out,
                   float* __restrict__ sid_out, float* __restrict__ snx_out,
                   float* __restrict__ sny_out, float* __restrict__ snz_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& W = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * TILE_R;
  float cap[RPC];
#pragma unroll
  for (int k = 0; k < RPC; ++k) {
    const int i = tid + k * CT;
    W.dirs.d[0][i] = dx[base + i];
    W.dirs.d[1][i] = dy[base + i];
    W.dirs.d[2][i] = dz[base + i];
    W.best[i] = NO_HIT;
    cap[k] = texit[base + i];
  }
  const float ox = sph[0], oy = sph[1], oz = sph[2];
  const Tile<SharedExt> T{W.ch,    W.faces, W.list,  W.best,
                          {W.dirs, {ox, oy, oz}},
                          nullptr, nullptr, nullptr, nullptr};
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
    run_chunk<EXT, SharedExt, true>(T, fpack, fpack_cols, oterm, 8, block_f,
                                    ray_major);
    if (n < slots) break;
    b = bound();
  }

#pragma unroll
  for (int k = 0; k < RPC; ++k) {
    const int i = tid + k * CT;
    t_out[base + i] = shared_key_t(W.best[i]);
    face_out[base + i] = shared_key_face(W.best[i]);
  }
  if (n_spheres == 0) return;

  // sphere tail: the winner by strict nonlinear depth, in config order
#pragma unroll
  for (int k = 0; k < RPC; ++k) {
    const int ray = tid + k * CT;
    const float x = W.dirs.d[0][ray], y = W.dirs.d[1][ray];
    const float z = W.dirs.d[2][ray];
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
    const size_t r = base + ray;
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
                              const float* blo, const float* bhi, int n_tiles,
                              int nb, int block_f, int fpack_cols, int n_spheres,
                              float inv_near, float rcp_span, int ray_major,
                              float* t, int* face, float* st, float* sid,
                              float* snx, float* sny, float* snz, void* stream) {
  if (block_f < 1 || block_f > rt::MAX_BLOCK_F) return (int)cudaErrorInvalidValue;
  const int bytes = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      closest_hit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0)
    closest_hit_kernel<<<n_tiles, rt::cull::CT, bytes, (cudaStream_t)stream>>>(
        tlb, order, dx, dy, dz, texit, fpack, oterm, sph, blo, bhi, nb, block_f,
        fpack_cols, n_spheres, inv_near, rcp_span, ray_major, t, face, st, sid,
        snx, sny, snz);
  return (int)cudaGetLastError();
}

extern "C" int rt_closest_hit_resources(int* out) {
  return rt::cull::resources(closest_hit_kernel, (int)sizeof(Smem), out);
}
