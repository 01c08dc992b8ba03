// Fused extend + shadow sweep of the path tracer: one walk over the face
// pack serves two independent ray wavefronts, the closest hit of the
// next bounce's extension rays and the any-hit of this bounce's shadow
// rays.
//
// Replaces the TPU kernel rust_wgpu_raytracing_tpu/ops/megakernel.py
// _make_fused_extend_shadow_kernel (reached from extend_shadow_pallas,
// VMEM branch): the same inputs (the extension wavefront's act-aware
// mask words words_a, the shadow wavefront's words_b, the extension
// direction and origin planes, the shadow direction and origin planes,
// the activity plane act, the (F, 40) face pack and the (F, 8) plane
// constants dc = [d, c0, c1, c2]) and the same outputs: the extension
// rays' lexicographic (t, face) winner at t >= 1e-3 (t = +inf, face = 0
// where nothing is hit) and occ (R,) f32 = act where an active shadow
// ray hits some face at t >= 1e-3, else 0. It also takes the face
// blocks' boxes blo / bhi (nb, 3) (the scene's cluster AABBs).
//
// The walk: the union of the two masks in word and bit order, in chunks
// of slots_for(block_f) blocks (8 of 32 faces), each chunk through
// cull_walk.cuh run_chunk: a block's faces are tested only for the
// extension rays whose line enters its box at or below their best t and
// whose words_a bit is set, and for the live shadow rays (active, not yet
// occluded) whose line enters it and whose words_b bit is set. The TPU
// kernel tests every lane of every admitted block, with no early exit;
// the results are the same bits (cull_walk.cuh says why).
//
// What bounds it on the H100: the face tests of the (ray, block) pairs
// that enter (51 FP32 operations each, a divide counted as one) and the
// box tests (29 operations) of the admitted ones; a bounce-1 tile of
// hemisphere samples admits hundreds of blocks, but a ray enters only a
// few boxes. Both wavefronts' rays live in shared memory (86 KB a block,
// two blocks an SM), so the registers hold no ray planes. The face tests
// are rt_common.cuh perray_hit_cols, _chp_block_tv and _ah_block term
// for term (-fmad=false).
#include "cull_walk.cuh"

namespace {

using namespace rt;
using namespace rt::cull;

struct Smem {
  Walk w;
  Rays sh;                       // the shadow rays
  unsigned char state[TILE_R];   // S_OFF, S_LIVE, S_OCC
};

__global__ void __launch_bounds__(CT, 2)
extend_shadow_kernel(const int* __restrict__ words_a,
                     const int* __restrict__ words_b, int nwords, int nb,
                     int block_f, int fpack_cols, const float* __restrict__ dx,
                     const float* __restrict__ dy, const float* __restrict__ dz,
                     const float* __restrict__ ox, const float* __restrict__ oy,
                     const float* __restrict__ oz, const float* __restrict__ sdx,
                     const float* __restrict__ sdy, const float* __restrict__ sdz,
                     const float* __restrict__ sox, const float* __restrict__ soy,
                     const float* __restrict__ soz, const float* __restrict__ act,
                     const float* __restrict__ fpack, const float* __restrict__ dc,
                     const float* __restrict__ blo, const float* __restrict__ bhi,
                     float* __restrict__ t_out, int* __restrict__ face_out,
                     float* __restrict__ occ_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)blockIdx.x * TILE_R;

  load_rays(S.w.ext, dx, dy, dz, ox, oy, oz, base);
  load_rays(S.sh, sdx, sdy, sdz, sox, soy, soz, base);
  for (int i = tid; i < TILE_R; i += CT) {
    S.w.best[i] = NO_HIT;
    S.state[i] = act[base + i] > 0.0f ? S_LIVE : S_OFF;
  }

  const Tile<PerRayExt> T{S.w.ch,  S.w.faces, S.w.list, S.w.best,
                          {S.w.ext}, &S.sh,     S.state,  nullptr, nullptr};
  const int* wa = words_a + (size_t)blockIdx.x * nwords;
  const int* wb = words_b + (size_t)blockIdx.x * nwords;
  const int slots = slots_for(block_f);
  // warp 0's place in the union walk: word w, its bits not yet taken
  int w = -1;
  unsigned rem = 0, ca = 0, cb = 0;
  for (;;) {
    if (warp == 0) {
      int n = 0, my_blk = 0, my_flag = 0;
      while (n < slots) {
        if (rem == 0) {
          if (++w >= nwords) break;
          ca = (unsigned)wa[w];
          cb = (unsigned)wb[w];
          rem = ca | cb;
          continue;
        }
        const int bit = __ffs((int)rem) - 1;
        rem &= rem - 1u;
        const int ci = w * 32 + bit;
        if (ci >= nb) {  // padding bits of the last word
          rem = 0;
          continue;
        }
        if (lane == n) {
          my_blk = ci;
          my_flag = ((ca >> bit) & 1u) | (((cb >> bit) & 1u) << 1);
        }
        ++n;
      }
      if (lane < n) load_slot(S.w.ch, lane, my_blk, my_flag, blo, bhi);
      if (lane == 0) S.w.ch.n = n;
    }
    __syncthreads();
    if (S.w.ch.n == 0) break;  // uniform
    run_chunk<EXT | SHADOW>(T, fpack, fpack_cols, dc, 8, block_f);
  }

  for (int i = tid; i < TILE_R; i += CT) {
    const unsigned long long k = S.w.best[i];
    t_out[base + i] = __uint_as_float((unsigned)(k >> 32));
    face_out[base + i] = (int)(unsigned)k;
    occ_out[base + i] = S.state[i] == S_OCC ? act[base + i] : 0.0f;
  }
}

}  // namespace

extern "C" int rt_extend_shadow(const int* words_a, const int* words_b,
                                const float* dx, const float* dy, const float* dz,
                                const float* ox, const float* oy, const float* oz,
                                const float* sdx, const float* sdy,
                                const float* sdz, const float* sox,
                                const float* soy, const float* soz,
                                const float* act, const float* fpack,
                                const float* dc, const float* blo,
                                const float* bhi, int n_tiles, int nwords, int nb,
                                int block_f, int fpack_cols, float* t, int* face,
                                float* occ, void* stream) {
  if (block_f < 1 || block_f > rt::MAX_BLOCK_F) return (int)cudaErrorInvalidValue;
  if (nwords * 32 < nb) return (int)cudaErrorInvalidValue;
  const int bytes = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      extend_shadow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0)
    extend_shadow_kernel<<<n_tiles, CT, bytes, (cudaStream_t)stream>>>(
        words_a, words_b, nwords, nb, block_f, fpack_cols, dx, dy, dz, ox, oy,
        oz, sdx, sdy, sdz, sox, soy, soz, act, fpack, dc, blo, bhi, t, face,
        occ);
  return (int)cudaGetLastError();
}

extern "C" int rt_extend_shadow_resources(int* out) {
  return rt::cull::resources(extend_shadow_kernel, (int)sizeof(Smem), out);
}
