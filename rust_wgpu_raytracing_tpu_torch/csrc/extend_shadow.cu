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
// ray hits some face at t >= 1e-3, else 0.
//
// The block walks the union of the two masks; a block runs the
// closest-hit test only if its words_a bit is set and the shadow test
// only if its words_b bit is set (for rays that are active and not yet
// occluded). Both merges are order-independent (a lexicographic min and
// an OR), so blocks are visited in word and bit order, without the TPU
// kernel's per-word accumulators; like the TPU kernel, the walk has no
// early exit.
//
// What bounds it on the H100: face-visit compute, ~52 FP32 operations
// and a divide per visited (face, ray) pair for each wavefront whose bit
// is set. Each admitted block's 16 plane columns are staged once in
// shared memory and serve both tests; the ray state (12 planes, act,
// the winner and occ) stays in registers. The face tests are
// rt_common.cuh perray_hit, shared with K3 and K7; -fmad=false.
#include "rt_common.cuh"

namespace {

using namespace rt;

__global__ void __launch_bounds__(THREADS)
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
                     float* __restrict__ t_out, int* __restrict__ face_out,
                     float* __restrict__ occ_out) {
  __shared__ float faces[MAX_BLOCK_F * STAGE_COLS];

  const int tile = blockIdx.x;
  const size_t base = (size_t)tile * TILE_R + threadIdx.x;
  float rdx[RPT], rdy[RPT], rdz[RPT], rox[RPT], roy[RPT], roz[RPT];
  float sx[RPT], sy[RPT], sz[RPT], su[RPT], sv[RPT], sw[RPT];
  float ract[RPT], occ[RPT], bt[RPT];
  int bf[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const size_t r = base + (size_t)k * THREADS;
    rdx[k] = dx[r];
    rdy[k] = dy[r];
    rdz[k] = dz[r];
    rox[k] = ox[r];
    roy[k] = oy[r];
    roz[k] = oz[r];
    sx[k] = sdx[r];
    sy[k] = sdy[r];
    sz[k] = sdz[r];
    su[k] = sox[r];
    sv[k] = soy[r];
    sw[k] = soz[r];
    ract[k] = act[r];
    occ[k] = 0.0f;
    bt[k] = INFINITY;
    bf[k] = 0;
  }

  const int* wa = words_a + (size_t)tile * nwords;
  const int* wb = words_b + (size_t)tile * nwords;
  for (int w = 0; w < nwords; ++w) {
    const unsigned a = (unsigned)wa[w], s = (unsigned)wb[w];
    unsigned bits = a | s;  // uniform across the block
    while (bits) {
      const int bit = __ffs((int)bits) - 1;
      bits &= bits - 1u;
      const int ci = w * 32 + bit;
      if (ci >= nb) break;  // padding bits of the last word
      __syncthreads();      // the previous block's planes are consumed
      stage_faces(faces, fpack, fpack_cols, dc, ci, block_f);
      __syncthreads();
      if ((a >> bit) & 1u) {
        const int face_base = ci * block_f;
        for (int j = 0; j < block_f; ++j) {
          const float* g = faces + j * STAGE_COLS;
          const int fid = face_base + j;
#pragma unroll
          for (int k = 0; k < RPT; ++k) {
            float t;
            const bool valid =
                perray_hit(g, rdx[k], rdy[k], rdz[k], rox[k], roy[k], roz[k], t);
            const float tm = valid ? t : INFINITY;
            if (tm < bt[k] || (tm == bt[k] && fid < bf[k])) {
              bt[k] = tm;
              bf[k] = fid;
            }
          }
        }
      }
      if ((s >> bit) & 1u)
        anyhit_block(faces, block_f, sx, sy, sz, su, sv, sw, ract, occ);
    }
  }

#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const size_t r = base + (size_t)k * THREADS;
    t_out[r] = bt[k];
    face_out[r] = bf[k];
    occ_out[r] = occ[k];
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
                                const float* dc, int n_tiles, int nwords, int nb,
                                int block_f, int fpack_cols, float* t, int* face,
                                float* occ, void* stream) {
  if (block_f < 1 || block_f > rt::MAX_BLOCK_F) return (int)cudaErrorInvalidValue;
  if (nwords * 32 < nb) return (int)cudaErrorInvalidValue;
  if (n_tiles > 0)
    extend_shadow_kernel<<<n_tiles, rt::THREADS, 0, (cudaStream_t)stream>>>(
        words_a, words_b, nwords, nb, block_f, fpack_cols, dx, dy, dz, ox, oy,
        oz, sdx, sdy, sdz, sox, soy, soz, act, fpack, dc, t, face, occ);
  return (int)cudaGetLastError();
}
