// The streamed sweeps: closest hit (shared origin, K9; per-ray origin,
// K10) and shadow any-hit (K11) over a face record too large for the
// all-on-chip kernels' schedule, walked superblock word by superblock
// word.
//
// Replaces the TPU kernels rust_wgpu_raytracing_tpu/ops/megakernel.py
// _make_streaming_ch_slim_kernel (K9, from gbuffer_pallas's stream
// branch), _make_streaming_chp_slim_kernel (K10, gbuffer_perray_pallas)
// and _make_streaming_anyhit_kernel (K11, anyhit_pallas), with the same
// inputs: per batch of nsub 1024-ray subtiles the mask rows mask3 (NB,
// nsub+1, S) (row nsub: their union), the entry bounds tlb3 (NB, nsub+1,
// S) (+inf where a word is empty; row nsub: the batch minimum) and the
// visit order order2 (NB, S), ascending in the batch minimum; the ray
// planes, root-exit caps texit and, for K11, the activity plane act; the
// (F, 128) streaming record spack. The outputs too: the lexicographic
// (t, face) winner (face id = 1024 s + 32 b + lane, misses t = +inf,
// face 0) or occ in {0, 1}.
//
// Which floats: the face tests read the record's plane columns 0-11 and,
// for K10 and K11, its plane constants [d, c0, c1, c2] at column SC_DC =
// 40. The TPU kernel K9 reads the frame's origin terms from columns 48-51
// after the JAX glue splices them into the record; K9 here reads the same
// floats from the (F, 8) origin-term tensor of the frame (oterm), so the
// 268 MB record at 522k faces is never rewritten per frame. The tests are
// rt_common.cuh's shared_origin_t (_ch_block_tv), perray_hit_cols
// (_chp_block_tv) and anyhit_block (_ah_block), term for term, compiled
// with -fmad=false. Padding rows are all zero: N.d = 0 fails
// |N.d| >= 1e-6 and t = 0/0 = NaN fails every comparison.
//
// The walk: one CUDA block per subtile (K9, K11: 256 threads x 4 rays;
// K10: 512 threads, the rays in shared memory). The block
// reads its batch's order row and walks the words in that order. It
// skips a word whose own mask word is 0 or whose own entry bound exceeds
// its bound, and stops at the first word whose batch-minimum bound
// exceeds it: order2 ascends in that minimum and a subtile's own bound
// is at least the minimum, so every later word would be skipped too. The
// bound is the block-wide max over its rays of min(best t, root exit)
// (K9, K10) or of the root exit of the active, unoccluded rays, -1 for
// the rest (K11, which stops at bound < 0: every active ray occluded),
// refreshed after each visited word. A skipped word cannot change a
// result (its faces lie beyond every ray's current winner or exit), so
// the outputs equal the TPU kernel's, whose bounds refresh on the same
// words. K9 and K11 stage each set bit's 32-face block in shared memory
// and test it against the subtile's 1024 rays held in registers. K10
// takes each word's set bits through the per-ray culled walk of
// cull_walk.cuh: a block's faces are tested only for the rays whose line
// enters its box (blo, bhi) at or below their best t.
//
// What bounds it on the H100: face-visit compute (27 FP32 operations
// per (face, ray) test with a shared origin, 51 with per-ray origins),
// as for K1/K7, over the admitted blocks (K9, K11) or the entered ones
// (K10, plus a 29-operation box test per admitted block and ray); a
// visited block reads 2 KB of the record from L2 or memory. The TPU kernel double-buffers one superblock DMA for the 8
// subtiles of a batch; here neighbouring subtiles walk the same words at
// about the same time and share them through the 50 MB L2. TMA staging of
// whole superblocks and a persistent batch block are later work.
#include "cull_walk.cuh"

namespace {

using namespace rt;

constexpr int BITS = 32;            // face blocks per superblock word
constexpr int BLOCK_F_STREAM = 32;  // faces per face block

enum Mode { SHARED = 0, ANYHIT = 2 };

template <int MODE>
__global__ void __launch_bounds__(THREADS)
stream_sweep_kernel(const int* __restrict__ mask3, const int* __restrict__ order2,
                    const float* __restrict__ tlb3, const float* __restrict__ dx,
                    const float* __restrict__ dy, const float* __restrict__ dz,
                    const float* __restrict__ ox, const float* __restrict__ oy,
                    const float* __restrict__ oz, const float* __restrict__ act,
                    const float* __restrict__ texit,
                    const float* __restrict__ pack, int pack_cols,
                    const float* __restrict__ extra, int extra_cols, int nsub,
                    int n_super, float* __restrict__ t_out,
                    int* __restrict__ face_out, float* __restrict__ occ_out) {
  __shared__ float faces[BLOCK_F_STREAM * STAGE_COLS];
  __shared__ float red[THREADS / 32];

  const int batch = blockIdx.x / nsub;
  const int sub = blockIdx.x % nsub;
  const size_t row = ((size_t)batch * (nsub + 1) + sub) * n_super;
  const int* own_mask = mask3 + row;
  const float* own_tlb = tlb3 + row;
  const float* batch_tlb = tlb3 + ((size_t)batch * (nsub + 1) + nsub) * n_super;
  const int* ord = order2 + (size_t)batch * n_super;

  const size_t base = (size_t)blockIdx.x * TILE_R + threadIdx.x;
  float rdx[RPT], rdy[RPT], rdz[RPT], rox[RPT], roy[RPT], roz[RPT];
  float ract[RPT], cap[RPT], bt[RPT], occ[RPT];
  int bf[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const size_t r = base + (size_t)k * THREADS;
    rdx[k] = dx[r];
    rdy[k] = dy[r];
    rdz[k] = dz[r];
    rox[k] = MODE != SHARED ? ox[r] : 0.0f;
    roy[k] = MODE != SHARED ? oy[r] : 0.0f;
    roz[k] = MODE != SHARED ? oz[r] : 0.0f;
    ract[k] = MODE == ANYHIT ? act[r] : 0.0f;
    cap[k] = texit[r];
    bt[k] = INFINITY;
    bf[k] = 0;
    occ[k] = 0.0f;
  }

  auto bound = [&]() {
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      if constexpr (MODE == ANYHIT)
        m = fmaxf(m, ract[k] * (1.0f - occ[k]) > 0.0f ? cap[k] : -1.0f);
      else
        m = fmaxf(m, fminf(bt[k], cap[k]));
    }
    return block_max(m, red);
  };

  float b = bound();
  for (int j = 0; j < n_super; ++j) {
    if (MODE == ANYHIT && b < 0.0f) break;  // no live ray left
    const int s = ord[j];
    if (!(batch_tlb[s] <= b)) break;  // uniform: every thread reads the same
    unsigned word = (unsigned)own_mask[s];
    if (word == 0u || !(own_tlb[s] <= b)) continue;
    while (word) {
      const int bit = __ffs(word) - 1;
      word &= word - 1u;
      const int ci = s * BITS + bit;
      __syncthreads();  // the previous block's planes are consumed
      stage_faces(faces, pack, pack_cols, extra, ci, BLOCK_F_STREAM, extra_cols);
      __syncthreads();
      if constexpr (MODE == ANYHIT) {
        anyhit_block(faces, BLOCK_F_STREAM, rdx, rdy, rdz, rox, roy, roz, ract,
                     occ);
      } else {
        const int face_base = ci * BLOCK_F_STREAM;
        for (int f = 0; f < BLOCK_F_STREAM; ++f) {
          const float* g = faces + f * STAGE_COLS;
          const int fid = face_base + f;
#pragma unroll
          for (int k = 0; k < RPT; ++k) {
            const float tm = shared_origin_t(g, rdx[k], rdy[k], rdz[k]);
            if (tm < bt[k] || (tm == bt[k] && fid < bf[k])) {
              bt[k] = tm;
              bf[k] = fid;
            }
          }
        }
      }
    }
    b = bound();
  }

#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const size_t r = base + (size_t)k * THREADS;
    if constexpr (MODE == ANYHIT) {
      occ_out[r] = occ[k];
    } else {
      t_out[r] = bt[k];
      face_out[r] = bf[k];
    }
  }
}

// K10, the per-ray closest hit, walks the same words with the same skip,
// stop and bound refresh, but each word's set bits go through the
// per-ray culled walk of cull_walk.cuh (chunks of 8 blocks): a block's
// faces are tested only for the aimed rays whose line enters its box
// (blo, bhi) at or below their best t. Rays in shared memory; 512
// threads per subtile.
__global__ void __launch_bounds__(cull::CT, 2)
perray_culled_kernel(const int* __restrict__ mask3,
                     const int* __restrict__ order2,
                     const float* __restrict__ tlb3,
                     const float* __restrict__ dx, const float* __restrict__ dy,
                     const float* __restrict__ dz, const float* __restrict__ ox,
                     const float* __restrict__ oy, const float* __restrict__ oz,
                     const float* __restrict__ texit,
                     const float* __restrict__ pack, int pack_cols,
                     const float* __restrict__ extra,
                     const float* __restrict__ blo,
                     const float* __restrict__ bhi, int nsub, int n_super,
                     float* __restrict__ t_out, int* __restrict__ face_out) {
  using namespace rt::cull;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Walk& W = *reinterpret_cast<Walk*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int batch = blockIdx.x / nsub;
  const int sub = blockIdx.x % nsub;
  const size_t row = ((size_t)batch * (nsub + 1) + sub) * n_super;
  const int* own_mask = mask3 + row;
  const float* own_tlb = tlb3 + row;
  const float* batch_tlb = tlb3 + ((size_t)batch * (nsub + 1) + nsub) * n_super;
  const int* ord = order2 + (size_t)batch * n_super;

  const size_t base = (size_t)blockIdx.x * TILE_R;
  load_rays(W.ext, dx, dy, dz, ox, oy, oz, base);
  float cap[RPC];
#pragma unroll
  for (int k = 0; k < RPC; ++k) {
    W.best[tid + k * CT] = NO_HIT;
    cap[k] = texit[base + tid + k * CT];
  }
  // the block-wide max of min(best t, root exit) over the rays
  auto bound = [&]() {
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < RPC; ++k)
      m = fmaxf(m, fminf(__uint_as_float((unsigned)(
                             W.best[tid + k * CT] >> 32)), cap[k]));
    return walk_max(m, W.ch.red);
  };

  const int slots = slots_for(BLOCK_F_STREAM);
  float b = bound();
  for (int j = 0; j < n_super; ++j) {
    const int s = ord[j];
    if (!(batch_tlb[s] <= b)) break;  // uniform: every thread reads the same
    unsigned word = (unsigned)own_mask[s];
    if (word == 0u || !(own_tlb[s] <= b)) continue;
    while (word) {
      if (warp == 0) {
        unsigned rest = word;
        int n = 0;
        for (; rest && n < slots; ++n) {
          const int bit = __ffs((int)rest) - 1;
          rest &= rest - 1u;
          if (lane == n) load_slot(W.ch, n, s * BITS + bit, 1, blo, bhi);
        }
        if (lane == 0) W.ch.n = n;
      }
      for (int k = 0; k < slots && word; ++k) word &= word - 1u;
      __syncthreads();
      run_chunk<false>(W, nullptr, nullptr, pack, pack_cols, extra,
                       pack_cols, BLOCK_F_STREAM);
    }
    b = bound();
  }

  for (int i = tid; i < TILE_R; i += CT) {
    const unsigned long long k = W.best[i];
    t_out[base + i] = __uint_as_float((unsigned)(k >> 32));
    face_out[base + i] = (int)(unsigned)k;
  }
}

template <int MODE>
int launch(const int* mask3, const int* order2, const float* tlb3, const float* dx,
           const float* dy, const float* dz, const float* ox, const float* oy,
           const float* oz, const float* act, const float* texit, const float* pack,
           int pack_cols, const float* extra, int extra_cols, int n_sub_total,
           int nsub, int n_super, float* t, int* face, float* occ, void* stream) {
  if (nsub < 1 || n_sub_total % nsub) return (int)cudaErrorInvalidValue;
  if (n_sub_total > 0)
    stream_sweep_kernel<MODE><<<n_sub_total, THREADS, 0, (cudaStream_t)stream>>>(
        mask3, order2, tlb3, dx, dy, dz, ox, oy, oz, act, texit, pack, pack_cols,
        extra, extra_cols, nsub, n_super, t, face, occ);
  return (int)cudaGetLastError();
}

}  // namespace

// K9: extra = the frame's (F, 8) origin terms [t_num, hc0, hc1, hc2, ...]
extern "C" int rt_stream_closest_hit(const int* mask3, const int* order2,
                                     const float* tlb3, const float* dx,
                                     const float* dy, const float* dz,
                                     const float* texit, const float* spack,
                                     const float* oterm, int n_sub_total,
                                     int nsub, int n_super, int pack_cols,
                                     float* t, int* face, void* stream) {
  return launch<SHARED>(mask3, order2, tlb3, dx, dy, dz, nullptr, nullptr,
                        nullptr, nullptr, texit, spack, pack_cols, oterm, 8,
                        n_sub_total, nsub, n_super, t, face, nullptr, stream);
}

// K10: the plane constants at column sc_dc of the record, the 32-face
// blocks' boxes blo / bhi (F / 32, 3)
extern "C" int rt_stream_closest_hit_perray(
    const int* mask3, const int* order2, const float* tlb3, const float* dx,
    const float* dy, const float* dz, const float* ox, const float* oy,
    const float* oz, const float* texit, const float* spack, const float* blo,
    const float* bhi, int n_sub_total, int nsub, int n_super, int pack_cols,
    int sc_dc, float* t, int* face, void* stream) {
  if (nsub < 1 || n_sub_total % nsub) return (int)cudaErrorInvalidValue;
  const int bytes = (int)sizeof(rt::cull::Walk);
  cudaError_t err = cudaFuncSetAttribute(
      perray_culled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  if (n_sub_total > 0)
    perray_culled_kernel<<<n_sub_total, rt::cull::CT, bytes,
                           (cudaStream_t)stream>>>(
        mask3, order2, tlb3, dx, dy, dz, ox, oy, oz, texit, spack, pack_cols,
        spack + sc_dc, blo, bhi, nsub, n_super, t, face);
  return (int)cudaGetLastError();
}

extern "C" int rt_stream_closest_hit_perray_resources(int* out) {
  return rt::cull::resources(perray_culled_kernel,
                             (int)sizeof(rt::cull::Walk), out);
}

// K11
extern "C" int rt_stream_anyhit(const int* mask3, const int* order2,
                                const float* tlb3, const float* dx,
                                const float* dy, const float* dz,
                                const float* ox, const float* oy,
                                const float* oz, const float* act,
                                const float* texit, const float* spack,
                                int n_sub_total, int nsub, int n_super,
                                int pack_cols, int sc_dc, float* occ,
                                void* stream) {
  return launch<ANYHIT>(mask3, order2, tlb3, dx, dy, dz, ox, oy, oz, act, texit,
                        spack, pack_cols, spack + sc_dc, pack_cols, n_sub_total,
                        nsub, n_super, nullptr, nullptr, occ, stream);
}
