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
// face 0) or occ = act where an active ray is occluded, else 0. They
// also take the 32-face blocks' boxes blo / bhi (F / 32, 3), and K9 the
// camera origin.
//
// Which floats: the face tests read the record's plane columns 0-11 and,
// for K10 and K11, its plane constants [d, c0, c1, c2] at column SC_DC =
// 40. The TPU kernel K9 reads the frame's origin terms from columns 48-51
// after the JAX glue splices them into the record; K9 here reads the same
// floats from the (F, 8) origin-term tensor of the frame (oterm), so the
// 268 MB record at 522k faces is never rewritten per frame. The tests are
// rt_common.cuh's shared_origin_t_cols (_ch_block_tv) and perray_hit_cols
// (_chp_block_tv, _ah_block), term for term, compiled with -fmad=false.
// Padding rows are all zero: N.d = 0 fails |N.d| >= 1e-6 and t = 0/0 =
// NaN fails every comparison. K9's zero t (a camera on a face's plane)
// keeps the winning face's own sign (cull_walk.cuh SharedExt::pack).
//
// The walk: a subtile's rays in shared memory, 512 threads (CT). The
// block reads its batch's order row and walks the words in that order.
// It skips a word whose own mask word is 0 or whose own entry bound
// exceeds its bound, and stops at the first word whose batch-minimum
// bound exceeds it: order2 ascends in that minimum and a subtile's own
// bound is at least the minimum, so every later word would be skipped
// too. The bound is the block-wide max over its rays of min(best t, root
// exit) (K9, K10) or of the root exit of the active, unoccluded rays, -1
// for the rest (K11, which stops at bound < 0: every active ray
// occluded), refreshed after each visited word. A skipped word cannot
// change a result (its faces lie beyond every ray's current winner or
// exit), so the outputs equal the TPU kernel's, whose bounds refresh on
// the same words. Each word's set bits go through the per-ray culled walk
// of cull_walk.cuh, chunks of 8 blocks: a block's faces are tested only
// for the rays whose line enters its box, a closest-hit ray only where
// that entry lies at or below its best t (K9's rays from the camera: the
// origin three scalars, the directions in shared memory); K11 keeps its
// live rays (active, not yet occluded) in a list compacted after each
// word, so its box tests loop over live rays only.
//
// Long walks (K9, K11): a subtile's walk is uneven (one batch of the
// 1080p 522k-face frame admits 16,442 blocks against a mean of ~77 a
// subtile), and the longest walk would set the launch's time. So the
// walk is cut into work items: a subtile and a segment of its visit
// order holding at most `seg` admitted blocks (words whose exclusive
// prefix of admitted blocks, pre, falls in [q seg, (q+1) seg)). The
// wrapper builds pre and the items' offsets on the device
// (stream_sweep.walk_items); a grid of as many blocks as fit the card
// takes the items through an atomic counter. Each item starts from the
// outputs as they stand (K9's 64-bit keys, K11's occ plane) and merges
// into them: K9 by atomicMin of the keys (unpacked by the wrapper), K11
// by writing act where it occludes. A segment's skip and stop are exact
// under its own bound, which is at least the whole walk's at that word.
// K10 walks each subtile whole in one block.
//
// What bounds it on the H100: the face tests of the (ray, block) pairs
// that enter (27 FP32 operations each with a shared origin, 51 with
// per-ray origins) and the 29-operation box tests of the admitted pairs
// of live rays; a staged block reads 2 KB of the record from L2 or
// memory. The TPU kernel double-buffers one superblock DMA for the 8
// subtiles of a batch; here neighbouring subtiles walk the same words at
// about the same time and share them through the 50 MB L2.
#include "cull_walk.cuh"

namespace {

using namespace rt;
using namespace rt::cull;

constexpr int BLOCK_F_STREAM = 32;  // faces per face block

// A streamed walk's schedule, record and boxes.
struct Sched {
  const int* mask3;
  const int* order2;
  const float* tlb3;
  int nsub, n_super;
  const float* pack;
  int pack_cols;
  const float* extra;
  int extra_cols;
  const float* blo;
  const float* bhi;
};

// The work items of a split walk: item_off (n_sub + 1) the first item of
// each subtile (item_off[n_sub]: their count), pre (n_sub, S) the
// exclusive prefix of admitted blocks along each subtile's visit order,
// seg the blocks per segment, counter the items handed out.
struct Items {
  const int* off;
  const int* pre;
  int seg;
  int* counter;
};

// first j in [0, n) with row[j] >= x (row ascending), else n
__device__ __forceinline__ int first_at_least(const int* row, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] >= x)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// The next work item of this block: subtile `sub`, visit-order words
// [j0, j1). False when none is left. `slot` is 3 ints of shared memory.
__device__ bool next_item(const Items& I, int* slot, int n_sub, int n_super,
                          int& sub, int& j0, int& j1) {
  __syncthreads();  // the previous item is done with the shared state
  if (threadIdx.x == 0) {
    const int k = atomicAdd(I.counter, 1);
    int s = -1, a = 0, b = 0;
    if (k < I.off[n_sub]) {
      int lo = 0, hi = n_sub;  // I.off[lo] <= k < I.off[hi]
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (I.off[mid] <= k)
          lo = mid;
        else
          hi = mid;
      }
      s = lo;
      const int q = k - I.off[s];
      const int* row = I.pre + (size_t)s * n_super;
      a = first_at_least(row, n_super, q * I.seg);
      b = first_at_least(row, n_super, (q + 1) * I.seg);
    }
    slot[0] = s;
    slot[1] = a;
    slot[2] = b;
  }
  __syncthreads();
  sub = slot[0];
  j0 = slot[1];
  j1 = slot[2];
  return sub >= 0;
}

// The walk of one item: subtile `sub`'s words [j0, j1) of its batch's
// visit order, from bound b; the rules of the header, each admitted
// word's set bits through run_chunk<HALVES>, bound() after each word.
// A shadow-only walk also stops at b < 0.
template <int HALVES, class Ext, class Bound>
__device__ void walk_item(const Tile<Ext>& T, const Sched& S, int sub,
                          int j0, int j1, float b, Bound bound) {
  const int batch = sub / S.nsub;
  const size_t row =
      ((size_t)batch * (S.nsub + 1) + sub % S.nsub) * S.n_super;
  const int* own_mask = S.mask3 + row;
  const float* own_tlb = S.tlb3 + row;
  const float* batch_tlb =
      S.tlb3 + ((size_t)batch * (S.nsub + 1) + S.nsub) * S.n_super;
  const int* ord = S.order2 + (size_t)batch * S.n_super;
  const int slots = slots_for(BLOCK_F_STREAM);
  for (int j = j0; j < j1; ++j) {
    if (HALVES == SHADOW && b < 0.0f) break;  // no live ray left
    const int s = ord[j];
    if (!(batch_tlb[s] <= b)) break;  // uniform: every thread reads the same
    unsigned word = (unsigned)own_mask[s];
    if (word == 0u || !(own_tlb[s] <= b)) continue;
    while (word) {
      word = fill_chunk(T.ch, word, s, HALVES, slots, S.blo, S.bhi);
      run_chunk<HALVES>(T, S.pack, S.pack_cols, S.extra, S.extra_cols,
                        BLOCK_F_STREAM);
    }
    b = bound();
  }
}

// K10, the per-ray closest hit: one block walks each subtile whole,
// with the closest-hit half of the culled walk over every aimed ray.
__global__ void __launch_bounds__(CT, 2)
perray_culled_kernel(Sched S, const float* __restrict__ dx,
                     const float* __restrict__ dy,
                     const float* __restrict__ dz,
                     const float* __restrict__ ox,
                     const float* __restrict__ oy,
                     const float* __restrict__ oz,
                     const float* __restrict__ texit,
                     float* __restrict__ t_out, int* __restrict__ face_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Walk& W = *reinterpret_cast<Walk*>(smem_raw);
  const int tid = threadIdx.x;
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
  const Tile<PerRayExt> T{W.ch,   W.faces, W.list,  W.best, {W.ext},
                          nullptr, nullptr, nullptr, nullptr};
  walk_item<EXT>(T, S, blockIdx.x, 0, S.n_super, bound(), bound);
  for (int i = tid; i < TILE_R; i += CT) {
    const unsigned long long k = W.best[i];
    t_out[base + i] = __uint_as_float((unsigned)(k >> 32));
    face_out[base + i] = (int)(unsigned)k;
  }
}

// K11's shared memory: the shadow rays, their caps and states, the live
// list
struct AnyhitSmem {
  Rays sh;
  float cap[TILE_R];
  unsigned short live[TILE_R];
  unsigned char state[TILE_R];
  float faces[STAGE_FLOATS];
  unsigned short list[CAP];
  Chunk ch;
  int n_live;
  int slot[3];
};

// K11: the shadow half of the culled walk, over live rays only.
__global__ void __launch_bounds__(CT, 2)
anyhit_culled_kernel(Sched S, const float* __restrict__ dx,
                     const float* __restrict__ dy,
                     const float* __restrict__ dz,
                     const float* __restrict__ ox,
                     const float* __restrict__ oy,
                     const float* __restrict__ oz,
                     const float* __restrict__ act,
                     const float* __restrict__ texit, Items I, int n_sub,
                     float* occ_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  AnyhitSmem& A = *reinterpret_cast<AnyhitSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const Tile<NoExt> T{A.ch, A.faces, A.list,  nullptr,   {},
                      &A.sh, A.state, A.live, &A.n_live};
  int sub, j0, j1;
  while (next_item(I, A.slot, n_sub, S.n_super, sub, j0, j1)) {
    const size_t base = (size_t)sub * TILE_R;
    load_rays(A.sh, dx, dy, dz, ox, oy, oz, base);
    for (int i = tid; i < TILE_R; i += CT) {
      A.cap[i] = texit[base + i];
      // a ray another item has occluded is done
      A.state[i] = act[base + i] > 0.0f && __ldcg(occ_out + base + i) == 0.0f
                       ? S_LIVE
                       : S_OFF;
    }
    const float b = compact_live(A, true);
    walk_item<SHADOW>(T, S, sub, j0, j1, b,
                      [&]() { return compact_live(A, false); });
    for (int i = tid; i < TILE_R; i += CT)
      if (A.state[i] == S_OCC) occ_out[base + i] = act[base + i];
  }
}

// K9's shared memory: the keys, the directions
struct SharedSmem {
  unsigned long long best[TILE_R];
  Dirs dirs;
  float faces[STAGE_FLOATS];
  unsigned short list[CAP];
  Chunk ch;
  int slot[3];
};

// K9: the closest-hit half of the culled walk, rays from one origin.
__global__ void __launch_bounds__(CT, 2)
shared_culled_kernel(Sched S, const float* __restrict__ dx,
                     const float* __restrict__ dy,
                     const float* __restrict__ dz,
                     const float* __restrict__ texit,
                     const float* __restrict__ origin, Items I, int n_sub,
                     unsigned long long* key_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SharedSmem& W = *reinterpret_cast<SharedSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const Tile<SharedExt> T{W.ch,
                          W.faces,
                          W.list,
                          W.best,
                          {W.dirs, {origin[0], origin[1], origin[2]}},
                          nullptr,
                          nullptr,
                          nullptr,
                          nullptr};
  int sub, j0, j1;
  while (next_item(I, W.slot, n_sub, S.n_super, sub, j0, j1)) {
    const size_t base = (size_t)sub * TILE_R;
    float cap[RPC];
    unsigned long long init[RPC];
#pragma unroll
    for (int k = 0; k < RPC; ++k) {
      const int i = tid + k * CT;
      W.dirs.d[0][i] = dx[base + i];
      W.dirs.d[1][i] = dy[base + i];
      W.dirs.d[2][i] = dz[base + i];
      init[k] = __ldcg(key_out + base + i);  // another item's winner
      W.best[i] = init[k];
      cap[k] = texit[base + i];
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
    walk_item<EXT>(T, S, sub, j0, j1, bound(), bound);
#pragma unroll
    for (int k = 0; k < RPC; ++k) {
      const int i = tid + k * CT;
      if (W.best[i] < init[k]) atomicMin(key_out + base + i, W.best[i]);
    }
  }
}

// Launch a K9 or K11 walk: a grid of as many blocks as fit the card at
// once takes the items.
template <class Kernel, class... Args>
int launch_walk(Kernel kernel, int bytes, int n_sub, void* stream,
                Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, CT,
                                                        bytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = sms * per > 1 ? sms * per : 1;
  if (n_sub > 0)
    kernel<<<grid, CT, bytes, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// K9: oterm = the frame's (F, 8) origin terms [t_num, hc0, hc1, hc2,
// ...], origin (3,) the camera's, key (R,) the SharedExt::pack keys
// to merge into (+inf, 0 to start)
extern "C" int rt_stream_closest_hit(
    const int* mask3, const int* order2, const float* tlb3, const float* dx,
    const float* dy, const float* dz, const float* texit, const float* spack,
    const float* oterm, const float* origin, const float* blo,
    const float* bhi, const int* item_off, const int* pre, int seg,
    int* counter, int n_sub_total, int nsub, int n_super, int pack_cols,
    unsigned long long* key, void* stream) {
  if (nsub < 1 || n_sub_total % nsub) return (int)cudaErrorInvalidValue;
  const Sched S{mask3, order2, tlb3, nsub, n_super, spack, pack_cols,
                oterm, 8,     blo,    bhi};
  const Items I{item_off, pre, seg, counter};
  return launch_walk(shared_culled_kernel, (int)sizeof(SharedSmem),
                     n_sub_total, stream, S, dx, dy, dz,
                     texit, origin, I, n_sub_total, key);
}

extern "C" int rt_stream_closest_hit_resources(int* out) {
  return rt::cull::resources(shared_culled_kernel, (int)sizeof(SharedSmem),
                             out);
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
  const Sched S{mask3,     order2,       tlb3,      nsub, n_super, spack,
                pack_cols, spack + sc_dc, pack_cols, blo,  bhi};
  const int bytes = (int)sizeof(Walk);
  cudaError_t err = cudaFuncSetAttribute(
      perray_culled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  if (n_sub_total > 0)
    perray_culled_kernel<<<n_sub_total, CT, bytes, (cudaStream_t)stream>>>(
        S, dx, dy, dz, ox, oy, oz, texit, t, face);
  return (int)cudaGetLastError();
}

extern "C" int rt_stream_closest_hit_perray_resources(int* out) {
  return rt::cull::resources(perray_culled_kernel, (int)sizeof(Walk), out);
}

// K11: occ (R,) zeros to start; the plane constants at column sc_dc
extern "C" int rt_stream_anyhit(
    const int* mask3, const int* order2, const float* tlb3, const float* dx,
    const float* dy, const float* dz, const float* ox, const float* oy,
    const float* oz, const float* act, const float* texit,
    const float* spack, const float* blo, const float* bhi,
    const int* item_off, const int* pre, int seg, int* counter,
    int n_sub_total, int nsub, int n_super, int pack_cols, int sc_dc,
    float* occ, void* stream) {
  if (nsub < 1 || n_sub_total % nsub) return (int)cudaErrorInvalidValue;
  const Sched S{mask3,     order2,       tlb3, nsub, n_super, spack,
                pack_cols, spack + sc_dc, pack_cols, blo, bhi};
  const Items I{item_off, pre, seg, counter};
  return launch_walk(anyhit_culled_kernel, (int)sizeof(AnyhitSmem),
                     n_sub_total, stream, S, dx, dy, dz,
                     ox, oy, oz, act, texit, I, n_sub_total, occ);
}

extern "C" int rt_stream_anyhit_resources(int* out) {
  return rt::cull::resources(anyhit_culled_kernel, (int)sizeof(AnyhitSmem),
                             out);
}
