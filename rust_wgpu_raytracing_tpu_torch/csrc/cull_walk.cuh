// The per-ray culled walk of K1 (closest_hit.cu), K3 (anyhit.cu), K4's
// in-kernel shadow loop (frame.cu; its sweep walks the same chunks with
// the rays in registers), K7 (closest_hit_perray.cu), K8
// (extend_shadow.cu) and the streamed sweeps
// K9, K10 and K11 (stream_sweep.cu): a tile's admitted face
// blocks are taken in chunks of a few blocks, and each block's faces are
// tested only for the rays whose own line enters the block's box
// (rt_common.cuh ray_box_enter), a closest-hit ray only where that entry
// lies at or below its best t so far.
//
// Why: a tile of incoherent bounce rays, or of shadow rays of which a
// tenth are live, admits hundreds of blocks, but a ray enters only a few
// of their boxes. The TPU kernels test every lane against every admitted
// block (a 1024-lane vector gains nothing from skipping lanes); a 32-lane
// warp does, once the (ray, block) pairs that need a test are compacted.
// The outputs stay the unculled walk's, bit for bit: the merges (a
// lexicographic (t, face) min, an OR) do not depend on the order of
// visits, a ray whose line misses the widened box cannot hit a face
// inside it, and no face t lies before its box's entry.
//
// One CUDA block of CT = 512 threads per 1024-ray tile. The rays live in
// shared memory (struct of arrays; K1's and K9's as directions beside
// one origin), with the closest-hit winner packed as one 64-bit key
// (float bits of t << 32 | face): the bits of a t >= +0.0 order as its
// value, so the key's order is the lexicographic (t, face) order. K8 and
// K10 hit at t >= 1e-3; K1 and K9 at t >= 0, where a zero t packs as
// +0.0 in the high word (the bits of -0.0 would order after every
// positive t) and its sign goes to bit 0 of the low word, beside face << 1
// (SharedExt::pack): the winner keeps its own zero, as the TPU kernel's
// merge keeps it. A miss keeps (+inf, 0). Per chunk:
//  1. box phase: each thread box-tests its rays against the chunk's
//     blocks (bit s of a per-ray mask: the ray enters block s); K11
//     takes the live rays from a compacted list, so only live rays are
//     tested;
//  2. a block-wide scan of the masks' popcounts numbers the (ray, block)
//     pairs; the union of the masks says which blocks some pair needs;
//  3. only those blocks are staged, column-major (one face per lane);
//  4. the pairs are written to a list (at most CAP per round) and the
//     warps take them: the lanes are the block's faces (G lanes per pair,
//     G the power of two >= block_f, 32 / G pairs per warp). A
//     closest-hit pair min-reduces t over its lanes, takes the first lane
//     at that t (the lowest face id) by a ballot and merges its key (that
//     lane's own t) into the ray's with a shared-memory atomicMin; a
//     shadow pair ORs its lanes' hits into the ray's state (then the ray
//     leaves the walk).
// A walk of coherent rays (K1's from the camera, K3's shadow rays toward
// the light) enters the same blocks from most rays of a warp; there a
// pair costs a warp pass of shuffles, a ballot and an atomic for one ray.
// So K1 and K3 (run_chunk's HYBRID) take a dense chunk ray-major
// instead: where the (ray, block) pairs reach `ray_major` times the
// warps' visits of the blocks they need, each thread tests its own rays
// against the faces of the blocks its warp enters, face after face, each
// face's columns read by all lanes at once (ray_major_chunk).
#pragma once

#include "rt_common.cuh"

namespace rt {
namespace cull {

constexpr int CT = 512;               // threads of a culled walk's block
constexpr int NW = CT / 32;           // warps
constexpr int RPC = TILE_R / CT;      // rays per thread in the box phase
constexpr int MAX_SLOTS = 32;         // blocks per chunk (a mask bit each)
constexpr int STAGE_FACES = 256;      // faces staged per chunk
// staged floats: slots(block_f) * 16 columns * (block_f + 1), at most
// 32 * 16 * 9 (block_f 8); block_f 32 takes 8 * 16 * 33
constexpr int STAGE_FLOATS = MAX_SLOTS * STAGE_COLS * 9;
constexpr int CAP = 4096;             // (ray, block) pairs per round
constexpr unsigned long long NO_HIT = 0x7f80000000000000ull;  // (+inf, 0)
constexpr unsigned FULL = 0xffffffffu;

// blocks per chunk: as many as fit STAGE_FACES, at most MAX_SLOTS
__host__ __device__ constexpr int slots_for(int block_f) {
  return STAGE_FACES / block_f < MAX_SLOTS ? STAGE_FACES / block_f
                                           : MAX_SLOTS;
}

// one wavefront's rays, struct of arrays
struct Rays {
  float o[3][TILE_R];
  float d[3][TILE_R];
};

// the blocks of one chunk and the block-wide scan's scratch
struct Chunk {
  int n;                     // slots in use
  int blk[MAX_SLOTS];        // face block of each slot
  int flag[MAX_SLOTS];       // bit 0: closest-hit half, bit 1: shadow half
  float lo[MAX_SLOTS][3];    // the boxes, widened (widen_lo, widen_hi)
  float hi[MAX_SLOTS][3];
  int wsum[NW];
  unsigned wneed[NW];
  float red[NW];
};

// shared memory of a closest-hit walk (K7, K10); K8 adds the shadow rays
struct Walk {
  unsigned long long best[TILE_R];  // (t bits << 32 | face) per ray
  Rays ext;                         // the closest-hit rays
  float faces[STAGE_FLOATS];        // (slot, column, face), face stride bf+1
  unsigned short list[CAP];         // pair: ray | slot << 10 | half << 15
  Chunk ch;
};

// state of a shadow ray
constexpr unsigned char S_OFF = 0, S_LIVE = 1, S_OCC = 2;

// the halves of a walk (run_chunk's HALVES, a slot's flag bits)
constexpr int EXT = 1, SHADOW = 2;

// K9's rays: directions only, beside the tile's one origin
struct Dirs {
  float d[3][TILE_R];
};

// The closest-hit rays of a walk, with per-ray origins (K7, K8, K10): every
// hit has t >= 1e-3 > 0, so t's bits are the key's.
struct PerRayExt {
  static constexpr bool SIGNED_ZERO = false;
  const Rays& R;
  __device__ __forceinline__ bool aimed(int i) const {
    return R.d[0][i] != 0.0f || R.d[1][i] != 0.0f || R.d[2][i] != 0.0f;
  }
  __device__ __forceinline__ BoxRay box(int i) const {
    return box_ray(R.o[0][i], R.o[1][i], R.o[2][i], R.d[0][i], R.d[1][i],
                   R.d[2][i]);
  }
  __device__ __forceinline__ bool hit(const float* g, int stride, int i,
                                      float& t) const {
    return perray_hit_cols(g, stride, R.d[0][i], R.d[1][i], R.d[2][i],
                           R.o[0][i], R.o[1][i], R.o[2][i], t);
  }
  __device__ __forceinline__ static unsigned key(float t) {
    return __float_as_uint(t);
  }
};

// The closest-hit rays of K1 and K9, from one origin: the face test is
// shared_origin_t's (t >= 0, staged columns 12-15 the origin terms). A
// zero t (+0.0 or -0.0, by the signs of t_num and N.d) packs as +0.0 in
// the key's high word and its sign in bit 0 of the low word, beside
// face << 1: the key orders by (t by value, face), and the winner keeps
// the sign of its own t (a camera on a face's plane draws the face or
// not by that sign: 1/t is the frame's depth).
struct SharedExt {
  static constexpr bool SIGNED_ZERO = true;
  const Dirs& R;
  float o[3];
  __device__ __forceinline__ bool aimed(int i) const {
    return R.d[0][i] != 0.0f || R.d[1][i] != 0.0f || R.d[2][i] != 0.0f;
  }
  __device__ __forceinline__ BoxRay box(int i) const {
    return box_ray(o[0], o[1], o[2], R.d[0][i], R.d[1][i], R.d[2][i]);
  }
  __device__ __forceinline__ bool hit(const float* g, int stride, int i,
                                      float& t) const {
    t = shared_origin_t_cols(g, stride, R.d[0][i], R.d[1][i], R.d[2][i]);
    return t != INFINITY;
  }
  __device__ __forceinline__ static unsigned long long pack(float t,
                                                            unsigned face) {
    const unsigned bits = __float_as_uint(t);
    return t == 0.0f ? (unsigned long long)(face << 1 | bits >> 31)
                     : (unsigned long long)bits << 32 | face << 1;
  }
};

// t and face of a SharedExt key
__device__ __forceinline__ float shared_key_t(unsigned long long key) {
  return __uint_as_float((unsigned)(key >> 32) | (unsigned)key << 31);
}
__device__ __forceinline__ int shared_key_face(unsigned long long key) {
  return (int)((unsigned)key >> 1);
}

// the closest-hit half of a shadow-only walk (K3, K11): none
struct NoExt {
  static constexpr bool SIGNED_ZERO = false;
  __device__ __forceinline__ static unsigned key(float t) {
    return __float_as_uint(t);
  }
};

__device__ __forceinline__ void load_rays(Rays& R, const float* dx,
                                          const float* dy, const float* dz,
                                          const float* ox, const float* oy,
                                          const float* oz, size_t base) {
  for (int i = threadIdx.x; i < TILE_R; i += CT) {
    R.d[0][i] = dx[base + i];
    R.d[1][i] = dy[base + i];
    R.d[2][i] = dz[base + i];
    R.o[0][i] = ox[base + i];
    R.o[1][i] = oy[base + i];
    R.o[2][i] = oz[base + i];
  }
}

// Block-wide max of one float per thread of a CT-thread block; all
// threads get it.
__device__ __forceinline__ float walk_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  __syncthreads();  // previous readers of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < NW; ++w) m = fmaxf(m, red[w]);
  return m;
}

// Slot s of the chunk takes face block blk with its half flags and its
// widened box; a padding box (lo > hi) takes no half: no ray enters it.
__device__ __forceinline__ void load_slot(Chunk& ch, int s, int blk, int flag,
                                          const float* blo,
                                          const float* bhi) {
  bool box = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float lo = blo[(size_t)blk * 3 + a], hi = bhi[(size_t)blk * 3 + a];
    box = box && lo <= hi;
    ch.lo[s][a] = widen_lo(lo);
    ch.hi[s][a] = widen_hi(hi);
  }
  ch.blk[s] = blk;
  ch.flag[s] = box ? flag : 0;
}

// Box-test one ray (r from box_ray) against the slots whose `want` flag
// is set: bit s of the result = the ray enters slot s's box (at or below
// `cap`).
__device__ __forceinline__ unsigned enter_mask(const Chunk& ch, int want,
                                               const BoxRay& r, float cap) {
  unsigned m = 0;
  for (int s = 0; s < ch.n; ++s) {
    float e;
    if ((ch.flag[s] & want) && ray_box_enter(ch.lo[s], ch.hi[s], r, e) &&
        e <= cap)
      m |= 1u << s;
  }
  return m;
}

// The rays, the shared scratch and the outputs of one chunk of a walk.
// `best` holds the closest-hit keys; `ext` (PerRayExt, SharedExt, NoExt)
// the closest-hit rays; `sh` and `state` the shadow rays and their
// states; `live` the ray indices of the first *n_live entries that a
// shadow-only walk (K11) box-tests.
template <class Ext>
struct Tile {
  Chunk& ch;
  float* faces;               // (slot, column, face), face stride bf+1
  unsigned short* list;       // pair: ray | slot << 10 | half << 15
  unsigned long long* best;
  Ext ext;
  const Rays* sh;
  unsigned char* state;
  const unsigned short* live;
  const int* n_live;
};

// A dense chunk of a one-half walk (run_chunk with HYBRID), after its
// staging: each thread tests its own rays ray[k] (their masks mk[k])
// against the faces of the blocks its warp enters (the union wu), block
// by block and face by face, each test only where the ray's own mask bit
// is set. The thread owns its rays in the chunk: a closest-hit ray's key
// (the least of Ext::pack, as the pairs' atomicMin merges it) and a
// shadow ray's state are updated without atomics. Ends synchronised.
template <int HALVES, class Ext>
__device__ __forceinline__ void ray_major_chunk(const Tile<Ext>& T,
                                                const int (&ray)[RPC],
                                                const unsigned (&mk)[RPC],
                                                unsigned wu, int block_f) {
  const int stride = block_f + 1;
  __syncthreads();  // the faces are staged
  if constexpr ((HALVES & EXT) != 0) {
    unsigned long long key[RPC];
#pragma unroll
    for (int k = 0; k < RPC; ++k) key[k] = mk[k] ? T.best[ray[k]] : 0ull;
    for (unsigned m = wu; m; m &= m - 1u) {
      const int s = __ffs(m) - 1;
      const float* blk = T.faces + s * STAGE_COLS * stride;
      const unsigned face0 = (unsigned)(T.ch.blk[s] * block_f);
      for (int j = 0; j < block_f; ++j) {
#pragma unroll
        for (int k = 0; k < RPC; ++k) {
          float t;
          if ((mk[k] >> s & 1u) && T.ext.hit(blk + j, stride, ray[k], t)) {
            const unsigned long long c = Ext::pack(t, face0 + j);
            key[k] = c < key[k] ? c : key[k];
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < RPC; ++k)
      if (mk[k]) T.best[ray[k]] = key[k];
  } else {
    bool was[RPC], live[RPC];
#pragma unroll
    for (int k = 0; k < RPC; ++k) {
      was[k] = mk[k] && T.state[ray[k]] == S_LIVE;
      live[k] = was[k];
    }
    const Rays& R = *T.sh;
    for (unsigned m = wu; m; m &= m - 1u) {
      const int s = __ffs(m) - 1;
      const float* blk = T.faces + s * STAGE_COLS * stride;
      for (int j = 0; j < block_f; ++j) {
#pragma unroll
        for (int k = 0; k < RPC; ++k) {
          const int i = ray[k];
          float t;
          if (live[k] && (mk[k] >> s & 1u) &&
              perray_hit_cols(blk + j, stride, R.d[0][i], R.d[1][i],
                              R.d[2][i], R.o[0][i], R.o[1][i], R.o[2][i],
                              t))
            live[k] = false;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < RPC; ++k)
      if (was[k] && !live[k]) T.state[ray[k]] = S_OCC;
  }
  __syncthreads();
}

// One chunk of the walk (T.ch filled and synchronised by the caller).
// With EXT in HALVES, the closest-hit half tests the aimed rays of T.ext
// against the slots with flag bit 0; with SHADOW, the live rays of T.sh
// (state S_LIVE) against the slots with flag bit 1 (a shadow-only walk
// takes its rays from T.live). Faces: columns 0-11 of `pack` (row stride
// pack_cols) and 0-3 of `extra` (row stride extra_cols). HYBRID (a
// one-half walk: K1, K3) takes the chunk ray-major (ray_major_chunk)
// where its (ray, block) pairs reach ray_major times the sum over the
// warps of the blocks each enters, else by pairs. Ends synchronised.
template <int HALVES, class Ext, bool HYBRID = false>
__device__ void run_chunk(const Tile<Ext>& T, const float* __restrict__ pack,
                          int pack_cols, const float* __restrict__ extra,
                          int extra_cols, int block_f, int ray_major = 0) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Chunk& ch = T.ch;
  constexpr bool HAS_EXT = (HALVES & EXT) != 0;
  constexpr bool HAS_SH = (HALVES & SHADOW) != 0;

  // 1. box phase
  unsigned em[RPC], sm[RPC];
  int ray[RPC];
  int cnt = 0;
  unsigned need = 0;
#pragma unroll
  for (int k = 0; k < RPC; ++k) {
    int i = tid + k * CT;
    if constexpr (!HAS_EXT) i = i < *T.n_live ? T.live[i] : -1;
    ray[k] = i;
    em[k] = 0;
    sm[k] = 0;
    if constexpr (HAS_EXT) {
      if (T.ext.aimed(i))
        em[k] = enter_mask(ch, EXT, T.ext.box(i),
                           __uint_as_float((unsigned)(T.best[i] >> 32)));
    }
    if constexpr (HAS_SH) {
      if (i >= 0 && T.state[i] == S_LIVE)
        sm[k] = enter_mask(ch, SHADOW,
                           box_ray(T.sh->o[0][i], T.sh->o[1][i],
                                   T.sh->o[2][i], T.sh->d[0][i],
                                   T.sh->d[1][i], T.sh->d[2][i]),
                           INFINITY);
    }
    cnt += __popc(em[k]) + __popc(sm[k]);
    need |= em[k] | sm[k];
  }

  // 2. number the pairs: block-wide exclusive scan of cnt
  int incl = cnt;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  need = __reduce_or_sync(FULL, need);
  if (lane == 31) ch.wsum[warp] = incl;
  if (lane == 0) ch.wneed[warp] = need;
  __syncthreads();
  int first = incl - cnt, total = 0, visits = 0;
  need = 0;
  for (int w = 0; w < NW; ++w) {
    const int v = ch.wsum[w];
    total += v;
    if (w < warp) first += v;
    need |= ch.wneed[w];
    if constexpr (HYBRID) visits += __popc(ch.wneed[w]);
  }
  if (total == 0) return;  // uniform

  // 3. stage the blocks some pair needs, column-major
  const int stride = block_f + 1;
  for (unsigned m = need; m;) {
    const int s = __ffs(m) - 1;
    m &= m - 1u;
    const size_t row0 = (size_t)ch.blk[s] * block_f;
    for (int e = tid; e < block_f * STAGE_COLS; e += CT) {
      const int j = e / STAGE_COLS, c = e % STAGE_COLS;
      const size_t row = row0 + j;
      T.faces[(s * STAGE_COLS + c) * stride + j] =
          c < 12 ? pack[row * pack_cols + c]
                 : extra[row * extra_cols + (c - 12)];
    }
  }

  if constexpr (HYBRID) {
    static_assert(HALVES == EXT || HALVES == SHADOW, "one half");
    if (total >= ray_major * visits) {  // uniform
      if constexpr (HAS_EXT)
        ray_major_chunk<HALVES>(T, ray, em, ch.wneed[warp], block_f);
      else
        ray_major_chunk<HALVES>(T, ray, sm, ch.wneed[warp], block_f);
      return;
    }
  }

  // 4. the pairs, CAP per round
  int g = 1;
  while (g < block_f) g <<= 1;
  const int ppw = 32 / g, q = lane / g, j = lane % g;
  const unsigned gmask = g == 32 ? FULL : ((1u << g) - 1u) << (q * g);
  for (int base = 0; base < total; base += CAP) {
    if (first < base + CAP && first + cnt > base) {
      int idx = first;
#pragma unroll
      for (int k = 0; k < RPC; ++k) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (!(HALVES & (1 << half))) continue;
          for (unsigned m = half ? sm[k] : em[k]; m; m &= m - 1u, ++idx)
            if (idx >= base && idx < base + CAP)
              T.list[idx - base] = (unsigned short)(
                  ray[k] | ((__ffs(m) - 1) << 10) | (half << 15));
        }
      }
    }
    __syncthreads();
    const int npairs = min(CAP, total - base);
    for (int p0 = warp * ppw; p0 < npairs; p0 += NW * ppw) {
      const int p = p0 + q;
      const bool have = p < npairs;
      float tm = INFINITY;  // a closest-hit lane's t, +inf where it misses
      bool hit = false;     // a shadow lane's hit
      int i = 0, s = 0, half = 0;
      if (have) {
        const unsigned e = T.list[p];
        i = e & 1023;
        s = (e >> 10) & 31;
        half = e >> 15;
        if (j < block_f && !(HAS_SH && half && T.state[i] != S_LIVE)) {
          const float* col = T.faces + s * STAGE_COLS * stride + j;
          float t;
          bool v;
          if constexpr (HALVES == (EXT | SHADOW)) {
            // K8: one test, on the pair's ray set
            const Rays& R = half ? *T.sh : T.ext.R;
            v = perray_hit_cols(col, stride, R.d[0][i], R.d[1][i],
                                R.d[2][i], R.o[0][i], R.o[1][i], R.o[2][i],
                                t);
          } else if constexpr (HAS_SH) {
            const Rays& R = *T.sh;
            v = perray_hit_cols(col, stride, R.d[0][i], R.d[1][i],
                                R.d[2][i], R.o[0][i], R.o[1][i], R.o[2][i],
                                t);
          } else {
            v = T.ext.hit(col, stride, i, t);
          }
          if (half)
            hit = v;
          else if (v)
            tm = t;
        }
      }
      // the pair's winner: the least t over its lanes, on a tie the
      // first lane (the lowest face id); a +inf t never beats (+inf, 0)
      float tmin = tm;
      for (int o = g >> 1; o > 0; o >>= 1)
        tmin = fminf(tmin, __shfl_xor_sync(FULL, tmin, o));
      const unsigned bits =
          __ballot_sync(FULL, half ? hit : (tm == tmin && tmin < INFINITY)) &
          gmask;
      if constexpr (Ext::SIGNED_ZERO) {
        // the first lane at the least t merges its own t (a closest-hit
        // walk only): a zero keeps its sign
        if (have && bits && lane == __ffs(bits) - 1)
          atomicMin(&T.best[i], Ext::pack(tm, ch.blk[s] * block_f + j));
      } else if (have && j == 0 && bits) {
        if (half)
          T.state[i] = S_OCC;
        else if constexpr (HAS_EXT)
          atomicMin(&T.best[i],
                    ((unsigned long long)Ext::key(tmin) << 32) |
                        (unsigned)(ch.blk[s] * block_f + __ffs(bits) - 1 -
                                   q * g));
      }
    }
    __syncthreads();
  }
}

// Fill the chunk from the set bits of `word` (superblock s), at most
// `slots` of them, each slot with its box and the halves `flag`: warp 0
// loads, then the block synchronises. Returns the bits left.
__device__ __forceinline__ unsigned fill_chunk(Chunk& ch, unsigned word,
                                               int s, int flag, int slots,
                                               const float* blo,
                                               const float* bhi) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    unsigned rest = word;
    int n = 0;
    for (; rest && n < slots; ++n) {
      const int bit = __ffs((int)rest) - 1;
      rest &= rest - 1u;
      if (lane == n) load_slot(ch, n, s * 32 + bit, flag, blo, bhi);
    }
    if (lane == 0) ch.n = n;
  }
  for (int k = 0; k < slots && word; ++k) word &= word - 1u;
  __syncthreads();
  return word;
}

// Fill the chunk from a tile's front-to-back schedule (K1, K3, K7): the
// blocks ord[p], ord[p + 1], ... (at most `slots`, none past nb) as long
// as their entry bound tl[block] is at most b, each slot with its box and
// the halves `flag`: warp 0 loads, then the block synchronises. Returns
// the slots filled; fewer than `slots` means the walk ends with this
// chunk: `order` ascends in tl, so no later block passes the bound
// either (and a block that fails `tl <= b` stops the TPU kernel's walk
// too).
__device__ __forceinline__ int fill_sched_chunk(Chunk& ch, const float* tl,
                                                const int* ord, int nb,
                                                int p, float b, int flag,
                                                int slots, const float* blo,
                                                const float* bhi) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, q = p + lane;
    int ci = 0;
    bool ok = false;
    if (lane < slots && q < nb) {
      ci = ord[q];
      ok = tl[ci] <= b;
    }
    const unsigned fail = __ballot_sync(FULL, !ok);
    const int n = fail ? __ffs((int)fail) - 1 : 32;
    if (lane < n) load_slot(ch, lane, ci, flag, blo, bhi);
    if (lane == 0) ch.n = n;
  }
  __syncthreads();
  return ch.n;
}

// The live-ray list of a shadow-only walk (K3, K11; S holds the rays'
// `state`, `cap`, the list `live`, its length `n_live` and the chunk
// scratch `ch`): compact the rays in state S_LIVE into S.live (all: from
// every ray of the tile, else from the list as it stands) and return the
// block-wide max of their caps, -1 when none is live. Ends synchronised.
template <class S>
__device__ float compact_live(S& A, bool all) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int ray[RPC], cnt = 0;
  float m = -1.0f;
#pragma unroll
  for (int k = 0; k < RPC; ++k) {
    const int p = tid + k * CT;
    const int i = all ? p : (p < A.n_live ? A.live[p] : -1);
    ray[k] = i >= 0 && A.state[i] == S_LIVE ? i : -1;
    if (ray[k] >= 0) {
      ++cnt;
      m = fmaxf(m, A.cap[i]);
    }
  }
  int incl = cnt;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
    m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
  }
  __syncthreads();  // every read of the list and of the scratch is done
  if (lane == 31) A.ch.wsum[warp] = incl;
  if (lane == 0) A.ch.red[warp] = m;
  __syncthreads();
  int first = incl - cnt, total = 0;
  for (int w = 0; w < NW; ++w) {
    total += A.ch.wsum[w];
    if (w < warp) first += A.ch.wsum[w];
    m = fmaxf(m, A.ch.red[w]);
  }
#pragma unroll
  for (int k = 0; k < RPC; ++k)
    if (ray[k] >= 0) A.live[first++] = (unsigned short)ray[k];
  if (tid == 0) A.n_live = total;
  __syncthreads();
  return m;
}

// out[0..3] = registers a thread, spilled bytes a thread, dynamic shared
// memory a block and blocks an SM at that memory, of a culled walk kernel
// launched with `bytes` of dynamic shared memory.
template <class Kernel>
int resources(Kernel kernel, int bytes, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, CT,
                                                        bytes);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = bytes;
  out[3] = ctas;
  return (int)err;
}

}  // namespace cull
}  // namespace rt
