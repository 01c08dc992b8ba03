// The culled sweeps' front end for one ray set (K13): each 1024-ray
// tile's ray bounds, each ray's root-exit cap, the flat scan's packed
// (tile, block) mask words and the all-on-chip sweeps' front-to-back
// schedule, in one launch.
//
// Replaces no Pallas kernel. The JAX package computes these in plain jnp
// (rust_wgpu_raytracing_tpu/ops/megakernel.py tile_ray_bounds,
// _mask_words' flat scan, _vmem_sched), which XLA fuses inside its frame
// program. The port's plain twin (ops/kernels/sweep_front.py
// sweep_front_plain over ops/traverse.py tile_ray_bounds,
// flat_mask_words, tile_schedule, sweep_root_exit) materialises every
// intermediate: the (tiles, clusters, 3) slab tests twice, the bounds'
// reductions, the regroup, the packing and the argsort, ~250 launches
// and ~2.6 GB of traffic for a 1080p ray set of the 16,200-face scene.
// This kernel is that fusion, written by hand; megakernel.sweep_inputs
// calls it once a ray set.
//
// The arithmetic is the plain code's, term for term, each operation
// rounded on its own (-fmad=false, no fast math): the slab test
// slab_interval_entry with dp_s = |dp| > 1e-30 ? dp : 1e-30, IEEE
// divides a / dp_s and b / dn_s, the entry bound t0 * (1 - 1e-5) - 1e-6;
// the root exit with d_safe = d == 0 ? 1 : d, IEEE divides and t1 * (1 +
// 1e-5) + 1e-6; the Python constants as the f32 values torch gives them
// on an f32 tensor (the double rounded once). Minima and maxima propagate
// NaN, as torch's amin, amax, minimum and maximum do. Where a min or max
// meets a zero of each sign the kernel returns -0.0 for a min and +0.0
// for a max; torch's reductions settle that tie by their own order, so a
// tile bound can differ from the plain one in the sign of a zero, and in
// nothing else. No consumer can tell: the slab tests only compare the
// bounds, subtract them from box corners whose results they compare or
// divide by a guarded divisor into a bound that is compared or clamped
// to 0 before it is used (the words, tlb, order and texit are bitwise).
//
// The schedule's order is torch.argsort(tlb, stable=True): a sort of
// (key(tlb) << 32 | block) as u64, key an order-preserving map of the
// float with -0.0 taken as +0.0 and every NaN last, so equal bounds keep
// their block order. A bitonic sort over the next power of two of nb
// keys in shared memory (4 KB at the refscene frame's nb = 508, 128 KB
// at most), padded with ~0.
//
// What bounds it on the H100: bytes. At the refscene 1080p camera rays
// (2,040 tiles, 508 32-face blocks) it reads three ray planes (25 MB)
// and writes texit (8.4 MB), tlb and order (4.1 MB each) and the words:
// ~42 MB, ~13 us at 3.35 TB/s; the shadow rays add three origin planes
// and act (~75 MB). The slab tests are ~50 FP32 operations a (tile,
// cluster) and test, ~1M pairs twice: ~0.1 GFLOP. What the card's time
// goes to instead: the latency of each tile's chain of phases (the
// loads, the reduction, the box loads of the slab tests, the sort's 45
// barrier stages at nb = 508), which only other blocks on the SM hide.
//
// The design: a block of 256 threads a tile, 4 rays a thread (coalesced
// loads), up to 4 blocks an SM. A thread loads its rays, writes their
// texit and folds their bounds; the block reduces the 12 bounds (24
// where the mask's gate differs) by warp shuffles and shared memory.
// Thread j then tests block j (j += 256) against its clusters' boxes
// (read from L2; every tile reads the same boxes): the flat words by one
// ballot a warp (bit k of word w = block 32 w + k), written out and kept
// in shared memory for the schedule, which reads their bits, tests only
// the blocks they keep and sorts the keys.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE_R = 1024;          // rays a tile
constexpr int THREADS = 256;          // a block a tile
constexpr int RAYS = TILE_R / THREADS;  // rays a thread
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_SM = 4;          // blocks an SM the registers allow
constexpr unsigned FULL = 0xffffffffu;
constexpr int GATE_ACT = 1, GATE_LIVE = 2;  // GATE_ALL = 0: every ray

// the Python constants as torch rounds them to f32
constexpr float EPS30 = (float)1e-30;
constexpr float EPS6 = (float)1e-6;
constexpr float DEFLATE = (float)(1.0 - 1e-5);
constexpr float INFLATE = (float)(1.0 + 1e-5);

struct Args {
  const float *o, *ox, *oy, *oz, *dx, *dy, *dz, *act;
  const float *clo, *chi, *blo, *bhi, *rlo, *rhi;
  const int* words_in;
  int gate, mask_gate, nb, nwords, npow2;
  int grp, rep;  // a block holds grp clusters, or a cluster rep blocks
  float *bounds, *mask_bounds;
  int* words;
  float* tlb;
  int* order;
  float* texit;
  int n_tiles;
};

// NaN-propagating min and max; a zero of each sign gives -0.0 to the min
// and +0.0 to the max
__device__ __forceinline__ float tmin(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a != b) return a < b ? a : b;
  return (__float_as_uint(a) >> 31) ? a : b;
}

__device__ __forceinline__ float tmax(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a != b) return a > b ? a : b;
  return (__float_as_uint(a) >> 31) ? b : a;
}

// slot s of the 12 bounds: omin xyz, omax xyz, dmin xyz, dmax xyz
__device__ __forceinline__ float fold(int s, float a, float b) {
  return ((s % 12) / 3) & 1 ? tmax(a, b) : tmin(a, b);
}

// v[0..N) folded over the block; out[s] = the result (every thread)
template <int N>
__device__ void block_reduce(float (&v)[N], float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < N; ++s) {
#pragma unroll
    for (int off = 16; off; off >>= 1)
      v[s] = fold(s, v[s], __shfl_xor_sync(FULL, v[s], off));
  }
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < N; ++s) red[warp * N + s] = v[s];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int s = 0; s < N; ++s) {
      // a lane a warp; the others hold the fold's identity
      const bool is_max = ((s % 12) / 3) & 1;
      float x = lane < WARPS ? red[lane * N + s]
                             : (is_max ? -INFINITY : INFINITY);
#pragma unroll
      for (int off = 16; off; off >>= 1)
        x = fold(s, x, __shfl_xor_sync(FULL, x, off));
      if (lane == 0) out[s] = x;
    }
  }
  __syncthreads();
}

// one ray folded into a tile's 12 bound slots v (first: v takes the
// ray's): a ray outside the gate gives +inf to the minima and -inf to
// the maxima; a shared origin is every tile's bound
__device__ __forceinline__ void fold_ray(float* v, bool first, bool in,
                                         bool shared, const float* o,
                                         const float* d) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float w[4] = {shared ? o[k] : (in ? o[k] : INFINITY),
                        shared ? o[k] : (in ? o[k] : -INFINITY),
                        in ? d[k] : INFINITY, in ? d[k] : -INFINITY};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int s = 3 * q + k;
      v[s] = first ? w[q] : fold(s, v[s], w[q]);
    }
  }
}

__device__ __forceinline__ bool gate_in(int gate, const Args& p, size_t ray,
                                        const float* d) {
  if (gate == GATE_ACT) return p.act[ray] > 0.0f;
  if (gate == GATE_LIVE)
    return (d[0] != 0.0f) | (d[1] != 0.0f) | (d[2] != 0.0f);
  return true;
}

// the per-tile terms of slab_interval_entry
struct Cone {
  float omin[3], omax[3], dns[3], dps[3];
  bool mixed[3], zero[3], pos[3];
};

__device__ __forceinline__ Cone make_cone(const float* b) {
  Cone c;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float dn = b[6 + k], dp = b[9 + k];
    c.omin[k] = b[k];
    c.omax[k] = b[3 + k];
    c.mixed[k] = (dn <= 0.0f) & (dp >= 0.0f);
    c.zero[k] = (dn == 0.0f) & (dp == 0.0f);
    c.pos[k] = dn > 0.0f;
    c.dps[k] = fabsf(dp) > EPS30 ? dp : EPS30;
    c.dns[k] = fabsf(dn) > EPS30 ? dn : EPS30;
  }
  return c;
}

// slab_interval_entry on the box [lo, hi]: whether the cone may reach it,
// and the entry bound (+inf where it may not)
__device__ __forceinline__ bool slab_entry(const float* lo, const float* hi,
                                           const Cone& c, float& t0_lb) {
  bool box_ok = true;
  float t0 = 0.0f, t1 = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float a = __ldg(lo + k) - c.omax[k];
    const float b = __ldg(hi + k) - c.omin[k];
    box_ok = box_ok & (b >= a);
    // the plain code's lo_pos, hi_pos or lo_neg, hi_neg, as the tile's
    // (warp-uniform) mixed and pos select: two divides, not four
    float lt = 0.0f, ht = INFINITY;
    if (!c.mixed[k] && c.pos[k]) {
      lt = a > 0.0f ? a / c.dps[k] : 0.0f;
      ht = b >= 0.0f ? b / c.dns[k] : -1.0f;
    } else if (!c.mixed[k]) {
      lt = b < 0.0f ? b / c.dns[k] : 0.0f;
      ht = a <= 0.0f ? a / c.dps[k] : -1.0f;
    }
    if (c.zero[k] && !((a <= 0.0f) & (b >= 0.0f))) ht = -1.0f;
    t0 = k ? tmax(t0, lt) : lt;
    t1 = k ? tmin(t1, ht) : ht;
  }
  const bool ok = box_ok & (t1 >= 0.0f) & (t1 >= t0);
  const float t0c = t0 < 0.0f ? 0.0f : t0;  // clamp_min(0): NaN stays
  t0_lb = ok ? t0c * DEFLATE - EPS6 : INFINITY;
  return ok;
}

// the first of block j's grp clusters
__device__ __forceinline__ int first_cluster(const Args& p, int j) {
  return j / p.rep * p.grp;
}

// block j's flat-scan bit: any of its clusters passes
__device__ __forceinline__ bool block_bit(const Args& p, const Cone& c,
                                          int j) {
  const int c0 = first_cluster(p, j);
  bool bit = false;
  for (int q = 0; q < p.grp && !bit; ++q) {
    float unused;
    bit = slab_entry(p.clo + 3 * (c0 + q), p.chi + 3 * (c0 + q), c, unused);
  }
  return bit;
}

// block j's entry bound: the least of its clusters'
__device__ __forceinline__ float block_t0(const Args& p, const Cone& c,
                                          int j) {
  const int c0 = first_cluster(p, j);
  float t = INFINITY;
  for (int q = 0; q < p.grp; ++q) {
    float e;
    slab_entry(p.blo + 3 * (c0 + q), p.bhi + 3 * (c0 + q), c, e);
    t = q ? tmin(t, e) : e;
  }
  return t;
}

// ray_root_exit, -1 for a zero direction (traverse.sweep_root_exit)
__device__ __forceinline__ float root_exit(const float* lo, const float* hi,
                                           const float* o, const float* d) {
  float t0 = 0.0f, t1 = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float l = __ldg(lo + a), h = __ldg(hi + a);
    const float ds = d[a] == 0.0f ? 1.0f : d[a];
    const float ta = (l - o[a]) / ds;
    const float tb = (h - o[a]) / ds;
    float tn = tmin(ta, tb), tf = tmax(ta, tb);
    if (d[a] == 0.0f) {
      const bool inside = (o[a] >= l) & (o[a] <= h);
      tn = inside ? 0.0f : INFINITY;
      tf = inside ? INFINITY : -INFINITY;
    }
    t0 = tmax(t0, tn);
    t1 = tmin(t1, tf);
  }
  const bool live = (d[0] != 0.0f) | (d[1] != 0.0f) | (d[2] != 0.0f);
  return live && t1 >= t0 ? t1 * INFLATE + EPS6 : -1.0f;
}

// The tile's RAYS rays a thread: each ray's texit written, the bounds
// (12 slots; 24 where the mask's gate differs) folded over the block
// into out
template <int N>
__device__ void tile_bounds(const Args& p, int tile, float* red,
                            float* out) {
  const bool shared = p.o != nullptr;
  float v[N];
#pragma unroll
  for (int k = 0; k < RAYS; ++k) {
    const size_t ray = (size_t)tile * TILE_R + k * THREADS + threadIdx.x;
    float o[3], d[3];
    d[0] = p.dx[ray];
    d[1] = p.dy[ray];
    d[2] = p.dz[ray];
    if (shared) {
      o[0] = __ldg(p.o);
      o[1] = __ldg(p.o + 1);
      o[2] = __ldg(p.o + 2);
    } else {
      o[0] = p.ox[ray];
      o[1] = p.oy[ray];
      o[2] = p.oz[ray];
    }
    if (p.texit) p.texit[ray] = root_exit(p.rlo, p.rhi, o, d);
    fold_ray(v, k == 0, gate_in(p.gate, p, ray, d), shared, o, d);
    if (N == 24)
      fold_ray(v + 12, k == 0, gate_in(p.mask_gate, p, ray, d), shared, o,
               d);
  }
  block_reduce<N>(v, red, out);
}

// an order-preserving u32 key: -0.0 as +0.0, every NaN last
__device__ __forceinline__ uint32_t sort_key(float x) {
  if (x != x) return 0xffffffffu;
  const uint32_t u = __float_as_uint(x == 0.0f ? 0.0f : x);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(THREADS, BLOCKS_SM)
sweep_front_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[WARPS * 24];
  __shared__ float bnd[24];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x;
  const bool two = p.mask_bounds != nullptr;
  const bool sched = p.tlb != nullptr;

  if (two)
    tile_bounds<24>(p, tile, red, bnd);
  else
    tile_bounds<12>(p, tile, red, bnd);
  if (tid < 24 && (tid < 12 || two)) {
    const int s = tid % 12;
    float* out = tid < 12 ? p.bounds : p.mask_bounds;
    out[((size_t)(s / 3) * p.n_tiles + tile) * 3 + s % 3] = bnd[tid];
  }

  uint32_t* words_s = reinterpret_cast<uint32_t*>(smem_raw);
  if (p.clo) {  // the flat scan, a block a thread and a word a warp
    const Cone c = make_cone(two ? bnd + 12 : bnd);
    for (int j0 = 0; j0 < p.nb; j0 += THREADS) {
      const int j = j0 + tid;
      const unsigned w = __ballot_sync(FULL, j < p.nb && block_bit(p, c, j));
      const int wi = (j0 >> 5) + warp;
      if (lane == 0 && wi < p.nwords) {
        p.words[(size_t)tile * p.nwords + wi] = (int)w;
        if (sched) words_s[wi] = w;
      }
    }
  } else if (sched) {
    for (int w = tid; w < p.nwords; w += THREADS)
      words_s[w] = (uint32_t)p.words_in[(size_t)tile * p.nwords + w];
  }
  if (!sched) return;
  __syncthreads();

  uint64_t* keys = reinterpret_cast<uint64_t*>(
      smem_raw + (((size_t)p.nwords * 4 + 7) & ~(size_t)7));
  const Cone c = make_cone(bnd);
  for (int j = tid; j < p.npow2; j += THREADS) {
    uint64_t key = ~0ull;
    if (j < p.nb) {
      const float t = (words_s[j >> 5] >> (j & 31)) & 1u ? block_t0(p, c, j)
                                                          : INFINITY;
      p.tlb[(size_t)tile * p.nb + j] = t;
      key = (uint64_t)sort_key(t) << 32 | (uint32_t)j;
    }
    keys[j] = key;
  }
  __syncthreads();
  for (int k = 2; k <= p.npow2; k <<= 1) {
    for (int jj = k >> 1; jj > 0; jj >>= 1) {
      for (int i = tid; i < p.npow2; i += THREADS) {
        const int ixj = i ^ jj;
        if (ixj > i) {
          const uint64_t a = keys[i], b = keys[ixj];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int j = tid; j < p.nb; j += THREADS)
    p.order[(size_t)tile * p.nb + j] = (int)(uint32_t)keys[j];
}

}  // namespace

extern "C" int rt_sweep_front(
    const float* o, const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* act,
    const float* clo, const float* chi, const float* blo, const float* bhi,
    const float* rlo, const float* rhi, const int* words_in, int gate,
    int mask_gate, int n_tiles, int n_clusters, int faces, int block_f,
    float* bounds, float* mask_bounds, int* words, float* tlb, int* order,
    float* texit, void* stream) {
  if (n_tiles <= 0) return (int)cudaGetLastError();
  Args p{o, ox, oy, oz, dx, dy, dz, act, clo, chi, blo, bhi, rlo, rhi,
         words_in, gate, mask_gate};
  p.nb = faces / block_f;
  p.nwords = (p.nb + 31) / 32;
  const int cull = n_clusters > 0 ? faces / n_clusters : block_f;
  p.grp = block_f >= cull ? block_f / cull : 1;
  p.rep = block_f >= cull ? 1 : cull / block_f;
  p.bounds = bounds;
  p.mask_bounds = mask_bounds;
  p.words = words;
  p.tlb = tlb;
  p.order = order;
  p.texit = texit;
  p.n_tiles = n_tiles;
  p.npow2 = 1;
  size_t smem = 0;
  if (tlb) {
    while (p.npow2 < p.nb) p.npow2 <<= 1;
    smem = (((size_t)p.nwords * 4 + 7) & ~(size_t)7) + (size_t)p.npow2 * 8;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sweep_front_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sweep_front_kernel<<<n_tiles, THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// out[0..3] = registers a thread, spilled bytes a thread, static shared
// memory a block and blocks an SM (with the 4 KB sort of nb = 512, the
// refscene frame's).
extern "C" int rt_sweep_front_resources(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, sweep_front_kernel);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, sweep_front_kernel, THREADS, 8 + 512 * 8);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = ctas;
  return (int)err;
}
