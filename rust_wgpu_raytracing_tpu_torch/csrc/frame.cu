// The fused frame kernel (K4): the whole geometric frame of one 1024-ray
// tile.
//
// Replaces the TPU kernel rust_wgpu_raytracing_tpu/ops/fusedframe.py
// _make_frame_kernel (reached from render_frame_fused): the same inputs
// (schedule tlb/order, the frame's const vector, ray planes, root-exit
// caps, the (F, 40) face pack, the (F, 8) origin terms and plane
// constants dc) and the same planes out, written as one (n_out, R)
// tensor in the order of ops/kernels/frame.py:
//   all modes  depth, kind, occ, uvx, uvy, mat, lam, spec
//   sched      + wt, wnx, wny, wnz, wlx, wly, wlz, wrel
//   nm         + nx, ny, nz (flipped geometric normal), vn xyz, tangent
//              xyz, bitangent xyz (lam/spec of the mesh are 0: the tail
//              shades the perturbed normal)
//   inkernel   occ traced here: the winner's shadow ray against the
//              spheres and the mesh clusters in the const vector's order
// It also takes the face blocks' boxes blo / bhi (nb, 3): a block is one
// cluster, so they are the cluster AABBs.
//
// What bounds it on the H100: where the mesh fills the view, the face
// tests (27 FP32 operations each, a divide counted as one) of the (ray,
// block) pairs whose line from the camera enters the block's box at or
// below the ray's best t, and in the in-kernel shadow mode the any-hit
// tests (51 operations) of the live shadow rays whose line enters a
// cluster's box; where it covers a few percent of the pixels, writing
// the planes (16 of 8 MB each at 1080p in mode sched). Everything after
// the sweep is ~300 FP32 operations per ray per sphere pass, on
// registers. The TPU kernel tests every lane of the tile against every
// admitted block: at the smoke view, where 3% of the pixels hit the
// mesh, almost every one of those tests is wasted.
//
// The design. One block of CT = 512 threads per tile; each thread holds
// RPC = 2 rays (tile rays tid and tid + 512) and their (t, face)
// winners in registers for the whole sweep. The tile's `order` row is
// taken in chunks of slots_for(block_f) blocks while their entry bound
// tlb is at most the bound b, the block-wide max of min(best t, root
// exit), refreshed after each chunk (cull_walk.cuh fill_sched_chunk: the
// TPU walk's stop rule and K1's). A chunk's faces are staged once, one
// barrier pair a chunk, face-major (16 columns a face, read by every lane
// at once as four 16-byte broadcasts). Before a staged block's faces each
// thread box-tests its own rays from the camera origin (rt_common.cuh
// ray_box_enter, entry at or below the ray's best t) and the warp votes
// per ray slot: a block that no ray of a warp's slot enters is skipped by
// the warp, otherwise the warp runs the block's faces with the other
// rays masked. A warp's slot is one row of 32 neighbouring pixels, so
// the vote is near uniform: coherent primary rays keep the two-rays-per-
// face-read loop, and blocks a row misses cost one box test. The merge
// is the lexicographic (t, face) min, which does not depend on the order
// of visits, and a ray that misses a widened box or enters it beyond its
// best t cannot change its winner, so the winner is the TPU kernel's,
// a zero t (a camera on a face's plane) with the winning face's own sign.
//
// The tail resolves the winner's attributes from ONE read of its face row
// instead of merging every attribute per visited block as the Pallas
// kernel does: the block merge picks exactly the winner's values (by
// value: the Pallas pick is a sum, which turns -0.0 into +0.0). Sphere
// passes, Blinn-Phong (pow32, the JAX kernel's multiply chain) and the
// composite stay in registers, and the planes are written once,
// coalesced.
//
// The in-kernel shadow loop keeps the TPU kernel's visit order (the
// static near-to-far cluster order in the const vector) and its
// wavefront admission (slab_scalar of the tile's shadow cone, entry at
// most the largest root exit of a live ray). The winners' shadow rays go
// to shared memory, the live ones (relevant, not occluded by a sphere or
// a cluster so far) in a list compacted after each chunk (cull_walk.cuh
// compact_live, K3's); the admitted clusters are taken in chunks through
// cull_walk.cuh run_chunk<SHADOW>: a cluster's faces are tested only for
// the live rays whose line enters its box, by (ray, block) pairs or, in a
// dense chunk, by each thread for its own live rays. The loop stops when
// no live ray is left. occ is an OR, so it is the plain version's bit for
// bit. Operation order follows the JAX kernel term for term; -fmad=false.
#include <float.h>
#include <stddef.h>

#include "cull_walk.cuh"

namespace {

using namespace rt;
using namespace rt::cull;

constexpr int FPACK_COLS = 40;
constexpr int MODE_NONE = 0, MODE_SCHED = 1, MODE_NM = 2, MODE_INKERNEL = 3;
constexpr int C_ROOT = 3, C_SPH = 9, SPH_STRIDE = 13, MAT_STRIDE = 3;
constexpr float PARK = 1e9f;
// Python folds these in double before JAX rounds them to f32
constexpr float EXIT_GROW = (float)(1.0 + 1e-5);
constexpr float ENTRY_SHRINK = (float)(1.0 - 1e-5);

// Shared memory. The sweep uses the head (up to `sh`); the in-kernel
// shadow mode also the shadow rays, their states, caps and live list.
struct Smem {
  float faces[STAGE_FLOATS];  // the sweep: (slot, face, column) face-major
  Chunk ch;
  float red[12 * NW];         // block_minmax6
  int n_live;
  int seq;                    // the shadow loop's position in the order
  Rays sh;
  float cap[TILE_R];
  unsigned short live[TILE_R];
  unsigned short list[CAP];
  unsigned char state[TILE_R];
};

constexpr int smem_bytes(int mode) {
  return mode == MODE_INKERNEL ? (int)sizeof(Smem) : (int)offsetof(Smem, sh);
}

// jnp.maximum(0, v) with its NaN propagation
__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

// The multiply chain of fusedframe._pow32, its denormal result flushed
// to zero as the JAX package's arithmetic flushes it (ops/rounding.py);
// the kernel itself is built without -ftz, like the plain version's ops.
__device__ __forceinline__ float pow32(float x) {
  const float x2 = x * x;
  const float x4 = x2 * x2;
  const float x8 = x4 * x4;
  const float x16 = x8 * x8;
  const float x32 = x16 * x16;
  return fabsf(x32) < FLT_MIN ? 0.0f : x32;
}

// fusedframe._blinn: (lambert, pow32(N.H)) for light vector l.
__device__ __forceinline__ void blinn(float nx, float ny, float nz, float dx,
                                      float dy, float dz, float lx, float ly,
                                      float lz, float& lam, float& spec) {
  float ll = sqrtf(lx * lx + ly * ly + lz * lz);
  ll = ll > 0.0f ? ll : 1.0f;
  const float ulx = lx / ll, uly = ly / ll, ulz = lz / ll;
  lam = relu(-(nx * ulx + ny * uly + nz * ulz));
  const float hx = -ulx - dx, hy = -uly - dy, hz = -ulz - dz;
  float hl = sqrtf(hx * hx + hy * hy + hz * hz);
  hl = hl > 0.0f ? hl : 1.0f;
  spec = pow32(relu((hx * nx + hy * ny + hz * nz) / hl));
}

// fusedframe._sphere_quadratic: t (+inf on a miss), roots below t_min
// rejected, |a| <= 1e-20 a miss.
__device__ __forceinline__ float sphere_quadratic(float cx, float cy, float cz,
                                                  float rad, float ox, float oy,
                                                  float oz, float dx, float dy,
                                                  float dz, float t_min) {
  const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
  const float a = dx * dx + dy * dy + dz * dz;
  const float b = 2.0f * (ocx * dx + ocy * dy + ocz * dz);
  const float c = (ocx * ocx + ocy * ocy + ocz * ocz) - rad * rad;
  const float disc = b * b - 4.0f * a * c;
  const float sq = sqrtf(relu(disc));
  const float a_s = fabsf(a) > 1e-20f ? a : 1.0f;
  const float t1 = (-b - sq) / (2.0f * a_s);
  const float t2 = (-b + sq) / (2.0f * a_s);
  const float t = t1 >= t_min ? t1 : (t2 >= t_min ? t2 : INFINITY);
  return (disc < 0.0f || fabsf(a) <= 1e-20f) ? INFINITY : t;
}

// fusedframe.slab_scalar: conservative test of the block's shadow
// wavefront (origin box [om, oM], direction box [dm, dM]) against one
// cluster AABB; returns admit and sets the entry-t lower bound t0c.
__device__ __forceinline__ bool slab_scalar(const float* box, const float* om,
                                            const float* oM, const float* dm,
                                            const float* dM, float& t0c) {
  float t0 = 0.0f, t1 = INFINITY;
  bool ok = true;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float a = box[ax] - oM[ax];
    const float b = box[3 + ax] - om[ax];
    ok = ok && b >= a;
    const float lo = dm[ax], hi = dM[ax];
    const bool mixed = lo <= 0.0f && hi >= 0.0f;
    const bool zero = lo == 0.0f && hi == 0.0f;
    const bool pos = lo > 0.0f;
    const float dp_s = fabsf(hi) > 1e-30f ? hi : 1e-30f;
    const float dn_s = fabsf(lo) > 1e-30f ? lo : 1e-30f;
    const float lo_pos = a > 0.0f ? a / dp_s : 0.0f;
    const float hi_pos = b >= 0.0f ? b / dn_s : -1.0f;
    const float lo_neg = b < 0.0f ? b / dn_s : 0.0f;
    const float hi_neg = a <= 0.0f ? a / dp_s : -1.0f;
    const float lo_t = mixed ? 0.0f : (pos ? lo_pos : lo_neg);
    float hi_t = mixed ? INFINITY : (pos ? hi_pos : hi_neg);
    if (zero && !(a <= 0.0f && b >= 0.0f)) hi_t = -1.0f;
    t0 = fmaxf(t0, lo_t);
    t1 = fminf(t1, hi_t);
  }
  t0c = relu(t0) * ENTRY_SHRINK - 1e-6f;
  return ok && t1 >= 0.0f && t1 >= t0;
}

// a[k] for a k that is not a compile-time constant, without indexing the
// register array (which would move it to local memory)
template <class T>
__device__ __forceinline__ T pick(const T (&a)[RPC], int k) {
  T v = a[0];
#pragma unroll
  for (int j = 1; j < RPC; ++j)
    if (k == j) v = a[j];
  return v;
}

// Block-wide min of v[0..5] and max of v[6..11] (12 floats per thread);
// every thread gets the 12 results. `red` holds 12 * NW floats.
__device__ __forceinline__ void block_minmax6(float (&v)[12], float* red) {
#pragma unroll
  for (int i = 0; i < 12; ++i)
    for (int o = 16; o > 0; o >>= 1) {
      const float u = __shfl_xor_sync(FULL, v[i], o);
      v[i] = i < 6 ? fminf(v[i], u) : fmaxf(v[i], u);
    }
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int i = 0; i < 12; ++i) red[warp * 12 + i] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    float m = red[i];
    for (int w = 1; w < NW; ++w)
      m = i < 6 ? fminf(m, red[w * 12 + i]) : fmaxf(m, red[w * 12 + i]);
    v[i] = m;
  }
}

// The closest-hit sweep of one tile (module note): the thread's rays
// (x, y, z from origin o, root-exit caps cap) get their lexicographic
// (t, face) winners bt, bf (a miss keeps +inf, 0). Ends with every
// thread past its last read of the staged chunk or at a barrier.
__device__ __forceinline__ void sweep(
    Smem& S, const float* __restrict__ tl, const int* __restrict__ ord, int nb,
    int block_f, const float* __restrict__ fpack, const float* __restrict__ oterm,
    const float* __restrict__ blo, const float* __restrict__ bhi, const float (&o)[3],
    const float (&x)[RPC], const float (&y)[RPC], const float (&z)[RPC],
    const float (&cap)[RPC], float (&bt)[RPC], int (&bf)[RPC]) {
  BoxRay br[RPC];
  unsigned aimed = 0;
#pragma unroll
  for (int k = 0; k < RPC; ++k) {
    bt[k] = INFINITY;
    bf[k] = 0;
    br[k] = box_ray(o[0], o[1], o[2], x[k], y[k], z[k]);
    if (x[k] != 0.0f || y[k] != 0.0f || z[k] != 0.0f) aimed |= 1u << k;
  }
  auto bound = [&]() {
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < RPC; ++k) m = fmaxf(m, fminf(bt[k], cap[k]));
    return walk_max(m, S.ch.red);
  };
  const int slots = slots_for(block_f);
  const int per = block_f * STAGE_COLS;  // staged floats a block
  float b = bound();
  for (int p = 0;; p += slots) {
    const int n = fill_sched_chunk(S.ch, tl, ord, nb, p, b, EXT, slots, blo,
                                   bhi);
    if (n == 0) break;
    for (int e = threadIdx.x; e < n * per; e += CT) {
      const int s = e / per, j = (e % per) / STAGE_COLS, c = e % STAGE_COLS;
      const size_t row = (size_t)S.ch.blk[s] * block_f + j;
      S.faces[e] = c < 12 ? fpack[row * FPACK_COLS + c]
                          : oterm[row * 8 + (c - 12)];
    }
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      if (!(S.ch.flag[s] & EXT)) continue;  // a padding box: no ray enters
      unsigned enter = 0, any = 0;
#pragma unroll
      for (int k = 0; k < RPC; ++k) {
        float e;
        if ((aimed >> k & 1u) && ray_box_enter(S.ch.lo[s], S.ch.hi[s], br[k], e) &&
            e <= bt[k])
          enter |= 1u << k;
        if (__any_sync(FULL, enter >> k & 1u)) any |= 1u << k;
      }
      if (!any) continue;  // uniform across the warp
      const float4* g4 = reinterpret_cast<const float4*>(S.faces + s * per);
      const int face0 = S.ch.blk[s] * block_f;
      for (int j = 0; j < block_f; ++j, g4 += STAGE_COLS / 4) {
        float g[STAGE_COLS];
#pragma unroll
        for (int q = 0; q < STAGE_COLS / 4; ++q) {
          const float4 v = g4[q];
          g[4 * q] = v.x;
          g[4 * q + 1] = v.y;
          g[4 * q + 2] = v.z;
          g[4 * q + 3] = v.w;
        }
        const int fid = face0 + j;
#pragma unroll
        for (int k = 0; k < RPC; ++k) {
          if (!(any >> k & 1u) || !(enter >> k & 1u)) continue;
          const float tm = shared_origin_t(g, x[k], y[k], z[k]);
          if (tm < bt[k] || (tm == bt[k] && fid < bf[k])) {
            bt[k] = tm;
            bf[k] = fid;
          }
        }
      }
    }
    if (n < slots) break;
    b = bound();  // its first barrier: every warp is done with the chunk
  }
}

// Fill the shadow loop's chunk (warp 0, then the block synchronises):
// from position S.seq of the cluster order `ord` (nb floats), the
// clusters the wavefront admits (slab_scalar on the AABBs `boxes`, 6
// floats a cluster, with entry at most b), at most `slots`, each with
// its box from blo / bhi. Moves S.seq past the last cluster taken or
// tested; returns the clusters taken.
__device__ __forceinline__ int fill_order_chunk(
    Smem& S, const float* __restrict__ boxes, const float* __restrict__ ord,
    int nb, const float (&om)[3], const float (&oM)[3], const float (&dm)[3],
    const float (&dM)[3], float b, int slots, const float* __restrict__ blo,
    const float* __restrict__ bhi) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int seq = S.seq, n = 0;
    while (n < slots && seq < nb) {
      const int q = seq + lane;
      int c = 0;
      bool ok = false;
      if (q < nb) {
        c = (int)ord[q];
        float t0c;
        ok = slab_scalar(boxes + 6 * c, om, oM, dm, dM, t0c) && t0c <= b;
      }
      const unsigned adm = __ballot_sync(FULL, ok);
      const int take = min(__popc(adm), slots - n);
      const int rank = __popc(adm & ((1u << lane) - 1u));
      if (ok && rank < take) load_slot(S.ch, n + rank, c, SHADOW, blo, bhi);
      if (take < __popc(adm)) {  // full: resume after the last one taken
        unsigned m = adm;
        for (int i = 1; i < take; ++i) m &= m - 1u;
        seq += __ffs((int)m);
      } else {
        seq += 32;
      }
      n += take;
    }
    if (lane == 0) {
      S.ch.n = n;
      S.seq = seq;
    }
  }
  __syncthreads();
  return S.ch.n;
}

template <int MODE>
__global__ void __launch_bounds__(CT, 2)
frame_kernel(const float* __restrict__ tlb, const int* __restrict__ order,
             const float* __restrict__ cst, const float* __restrict__ dx,
             const float* __restrict__ dy, const float* __restrict__ dz,
             const float* __restrict__ texit, const float* __restrict__ fpack,
             const float* __restrict__ oterm, const float* __restrict__ dc,
             const float* __restrict__ blo, const float* __restrict__ bhi,
             int nb, int block_f, int ns, int nmat, int ray_major,
             float inv_near, float rcp_span, float* __restrict__ out,
             size_t n_rays) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * TILE_R + tid;
  const float o[3] = {cst[0], cst[1], cst[2]};
  float rx[RPC], ry[RPC], rz[RPC], cap[RPC], bt[RPC];
  int bf[RPC];
#pragma unroll
  for (int k = 0; k < RPC; ++k) {
    const size_t r = base + (size_t)k * CT;
    rx[k] = dx[r];
    ry[k] = dy[r];
    rz[k] = dz[r];
    cap[k] = texit[r];
  }
  sweep(S, tlb + (size_t)blockIdx.x * nb, order + (size_t)blockIdx.x * nb, nb,
        block_f, fpack, oterm, blo, bhi, o, rx, ry, rz, cap, bt, bf);

  const float ox = o[0], oy = o[1], oz = o[2];
  const int mat0 = C_SPH + SPH_STRIDE * ns;
  // one ray at a time: the tail's values of two rays at once would not
  // fit the registers
#pragma unroll 1
  for (int k = 0; k < RPC; ++k) {
    const size_t r = base + (size_t)k * CT;
    const float x = pick(rx, k), y = pick(ry, k), z = pick(rz, k);
    const float tm = pick(bt, k);
    const int face = pick(bf, k);
    const bool hit_m = tm < INFINITY;

    // ---- the winner's attributes (_ch_block's expressions), 0 on a miss
    float nd = 0.0f, gnx = 0.0f, gny = 0.0f, gnz = 0.0f, mat = 0.0f;
    float uvx = 0.0f, uvy = 0.0f;
    float vn[3] = {0.0f, 0.0f, 0.0f}, tg[3] = {0.0f, 0.0f, 0.0f},
          bg[3] = {0.0f, 0.0f, 0.0f};
    if (hit_m) {
      const float* g = fpack + (size_t)face * FPACK_COLS;
      const float* ot = oterm + (size_t)face * 8;
      nd = g[0] * x + g[1] * y + g[2] * z;
      const float h1 = ot[2] + tm * (g[6] * x + g[7] * y + g[8] * z);
      const float h2 = ot[3] + tm * (g[9] * x + g[10] * y + g[11] * z);
      const float u_n = h1 * g[12];
      const float v_n = h2 * g[12];
      const float w_n = 1.0f - u_n - v_n;
      uvx = u_n * g[16] + v_n * g[18] + w_n * g[20];
      uvy = u_n * g[17] + v_n * g[19] + w_n * g[21];
      gnx = g[13];
      gny = g[14];
      gnz = g[15];
      mat = g[22];
      if constexpr (MODE == MODE_NM) {
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          vn[ax] = u_n * g[30 + ax] + v_n * g[33 + ax] + w_n * g[36 + ax];
          tg[ax] = g[24 + ax];
          bg[ax] = g[27 + ax];
        }
      }
    }

    // ---- mesh shading factors ----
    const bool flip = nd > 0.0f;
    const float mnx = flip ? -gnx : gnx;
    const float mny = flip ? -gny : gny;
    const float mnz = flip ? -gnz : gnz;
    float mlx = cst[mat0], mly = cst[mat0 + 1], mlz = cst[mat0 + 2];
    for (int m = 1; m < nmat; ++m)
      if (mat == (float)m) {
        mlx = cst[mat0 + MAT_STRIDE * m];
        mly = cst[mat0 + MAT_STRIDE * m + 1];
        mlz = cst[mat0 + MAT_STRIDE * m + 2];
      }
    float m_lam = 0.0f, m_spec = 0.0f;
    if constexpr (MODE != MODE_NM)
      blinn(mnx, mny, mnz, x, y, z, mlx, mly, mlz, m_lam, m_spec);

    // ---- composite (reference pass order: spheres, then mesh) ----
    float depth = 1.0f, kind = 0.0f, wt = 0.0f, wnx = 0.0f, wny = 0.0f, wnz = 0.0f;
    float wlx = 0.0f, wly = 0.0f, wlz = 1.0f, wlam = 0.0f, wspec = 0.0f, wrel = 0.0f;
    for (int s = 0; s < ns; ++s) {
      const float* sp = cst + C_SPH + SPH_STRIDE * s;
      const float cx = sp[0], cy = sp[1], cz = sp[2];
      const float slx = sp[10], sly = sp[11], slz = sp[12];
      const float t = sphere_quadratic(cx, cy, cz, sp[3], ox, oy, oz, x, y, z, 0.0f);
      const bool hit = t < INFINITY;
      const float ts = hit ? t : 0.0f;
      const float pxs = ox + x * ts - cx;
      const float pys = oy + y * ts - cy;
      const float pzs = oz + z * ts - cz;
      float l = sqrtf(pxs * pxs + pys * pys + pzs * pzs);
      l = l > 0.0f ? l : 1.0f;
      const float snx = pxs / l, sny = pys / l, snz = pzs / l;
      float lam, spec;
      blinn(snx, sny, snz, x, y, z, slx, sly, slz, lam, spec);
      const float d = ((1.0f / (hit ? t : 1.0f)) - inv_near) * rcp_span;
      if (hit && d < depth) {
        depth = d;
        kind = (float)(s + 1);
        wt = t;
        wnx = snx;
        wny = sny;
        wnz = snz;
        wlx = slx;
        wly = sly;
        wlz = slz;
        wlam = lam;
        wspec = spec;
        wrel = (lam > 0.0f || spec > 0.0f) ? 1.0f : 0.0f;
      }
    }
    const float d_m = ((1.0f / (hit_m ? tm : 1.0f)) - inv_near) * rcp_span;
    if (hit_m && d_m < depth) {
      depth = d_m;
      kind = (float)(ns + 1);
      wt = tm;
      wnx = mnx;
      wny = mny;
      wnz = mnz;
      wlx = mlx;
      wly = mly;
      wlz = mlz;
      wlam = m_lam;
      wspec = m_spec;
      wrel = (m_lam > 0.0f || m_spec > 0.0f) ? 1.0f : 0.0f;
    }

    const float head[8] = {depth, kind, 0.0f, uvx, uvy, mat, wlam, wspec};
#pragma unroll
    for (int p = 0; p < 8; ++p)
      if (MODE != MODE_INKERNEL || p != 2) out[(size_t)p * n_rays + r] = head[p];
    if constexpr (MODE == MODE_SCHED) {
      const float w[8] = {wt, wnx, wny, wnz, wlx, wly, wlz, wrel};
#pragma unroll
      for (int p = 0; p < 8; ++p) out[(size_t)(8 + p) * n_rays + r] = w[p];
    } else if constexpr (MODE == MODE_NM) {
      const float w[12] = {mnx, mny, mnz, vn[0], vn[1], vn[2],
                           tg[0], tg[1], tg[2], bg[0], bg[1], bg[2]};
#pragma unroll
      for (int p = 0; p < 12; ++p) out[(size_t)(8 + p) * n_rays + r] = w[p];
    } else if constexpr (MODE == MODE_INKERNEL) {
      // ---- the winner's shadow ray, into shared memory ----
      const bool rel = kind > 0.0f && wrel > 0.0f;
      float ll = sqrtf(wlx * wlx + wly * wly + wlz * wlz);
      ll = ll > 0.0f ? ll : 1.0f;
      const float sd[3] = {rel ? -wlx / ll : 0.0f, rel ? -wly / ll : 0.0f,
                           rel ? -wlz / ll : 0.0f};
      const float tw = rel ? wt : 0.0f;
      const float sp[3] = {rel ? ox + x * tw + wnx * 1e-3f : PARK,
                           rel ? oy + y * tw + wny * 1e-3f : PARK,
                           rel ? oz + z * tw + wnz * 1e-3f : PARK};
      // sphere occlusion first: an occluded ray is not live
      bool occ = false;
      for (int s = 0; s < ns; ++s) {
        const float* c = cst + C_SPH + SPH_STRIDE * s;
        const float t = sphere_quadratic(c[0], c[1], c[2], c[3], sp[0], sp[1],
                                         sp[2], sd[0], sd[1], sd[2], 1e-3f);
        occ = occ || t < INFINITY;
      }
      // root-exit cap along the shadow direction
      float st0 = 0.0f, st1 = INFINITY;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        const float lo = cst[C_ROOT + ax], hi = cst[C_ROOT + 3 + ax];
        const float op = sp[ax], dp = sd[ax];
        const float d_safe = dp == 0.0f ? 1.0f : dp;
        const float ta = (lo - op) / d_safe;
        const float tb = (hi - op) / d_safe;
        float tn = fminf(ta, tb), tf = fmaxf(ta, tb);
        const bool inside = op >= lo && op <= hi;
        if (dp == 0.0f) {
          tn = inside ? 0.0f : INFINITY;
          tf = inside ? INFINITY : -INFINITY;
        }
        st0 = fmaxf(st0, tn);
        st1 = fminf(st1, tf);
      }
      const int i = tid + k * CT;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        S.sh.o[ax][i] = sp[ax];
        S.sh.d[ax][i] = sd[ax];
      }
      S.cap[i] = (rel && st1 >= st0) ? st1 * EXIT_GROW + 1e-6f : -1.0f;
      S.state[i] = !rel ? S_OFF : (occ ? S_OCC : S_LIVE);
    }
  }
  if constexpr (MODE == MODE_INKERNEL) {
    // ---- the shadow wavefront against the mesh clusters ----
    // its bounds over the relevant rays (the thread's own, read back):
    // origin min, direction min, origin max, direction max
    float v[12];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      v[i] = INFINITY;
      v[6 + i] = -INFINITY;
    }
#pragma unroll
    for (int k = 0; k < RPC; ++k) {
      const int i = tid + k * CT;
      if (S.state[i] == S_OFF) continue;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        v[ax] = fminf(v[ax], S.sh.o[ax][i]);
        v[3 + ax] = fminf(v[3 + ax], S.sh.d[ax][i]);
        v[6 + ax] = fmaxf(v[6 + ax], S.sh.o[ax][i]);
        v[9 + ax] = fmaxf(v[9 + ax], S.sh.d[ax][i]);
      }
    }
    block_minmax6(v, S.red);
    const float om[3] = {v[0], v[1], v[2]}, dm[3] = {v[3], v[4], v[5]};
    const float oM[3] = {v[6], v[7], v[8]}, dM[3] = {v[9], v[10], v[11]};
    const int blk0 = mat0 + MAT_STRIDE * nmat;
    const int shord0 = blk0 + 6 * nb;
    const int slots = slots_for(block_f);
    const Tile<NoExt> T{S.ch,  S.faces, S.list, nullptr,   {},
                        &S.sh, S.state, S.live, &S.n_live};
    if (tid == 0) S.seq = 0;
    // b is uniform: every thread holds the same
    float b = compact_live(S, true);
    while (b >= 0.0f) {
      const int n = fill_order_chunk(S, cst + blk0, cst + shord0, nb, om, oM,
                                     dm, dM, b, slots, blo, bhi);
      if (n == 0) break;
      run_chunk<SHADOW, NoExt, true>(T, fpack, FPACK_COLS, dc, 8, block_f,
                                     ray_major);
      b = compact_live(S, false);
    }
#pragma unroll
    for (int k = 0; k < RPC; ++k)
      out[(size_t)2 * n_rays + base + (size_t)k * CT] =
          S.state[tid + k * CT] == S_OCC ? 1.0f : 0.0f;
  }
}

template <int MODE>
int launch(const float* tlb, const int* order, const float* cst, const float* dx,
           const float* dy, const float* dz, const float* texit,
           const float* fpack, const float* oterm, const float* dc,
           const float* blo, const float* bhi, int n_tiles, int nb, int block_f,
           int ns, int nmat, int ray_major, float inv_near, float rcp_span,
           float* out, cudaStream_t stream) {
  constexpr int bytes = smem_bytes(MODE);
  cudaError_t err = cudaFuncSetAttribute(
      frame_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0)
    frame_kernel<MODE><<<n_tiles, CT, bytes, stream>>>(
        tlb, order, cst, dx, dy, dz, texit, fpack, oterm, dc, blo, bhi, nb,
        block_f, ns, nmat, ray_major, inv_near, rcp_span, out,
        (size_t)n_tiles * TILE_R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rt_frame(const float* tlb, const int* order, const float* cst,
                        const float* dx, const float* dy, const float* dz,
                        const float* texit, const float* fpack, const float* oterm,
                        const float* dc, const float* blo, const float* bhi,
                        int n_tiles, int nb, int block_f, int ns, int nmat,
                        int mode, int ray_major, float inv_near, float rcp_span,
                        float* out, void* stream) {
  if (block_f < 1 || block_f > MAX_BLOCK_F) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case MODE_NONE:
      return launch<MODE_NONE>(tlb, order, cst, dx, dy, dz, texit, fpack, oterm,
                               dc, blo, bhi, n_tiles, nb, block_f, ns, nmat,
                               ray_major, inv_near, rcp_span, out, s);
    case MODE_SCHED:
      return launch<MODE_SCHED>(tlb, order, cst, dx, dy, dz, texit, fpack, oterm,
                                dc, blo, bhi, n_tiles, nb, block_f, ns, nmat,
                                ray_major, inv_near, rcp_span, out, s);
    case MODE_NM:
      return launch<MODE_NM>(tlb, order, cst, dx, dy, dz, texit, fpack, oterm,
                             dc, blo, bhi, n_tiles, nb, block_f, ns, nmat,
                             ray_major, inv_near, rcp_span, out, s);
    case MODE_INKERNEL:
      return launch<MODE_INKERNEL>(tlb, order, cst, dx, dy, dz, texit, fpack,
                                   oterm, dc, blo, bhi, n_tiles, nb, block_f, ns,
                                   nmat, ray_major, inv_near, rcp_span, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// out[0..3] as cull_walk.cuh resources, for the kernel of `mode`.
extern "C" int rt_frame_resources(int mode, int* out) {
  switch (mode) {
    case MODE_NONE:
      return resources(frame_kernel<MODE_NONE>, smem_bytes(MODE_NONE), out);
    case MODE_SCHED:
      return resources(frame_kernel<MODE_SCHED>, smem_bytes(MODE_SCHED), out);
    case MODE_NM:
      return resources(frame_kernel<MODE_NM>, smem_bytes(MODE_NM), out);
    case MODE_INKERNEL:
      return resources(frame_kernel<MODE_INKERNEL>, smem_bytes(MODE_INKERNEL),
                       out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
