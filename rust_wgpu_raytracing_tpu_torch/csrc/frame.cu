// The fused frame kernel: the whole geometric frame of one 1024-ray tile.
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
//
// What bounds it on the H100: the face-visit compute of the closest-hit
// sweep (as in closest_hit.cu) and, in the in-kernel shadow mode, of the
// any-hit cluster loop; everything after the sweep is ~300 FP32
// operations per ray per sphere pass, on registers. The design runs the
// shared sweep (rt_common.cuh sweep_closest) and then resolves the
// winner's attributes from ONE read of its face row instead of merging
// every attribute per visited block as the Pallas kernel does: the
// block merge picks exactly the winner's values (by value: the Pallas
// pick is a sum, which turns -0.0 into +0.0). Sphere passes, Blinn-Phong
// (pow32, the JAX kernel's multiply chain) and the composite stay in
// registers, and the planes are written once, coalesced. The in-kernel
// shadow loop reduces the wavefront's bounds across the block once,
// evaluates each cluster's slab admission once per block, and reuses
// the any-hit block test of anyhit.cu (rt_common.cuh anyhit_block).
// Operation order follows the JAX kernel term for term; -fmad=false.
#include <float.h>

#include "rt_common.cuh"

namespace {

using namespace rt;

constexpr int FPACK_COLS = 40;
constexpr int MODE_NONE = 0, MODE_SCHED = 1, MODE_NM = 2, MODE_INKERNEL = 3;
constexpr int C_ROOT = 3, C_SPH = 9, SPH_STRIDE = 13, MAT_STRIDE = 3;
constexpr float PARK = 1e9f;
// Python folds these in double before JAX rounds them to f32
constexpr float EXIT_GROW = (float)(1.0 + 1e-5);
constexpr float ENTRY_SHRINK = (float)(1.0 - 1e-5);

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

// Block-wide min of v[0..5] and max of v[6..11] (12 floats per thread);
// every thread gets the 12 results. `red` holds 12 * THREADS/32 floats.
__device__ __forceinline__ void block_minmax6(float (&v)[12], float* red) {
#pragma unroll
  for (int i = 0; i < 12; ++i)
    for (int o = 16; o > 0; o >>= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, v[i], o);
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
    for (int w = 1; w < THREADS / 32; ++w)
      m = i < 6 ? fminf(m, red[w * 12 + i]) : fmaxf(m, red[w * 12 + i]);
    v[i] = m;
  }
}

__global__ void __launch_bounds__(THREADS)
frame_kernel(const float* __restrict__ tlb, const int* __restrict__ order,
             const float* __restrict__ cst, const float* __restrict__ dx,
             const float* __restrict__ dy, const float* __restrict__ dz,
             const float* __restrict__ texit, const float* __restrict__ fpack,
             const float* __restrict__ oterm, const float* __restrict__ dc, int nb,
             int block_f, int ns, int nmat, int mode, float inv_near,
             float rcp_span, float* __restrict__ out, size_t n_rays) {
  __shared__ float faces[MAX_BLOCK_F * STAGE_COLS];
  __shared__ float red[12 * (THREADS / 32)];

  const int tile = blockIdx.x;
  const size_t base = (size_t)tile * TILE_R + threadIdx.x;
  float rx[RPT], ry[RPT], rz[RPT], cap[RPT], bt[RPT];
  int bf[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const size_t r = base + (size_t)k * THREADS;
    rx[k] = dx[r];
    ry[k] = dy[r];
    rz[k] = dz[r];
    cap[k] = texit[r];
  }
  sweep_closest(tlb + (size_t)tile * nb, order + (size_t)tile * nb, nb, block_f,
                fpack, FPACK_COLS, oterm, rx, ry, rz, cap, bt, bf, faces, red);

  const float ox = cst[0], oy = cst[1], oz = cst[2];
  const int mat0 = C_SPH + SPH_STRIDE * ns;
  // the in-kernel shadow wavefront, kept for the cluster loop
  float spx[RPT], spy[RPT], spz[RPT], sdx[RPT], sdy[RPT], sdz[RPT];
  float srel[RPT], socc[RPT], sexit[RPT];

#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const size_t r = base + (size_t)k * THREADS;
    const float x = rx[k], y = ry[k], z = rz[k];
    const float tm = bt[k];
    const bool hit_m = tm < INFINITY;

    // ---- the winner's attributes (_ch_block's expressions), 0 on a miss
    float nd = 0.0f, gnx = 0.0f, gny = 0.0f, gnz = 0.0f, mat = 0.0f;
    float uvx = 0.0f, uvy = 0.0f;
    float vn[3] = {0.0f, 0.0f, 0.0f}, tg[3] = {0.0f, 0.0f, 0.0f},
          bg[3] = {0.0f, 0.0f, 0.0f};
    if (hit_m) {
      const float* g = fpack + (size_t)bf[k] * FPACK_COLS;
      const float* o = oterm + (size_t)bf[k] * 8;
      nd = g[0] * x + g[1] * y + g[2] * z;
      const float h1 = o[2] + tm * (g[6] * x + g[7] * y + g[8] * z);
      const float h2 = o[3] + tm * (g[9] * x + g[10] * y + g[11] * z);
      const float u_n = h1 * g[12];
      const float v_n = h2 * g[12];
      const float w_n = 1.0f - u_n - v_n;
      uvx = u_n * g[16] + v_n * g[18] + w_n * g[20];
      uvy = u_n * g[17] + v_n * g[19] + w_n * g[21];
      gnx = g[13];
      gny = g[14];
      gnz = g[15];
      mat = g[22];
      if (mode == MODE_NM) {
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
    if (mode != MODE_NM) blinn(mnx, mny, mnz, x, y, z, mlx, mly, mlz, m_lam, m_spec);

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
    for (int p = 0; p < 8; ++p) out[(size_t)p * n_rays + r] = head[p];
    if (mode == MODE_SCHED) {
      const float w[8] = {wt, wnx, wny, wnz, wlx, wly, wlz, wrel};
#pragma unroll
      for (int p = 0; p < 8; ++p) out[(size_t)(8 + p) * n_rays + r] = w[p];
    } else if (mode == MODE_NM) {
      const float w[12] = {mnx, mny, mnz, vn[0], vn[1], vn[2],
                           tg[0], tg[1], tg[2], bg[0], bg[1], bg[2]};
#pragma unroll
      for (int p = 0; p < 12; ++p) out[(size_t)(8 + p) * n_rays + r] = w[p];
    } else if (mode == MODE_INKERNEL) {
      // ---- the winner's shadow ray ----
      const bool rel = kind > 0.0f && wrel > 0.0f;
      float ll = sqrtf(wlx * wlx + wly * wly + wlz * wlz);
      ll = ll > 0.0f ? ll : 1.0f;
      sdx[k] = rel ? -wlx / ll : 0.0f;
      sdy[k] = rel ? -wly / ll : 0.0f;
      sdz[k] = rel ? -wlz / ll : 0.0f;
      const float tw = rel ? wt : 0.0f;
      spx[k] = rel ? ox + x * tw + wnx * 1e-3f : PARK;
      spy[k] = rel ? oy + y * tw + wny * 1e-3f : PARK;
      spz[k] = rel ? oz + z * tw + wnz * 1e-3f : PARK;
      srel[k] = rel ? 1.0f : 0.0f;
      // sphere occlusion first: later cluster visits skip shadowed rays
      float occ = 0.0f;
      for (int s = 0; s < ns; ++s) {
        const float* sp = cst + C_SPH + SPH_STRIDE * s;
        const float t = sphere_quadratic(sp[0], sp[1], sp[2], sp[3], spx[k], spy[k],
                                         spz[k], sdx[k], sdy[k], sdz[k], 1e-3f);
        occ = fmaxf(occ, t < INFINITY ? 1.0f : 0.0f);
      }
      socc[k] = occ;
      // root-exit cap along the shadow direction
      float st0 = 0.0f, st1 = INFINITY;
      const float p3[3] = {spx[k], spy[k], spz[k]};
      const float d3[3] = {sdx[k], sdy[k], sdz[k]};
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        const float lo = cst[C_ROOT + ax], hi = cst[C_ROOT + 3 + ax];
        const float op = p3[ax], dp = d3[ax];
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
      sexit[k] = (rel && st1 >= st0) ? st1 * EXIT_GROW + 1e-6f : -1.0f;
    }
  }
  if (mode != MODE_INKERNEL) return;  // uniform across the block

  // ---- the shadow wavefront against the mesh clusters ----
  float v[12];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    v[i] = INFINITY;
    v[6 + i] = -INFINITY;
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    if (srel[k] <= 0.0f) continue;
    const float q[6] = {spx[k], spy[k], spz[k], sdx[k], sdy[k], sdz[k]};
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      v[i] = fminf(v[i], q[i]);
      v[6 + i] = fmaxf(v[6 + i], q[i]);
    }
  }
  block_minmax6(v, red);
  const float om[3] = {v[0], v[1], v[2]}, dm[3] = {v[3], v[4], v[5]};
  const float oM[3] = {v[6], v[7], v[8]}, dM[3] = {v[9], v[10], v[11]};

  const int blk0 = mat0 + MAT_STRIDE * nmat;
  const int shord0 = blk0 + 6 * nb;
  float bound = -1.0f;
  for (int seq = 0; seq < nb; ++seq) {
    if (seq % REFRESH == 0) {
      // a stale bound (older, less occluded state) only admits more
      // clusters; occ is an OR, so the result is unchanged
      float m = -1.0f;
#pragma unroll
      for (int k = 0; k < RPT; ++k)
        m = fmaxf(m, (srel[k] > 0.0f && socc[k] < 1.0f) ? sexit[k] : -1.0f);
      bound = block_max(m, red);
      if (bound < 0.0f) break;  // every ray occluded or parked
    }
    const int c = (int)cst[shord0 + seq];
    float t0c;
    const bool admit = slab_scalar(cst + blk0 + 6 * c, om, oM, dm, dM, t0c);
    if (!(admit && t0c <= bound)) continue;  // uniform across the block
    __syncthreads();
    stage_faces(faces, fpack, FPACK_COLS, dc, c, block_f);
    __syncthreads();
    anyhit_block(faces, block_f, sdx, sdy, sdz, spx, spy, spz, srel, socc);
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) out[(size_t)2 * n_rays + base + (size_t)k * THREADS] = socc[k];
}

}  // namespace

extern "C" int rt_frame(const float* tlb, const int* order, const float* cst,
                        const float* dx, const float* dy, const float* dz,
                        const float* texit, const float* fpack, const float* oterm,
                        const float* dc, int n_tiles, int nb, int block_f, int ns,
                        int nmat, int mode, float inv_near, float rcp_span, float* out,
                        void* stream) {
  if (block_f < 1 || block_f > rt::MAX_BLOCK_F || mode < MODE_NONE ||
      mode > MODE_INKERNEL)
    return (int)cudaErrorInvalidValue;
  if (n_tiles > 0)
    frame_kernel<<<n_tiles, rt::THREADS, 0, (cudaStream_t)stream>>>(
        tlb, order, cst, dx, dy, dz, texit, fpack, oterm, dc, nb, block_f, ns, nmat,
        mode, inv_near, rcp_span, out, (size_t)n_tiles * rt::TILE_R);
  return (int)cudaGetLastError();
}
