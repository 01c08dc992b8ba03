// Closest hit for rays with per-ray origins (the path tracer's bounce
// rays).
//
// Replaces the TPU kernel rust_wgpu_raytracing_tpu/ops/megakernel.py
// _make_closest_hit_perray_kernel + _chp_block_slim (reached from
// gbuffer_perray_pallas, VMEM branch): the same inputs (schedule
// tlb/order, direction and origin planes, root-exit caps, the (F, 40)
// face pack and the (F, 8) plane constants dc = [d, c0, c1, c2]) and the
// same outputs: the lexicographic (t, face) winner over the admitted
// faces at t >= 1e-3 (misses keep t = +inf, face = 0; rays with a zero
// direction never hit, their root-exit cap is -1).
//
// What bounds it on the H100: face-visit compute. Each visited
// (face, ray) pair costs ~52 FP32 operations and a divide (the origin
// terms are per ray, so twice K1's plane work), against 64 B per face
// block row and 28 B per ray of memory traffic.
// The design: each ray's (t, face) stays in registers for the whole
// walk, each admitted face block is staged once per 1024-ray tile in
// shared memory (plane columns 0-11 and dc 0-3), and the front-to-back
// walk stops at the first block whose entry bound exceeds every ray's
// min(best t, root exit) (sweep_closest_by below). The face test is
// rt_common.cuh perray_hit, perray_hit_cols's twin (K3, K8);
// -fmad=false so every product rounds, as in the plain version.
#include "rt_common.cuh"

namespace {

using namespace rt;

// The register sweep walks one 1024-ray schedule tile per CUDA block:
// 256 threads x 4 rays each, rays r = tile*1024 + threadIdx.x + k*256 so
// that neighbouring threads load neighbouring floats. The per-tile face
// blocks are visited in the order the host schedule gives (ascending
// entry-t lower bound `tlb`, culled blocks at +inf), and the walk stops
// at the first block whose bound exceeds the block-wide max of each
// ray's own cap. The cap is refreshed every REFRESH visits; a stale cap
// is the max over an older, larger state, so the visited set only
// grows and the result is unchanged (the merges are idempotent).
constexpr int THREADS = 256;
constexpr int RPT = TILE_R / THREADS;   // rays per thread
constexpr int REFRESH = 4;              // visits between bound refreshes

// Block-wide max of one float per thread; every thread gets the result.
// `red` holds THREADS/32 floats of shared memory. All threads must call.
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // previous readers of red are done
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < THREADS / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}

// Stage columns 0-11 of `pack` (row stride pack_cols) and columns 0-3 of
// `extra` (row stride extra_cols) for faces [ci*block_f, (ci+1)*block_f)
// into shared memory, STAGE_COLS floats per face.
__device__ __forceinline__ void stage_faces(float* dst, const float* pack,
                                            int pack_cols,
                                            const float* extra, int ci,
                                            int block_f, int extra_cols = 8) {
  for (int i = threadIdx.x; i < block_f * STAGE_COLS; i += THREADS) {
    const int f = i / STAGE_COLS;
    const int c = i % STAGE_COLS;
    const size_t row = (size_t)ci * block_f + f;
    dst[i] = c < 12 ? pack[row * pack_cols + c]
                    : extra[row * extra_cols + (c - 12)];
  }
}

// The closest-hit (t, face) sweep of one tile (JAX _merge_tf's
// lexicographic merge): for each of the thread's RPT rays, the smallest
// t over the admitted faces and, on a tie, the smallest face id; misses
// keep t = +inf, face = 0. `test(g, k)` returns ray k's t for the staged
// face g, +inf where it misses. `extra` (row stride 8) supplies staged
// columns 12-15. `faces` holds MAX_BLOCK_F * STAGE_COLS floats of shared
// memory, `red` THREADS/32 floats.
template <class Test>
__device__ __forceinline__ void sweep_closest_by(
    const float* __restrict__ tl, const int* __restrict__ ord, int nb,
    int block_f, const float* __restrict__ fpack, int fpack_cols,
    const float* __restrict__ extra, const float (&cap)[RPT],
    float (&bt)[RPT], int (&bf)[RPT], float* faces, float* red, Test test) {
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    bt[k] = INFINITY;
    bf[k] = 0;
  }
  auto bound = [&]() {
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < RPT; ++k) m = fmaxf(m, fminf(bt[k], cap[k]));
    return block_max(m, red);
  };
  float b = bound();
  for (int p = 0; p < nb; ++p) {
    const int ci = ord[p];
    if (!(tl[ci] <= b)) break;  // uniform: every thread reads the same values
    __syncthreads();            // the previous block's planes are consumed
    stage_faces(faces, fpack, fpack_cols, extra, ci, block_f);
    __syncthreads();
    const int face_base = ci * block_f;
    for (int j = 0; j < block_f; ++j) {
      const float* g = faces + j * STAGE_COLS;
      const int fid = face_base + j;
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const float tm = test(g, k);
        if (tm < bt[k] || (tm == bt[k] && fid < bf[k])) {
          bt[k] = tm;
          bf[k] = fid;
        }
      }
    }
    if ((p + 1) % REFRESH == 0) b = bound();
  }
}

__global__ void __launch_bounds__(THREADS)
closest_hit_perray_kernel(const float* __restrict__ tlb,
                          const int* __restrict__ order,
                          const float* __restrict__ dx, const float* __restrict__ dy,
                          const float* __restrict__ dz, const float* __restrict__ ox,
                          const float* __restrict__ oy, const float* __restrict__ oz,
                          const float* __restrict__ texit,
                          const float* __restrict__ fpack, const float* __restrict__ dc,
                          int nb, int block_f, int fpack_cols,
                          float* __restrict__ t_out, int* __restrict__ face_out) {
  __shared__ float faces[MAX_BLOCK_F * STAGE_COLS];
  __shared__ float red[THREADS / 32];

  const int tile = blockIdx.x;
  const size_t base = (size_t)tile * TILE_R + threadIdx.x;
  float rdx[RPT], rdy[RPT], rdz[RPT], rox[RPT], roy[RPT], roz[RPT];
  float cap[RPT], bt[RPT];
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
    cap[k] = texit[r];
  }
  sweep_closest_by(tlb + (size_t)tile * nb, order + (size_t)tile * nb, nb,
                   block_f, fpack, fpack_cols, dc, cap, bt, bf, faces, red,
                   [&](const float* g, int k) {
                     float t;
                     const bool valid = perray_hit(g, rdx[k], rdy[k], rdz[k],
                                                   rox[k], roy[k], roz[k], t);
                     return valid ? t : INFINITY;
                   });
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const size_t r = base + (size_t)k * THREADS;
    t_out[r] = bt[k];
    face_out[r] = bf[k];
  }
}

}  // namespace

extern "C" int rt_closest_hit_perray(const float* tlb, const int* order,
                                     const float* dx, const float* dy,
                                     const float* dz, const float* ox,
                                     const float* oy, const float* oz,
                                     const float* texit, const float* fpack,
                                     const float* dc, int n_tiles, int nb,
                                     int block_f, int fpack_cols, float* t,
                                     int* face, void* stream) {
  if (block_f < 1 || block_f > rt::MAX_BLOCK_F) return (int)cudaErrorInvalidValue;
  if (n_tiles > 0)
    closest_hit_perray_kernel<<<n_tiles, THREADS, 0, (cudaStream_t)stream>>>(
        tlb, order, dx, dy, dz, ox, oy, oz, texit, fpack, dc, nb, block_f,
        fpack_cols, t, face);
  return (int)cudaGetLastError();
}
