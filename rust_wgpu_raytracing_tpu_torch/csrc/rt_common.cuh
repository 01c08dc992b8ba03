// Shared pieces of the ray-tracing kernels (closest_hit.cu, anyhit.cu).
//
// Both sweep kernels walk one 1024-ray schedule tile per CUDA block:
// 256 threads x 4 rays each, rays r = tile*1024 + threadIdx.x + k*256 so
// that neighbouring threads load neighbouring floats. The per-tile face
// blocks are visited in the order the host schedule gives (ascending
// entry-t lower bound `tlb`, culled blocks at +inf), and the walk stops
// at the first block whose bound exceeds the block-wide max of each
// ray's own cap. The cap is refreshed every REFRESH visits; a stale cap
// is the max over an older, larger state, so the visited set only
// grows and the result is unchanged (the merges are idempotent).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rt {

constexpr int THREADS = 256;
constexpr int TILE_R = 1024;            // rays per schedule tile
constexpr int RPT = TILE_R / THREADS;   // rays per thread
constexpr int MAX_BLOCK_F = 32;         // faces per face block (8 or 32)
constexpr int STAGE_COLS = 16;          // plane columns 0-11 + 4 per-face terms
constexpr int REFRESH = 4;              // visits between bound refreshes
constexpr float K_EPSILON = 1e-6f;      // reference kEpsilon (f32)

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
// `extra` (row stride 8) for faces [ci*block_f, (ci+1)*block_f) into
// shared memory, STAGE_COLS floats per face.
__device__ __forceinline__ void stage_faces(float* dst, const float* pack,
                                            int pack_cols,
                                            const float* extra, int ci,
                                            int block_f) {
  for (int i = threadIdx.x; i < block_f * STAGE_COLS; i += THREADS) {
    const int f = i / STAGE_COLS;
    const int c = i % STAGE_COLS;
    const size_t row = (size_t)ci * block_f + f;
    dst[i] = c < 12 ? pack[row * pack_cols + c] : extra[row * 8 + (c - 12)];
  }
}

}  // namespace rt
