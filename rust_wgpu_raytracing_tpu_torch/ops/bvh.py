"""Acceleration structures: Morton ordering and face clusters.

The reference brute-forces every face per pixel
(triangle_list/compute.wgsl:190-202). Faces are instead sorted by the
Morton code of their centroid and grouped into fixed-size clusters (=
the intersection kernels' face block), so cluster AABBs are tight and
a per-tile interval slab test (ops/megakernel.py tile_cull_mask) can
skip whole clusters. The test is conservative, so culled rendering is
bit-identical to brute force.

All steps are NumPy on the host and run once per scene build.
accel="bvh" culls with the two-level cut of the LBVH these Morton
clusters imply (32 clusters to a superblock, ops/hier_cull.py), as the
JAX package's renders do; its explicit LBVH build and skip-pointer
walk (build_lbvh, linearize_bvh, bvh_walk_mask_words), which no JAX
render path runs, are not ported (ROADMAP.md).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of each value to every third bit."""
    v = v.astype(np.uint32)
    v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
    v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
    v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
    v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
    return v


def morton3d(points: np.ndarray) -> np.ndarray:
    """30-bit Morton codes for points normalized into the unit cube."""
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    ext = np.maximum(hi - lo, 1e-12)
    q = np.clip(((points - lo) / ext) * 1023.0, 0, 1023).astype(np.uint32)
    return (expand_bits(q[:, 0]) << 2) | (expand_bits(q[:, 1]) << 1) | \
        expand_bits(q[:, 2])


def morton_order(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """Face permutation sorting by centroid Morton code (stable, so ties
    keep original buffer order)."""
    centroids = (p0 + p1 + p2) / 3.0
    codes = morton3d(centroids)
    return np.argsort(codes, kind="stable")


def cluster_aabbs(p0, p1, p2, cluster: int,
                  num_real: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-cluster AABBs over Morton-ordered (padded) faces.

    p0/p1/p2: (F,3) PADDED face corners (padding rows arbitrary).
    Padding-only clusters get an inverted AABB (+inf lo, -inf hi) so
    every cull test fails and the kernel never visits them. Fully
    vectorized — runs in milliseconds at 500k+ faces.
    """
    f = p0.shape[0]
    assert f % cluster == 0
    nb = f // cluster
    valid = (np.arange(f) < num_real)[:, None]
    flo = np.where(valid, np.minimum(np.minimum(p0, p1), p2), np.inf)
    fhi = np.where(valid, np.maximum(np.maximum(p0, p1), p2), -np.inf)
    lo = flo.reshape(nb, cluster, 3).min(axis=1).astype(np.float32)
    hi = fhi.reshape(nb, cluster, 3).max(axis=1).astype(np.float32)
    return lo, hi
