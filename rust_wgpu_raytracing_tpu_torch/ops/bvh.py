"""Acceleration structures: Morton ordering and face clusters.

The reference brute-forces every face per pixel
(triangle_list/compute.wgsl:190-202). Faces are instead sorted by the
Morton code of their centroid and grouped into fixed-size clusters (=
the intersection kernels' face block), so cluster AABBs are tight and
a per-tile interval slab test (ops/traverse.py cull_mask) can
skip whole clusters. The test is conservative, so culled rendering is
bit-identical to brute force.

Over the cluster leaves Scene.build also builds the LBVH (a Karras
2012 binary radix tree, build_lbvh) and linearizes it in DFS order with
skip pointers (linearize_bvh) into SceneData.bvh_pack, which the
stackless walk ops/traverse.py bvh_walk_mask_words reads. No render path
runs that walk, in the JAX package either: accel="bvh" culls with the
two-level cut of the same Morton clusters (32 clusters to a superblock,
ops/hier_cull.py).

All steps run on the host once per scene build. build_lbvh takes the
C++ builder of native/rtnative.cpp (the port's copy of the JAX
package's) by default, as the JAX package's does; where the library is
unavailable, or with use_native=False, it runs the JAX package's NumPy
build, vectorized over all internal nodes with a fixed number of
search steps. Both give the same arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
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


# ---------------------------------------------------------------------------
# LBVH: binary radix tree over cluster leaves (Karras 2012)
# ---------------------------------------------------------------------------


@dataclass
class LBVH:
    """Binary radix tree. n leaves, n-1 internal nodes.

    Node ids: internal 0..n-2, leaves n-1..2n-2 (leaf i = node n-1+i).
    """

    left: np.ndarray  # (n-1,) i32 child node id
    right: np.ndarray  # (n-1,) i32
    parent: np.ndarray  # (2n-1,) i32, -1 for root
    node_lo: np.ndarray  # (2n-1, 3) f32
    node_hi: np.ndarray  # (2n-1, 3) f32
    n_leaves: int

    def refit(self, leaf_lo: np.ndarray, leaf_hi: np.ndarray) -> None:
        """Bottom-up AABB refit with unchanged topology: every internal
        node of one depth at once, deepest first (children before
        parents, as the JAX package's per-node loop orders them; min and
        max are exact, so the boxes are the same)."""
        n = self.n_leaves
        self.node_lo[n - 1:] = leaf_lo
        self.node_hi[n - 1:] = leaf_hi
        depth = self._depths()[: n - 1]
        for d in range(int(depth.max(initial=-1)), -1, -1):
            i = np.nonzero(depth == d)[0]
            l, r = self.left[i], self.right[i]
            self.node_lo[i] = np.minimum(self.node_lo[l], self.node_lo[r])
            self.node_hi[i] = np.maximum(self.node_hi[l], self.node_hi[r])

    def _depths(self) -> np.ndarray:
        """(2n-1,) depth of each node below the root, by levels from the
        root (node ids are not topologically ordered in a radix tree)."""
        n = self.n_leaves
        depths = np.zeros(2 * n - 1, np.int32)
        level, d = np.array([0]), 0
        while level.size:
            depths[level] = d
            internal = level[level < n - 1]
            level = np.concatenate([self.left[internal],
                                    self.right[internal]])
            d += 1
        return depths


def _bit_length(x: np.ndarray) -> np.ndarray:
    """int(x).bit_length() of non-negative int64 values below 2^53
    (frexp is exact there)."""
    return np.frexp(x.astype(np.float64))[1].astype(np.int64)


def _delta(codes: np.ndarray, i: np.ndarray, j: np.ndarray) -> np.ndarray:
    """Karras delta of index arrays: the common-prefix length of codes i
    and j, ties broken by index (32 + 64 - bit_length(i ^ j) for equal
    codes, as the JAX package's _delta), -1 where j is out of range."""
    n = len(codes)
    ok = (j >= 0) & (j < n)
    js = np.where(ok, j, 0)
    ci, cj = codes[i], codes[js]
    same = 32 + (64 - _bit_length(i ^ js))
    diff = 32 - _bit_length(ci ^ cj)
    return np.where(ok, np.where(ci == cj, same, diff), -1)


def build_lbvh(codes_sorted: np.ndarray, leaf_lo: np.ndarray,
               leaf_hi: np.ndarray, use_native: bool = True) -> LBVH:
    """Karras binary radix tree from SORTED Morton codes + leaf AABBs.
    Uses the C++ builder (native/rtnative.cpp) when available; else the
    JAX package's NumPy build, each step over all internal nodes at once
    (the searches run a fixed number of doubling and halving steps, each
    node keeping its own bounds)."""
    n = len(codes_sorted)
    if use_native and n > 1:
        from .. import native as nat

        built = nat.lbvh_build_native(codes_sorted, leaf_lo, leaf_hi)
        if built is not None:
            left, right, parent, node_lo, node_hi = built
            return LBVH(left=left, right=right, parent=parent,
                        node_lo=node_lo, node_hi=node_hi, n_leaves=n)
    assert n >= 1
    if n == 1:
        return LBVH(left=np.zeros(0, np.int32), right=np.zeros(0, np.int32),
                    parent=np.array([-1], np.int32),
                    node_lo=leaf_lo.copy(), node_hi=leaf_hi.copy(),
                    n_leaves=1)

    codes = codes_sorted.astype(np.uint32).astype(np.int64)
    i = np.arange(n - 1, dtype=np.int64)
    d = np.where(_delta(codes, i, i + 1) > _delta(codes, i, i - 1), 1, -1)
    delta_min = _delta(codes, i, i - d)
    # upper bound of the range length: double while the prefix holds
    lmax = np.full(n - 1, 2, np.int64)
    grow = _delta(codes, i, i + lmax * d) > delta_min
    while grow.any():
        lmax = np.where(grow, lmax * 2, lmax)
        grow = grow & (_delta(codes, i, i + lmax * d) > delta_min)
    # binary search of the range's other end
    l = np.zeros(n - 1, np.int64)
    t = lmax // 2
    while (t >= 1).any():
        step = (t >= 1) & (_delta(codes, i, i + (l + t) * d) > delta_min)
        l = np.where(step, l + t, l)
        t = t // 2
    j = i + l * d
    delta_node = _delta(codes, i, j)
    # binary search of the split: t = ceil(t / 2) until a step with t == 1
    s = np.zeros(n - 1, np.int64)
    t = (l + 1) // 2
    live = np.ones(n - 1, bool)
    while live.any():
        step = live & (_delta(codes, i, i + (s + t) * d) > delta_node)
        s = np.where(step, s + t, s)
        live = live & (t != 1)
        t = np.where(live, (t + 1) // 2, t)
    gamma = i + s * d + np.minimum(d, 0)

    lo_i, hi_i = np.minimum(i, j), np.maximum(i, j)
    left = np.where(lo_i == gamma, n - 1 + gamma, gamma).astype(np.int32)
    right = np.where(hi_i == gamma + 1, n - 1 + gamma + 1,
                     gamma + 1).astype(np.int32)
    parent = np.full(2 * n - 1, -1, np.int32)
    parent[left] = i
    parent[right] = i

    node_lo = np.zeros((2 * n - 1, 3), np.float32)
    node_hi = np.zeros((2 * n - 1, 3), np.float32)
    bvh = LBVH(left=left, right=right, parent=parent, node_lo=node_lo,
               node_hi=node_hi, n_leaves=n)
    bvh.refit(leaf_lo, leaf_hi)
    return bvh


def linearize_bvh(bvh: LBVH) -> np.ndarray:
    """DFS (preorder) skip-pointer linearization for STACKLESS traversal.

    Returns a (9, M) f32 node pack, M = 2n-1, rows:
      0-2  node AABB lo        3-5  node AABB hi
      6    hit_next  — next DFS position when the AABB test passes
                       (internal: first child = pos+1; leaf: = miss_next)
      7    miss_next — skip pointer: DFS position of the next node that
                       is NOT in this node's subtree (root: M = done)
      8    leaf id   — cluster index for leaves, -1 for internal nodes

    Both pointers are > pos, so a walk terminates in at most M steps and
    visits each node at most once; all ids are exact in f32 (M < 2^24).
    Vectorized level by level: subtree sizes accumulate bottom-up over
    BFS levels, then preorder positions and skip pointers propagate
    top-down (pos[left] = pos+1, pos[right] = pos+1+size[left];
    skip[left] = pos[right], skip[right] = skip[parent])."""
    n = bvh.n_leaves
    m = 2 * n - 1
    pack = np.zeros((9, m), np.float32)
    if n == 1:
        pack[0:3, 0] = bvh.node_lo[0]
        pack[3:6, 0] = bvh.node_hi[0]
        pack[6, 0] = 1.0
        pack[7, 0] = 1.0
        pack[8, 0] = 0.0
        return pack

    left, right = bvh.left, bvh.right  # indexed by internal node id
    ids = np.arange(m)
    is_leaf = ids >= n - 1

    # BFS levels from the root (internal node 0)
    levels = [np.array([0], np.int64)]
    while True:
        internal = levels[-1][levels[-1] < n - 1]
        if internal.size == 0:
            break
        levels.append(np.concatenate([left[internal], right[internal]]))

    size = np.ones(m, np.int64)
    for lev in reversed(levels):
        internal = lev[lev < n - 1]
        if internal.size:
            size[internal] = 1 + size[left[internal]] + size[right[internal]]

    pos = np.zeros(m, np.int64)
    skip = np.zeros(m, np.int64)
    skip[0] = m
    for lev in levels:
        internal = lev[lev < n - 1]
        if internal.size == 0:
            continue
        l, r = left[internal], right[internal]
        pos[l] = pos[internal] + 1
        pos[r] = pos[internal] + 1 + size[l]
        skip[l] = pos[r]
        skip[r] = skip[internal]

    pack[0:3, pos] = bvh.node_lo.T
    pack[3:6, pos] = bvh.node_hi.T
    pack[6, pos] = np.where(is_leaf, skip, pos + 1).astype(np.float32)
    pack[7, pos] = skip.astype(np.float32)
    pack[8, pos] = np.where(is_leaf, ids - (n - 1), -1).astype(np.float32)
    return pack


def tile_cull_mask_np(dmin, dmax, omin, omax, blk_lo, blk_hi):
    """NumPy reference of the interval slab test (the torch version is
    ops/traverse.py cull_mask). Shapes: (T,3) tile dir/origin
    bounds, (B,3) cluster AABBs -> (T,B) bool."""
    t_cnt, b_cnt = dmin.shape[0], blk_lo.shape[0]
    out = np.zeros((t_cnt, b_cnt), bool)
    for ti in range(t_cnt):
        for bi in range(b_cnt):
            t0, t1 = 0.0, np.inf
            ok = True
            for a in range(3):
                A = blk_lo[bi, a] - omax[ti, a]
                B = blk_hi[bi, a] - omin[ti, a]
                dn, dx = dmin[ti, a], dmax[ti, a]
                if B < A:
                    ok = False
                    break
                if dn <= 0.0 <= dx:
                    continue  # t-range unconstrained (conservative)
                if dn > 0.0:
                    lo_t = A / dx if A > 0.0 else 0.0
                    hi_t = B / dn if B >= 0.0 else -1.0
                else:  # dx < 0
                    lo_t = B / dn if B < 0.0 else 0.0
                    hi_t = A / dx if A <= 0.0 else -1.0
                if hi_t < 0.0:
                    ok = False
                    break
                t0 = max(t0, lo_t)
                t1 = min(t1, hi_t)
                if t0 > t1:
                    ok = False
                    break
            out[ti, bi] = ok
    return out
