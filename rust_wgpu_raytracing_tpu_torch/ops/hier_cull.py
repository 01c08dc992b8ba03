"""accel="bvh": hierarchical tile-cone culling over a two-level LBVH cut.

Counterpart of the JAX package's ops/traverse_pallas.py. The scene's
faces are Morton-sorted, so the 32-face clusters grouped 32 to a
1024-face superblock form a fixed two-level cut of the LBVH (the same
granularity as the packed mask words). A tile's cone is tested against
each superblock's union box and, where it enters, against the
superblock's 32 cluster boxes (kernel K5, ops/kernels/hier_cull.py).
The words are a superset of the flat scan's (_mask_words "cull"), so
every accel renders the same frame.

Conservativeness as in JAX: the kernel multiplies by the direction
reciprocals where the flat scan divides, so each cluster box is first
widened by a margin relative to |box| + |origin| (_widen). Empty
padding boxes (+inf, -inf) pass through untouched and never hit.
hier_cull_fits keeps the JAX package's gate (its SMEM budget of AABB
tables), so accel="bvh" takes this path on exactly the scenes where
the JAX package does and the flat scan elsewhere.
"""

from __future__ import annotations

import torch

from .kernels import KERNELS, KernelSet

F32_INF = float("inf")
# the JAX kernel's SMEM budget for its AABB tables (supers + clusters, 6
# f32 each): ~25k clusters = ~800k faces
SMEM_AABB_BUDGET = 600_000
_EPS_REL = 1e-5
_EPS_ABS = 1e-6


def hier_cull_fits(n_clusters: int) -> bool:
    """True where the JAX package runs the two-level cull for
    accel="bvh" (its AABB tables fit SMEM); past it both packages take
    the flat scan."""
    b32 = -(-n_clusters // 32) * 32
    return (b32 + b32 // 32) * 24 <= SMEM_AABB_BUDGET


def _widen(lo, hi, omag):
    """Widen the AABBs by 1e-5 (|box| + omag) + 1e-6 (omag: a bound on
    |origin| over the tiles), leaving non-finite (padding) bounds as
    they are: inf - inf would poison a superblock's union."""
    m_lo = _EPS_REL * (lo.abs() + omag) + _EPS_ABS
    m_hi = _EPS_REL * (hi.abs() + omag) + _EPS_ABS
    wlo = torch.where(torch.isfinite(lo), lo - m_lo, lo)
    whi = torch.where(torch.isfinite(hi), hi + m_hi, hi)
    return wlo, whi


def cull_tables(blk_lo, blk_hi, omin, omax, nwords: int):
    """(sup (S, 6), clus (32 S, 6)) for S = nwords: the widened cluster
    boxes [lo xyz, hi xyz], padded with empty boxes to 32 per
    superblock, and each superblock's union box."""
    fin_lo = torch.where(torch.isfinite(omin), omin.abs(), 0.0)
    fin_hi = torch.where(torch.isfinite(omax), omax.abs(), 0.0)
    omag = torch.maximum(fin_lo.amax(), fin_hi.amax())
    lo, hi = _widen(blk_lo, blk_hi, omag)
    pad = nwords * 32 - lo.shape[0]
    if pad:
        lo = torch.cat([lo, lo.new_full((pad, 3), F32_INF)])
        hi = torch.cat([hi, hi.new_full((pad, 3), -F32_INF)])
    sup_lo = lo.reshape(nwords, 32, 3).amin(dim=1)
    sup_hi = hi.reshape(nwords, 32, 3).amax(dim=1)
    return (torch.cat([sup_lo, sup_hi], dim=1).contiguous(),
            torch.cat([lo, hi], dim=1).contiguous())


def hier_cull_words(blk_lo, blk_hi, omin, omax, dmin, dmax, *, nwords: int,
                    kernels: KernelSet = KERNELS):
    """(T, nwords) i32 packed per-(tile, cluster) activity words (JAX
    traverse_pallas.hier_cull_words): blk_lo/hi (B, 3) cluster AABBs in
    Morton order, omin..dmax (T, 3) tile cone bounds
    (ops/traverse.tile_ray_bounds). A superset of the flat scan's
    words, same layout. Callers gate on hier_cull_fits."""
    sup, clus = cull_tables(blk_lo, blk_hi, omin, omax, nwords)
    bounds = torch.cat([omin.T, omax.T, dmin.T, dmax.T]).contiguous()
    return kernels.hier_cull(sup, clus, bounds)
