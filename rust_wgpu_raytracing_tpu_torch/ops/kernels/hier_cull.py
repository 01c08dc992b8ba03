"""The two-level LBVH-cut cull of accel="bvh" (kernel K5).

The wrapper `hier_cull` launches csrc/hier_cull.cu for CUDA tensors and
runs `hier_cull_plain` for CPU tensors; each launch adds 1 to the
counter `launches.hier_cull` (runtime/profiler.py). Both compute the JAX
package's traverse_pallas._make_smem_kernel: for each tile's ray cone
(12 bound planes) and each superblock, the slab test of the superblock's
union box and, where it passes, of its 32 cluster boxes, packed into one
i32 word (bit c = cluster 32 s + c). The plain version tests a chunk of
superblocks for every tile at once.
"""

from __future__ import annotations

import torch

from ...runtime.profiler import count
from .build import check, library
from .common import is_cuda_call, ptr, require, stream_ptr

F32_INF = float("inf")
CLUSTERS = 32  # clusters per superblock = bits per word
# (tile, box) pairs per step of the plain version
PLAIN_PAIRS = 1 << 22


def _check(sup, clus, bounds):
    n_super = sup.shape[0] if sup.dim() == 2 else -1
    require(sup, "sup", torch.float32, (n_super, 6))
    require(clus, "clus", torch.float32, (n_super * CLUSTERS, 6))
    if bounds.dim() != 2 or bounds.shape[0] != 12:
        raise ValueError(f"bounds: shape {tuple(bounds.shape)}, expected "
                         f"(12, T)")
    require(bounds, "bounds", torch.float32, bounds.shape)
    return bounds.shape[1], n_super


def hier_cull(sup, clus, bounds):
    """words (T, S) i32. sup (S, 6): superblock union boxes [lo xyz, hi
    xyz]; clus (32 S, 6): the cluster boxes, superblock-major; bounds
    (12, T): the tiles' omin xyz, omax xyz, dmin xyz, dmax xyz."""
    n_tiles, n_super = _check(sup, clus, bounds)
    if not is_cuda_call(sup, clus, bounds):
        return hier_cull_plain(sup, clus, bounds)
    words = torch.empty((n_tiles, n_super), dtype=torch.int32,
                        device=sup.device)
    err = library().rt_hier_cull(ptr(sup), ptr(clus), ptr(bounds), n_tiles,
                                 n_super, ptr(words), stream_ptr(sup.device))
    check(err, "rt_hier_cull")
    count("launches.hier_cull")
    return words


def _cone(bounds):
    """The per-tile slab-test invariants (JAX _dir_pre) as (T, 1)
    columns: origin bounds, direction predicates and reciprocals."""
    col = [bounds[i][:, None] for i in range(12)]
    pre = {"omin": col[0:3], "omax": col[3:6], "mixed": [], "zero": [],
           "pos": [], "inv_dp": [], "inv_dn": []}
    for k in range(3):
        dn, dp = col[6 + k], col[9 + k]
        pre["mixed"].append((dn <= 0.0) & (dp >= 0.0))
        pre["zero"].append((dn == 0.0) & (dp == 0.0))
        pre["pos"].append(dn > 0.0)
        dp_s = torch.where(dp.abs() > 1e-30, dp, 1e-30)
        dn_s = torch.where(dn.abs() > 1e-30, dn, 1e-30)
        pre["inv_dp"].append(1.0 / dp_s)
        pre["inv_dn"].append(1.0 / dn_s)
    return pre


def box_test(box, pre):
    """JAX _box_test: (T, N) bool, the tiles' cones (pre, (T, 1)
    columns) against N boxes (box (N, 6))."""
    ok = None
    lo_t, hi_t = box.new_zeros(()), box.new_full((), F32_INF)
    for k in range(3):
        a = box[None, :, k] - pre["omax"][k]
        b = box[None, :, 3 + k] - pre["omin"][k]
        axis_ok = b >= a
        ok = axis_ok if ok is None else ok & axis_ok
        inv_dp, inv_dn = pre["inv_dp"][k], pre["inv_dn"][k]
        lo_pos = torch.where(a > 0.0, a * inv_dp, 0.0)
        hi_pos = torch.where(b >= 0.0, b * inv_dn, -1.0)
        lo_neg = torch.where(b < 0.0, b * inv_dn, 0.0)
        hi_neg = torch.where(a <= 0.0, a * inv_dp, -1.0)
        mixed, zero, pos = pre["mixed"][k], pre["zero"][k], pre["pos"][k]
        l = torch.where(mixed, 0.0, torch.where(pos, lo_pos, lo_neg))
        h = torch.where(mixed, F32_INF, torch.where(pos, hi_pos, hi_neg))
        h = torch.where(zero & ~((a <= 0.0) & (b >= 0.0)), -1.0, h)
        lo_t = torch.maximum(lo_t, l)
        hi_t = torch.minimum(hi_t, h)
    return ok & (hi_t >= 0.0) & (hi_t >= lo_t)


def hier_cull_plain(sup, clus, bounds):
    """Plain PyTorch version of hier_cull (same arguments, same words),
    chunked over superblocks to at most PLAIN_PAIRS (tile, box) pairs."""
    n_tiles, n_super = bounds.shape[1], sup.shape[0]
    pre = _cone(bounds)
    shift = torch.arange(CLUSTERS, dtype=torch.int64, device=sup.device)
    chunk = max(1, PLAIN_PAIRS // max(1, n_tiles * CLUSTERS))
    out = []
    for s0 in range(0, n_super, chunk):
        s1 = min(n_super, s0 + chunk)
        s_hit = box_test(sup[s0:s1], pre)  # (T, C)
        c_hit = box_test(clus[s0 * CLUSTERS:s1 * CLUSTERS], pre)
        c_hit = c_hit.reshape(n_tiles, s1 - s0, CLUSTERS) & s_hit[:, :, None]
        out.append((c_hit.to(torch.int64) << shift).sum(dim=2))
    words = torch.cat(out, dim=1) if out else torch.zeros(
        (n_tiles, 0), dtype=torch.int64, device=sup.device)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)
