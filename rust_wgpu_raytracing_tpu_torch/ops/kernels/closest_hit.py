"""Closest hit for shared-origin rays, spheres fused (kernel K1).

The wrapper `closest_hit` launches csrc/closest_hit.cu for CUDA tensors
and runs `closest_hit_plain` for CPU tensors; it never falls back from
one to the other. Each launch adds 1 to the counter
`launches.closest_hit` (runtime/profiler.py).

Both compute the JAX package's _make_closest_hit_kernel: for each ray
the lexicographic (t, face) winner over the faces of every face block
its tile's schedule admits (misses keep t=inf, face=0), then the
winning sphere by strict nonlinear depth. The plain version loops over
face blocks, vectorised over the admitted tiles' rays, and models no
early termination: the (t, face) merge does not depend on visit order,
and termination only drops blocks that cannot win.

The kernel also takes the face blocks' boxes (blk_lo, blk_hi: one row
per block, the union of its cluster AABBs) and tests a block's faces
only for the rays whose line from the camera enters its box at or below
their best t so far (testing/raycull.py sched_closest_culled models that
walk), by pairs or, in a dense chunk, ray-major (common.RAY_MAJOR). The
winner is the same, a zero t with the winning face's own sign, so the
plain version ignores the boxes. Without boxes the kernel admits every
aimed ray of an admitted block.
"""

from __future__ import annotations

import torch

from ...runtime.profiler import count
from ..composite import depth_constants
from ..intersect import K_EPSILON
from ..rounding import sqrt
from . import common
from .build import check, library
from .common import (INT_MAX, TILE_R, admitted_tiles, block_rows, box_args,
                     is_cuda_call, open_boxes, ptr, require, stream_ptr)

F32_INF = float("inf")

def _check(tlb, order, dx, dy, dz, texit, fpack, oterm, sph, block_f):
    n_tiles, nb = tlb.shape
    r = n_tiles * TILE_R
    f = nb * block_f
    require(tlb, "tlb", torch.float32, (n_tiles, nb))
    require(order, "order", torch.int32, (n_tiles, nb))
    for name, x in (("dx", dx), ("dy", dy), ("dz", dz), ("texit", texit)):
        require(x, name, torch.float32, (r,))
    if fpack.dim() != 2 or fpack.shape[1] < 12:
        raise ValueError(f"fpack: shape {tuple(fpack.shape)}, expected (F, >=12)")
    require(fpack, "fpack", torch.float32, (f, fpack.shape[1]))
    require(oterm, "oterm", torch.float32, (f, 8))
    if sph.dim() != 1 or (sph.shape[0] - 3) % 4:
        raise ValueError(f"sph: shape {tuple(sph.shape)}, expected (3 + 4S,)")
    require(sph, "sph", torch.float32, sph.shape)
    if not 1 <= block_f <= 32:
        raise ValueError(f"block_f {block_f} outside 1..32")
    return n_tiles, nb, (sph.shape[0] - 3) // 4


def closest_hit(tlb, order, dx, dy, dz, texit, fpack, oterm, sph,
                blk_lo=None, blk_hi=None, *, block_f: int,
                near: float = 0.01, far: float = 100.0):
    """(t (R,) f32, face (R,) i32, sph_out) for R = tiles * 1024 rays.

    tlb/order (T, nb): per-tile entry bounds (+inf = culled) and visit
    order; texit (R,): per-ray root-exit caps; fpack (F, >=12): plane
    columns (N, g0, g1, g2); oterm (F, 8): [t_num, hc0, hc1, hc2, ...];
    sph (3 + 4S,): origin then (center, radius) per sphere; blk_lo /
    blk_hi (nb, 3) f32 the blocks' boxes, or None. sph_out is (t, id_f32,
    nx, ny, nz) of the winning sphere, None when S = 0."""
    n_tiles, nb, n_sph = _check(tlb, order, dx, dy, dz, texit, fpack,
                                oterm, sph, block_f)
    boxes = box_args(blk_lo, blk_hi, nb)
    if not is_cuda_call(tlb, order, dx, dy, dz, texit, fpack, oterm, sph,
                        *boxes):
        return closest_hit_plain(tlb, order, dx, dy, dz, texit, fpack,
                                 oterm, sph, *boxes, block_f=block_f,
                                 near=near, far=far)
    lo, hi = boxes or open_boxes(nb, dx.device)
    r = dx.shape[0]
    t = torch.empty(r, dtype=torch.float32, device=dx.device)
    face = torch.empty(r, dtype=torch.int32, device=dx.device)
    planes = [torch.empty(r if n_sph else 0, dtype=torch.float32,
                          device=dx.device) for _ in range(5)]
    inv_near, rcp_span = depth_constants(near, far)
    err = library().rt_closest_hit(
        ptr(tlb), ptr(order), ptr(dx), ptr(dy), ptr(dz), ptr(texit),
        ptr(fpack), ptr(oterm), ptr(sph), ptr(lo), ptr(hi), n_tiles, nb,
        block_f, fpack.shape[1], n_sph, inv_near, rcp_span,
        common.RAY_MAJOR["closest_hit"], ptr(t), ptr(face),
        *[ptr(p) for p in planes], stream_ptr(dx.device))
    check(err, "rt_closest_hit")
    count("launches.closest_hit")
    return t, face, (tuple(planes) if n_sph else None)


def closest_hit_plain(tlb, order, dx, dy, dz, texit, fpack, oterm, sph,
                      blk_lo=None, blk_hi=None, *, block_f: int,
                      near: float = 0.01, far: float = 100.0):
    """Plain PyTorch version of closest_hit (same arguments, same
    results bit for bit): every ray of an admitted block, the boxes
    unread."""
    # visit order and termination cannot change a winner
    del order, texit, blk_lo, blk_hi
    t, face = closest_shared_blocks(admitted_tiles(tlb), dx, dy, dz, fpack,
                                    oterm, block_f)
    n_sph = (sph.shape[0] - 3) // 4
    if n_sph == 0:
        return t, face, None
    return t, face, sphere_winner(sph, n_sph, dx, dy, dz, near, far)


def closest_shared_blocks(tiles_of_block, dx, dy, dz, fpack, oterm,
                          block_f: int):
    """(t, face): for each face block j, the shared-origin closest-hit
    merge (JAX _ch_block_tv, origin terms from oterm (F, >=4)) over the
    rays of tiles_of_block[j] (an index tensor, or None)."""
    r = dx.shape[0]
    t = torch.full((r,), F32_INF, dtype=torch.float32, device=dx.device)
    face = torch.zeros(r, dtype=torch.int32, device=dx.device)
    for j, tiles in enumerate(tiles_of_block):
        if tiles is None:
            continue
        rows = slice(j * block_f, (j + 1) * block_f)
        tm = shared_plane_t(fpack[rows], oterm[rows],
                            *(block_rows(v, tiles) for v in (dx, dy, dz)))
        merge_block(t, face, tiles, tm, j * block_f)
    return t, face


def shared_plane_t(g, o, x, y, z):
    """(BF, n) t of the shared-origin face test (JAX _ch_block_tv) of the
    faces g (BF, >=12) with origin terms o (BF, >=4) against rays x, y,
    z (n,); +inf where a face misses."""
    def c(m, k):
        return m[:, k:k + 1]

    ndotd = c(g, 0) * x + c(g, 1) * y + c(g, 2) * z
    tt = c(o, 0) / ndotd
    h0 = c(o, 1) + tt * (c(g, 3) * x + c(g, 4) * y + c(g, 5) * z)
    h1 = c(o, 2) + tt * (c(g, 6) * x + c(g, 7) * y + c(g, 8) * z)
    h2 = c(o, 3) + tt * (c(g, 9) * x + c(g, 10) * y + c(g, 11) * z)
    valid = ((ndotd.abs() >= K_EPSILON) & (tt >= 0.0) & (h0 >= 0.0)
             & (h1 >= 0.0) & (h2 >= 0.0))
    return torch.where(valid, tt, F32_INF)


def merge_block(t, face, tiles, tm, face_base: int) -> None:
    """Merge one face block's per-(face, ray) t (tm (BF, n), +inf where
    a face misses) into the (t, face) planes at the rays of `tiles`, in
    place: the block winner is the min t, the first face in block order
    on ties, and it replaces the incumbent by the lexicographic (t, face)
    rule (misses keep t=inf, face=0)."""
    lane = torch.arange(tm.shape[0], dtype=torch.int32,
                        device=tm.device)[:, None]
    tmin = tm.amin(dim=0)
    new_face = torch.where(tm == tmin, lane, INT_MAX).amin(dim=0) + face_base
    prev_t = block_rows(t, tiles)
    prev_f = block_rows(face, tiles)
    better = (tmin < prev_t) | ((tmin == prev_t) & (new_face < prev_f))
    t.view(-1, TILE_R)[tiles] = torch.where(
        better, tmin, prev_t).view(-1, TILE_R)
    face.view(-1, TILE_R)[tiles] = torch.where(
        better, new_face, prev_f).view(-1, TILE_R)


def sphere_winner(sph, n_sph, dx, dy, dz, near, far):
    """Per-ray winning sphere by strict nonlinear depth, in config order:
    (t, id_f32, nx, ny, nz), the kernel's sphere tail term for term."""
    inv_near, rcp_span = depth_constants(near, far)
    ox, oy, oz = sph[0], sph[1], sph[2]
    a = dx * dx + dy * dy + dz * dz
    best_d = torch.full_like(dx, F32_INF)
    best_t = torch.full_like(dx, F32_INF)
    best_id = torch.zeros_like(dx)
    best_cx = torch.zeros_like(dx)
    best_cy = torch.zeros_like(dx)
    best_cz = torch.zeros_like(dx)
    for i in range(n_sph):
        cx, cy, cz, radius = (sph[3 + 4 * i], sph[4 + 4 * i],
                              sph[5 + 4 * i], sph[6 + 4 * i])
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        b = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
        c = (ocx * ocx + ocy * ocy + ocz * ocz) - radius * radius
        disc = b * b - 4.0 * a * c
        sq = sqrt(disc.clamp_min(0.0))
        t1 = (-b - sq) / (2.0 * a)
        t2 = (-b + sq) / (2.0 * a)
        t = torch.where(t1 >= 0.0, t1, torch.where(t2 >= 0.0, t2, F32_INF))
        t = torch.where(disc < 0.0, F32_INF, t)
        d = torch.where(torch.isfinite(t),
                        ((1.0 / t) - inv_near) * rcp_span, F32_INF)
        upd = d < best_d
        best_d = torch.where(upd, d, best_d)
        best_t = torch.where(upd, t, best_t)
        best_id = torch.where(upd, float(i), best_id)
        best_cx = torch.where(upd, cx, best_cx)
        best_cy = torch.where(upd, cy, best_cy)
        best_cz = torch.where(upd, cz, best_cz)
    ts = torch.where(torch.isfinite(best_t), best_t, 0.0)
    nx = (ox + dx * ts) - best_cx
    ny = (oy + dy * ts) - best_cy
    nz = (oz + dz * ts) - best_cz
    l = sqrt(nx * nx + ny * ny + nz * nz)
    l = torch.where(l > 0, l, 1.0)
    return best_t, best_id, nx / l, ny / l, nz / l
