"""Shadow any-hit for per-ray origins (kernel K3).

The wrapper `anyhit` launches csrc/anyhit.cu for CUDA tensors and runs
`anyhit_plain` for CPU tensors; each launch adds 1 to the counter
`launches.anyhit` (runtime/profiler.py). Both compute the JAX package's
_make_anyhit_kernel: occ = 1 where an active ray hits some face of a
block its tile's schedule admits at t >= 1e-3. The plain version loops
over face blocks, vectorised over the admitted tiles' rays, without
early termination (an OR over hits does not depend on visit order, and
termination only drops blocks no live ray can reach).

The kernel also takes the face blocks' boxes (blk_lo, blk_hi: one row
per block, the union of its cluster AABBs) and tests a block's faces
only for the live rays whose own line enters its box
(testing/raycull.py sched_anyhit_culled models that walk), by pairs or,
in a dense chunk, ray-major (common.RAY_MAJOR). The result is the same
bits, so the plain version ignores the boxes. Without boxes the kernel
admits every live ray of an admitted block.
"""

from __future__ import annotations

import torch

from ...runtime.profiler import count
from ..intersect import K_EPSILON
from . import common
from .build import check, library
from .common import (TILE_R, admitted_tiles, block_rows, box_args,
                     is_cuda_call, open_boxes, ptr, require, stream_ptr)


def _check(tlb, order, planes, fpack, dc, block_f):
    n_tiles, nb = tlb.shape
    r = n_tiles * TILE_R
    f = nb * block_f
    require(tlb, "tlb", torch.float32, (n_tiles, nb))
    require(order, "order", torch.int32, (n_tiles, nb))
    for name, x in zip(("dx", "dy", "dz", "ox", "oy", "oz", "act", "texit"),
                       planes):
        require(x, name, torch.float32, (r,))
    if fpack.dim() != 2 or fpack.shape[1] < 12:
        raise ValueError(f"fpack: shape {tuple(fpack.shape)}, expected (F, >=12)")
    require(fpack, "fpack", torch.float32, (f, fpack.shape[1]))
    require(dc, "dc", torch.float32, (f, 8))
    if not 1 <= block_f <= 32:
        raise ValueError(f"block_f {block_f} outside 1..32")
    return n_tiles, nb


def anyhit(tlb, order, dx, dy, dz, ox, oy, oz, act, texit, fpack, dc,
           blk_lo=None, blk_hi=None, *, block_f: int):
    """occ (R,) f32 in {0, 1} for R = tiles * 1024 rays with per-ray
    origins. act (R,) f32: 1 for rays to test; dc (F, 8): [d, c0, c1,
    c2, ...]; blk_lo / blk_hi (nb, 3) f32 the blocks' boxes, or None;
    the rest as for closest_hit."""
    planes = (dx, dy, dz, ox, oy, oz, act, texit)
    n_tiles, nb = _check(tlb, order, planes, fpack, dc, block_f)
    boxes = box_args(blk_lo, blk_hi, nb)
    if not is_cuda_call(tlb, order, *planes, fpack, dc, *boxes):
        return anyhit_plain(tlb, order, *planes, fpack, dc, *boxes,
                            block_f=block_f)
    lo, hi = boxes or open_boxes(nb, dx.device)
    occ = torch.empty(dx.shape[0], dtype=torch.float32, device=dx.device)
    err = library().rt_anyhit(
        ptr(tlb), ptr(order), *[ptr(p) for p in planes], ptr(fpack),
        ptr(dc), ptr(lo), ptr(hi), n_tiles, nb, block_f, fpack.shape[1],
        common.RAY_MAJOR["anyhit"], ptr(occ), stream_ptr(dx.device))
    check(err, "rt_anyhit")
    count("launches.anyhit")
    return occ


def anyhit_plain(tlb, order, dx, dy, dz, ox, oy, oz, act, texit, fpack, dc,
                 blk_lo=None, blk_hi=None, *, block_f: int):
    """Plain PyTorch version of anyhit (same arguments, same results):
    every active ray of an admitted block, the boxes unread."""
    # an OR does not depend on visit order or termination
    del order, texit, blk_lo, blk_hi
    return anyhit_blocks(admitted_tiles(tlb), dx, dy, dz, ox, oy, oz, act,
                         fpack, dc, block_f)


def perray_plane_test(g, d, x, y, z, u, v, w):
    """(t, hit) of the faces g (BF, >=12) with plane constants d (BF, 8)
    against rays with directions x, y, z and origins u, v, w (each
    (n,)): JAX _chp_block_tv / _ah_block term for term, t >= 1e-3."""
    def c(m, k):
        return m[:, k:k + 1]

    ndotd = c(g, 0) * x + c(g, 1) * y + c(g, 2) * z
    ndoto = c(g, 0) * u + c(g, 1) * v + c(g, 2) * w
    tt = -(ndoto + c(d, 0)) / ndotd

    def edge(k, col):
        og = c(g, k) * u + c(g, k + 1) * v + c(g, k + 2) * w - c(d, col)
        dg = c(g, k) * x + c(g, k + 1) * y + c(g, k + 2) * z
        return og + tt * dg

    hit = ((ndotd.abs() >= K_EPSILON) & (tt >= 1e-3) & (edge(3, 1) >= 0.0)
           & (edge(6, 2) >= 0.0) & (edge(9, 3) >= 0.0))
    return tt, hit


def anyhit_blocks(tiles_of_block, dx, dy, dz, ox, oy, oz, act, fpack, dc,
                  block_f: int):
    """occ (R,) f32: for each face block j, the any-hit test of the rays
    of tiles_of_block[j] (an index tensor, or None for no tile)."""
    occ = torch.zeros_like(dx)
    for j, tiles in enumerate(tiles_of_block):
        if tiles is None:
            continue
        x, y, z, u, v, w, a = (block_rows(p, tiles)
                               for p in (dx, dy, dz, ox, oy, oz, act))
        _, hit = perray_plane_test(fpack[j * block_f:(j + 1) * block_f],
                                   dc[j * block_f:(j + 1) * block_f],
                                   x, y, z, u, v, w)
        any_hit = torch.where(hit, 1.0, 0.0).amax(dim=0) * a
        occ.view(-1, TILE_R)[tiles] = torch.maximum(
            block_rows(occ, tiles), any_hit).view(-1, TILE_R)
    return occ
