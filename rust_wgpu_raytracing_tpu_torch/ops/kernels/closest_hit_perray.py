"""Closest hit for rays with per-ray origins (kernel K7).

The wrapper `closest_hit_perray` launches csrc/closest_hit_perray.cu for
CUDA tensors and runs `closest_hit_perray_plain` for CPU tensors; it
never falls back from one to the other. Each launch adds 1 to the
counter `launches.closest_hit_perray` (runtime/profiler.py).

Both compute the JAX package's _make_closest_hit_perray_kernel: for
each ray the lexicographic (t, face) winner at t >= 1e-3 over the faces
of every face block its tile's schedule admits (misses keep t=inf,
face=0). The plain version loops over face blocks, vectorised over the
admitted tiles' rays, without early termination (the merge does not
depend on visit order, and termination only drops blocks that cannot
win). It is the unit the fused extend+shadow kernel (K8) is held to.

The kernel also takes the face blocks' boxes (blk_lo, blk_hi: one row
per block, the union of its cluster AABBs) and tests a block's faces
only for the rays whose own line enters its box at or below their best
t so far (testing/raycull.py sched_perray_culled models that walk), by
pairs. The winner is the same, so the plain version ignores the boxes.
Without boxes the kernel admits every aimed ray of an admitted block.
"""

from __future__ import annotations

import torch

from ...runtime.profiler import count
from .anyhit import perray_plane_test
from .build import check, library
from .closest_hit import merge_block
from .common import (TILE_R, admitted_tiles, block_rows, box_args,
                     is_cuda_call, open_boxes, ptr, require, stream_ptr)

F32_INF = float("inf")

PLANES = ("dx", "dy", "dz", "ox", "oy", "oz")


def _check(tlb, order, planes, texit, fpack, dc, block_f):
    n_tiles, nb = tlb.shape
    r = n_tiles * TILE_R
    f = nb * block_f
    require(tlb, "tlb", torch.float32, (n_tiles, nb))
    require(order, "order", torch.int32, (n_tiles, nb))
    for name, x in zip(PLANES + ("texit",), (*planes, texit)):
        require(x, name, torch.float32, (r,))
    if fpack.dim() != 2 or fpack.shape[1] < 12:
        raise ValueError(f"fpack: shape {tuple(fpack.shape)}, expected (F, >=12)")
    require(fpack, "fpack", torch.float32, (f, fpack.shape[1]))
    require(dc, "dc", torch.float32, (f, 8))
    if not 1 <= block_f <= 32:
        raise ValueError(f"block_f {block_f} outside 1..32")
    return n_tiles, nb


def closest_hit_perray(tlb, order, dx, dy, dz, ox, oy, oz, texit, fpack, dc,
                       blk_lo=None, blk_hi=None, *, block_f: int):
    """(t (R,) f32, face (R,) i32) for R = tiles * 1024 rays with per-ray
    origins. tlb/order (T, nb) and texit (R,) as for closest_hit; dc
    (F, 8): [d, c0, c1, c2, ...]; blk_lo / blk_hi (nb, 3) f32 the
    blocks' boxes, or None."""
    planes = (dx, dy, dz, ox, oy, oz)
    n_tiles, nb = _check(tlb, order, planes, texit, fpack, dc, block_f)
    boxes = box_args(blk_lo, blk_hi, nb)
    if not is_cuda_call(tlb, order, *planes, texit, fpack, dc, *boxes):
        return closest_hit_perray_plain(tlb, order, *planes, texit, fpack,
                                        dc, *boxes, block_f=block_f)
    lo, hi = boxes or open_boxes(nb, dx.device)
    r = dx.shape[0]
    t = torch.empty(r, dtype=torch.float32, device=dx.device)
    face = torch.empty(r, dtype=torch.int32, device=dx.device)
    err = library().rt_closest_hit_perray(
        ptr(tlb), ptr(order), *[ptr(p) for p in planes], ptr(texit),
        ptr(fpack), ptr(dc), ptr(lo), ptr(hi), n_tiles, nb, block_f,
        fpack.shape[1], ptr(t), ptr(face), stream_ptr(dx.device))
    check(err, "rt_closest_hit_perray")
    count("launches.closest_hit_perray")
    return t, face


def closest_hit_perray_plain(tlb, order, dx, dy, dz, ox, oy, oz, texit,
                             fpack, dc, blk_lo=None, blk_hi=None, *,
                             block_f: int):
    """Plain PyTorch version of closest_hit_perray (same arguments, same
    results bit for bit): every ray of an admitted block, the boxes
    unread."""
    # visit order and termination cannot change a winner
    del order, texit, blk_lo, blk_hi
    return closest_perray_blocks(admitted_tiles(tlb), dx, dy, dz, ox, oy,
                                 oz, fpack, dc, block_f)


def closest_perray_blocks(tiles_of_block, dx, dy, dz, ox, oy, oz, fpack, dc,
                          block_f: int):
    """(t, face): for each face block j, the per-ray-origin closest-hit
    merge over the rays of tiles_of_block[j] (an index tensor, or None)."""
    r = dx.shape[0]
    t = torch.full((r,), F32_INF, dtype=torch.float32, device=dx.device)
    face = torch.zeros(r, dtype=torch.int32, device=dx.device)
    for j, tiles in enumerate(tiles_of_block):
        if tiles is None:
            continue
        rays = [block_rows(v, tiles) for v in (dx, dy, dz, ox, oy, oz)]
        tt, valid = perray_plane_test(fpack[j * block_f:(j + 1) * block_f],
                                      dc[j * block_f:(j + 1) * block_f],
                                      *rays)
        merge_block(t, face, tiles, torch.where(valid, tt, F32_INF),
                    j * block_f)
    return t, face
