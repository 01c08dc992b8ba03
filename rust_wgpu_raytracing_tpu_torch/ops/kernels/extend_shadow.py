"""Fused extend + shadow sweep of the path tracer (kernel K8).

The wrapper `extend_shadow` launches csrc/extend_shadow.cu for CUDA
tensors and runs `extend_shadow_plain` for CPU tensors; it never falls
back from one to the other. Each launch adds 1 to the counter
`launches.extend_shadow` (runtime/profiler.py).

Both compute the JAX package's _make_fused_extend_shadow_kernel: one
walk over the face blocks of the union of two packed activity masks,
words_a (the extension rays) and words_b (the shadow rays). A block
whose words_a bit is set merges the extension rays' lexicographic
(t, face) winner at t >= 1e-3 (kernel K7's test); a block whose words_b
bit is set ORs the active shadow rays' hits into occ (kernel K3's test).
So the plain version is K7's block merge over the words_a tiles plus
K3's over the words_b tiles.

The kernel also takes the face blocks' boxes (blk_lo, blk_hi: the
scene's cluster AABBs, one row per block) and tests a block's faces
only for the rays whose own line enters its box, a closest-hit ray only
where that entry lies at or below its best t so far (testing/raycull.py
models that walk). The results are the same bits, so the plain version ignores
the boxes. Without boxes the kernel admits every ray of an admitted
block.
"""

from __future__ import annotations

import torch

from ...runtime.profiler import count
from .anyhit import anyhit_blocks
from .build import check, library
from .closest_hit_perray import closest_perray_blocks
from .common import (TILE_R, box_args, is_cuda_call, open_boxes, ptr,
                     require, stream_ptr)

PLANES = ("dx", "dy", "dz", "ox", "oy", "oz",
          "sdx", "sdy", "sdz", "sox", "soy", "soz", "act")


def _check(words_a, words_b, planes, fpack, dc, block_f):
    r = planes[0].shape[0]
    if r % TILE_R:
        raise ValueError(f"{r} rays: not a multiple of {TILE_R}")
    n_tiles = r // TILE_R
    if fpack.dim() != 2 or fpack.shape[1] < 12:
        raise ValueError(f"fpack: shape {tuple(fpack.shape)}, expected (F, >=12)")
    f = fpack.shape[0]
    if not 1 <= block_f <= 32 or f % block_f:
        raise ValueError(f"block_f {block_f}: outside 1..32 or not a "
                         f"divisor of {f} faces")
    nb = f // block_f
    nwords = -(-nb // 32)
    for name, x in zip(PLANES, planes):
        require(x, name, torch.float32, (r,))
    require(fpack, "fpack", torch.float32, (f, fpack.shape[1]))
    require(dc, "dc", torch.float32, (f, 8))
    require(words_a, "words_a", torch.int32, (n_tiles * nwords,))
    require(words_b, "words_b", torch.int32, (n_tiles * nwords,))
    return n_tiles, nb, nwords


def extend_shadow(words_a, words_b, dx, dy, dz, ox, oy, oz, sdx, sdy, sdz,
                  sox, soy, soz, act, fpack, dc, blk_lo=None, blk_hi=None, *,
                  block_f: int):
    """(t (R,) f32, face (R,) i32, occ (R,) f32) for R = tiles * 1024.
    words_a / words_b (tiles * nwords,) i32: bit k of word w of a tile =
    face block 32w + k admitted for the extension / shadow rays; dx..oz
    the extension rays, sdx..soz the shadow rays, act (R,) f32 1 for
    shadow rays to test; fpack (F, >=12) and dc (F, 8) as for anyhit;
    blk_lo / blk_hi (F / block_f, 3) f32 the blocks' boxes, or None."""
    planes = (dx, dy, dz, ox, oy, oz, sdx, sdy, sdz, sox, soy, soz, act)
    n_tiles, nb, nwords = _check(words_a, words_b, planes, fpack, dc,
                                 block_f)
    boxes = box_args(blk_lo, blk_hi, nb)
    if not is_cuda_call(words_a, words_b, *planes, fpack, dc, *boxes):
        return extend_shadow_plain(words_a, words_b, *planes, fpack, dc,
                                   *boxes, block_f=block_f)
    lo, hi = boxes or open_boxes(nb, dx.device)
    r = dx.shape[0]
    t = torch.empty(r, dtype=torch.float32, device=dx.device)
    face = torch.empty(r, dtype=torch.int32, device=dx.device)
    occ = torch.empty(r, dtype=torch.float32, device=dx.device)
    err = library().rt_extend_shadow(
        ptr(words_a), ptr(words_b), *[ptr(p) for p in planes], ptr(fpack),
        ptr(dc), ptr(lo), ptr(hi), n_tiles, nwords, nb, block_f,
        fpack.shape[1], ptr(t), ptr(face), ptr(occ), stream_ptr(dx.device))
    check(err, "rt_extend_shadow")
    count("launches.extend_shadow")
    return t, face, occ


def mask_tiles(words, n_tiles: int, nb: int):
    """For each face block j, the tiles whose packed mask word sets bit j
    (an index tensor on the words' device), or None."""
    nwords = words.shape[0] // n_tiles
    w = words.view(n_tiles, nwords).to(torch.int64) & 0xFFFFFFFF
    c = torch.arange(nb, device=words.device)
    bits = ((w[:, c >> 5] >> (c & 31)) & 1).bool().T.cpu()
    out = []
    for j in range(nb):
        idx = bits[j].nonzero().squeeze(1)
        out.append(idx.to(words.device) if idx.numel() else None)
    return out


def extend_shadow_plain(words_a, words_b, dx, dy, dz, ox, oy, oz, sdx, sdy,
                        sdz, sox, soy, soz, act, fpack, dc, blk_lo=None,
                        blk_hi=None, *, block_f: int):
    """Plain PyTorch version of extend_shadow (same arguments, same
    results bit for bit): every ray of an admitted block, the boxes
    unread."""
    del blk_lo, blk_hi
    n_tiles = dx.shape[0] // TILE_R
    nb = fpack.shape[0] // block_f
    t, face = closest_perray_blocks(mask_tiles(words_a, n_tiles, nb),
                                    dx, dy, dz, ox, oy, oz, fpack, dc,
                                    block_f)
    occ = anyhit_blocks(mask_tiles(words_b, n_tiles, nb), sdx, sdy, sdz,
                        sox, soy, soz, act, fpack, dc, block_f)
    return t, face, occ
