"""The streamed sweeps over superblock words (kernels K9, K10, K11).

Three wrappers over csrc/stream_sweep.cu, each launching its kernel for
CUDA tensors and running its plain version for CPU tensors, each with
its own launch counter. Each takes the 32-face blocks' boxes too and
tests a block only for the rays whose own line enters its box, a
closest-hit ray only where that entry lies at or below its best t so far
(testing/raycull.py models the walks; the plain versions ignore the
boxes: the results are the same values):

- `stream_closest_hit` (K9, JAX _make_streaming_ch_slim_kernel): the
  shared-origin (t, face) winner, origin terms from the frame's (F, 8)
  oterm, the boxes tested from the camera origin;
- `stream_closest_hit_perray` (K10, _make_streaming_chp_slim_kernel):
  the per-ray-origin winner at t >= 1e-3, plane constants from the
  record's columns SC_DC..;
- `stream_anyhit` (K11, _make_streaming_anyhit_kernel): occ = act where
  an active ray hits a face at t >= 1e-3; the walk box-tests live rays
  only.

Their schedule: rays come in batches of nsub 1024-ray subtiles; mask3
(NB, nsub+1, S) i32 holds each subtile's packed word per superblock (a
word covers 32 blocks of 32 faces) and row nsub their union; tlb3 (NB,
nsub+1, S) f32 the entry lower bounds (+inf where a word is empty; row
nsub the batch minimum); order2 (NB, S) i32 the batch's visit order,
ascending in the minimum. Face ids are 1024 s + 32 b + lane.

K9 and K11 cut long walks into work items of at most SEG admitted
blocks (walk_items), so the longest subtile walk does not set the
launch's time; K10 walks each subtile in one CUDA block.

The plain versions visit, for every subtile, each set bit of each word
whose own entry bound is finite (the kernels never visit a word whose
bound is +inf), vectorised over the subtiles that admit a block, and
model no early termination: the merges do not depend on visit order,
and termination only drops words that cannot change a result.
"""

from __future__ import annotations

import torch

from ...core.scene import SC_DC
from ...runtime.profiler import count
from .anyhit import anyhit_blocks
from .build import check, library
from .closest_hit import closest_shared_blocks
from .closest_hit_perray import closest_perray_blocks
from .common import (TILE_R, box_args, is_cuda_call, open_boxes, ptr,
                     require, stream_ptr)

BLOCK_F = 32  # faces per block; 32 blocks per superblock word
# admitted blocks per work item of K9's and K11's split walks (read at
# each launch): of 32-512, about the lowest sum of their four times on
# the streamed cells, over three runs on the H100 (PERF.md)
SEG = 64
NO_HIT = 0x7F80000000000000  # the key of (+inf, 0): unpack_keys


def _check(mask3, order2, tlb3, planes, spack, names):
    if mask3.dim() != 3:
        raise ValueError(f"mask3: shape {tuple(mask3.shape)}, expected "
                         f"(NB, nsub+1, S)")
    nb, rows, n_super = mask3.shape
    nsub = rows - 1
    require(mask3, "mask3", torch.int32, (nb, nsub + 1, n_super))
    require(tlb3, "tlb3", torch.float32, (nb, nsub + 1, n_super))
    require(order2, "order2", torch.int32, (nb, n_super))
    r = nb * nsub * TILE_R
    for name, x in zip(names, planes):
        require(x, name, torch.float32, (r,))
    if spack.dim() != 2 or spack.shape[1] < SC_DC + 4:
        raise ValueError(f"spack: shape {tuple(spack.shape)}, expected "
                         f"(F, >={SC_DC + 4})")
    require(spack, "spack", torch.float32, (n_super * 32 * BLOCK_F,
                                            spack.shape[1]))
    if nsub < 1:
        raise ValueError("mask3: no subtile rows")
    return nb * nsub, nsub, n_super


def stream_closest_hit(mask3, order2, tlb3, dx, dy, dz, texit, spack,
                       oterm, origin=None, blk_lo=None, blk_hi=None):
    """(t (R,) f32, face (R,) i32) for shared-origin rays dx/dy/dz;
    texit (R,): root-exit caps; spack (F, 128): the streaming record
    (columns 0-11 read); oterm (F, 8): the frame's origin terms
    [t_num, hc0, hc1, hc2, ...]; origin (3,) f32: the camera origin,
    needed with the boxes; blk_lo / blk_hi (F / 32, 3) f32: the 32-face
    blocks' boxes, or None (every ray of an admitted block tested)."""
    planes = (dx, dy, dz, texit)
    n_sub, nsub, n_super = _check(mask3, order2, tlb3, planes, spack,
                                  ("dx", "dy", "dz", "texit"))
    require(oterm, "oterm", torch.float32, (spack.shape[0], 8))
    boxes = box_args(blk_lo, blk_hi, n_super * 32)
    if origin is not None:
        require(origin, "origin", torch.float32, (3,))
    elif boxes:
        raise ValueError("origin: needed with the boxes")
    more = (origin,) if origin is not None else ()
    if not is_cuda_call(mask3, order2, tlb3, *planes, spack, oterm, *more,
                        *boxes):
        return stream_closest_hit_plain(mask3, order2, tlb3, *planes,
                                        spack, oterm, origin, *boxes)
    lo, hi = boxes or open_boxes(n_super * 32, dx.device)
    if origin is None:  # open boxes admit every ray, from any origin
        origin = torch.zeros(3, dtype=torch.float32, device=dx.device)
    key = torch.full((dx.shape[0],), NO_HIT, dtype=torch.int64,
                     device=dx.device)
    held, items = _items(mask3, order2, tlb3)
    err = library().rt_stream_closest_hit(
        ptr(mask3), ptr(order2), ptr(tlb3), *[ptr(p) for p in planes],
        ptr(spack), ptr(oterm), ptr(origin), ptr(lo), ptr(hi), *items,
        n_sub, nsub, n_super, spack.shape[1], ptr(key),
        stream_ptr(dx.device))
    del held
    check(err, "rt_stream_closest_hit")
    count("launches.stream_closest_hit")
    return unpack_keys(key)


def unpack_keys(key):
    """(t f32, face i32) of K9's keys (csrc/cull_walk.cuh SharedExt):
    t's bits << 32 | face << 1, a zero t as +0.0 with its sign bit in
    bit 0. Every t >= 0, so its bits are below 2^31."""
    low = key & 0xFFFFFFFF
    t = ((key >> 32) | ((low & 1) << 31)).to(torch.int32)
    return t.view(torch.float32), (low >> 1).to(torch.int32)


def _popcount(x):
    """Set bits of each int64 holding a 32-bit word."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def walk_items(mask3, order2, tlb3, seg: int):
    """(pre (n_sub, S) i32, item_off (n_sub + 1,) i32) of K9's and K11's
    split walks: pre[u, j] the admitted blocks (set bits of words whose
    entry bound is finite) of subtile u in its batch's visit order before
    word j; a work item is subtile u and the words j whose pre[u, j] lies
    in [q seg, (q+1) seg), q < its item count, at least 1 (seg >= 32: no
    item is empty); item_off[u] the first item of subtile u,
    item_off[n_sub] their count. On the device, without a host sync."""
    nb, rows, n_super = mask3.shape
    nsub = rows - 1
    ordx = order2.to(torch.int64)[:, None, :].expand(nb, nsub, n_super)
    words = torch.gather(mask3[:, :nsub], 2, ordx).to(torch.int64) \
        & 0xFFFFFFFF
    ok = torch.isfinite(torch.gather(tlb3[:, :nsub], 2, ordx))
    cnt = (_popcount(words) * ok).reshape(nb * nsub, n_super)
    pre = torch.cumsum(cnt, 1) - cnt
    items = torch.where(cnt > 0, pre // seg, 0).amax(1) + 1
    off = torch.zeros(nb * nsub + 1, dtype=torch.int64, device=mask3.device)
    off[1:] = torch.cumsum(items, 0)
    return pre.to(torch.int32).contiguous(), off.to(torch.int32)


def _items(mask3, order2, tlb3):
    """(tensors, the kernels' item arguments (item_off, pre, SEG,
    counter)). The caller holds the tensors until the launch is
    queued."""
    seg = SEG
    if seg < 32:
        raise ValueError(f"SEG {seg}: at least a word's 32 blocks")
    pre, off = walk_items(mask3, order2, tlb3, seg)
    counter = torch.zeros(1, dtype=torch.int32, device=mask3.device)
    return (pre, off, counter), (ptr(off), ptr(pre), seg, ptr(counter))


def stream_closest_hit_perray(mask3, order2, tlb3, dx, dy, dz, ox, oy, oz,
                              texit, spack, blk_lo=None, blk_hi=None):
    """(t, face) for rays with per-ray origins ox/oy/oz (the path
    tracer's bounce rays), as stream_closest_hit otherwise; blk_lo /
    blk_hi (F / 32, 3) f32 the 32-face blocks' boxes, or None (every
    ray of an admitted block tested)."""
    planes = (dx, dy, dz, ox, oy, oz, texit)
    n_sub, nsub, n_super = _check(
        mask3, order2, tlb3, planes, spack,
        ("dx", "dy", "dz", "ox", "oy", "oz", "texit"))
    boxes = box_args(blk_lo, blk_hi, n_super * 32)
    if not is_cuda_call(mask3, order2, tlb3, *planes, spack, *boxes):
        return stream_closest_hit_perray_plain(mask3, order2, tlb3, *planes,
                                               spack, *boxes)
    lo, hi = boxes or open_boxes(n_super * 32, dx.device)
    r = dx.shape[0]
    t = torch.empty(r, dtype=torch.float32, device=dx.device)
    face = torch.empty(r, dtype=torch.int32, device=dx.device)
    err = library().rt_stream_closest_hit_perray(
        ptr(mask3), ptr(order2), ptr(tlb3), *[ptr(p) for p in planes],
        ptr(spack), ptr(lo), ptr(hi), n_sub, nsub, n_super, spack.shape[1],
        SC_DC, ptr(t), ptr(face), stream_ptr(dx.device))
    check(err, "rt_stream_closest_hit_perray")
    count("launches.stream_closest_hit_perray")
    return t, face


def stream_anyhit(mask3, order2, tlb3, dx, dy, dz, ox, oy, oz, act, texit,
                  spack, blk_lo=None, blk_hi=None):
    """occ (R,) f32 = act where an active ray hits (act (R,) f32 marks
    the rays to test, 1.0); blk_lo / blk_hi as stream_closest_hit's."""
    planes = (dx, dy, dz, ox, oy, oz, act, texit)
    n_sub, nsub, n_super = _check(
        mask3, order2, tlb3, planes, spack,
        ("dx", "dy", "dz", "ox", "oy", "oz", "act", "texit"))
    boxes = box_args(blk_lo, blk_hi, n_super * 32)
    if not is_cuda_call(mask3, order2, tlb3, *planes, spack, *boxes):
        return stream_anyhit_plain(mask3, order2, tlb3, *planes, spack,
                                   *boxes)
    lo, hi = boxes or open_boxes(n_super * 32, dx.device)
    occ = torch.zeros(dx.shape[0], dtype=torch.float32, device=dx.device)
    held, items = _items(mask3, order2, tlb3)
    err = library().rt_stream_anyhit(
        ptr(mask3), ptr(order2), ptr(tlb3), *[ptr(p) for p in planes],
        ptr(spack), ptr(lo), ptr(hi), *items, n_sub, nsub, n_super,
        spack.shape[1], SC_DC, ptr(occ), stream_ptr(dx.device))
    del held
    check(err, "rt_stream_anyhit")
    count("launches.stream_anyhit")
    return occ


def admitted_subtiles(mask3, tlb3):
    """For each 32-face block, the subtiles (global index batch * nsub +
    sub) that visit it: its bit is set in the subtile's word and the
    word's entry bound is finite. Index tensors on the mask's device,
    None for a block no subtile visits."""
    nsub = mask3.shape[1] - 1
    n_super = mask3.shape[2]
    words = mask3[:, :nsub].reshape(-1, n_super).to(torch.int64)
    live = torch.isfinite(tlb3[:, :nsub].reshape(-1, n_super))
    shift = torch.arange(32, dtype=torch.int64, device=mask3.device)
    bits = ((words[:, :, None] >> shift) & 1).bool() & live[:, :, None]
    adm = bits.reshape(bits.shape[0], n_super * 32).T.cpu()
    out = []
    for j in range(adm.shape[0]):
        idx = adm[j].nonzero().squeeze(1)
        out.append(idx.to(mask3.device) if idx.numel() else None)
    return out


def stream_closest_hit_plain(mask3, order2, tlb3, dx, dy, dz, texit, spack,
                             oterm, origin=None, blk_lo=None, blk_hi=None):
    """Plain PyTorch version of stream_closest_hit (the same values; the
    boxes unread)."""
    # visit order and termination cannot change a winner
    del order2, texit, origin, blk_lo, blk_hi
    return closest_shared_blocks(admitted_subtiles(mask3, tlb3), dx, dy, dz,
                                 spack, oterm, BLOCK_F)


def stream_closest_hit_perray_plain(mask3, order2, tlb3, dx, dy, dz, ox, oy,
                                    oz, texit, spack, blk_lo=None,
                                    blk_hi=None):
    """Plain PyTorch version of stream_closest_hit_perray (the boxes
    unread)."""
    del order2, texit, blk_lo, blk_hi
    return closest_perray_blocks(admitted_subtiles(mask3, tlb3), dx, dy, dz,
                                 ox, oy, oz, spack, spack[:, SC_DC:], BLOCK_F)


def stream_anyhit_plain(mask3, order2, tlb3, dx, dy, dz, ox, oy, oz, act,
                        texit, spack, blk_lo=None, blk_hi=None):
    """Plain PyTorch version of stream_anyhit (the boxes unread)."""
    # an OR does not depend on visit order or termination
    del order2, texit, blk_lo, blk_hi
    return anyhit_blocks(admitted_subtiles(mask3, tlb3), dx, dy, dz, ox, oy,
                         oz, act, spack, spack[:, SC_DC:], BLOCK_F)
