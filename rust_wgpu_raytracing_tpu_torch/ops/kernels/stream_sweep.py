"""The streamed sweeps over superblock words (kernels K9, K10, K11).

Three wrappers over csrc/stream_sweep.cu, each launching its kernel for
CUDA tensors and running its plain version for CPU tensors, each with
its own launch counter:

- `stream_closest_hit` (K9, JAX _make_streaming_ch_slim_kernel): the
  shared-origin (t, face) winner, origin terms from the frame's (F, 8)
  oterm;
- `stream_closest_hit_perray` (K10, _make_streaming_chp_slim_kernel):
  the per-ray-origin winner at t >= 1e-3, plane constants from the
  record's columns SC_DC..; it takes the 32-face blocks' boxes too and
  tests a block only for the rays whose own line enters its box at or
  below their best t so far (ops/kernels/raycull.py models it; the
  plain version ignores the boxes: the results are the same bits);
- `stream_anyhit` (K11, _make_streaming_anyhit_kernel): occ = 1 where
  an active ray hits a face at t >= 1e-3.

Their schedule: rays come in batches of nsub 1024-ray subtiles; mask3
(NB, nsub+1, S) i32 holds each subtile's packed word per superblock (a
word covers 32 blocks of 32 faces) and row nsub their union; tlb3 (NB,
nsub+1, S) f32 the entry lower bounds (+inf where a word is empty; row
nsub the batch minimum); order2 (NB, S) i32 the batch's visit order,
ascending in the minimum. Face ids are 1024 s + 32 b + lane.

The plain versions visit, for every subtile, each set bit of each word
whose own entry bound is finite (the kernels never visit a word whose
bound is +inf), vectorised over the subtiles that admit a block, and
model no early termination: the merges do not depend on visit order,
and termination only drops words that cannot change a result.
"""

from __future__ import annotations

import torch

from ...core.scene import SC_DC
from .anyhit import anyhit_blocks
from .build import check, library
from .closest_hit import closest_shared_blocks
from .closest_hit_perray import closest_perray_blocks
from .common import (TILE_R, box_args, is_cuda_call, open_boxes, ptr,
                     require, stream_ptr)

BLOCK_F = 32  # faces per block; 32 blocks per superblock word


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
                       oterm):
    """(t (R,) f32, face (R,) i32) for shared-origin rays dx/dy/dz;
    texit (R,): root-exit caps; spack (F, 128): the streaming record
    (columns 0-11 read); oterm (F, 8): the frame's origin terms
    [t_num, hc0, hc1, hc2, ...]."""
    planes = (dx, dy, dz, texit)
    n_sub, nsub, n_super = _check(mask3, order2, tlb3, planes, spack,
                                  ("dx", "dy", "dz", "texit"))
    require(oterm, "oterm", torch.float32, (spack.shape[0], 8))
    if not is_cuda_call(mask3, order2, tlb3, *planes, spack, oterm):
        return stream_closest_hit_plain(mask3, order2, tlb3, *planes,
                                        spack, oterm)
    r = dx.shape[0]
    t = torch.empty(r, dtype=torch.float32, device=dx.device)
    face = torch.empty(r, dtype=torch.int32, device=dx.device)
    err = library().rt_stream_closest_hit(
        ptr(mask3), ptr(order2), ptr(tlb3), *[ptr(p) for p in planes],
        ptr(spack), ptr(oterm), n_sub, nsub, n_super, spack.shape[1], ptr(t),
        ptr(face), stream_ptr(dx.device))
    check(err, "rt_stream_closest_hit")
    stream_closest_hit.launches += 1
    return t, face


stream_closest_hit.launches = 0


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
    stream_closest_hit_perray.launches += 1
    return t, face


stream_closest_hit_perray.launches = 0


def stream_anyhit(mask3, order2, tlb3, dx, dy, dz, ox, oy, oz, act, texit,
                  spack):
    """occ (R,) f32 in {0, 1}: act (R,) f32 marks the rays to test."""
    planes = (dx, dy, dz, ox, oy, oz, act, texit)
    n_sub, nsub, n_super = _check(
        mask3, order2, tlb3, planes, spack,
        ("dx", "dy", "dz", "ox", "oy", "oz", "act", "texit"))
    if not is_cuda_call(mask3, order2, tlb3, *planes, spack):
        return stream_anyhit_plain(mask3, order2, tlb3, *planes, spack)
    occ = torch.empty(dx.shape[0], dtype=torch.float32, device=dx.device)
    err = library().rt_stream_anyhit(
        ptr(mask3), ptr(order2), ptr(tlb3), *[ptr(p) for p in planes],
        ptr(spack), n_sub, nsub, n_super, spack.shape[1], SC_DC, ptr(occ),
        stream_ptr(dx.device))
    check(err, "rt_stream_anyhit")
    stream_anyhit.launches += 1
    return occ


stream_anyhit.launches = 0


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
                             oterm):
    """Plain PyTorch version of stream_closest_hit (same results)."""
    del order2, texit  # visit order and termination cannot change a winner
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
                        texit, spack):
    """Plain PyTorch version of stream_anyhit."""
    del order2, texit  # an OR does not depend on visit order or termination
    return anyhit_blocks(admitted_subtiles(mask3, tlb3), dx, dy, dz, ox, oy,
                         oz, act, spack, spack[:, SC_DC:], BLOCK_F)
