"""The culled sweeps' front end for one ray set (kernel K13).

The wrapper `sweep_front` launches csrc/sweep_front.cu for CUDA tensors
and runs `sweep_front_plain` for CPU tensors; each launch adds 1 to the
counter `launches.sweep_front` (runtime/profiler.py). Both compute, for
rays padded to whole 1024-ray tiles, what megakernel.sweep_inputs builds
from the rays alone:

- the tiles' ray bounds (ops/traverse.tile_ray_bounds), over the rays
  a gate selects: None every ray, "act" those with act > 0, "live"
  those with a non-zero direction component; the mask's bounds take
  their own gate where it differs;
- the flat scan's packed mask words (traverse.flat_mask_words) against
  the cluster boxes `cull_boxes`, or the words given (`words`: K5's or
  accel="brute"'s);
- the all-on-chip sweeps' schedule (traverse.tile_schedule: tlb and the
  stable order) against the empty-padded cluster boxes `sched_boxes`;
- each ray's root-exit cap texit (traverse.sweep_root_exit) against
  `root`.

The plain version is that PyTorch code, ~250 small launches a ray set
on the card at 1080p; the kernel is one launch, a CUDA block a tile,
that allocates nothing and syncs nothing, so a captured frame holds it
as one node. Bitwise the same, but for one thing no consumer reads: the
sign of a zero bound where a tile holds zeros of both signs, which
torch's reduction settles by its own order and the kernel as the
IEEE minimum and maximum do (-0.0 for a min, +0.0 for a max).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...runtime.profiler import count
from ..traverse import (flat_mask_words, sweep_root_exit, tile_ray_bounds,
                        tile_schedule)
from .build import check, library
from .common import TILE_R, is_cuda_call, ptr, require, stream_ptr

GATES = {None: 0, "act": 1, "live": 2}
# face blocks a tile the kernel's schedule sorts in shared memory (8-byte
# keys, a power of two: 128 KB of the H100's 227 KB a block)
MAX_SCHED_BLOCKS = 1 << 14


class Front(NamedTuple):
    """What sweep_front makes of one ray set."""

    bounds: tuple  # the schedule's (omin, omax, dmin, dmax), (T, 3) each
    mask_bounds: tuple  # the mask's (bounds itself where the gates agree)
    words: Optional[torch.Tensor]  # (T * nwords,) i32, or None
    tlb: Optional[torch.Tensor]  # (T, nb) f32, or None
    order: Optional[torch.Tensor]  # (T, nb) i32, or None
    texit: Optional[torch.Tensor]  # (R,) f32, or None


def _gate(kind, act, d):
    if kind is None:
        return None
    if kind == "act":
        return act > 0
    return (d[0] != 0.0) | (d[1] != 0.0) | (d[2] != 0.0)


def sweep_front_plain(o, dx, dy, dz, act=None, *, gate=None, mask_gate=None,
                      faces: int = 0, block_f: int = 1, cull_boxes=None,
                      words=None, sched_boxes=None, root=None) -> Front:
    """Plain PyTorch version of sweep_front (same arguments, same
    values)."""
    d = (dx, dy, dz)
    op = (o[0], o[1], o[2])  # 0-dim tensors of a shared origin, or planes
    bounds = tile_ray_bounds(*op, *d, TILE_R, _gate(gate, act, d))
    mask_bounds = bounds if mask_gate == gate else tile_ray_bounds(
        *op, *d, TILE_R, _gate(mask_gate, act, d))
    if cull_boxes is not None:
        words = flat_mask_words(*cull_boxes, mask_bounds, faces, block_f)
    tlb = order = None
    if sched_boxes is not None:
        tlb, order = tile_schedule(*sched_boxes, words, bounds, faces,
                                   block_f)
    texit = None if root is None else sweep_root_exit(*root, *op, *d)
    return Front(bounds, mask_bounds, words, tlb, order, texit)


def _check(o, d, act, gate, mask_gate, faces, block_f, cull_boxes, words,
           sched_boxes, root):
    n_rays = d[0].shape[0] if d[0].dim() == 1 else -1
    for name, p in zip(("dx", "dy", "dz"), d):
        require(p, name, torch.float32, (n_rays,))
    if n_rays % TILE_R:
        raise ValueError(f"{n_rays} rays: not whole {TILE_R}-ray tiles")
    if isinstance(o, torch.Tensor):
        require(o, "o", torch.float32, (3,))
    else:
        for name, p in zip(("ox", "oy", "oz"), o):
            require(p, name, torch.float32, (n_rays,))
    for name, g in (("gate", gate), ("mask_gate", mask_gate)):
        if g not in GATES:
            raise ValueError(f"{name} {g!r}, expected one of {list(GATES)}")
        if g == "act" and act is None:
            raise ValueError(f"{name} 'act' without act")
    if act is not None:
        require(act, "act", torch.float32, (n_rays,))
    n_tiles = n_rays // TILE_R
    if faces <= 0 or block_f <= 0 or faces % block_f:
        raise ValueError(f"{faces} faces in blocks of {block_f}")
    nb = faces // block_f
    nwords = -(-nb // 32)
    boxes = [b for b in (cull_boxes, sched_boxes) if b is not None]
    n_clusters = boxes[0][0].shape[0] if boxes else 0
    for pair in boxes:
        for name, b in zip(("lo", "hi"), pair):
            require(b, "box " + name, torch.float32, (n_clusters, 3))
    if boxes:
        cull = faces // max(1, n_clusters)
        if n_clusters * cull != faces or (block_f % cull and cull % block_f):
            raise ValueError(f"{n_clusters} clusters of {faces} faces do "
                             f"not group into blocks of {block_f}")
    if cull_boxes is not None and words is not None:
        raise ValueError("give cull_boxes or words, not both")
    if sched_boxes is not None:
        if cull_boxes is None and words is None:
            raise ValueError("the schedule needs cull_boxes or words")
        if nb > MAX_SCHED_BLOCKS:
            raise ValueError(f"{nb} blocks a tile: the schedule sorts at "
                             f"most {MAX_SCHED_BLOCKS}")
    if words is not None:
        require(words, "words", torch.int32, (n_tiles * nwords,))
    if root is not None:
        for name, b in zip(("root lo", "root hi"), root):
            require(b, name, torch.float32, (3,))
    return n_tiles, n_clusters, nb, nwords


def sweep_front(o, dx, dy, dz, act=None, *, gate=None, mask_gate=None,
                faces: int = 0, block_f: int = 1, cull_boxes=None,
                words=None, sched_boxes=None, root=None) -> Front:
    """One ray set's front end (module docstring). o: a shared origin (3,)
    f32 or the planes (ox, oy, oz); dx, dy, dz (R,) f32, R whole tiles;
    act (R,) f32 or None; gate, mask_gate: None, "act" or "live"; faces
    padded faces in blocks of block_f; cull_boxes (lo, hi) (B, 3) f32:
    make the flat scan's words (else pass them as words (T * nwords,)
    i32, or neither); sched_boxes (lo, hi) (B, 3): make tlb and order
    from the words; root (lo, hi) (3,) f32: make texit."""
    d = (dx, dy, dz)
    n_tiles, n_clusters, nb, nwords = _check(
        o, d, act, gate, mask_gate, faces, block_f, cull_boxes, words,
        sched_boxes, root)
    shared = isinstance(o, torch.Tensor)
    given = [o] if shared else list(o)
    given += [*d, *(t for t in (act, words) if t is not None)]
    for pair in (cull_boxes, sched_boxes, root):
        given += list(pair or ())
    if not is_cuda_call(*given):
        return sweep_front_plain(o, dx, dy, dz, act, gate=gate,
                                 mask_gate=mask_gate, faces=faces,
                                 block_f=block_f, cull_boxes=cull_boxes,
                                 words=words, sched_boxes=sched_boxes,
                                 root=root)
    dev = dx.device

    def out(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)
    two = mask_gate != gate
    bnd = out((4, n_tiles, 3))
    mbnd = out((4, n_tiles, 3)) if two else None
    made = out((n_tiles * nwords,), torch.int32) if cull_boxes is not None \
        else None
    tlb = out((n_tiles, nb)) if sched_boxes is not None else None
    order = out((n_tiles, nb), torch.int32) if sched_boxes is not None \
        else None
    texit = out((n_tiles * TILE_R,)) if root is not None else None
    cb = cull_boxes or (None, None)
    sb = sched_boxes or (None, None)
    rt = root or (None, None)
    po = (ptr(o), None, None, None) if shared else \
        (None, *(ptr(p) for p in o))

    def p(t):
        return None if t is None else ptr(t)
    err = library().rt_sweep_front(
        *po, *(ptr(v) for v in d), p(act), *(p(b) for b in cb),
        *(p(b) for b in sb), *(p(b) for b in rt), p(words), GATES[gate],
        GATES[mask_gate], n_tiles, n_clusters, faces, block_f, ptr(bnd),
        p(mbnd), p(made), p(tlb), p(order), p(texit), stream_ptr(dev))
    check(err, "rt_sweep_front")
    count("launches.sweep_front")
    bounds = tuple(bnd)
    return Front(bounds, tuple(mbnd) if two else bounds,
                 made if made is not None else words, tlb, order, texit)
