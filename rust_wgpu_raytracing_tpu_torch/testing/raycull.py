"""Plain models of the per-ray cluster culling in kernels K1, K3, K4 and
K7-K11.

K1 and K3 (csrc/closest_hit.cu, csrc/anyhit.cu), K4 (csrc/frame.cu), K7
(csrc/closest_hit_perray.cu), K8 (csrc/extend_shadow.cu) and the
streamed sweeps K9, K10, K11
(csrc/stream_sweep.cu) test a face block only against the rays whose own
forward line enters the block's box (ops/traverse.ray_box_enter), and a
closest-hit ray only where that entry lies at or below the ray's best t
so far. Their outputs stay those of the unculled plain versions
(closest_hit_plain, anyhit_plain, frame_plain, closest_hit_perray_plain,
extend_shadow_plain,
stream_closest_hit_plain, stream_closest_hit_perray_plain,
stream_anyhit_plain), which compute the TPU kernels' function: a ray
whose line misses a conservatively widened box cannot hit a face inside
it, a face beyond the ray's best t cannot win, and both merges (a
lexicographic (t, face) min and an OR) do not depend on the order of
visits.

This module walks the same (ray, block) pairs in plain PyTorch, so the
CPU tests can hold the culled walks against the unculled versions bit
for bit, counts the work a culled walk needs (`walk_counts`, read by
chip_smoke.py's bounds), and makes the seeded adversarial inputs the
tests and chip_smoke.py hold the kernels to (`write_grid_mesh`,
`adversarial_rays`, `adversarial_camera`, `plane_camera_config`). K1's,
K3's and K7's models
(`sched_closest_culled`, `sched_anyhit_culled`, `sched_perray_culled`)
follow the kernels' walk of the front-to-back schedule: chunks of the
tile's visit order under the bound refreshed after each chunk; K4's (`frame_culled`) walks the
schedule as K1's and its in-kernel shadow rays as K3's, over the static
cluster order and the wavefront's admission
(`inkernel_shadow_culled`). K9's and K11's models
(`stream_shared_culled`, `stream_anyhit_culled`) follow the kernels'
word walk itself: the work items of stream_sweep.walk_items (at
stream_sweep.SEG as it stands when called), each subtile's visit order
with its skip, stop and bound rules. K1's and K9's zero t keeps the
winning face's own sign (merge_own), K3 and K11 walk their live rays
only. It is not on any render path.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.scene import SC_DC
from ..ops.kernels import stream_sweep
from ..ops.kernels.anyhit import perray_plane_test
from ..ops.kernels.closest_hit import shared_plane_t, sphere_winner
from ..ops.kernels.common import INT_MAX, TILE_R, open_boxes
from ..ops.kernels.extend_shadow import mask_tiles
from ..ops.kernels.frame import (const_offsets, frame_from_sweep,
                                 shadow_cone_entry)
from ..ops.kernels.stream_sweep import BLOCK_F, admitted_subtiles, walk_items
from ..ops.traverse import ray_box_enter, ray_root_exit

F32_INF = float("inf")


def _rays_of(tiles, n_rays):
    """Global ray indices of the 1024-ray tiles `tiles`."""
    lane = torch.arange(TILE_R, device=tiles.device)
    return (tiles[:, None] * TILE_R + lane).reshape(-1)[:n_rays]


def culled_closest(tiles_of_block, blo, bhi, dx, dy, dz, ox, oy, oz, fpack,
                   dc, block_f: int):
    """(t, face): the closest-hit merge of the culled walk. Blocks are
    visited in index order (K8's word and bit order); block j tests only
    the aimed rays of tiles_of_block[j] whose line enters box j with an
    entry at or below their best t so far."""
    r = dx.shape[0]
    t = torch.full((r,), F32_INF, dtype=torch.float32, device=dx.device)
    face = torch.zeros(r, dtype=torch.int32, device=dx.device)
    for j, tiles in enumerate(tiles_of_block):
        if tiles is None:
            continue
        idx = _rays_of(tiles, r)
        x, y, z, u, v, w = (p[idx] for p in (dx, dy, dz, ox, oy, oz))
        ok, entry = ray_box_enter(blo[j], bhi[j], u, v, w, x, y, z)
        keep = ((x != 0.0) | (y != 0.0) | (z != 0.0)) & ok & (entry <= t[idx])
        merge_perray(t, face, idx[keep], (dx, dy, dz, ox, oy, oz), fpack, dc,
                     j, block_f)
    return t, face


def merge_perray(t, face, ray, planes, fpack, dc, j: int, block_f: int):
    """Test face block j against the rays `ray` (per-ray origins; planes
    dx, dy, dz, ox, oy, oz) and merge its winners into (t, face) in
    place: the block's winner is its first face at the least t, and it
    replaces the incumbent by the lexicographic (t, face) rule."""
    if ray.numel() == 0:
        return
    rows = slice(j * block_f, (j + 1) * block_f)
    tt, valid = perray_plane_test(fpack[rows], dc[rows], *(
        p[ray] for p in planes))
    tm = torch.where(valid, tt, F32_INF)
    tmin = tm.amin(dim=0)
    lane = torch.arange(block_f, dtype=torch.int32,
                        device=t.device)[:, None]
    new_face = torch.where(tm == tmin, lane, INT_MAX).amin(dim=0) \
        + j * block_f
    prev_t, prev_f = t[ray], face[ray]
    better = (tmin < prev_t) | ((tmin == prev_t) & (new_face < prev_f))
    t[ray] = torch.where(better, tmin, prev_t)
    face[ray] = torch.where(better, new_face, prev_f)


def culled_anyhit(tiles_of_block, blo, bhi, dx, dy, dz, ox, oy, oz, act,
                  fpack, dc, block_f: int):
    """occ: the any-hit OR of the culled walk: block j tests only the
    active rays of tiles_of_block[j] whose line enters box j."""
    r = dx.shape[0]
    occ = torch.zeros_like(dx)
    for j, tiles in enumerate(tiles_of_block):
        if tiles is None:
            continue
        idx = _rays_of(tiles, r)
        ok, _ = ray_box_enter(blo[j], bhi[j], ox[idx], oy[idx], oz[idx],
                              dx[idx], dy[idx], dz[idx])
        idx = idx[ok & (act[idx] > 0.0)]
        if idx.numel() == 0:
            continue
        rows = slice(j * block_f, (j + 1) * block_f)
        _, hit = perray_plane_test(fpack[rows], dc[rows], *(
            p[idx] for p in (dx, dy, dz, ox, oy, oz)))
        occ[idx] = torch.maximum(occ[idx], torch.where(
            hit.any(dim=0), act[idx], 0.0))
    return occ


def merge_own(t, face, ray, tm, face_base: int) -> None:
    """Merge one block's shared-origin t (tm (BF, n), +inf where a face
    misses) into the winners of the rays `ray` (n,) in place, as K1's
    and K9's keys merge (csrc/cull_walk.cuh SharedExt::pack): the block's
    winner is its first face at the least t by value, it replaces the
    incumbent by the lexicographic (t, face) rule, and it brings its own
    t: a zero keeps that face's sign."""
    lanes = torch.arange(tm.shape[0], dtype=torch.int32,
                         device=tm.device)[:, None]
    tmin = tm.amin(dim=0)
    lane = torch.where(tm == tmin, lanes, INT_MAX).amin(dim=0)
    own = tm.gather(0, lane[None].long())[0]
    new_face = lane + face_base
    prev_t, prev_f = t[ray], face[ray]
    better = (tmin < prev_t) | ((tmin == prev_t) & (new_face < prev_f))
    t[ray] = torch.where(better, own, prev_t)
    face[ray] = torch.where(better, new_face, prev_f)


def _slots(block_f: int) -> int:
    """Blocks per chunk of the culled walks (cull_walk.cuh slots_for)."""
    return min(256 // block_f, 32)


def sched_walk(tl, order, b: float, slots: int, bound, visit,
               stop_below_zero: bool) -> None:
    """One tile's walk of the front-to-back schedule (K1, K3, K7): chunks of
    up to `slots` blocks of the visit order `order` (a list) taken while
    their entry bound tl[block] is at most b; a chunk that ends early (a
    block fails the bound, or the order runs out) ends the walk.
    visit(chunk) gets each chunk's blocks, then b = bound(); K3 also
    stops at b < 0."""
    p = 0
    while not (stop_below_zero and b < 0.0):
        chunk = []
        for ci in order[p:p + slots]:
            if not tl[ci] <= b:
                break
            chunk.append(ci)
        if chunk:
            visit(chunk)
        if len(chunk) < slots:
            return
        p += slots
        b = bound()


def sched_closest_culled(tlb, order, dx, dy, dz, texit, fpack, oterm, sph,
                         blk_lo, blk_hi, *, block_f: int, near: float = 0.01,
                         far: float = 100.0, live_best: bool = False):
    """K1's culled walk in plain PyTorch: (t, face, sph_out) as
    closest_hit's, blk_lo/blk_hi (nb, 3) the face blocks' boxes. Each
    tile walks its schedule (sched_walk) under the bound max(min(best t,
    root exit)); in a chunk a block tests only the aimed rays whose line
    from the camera (sph[:3]) enters its box at or below their best t at
    the chunk's start (live_best: as it stands at the block, K4's rule).
    A zero t keeps the winning face's own sign."""
    r = dx.shape[0]
    t = torch.full((r,), F32_INF, dtype=torch.float32, device=dx.device)
    face = torch.zeros(r, dtype=torch.int32, device=dx.device)
    lane = torch.arange(TILE_R, device=dx.device)
    for u in range(tlb.shape[0]):
        idx = u * TILE_R + lane
        x, y, z, cap = dx[idx], dy[idx], dz[idx], texit[idx]
        aimed = (x != 0.0) | (y != 0.0) | (z != 0.0)
        o = [sph[a].expand_as(x) for a in range(3)]

        def visit(chunk):
            best = t[idx].clone()
            for j in chunk:
                if live_best:
                    best = t[idx]
                ok, entry = ray_box_enter(blk_lo[j], blk_hi[j], *o, x, y, z)
                keep = (aimed & ok & (entry <= best)).nonzero().squeeze(1)
                if keep.numel() == 0:
                    continue
                rows = slice(j * block_f, (j + 1) * block_f)
                tm = shared_plane_t(fpack[rows], oterm[rows], x[keep],
                                    y[keep], z[keep])
                merge_own(t, face, idx[keep], tm, j * block_f)

        def bound():
            return float(torch.minimum(t[idx], cap).max())
        sched_walk(tlb[u].tolist(), order[u].tolist(), bound(),
                   _slots(block_f), bound, visit, False)
    n_sph = (sph.shape[0] - 3) // 4
    if n_sph == 0:
        return t, face, None
    return t, face, sphere_winner(sph, n_sph, dx, dy, dz, near, far)


def sched_perray_culled(tlb, order, dx, dy, dz, ox, oy, oz, texit, fpack,
                        dc, blk_lo, blk_hi, *, block_f: int):
    """K7's culled walk in plain PyTorch: (t, face) as
    closest_hit_perray's, blk_lo/blk_hi (nb, 3) the face blocks' boxes.
    Each tile walks its schedule (sched_walk) under the bound max(min(best
    t, root exit)); in a chunk a block tests only the aimed rays whose own
    line enters its box at or below their best t at the chunk's start."""
    planes = (dx, dy, dz, ox, oy, oz)
    t = torch.full_like(dx, F32_INF)
    face = torch.zeros(dx.shape[0], dtype=torch.int32, device=dx.device)
    lane = torch.arange(TILE_R, device=dx.device)
    for u in range(tlb.shape[0]):
        idx = u * TILE_R + lane
        x, y, z, a, b, c = (p[idx] for p in planes)
        aimed = (x != 0.0) | (y != 0.0) | (z != 0.0)

        def visit(chunk):
            best = t[idx].clone()
            for j in chunk:
                ok, entry = ray_box_enter(blk_lo[j], blk_hi[j], a, b, c, x,
                                          y, z)
                merge_perray(t, face, idx[aimed & ok & (entry <= best)],
                             planes, fpack, dc, j, block_f)

        def bound():
            return float(torch.minimum(t[idx], texit[idx]).max())
        sched_walk(tlb[u].tolist(), order[u].tolist(), bound(),
                   _slots(block_f), bound, visit, False)
    return t, face


def sched_anyhit_culled(tlb, order, dx, dy, dz, ox, oy, oz, act, texit,
                        fpack, dc, blk_lo, blk_hi, *, block_f: int):
    """K3's culled walk in plain PyTorch: occ as anyhit's, blk_lo/blk_hi
    (nb, 3) the face blocks' boxes. Each tile keeps its live rays
    (active, not occluded so far) and walks its schedule (sched_walk)
    under the largest root exit of a live ray, -1 when none is left; in a
    chunk a block tests only the rays live at the chunk's start whose
    line enters its box; a ray leaves the walk once occluded."""
    occ = torch.zeros_like(dx)
    lane = torch.arange(TILE_R, device=dx.device)
    for u in range(tlb.shape[0]):
        idx = u * TILE_R + lane
        live = act[idx] > 0.0

        def visit(chunk):
            ray = idx[live]
            planes = [p[ray] for p in (dx, dy, dz, ox, oy, oz)]
            for j in chunk:
                ok, _ = ray_box_enter(blk_lo[j], blk_hi[j], *planes[3:],
                                      *planes[:3])
                if not bool(ok.any()):
                    continue
                rows = slice(j * block_f, (j + 1) * block_f)
                _, hit = perray_plane_test(fpack[rows], dc[rows], *(
                    p[ok] for p in planes))
                shut = ray[ok][hit.any(dim=0)]
                occ[shut] = act[shut]
                live[shut - u * TILE_R] = False

        def bound():
            caps = texit[idx][live]
            return max(-1.0, float(caps.max())) if caps.numel() else -1.0
        sched_walk(tlb[u].tolist(), order[u].tolist(), bound(),
                   _slots(block_f), bound, visit, True)
    return occ


def inkernel_shadow_culled(p, sd, rel, occ, const, ns: int, nmat: int,
                           fpack, dc, blk_lo, blk_hi, *, block_f: int):
    """K4's in-kernel shadow loop in plain PyTorch: the mesh occlusion
    (R,) f32 of the winners' shadow rays (origins p, directions sd, 3
    planes each; rel (R,) bool the relevant ones; occ (R,) f32 the
    spheres' occlusion; const the frame's const vector of ns spheres and
    nmat materials), as frame_from_sweep's mesh_occ. Each tile keeps
    its live rays (relevant, not occluded by a sphere or a cluster so
    far) and walks the const vector's static cluster order in chunks of
    up to slots_for(block_f) clusters that its shadow cone admits
    (slab_interval_entry, the kernel's slab_scalar) with an entry bound
    at most b, the largest root exit of a live ray (-1 when none is
    left, which ends the walk), refreshed after each chunk; in a chunk a
    cluster tests only the rays live at the chunk's start whose line
    enters its box (blk_lo / blk_hi). A ray leaves once occluded."""
    nb = blk_lo.shape[0]
    cap, t0 = shadow_admission(p, sd, rel, const, ns, nmat, nb)
    shord0 = const_offsets(ns, nmat, nb)[2]
    order = [int(c) for c in const[shord0:shord0 + nb].tolist()]
    slots = _slots(block_f)
    out = torch.zeros_like(p[0])
    lane = torch.arange(TILE_R, device=p[0].device)
    for u in range(t0.shape[0]):
        idx = u * TILE_R + lane
        live = rel[idx] & (occ[idx] == 0.0)
        tl = t0[u].tolist()

        def bound():
            caps = cap[idx][live]
            return max(-1.0, float(caps.max())) if caps.numel() else -1.0
        b, seq = bound(), 0
        while b >= 0.0 and seq < nb:
            chunk = []
            while len(chunk) < slots and seq < nb:
                if tl[order[seq]] <= b:
                    chunk.append(order[seq])
                seq += 1
            ray = idx[live]
            planes = [v[ray] for v in (*sd, *p)]
            for j in chunk:
                ok, _ = ray_box_enter(blk_lo[j], blk_hi[j], *planes[3:],
                                      *planes[:3])
                if not bool(ok.any()):
                    continue
                rows = slice(j * block_f, (j + 1) * block_f)
                _, hit = perray_plane_test(fpack[rows], dc[rows], *(
                    v[ok] for v in planes))
                shut = ray[ok][hit.any(dim=0)]
                out[shut] = 1.0
                live[shut - u * TILE_R] = False
            b = bound()
    return out


def shadow_admission(p, sd, rel, const, ns: int, nmat: int, nb: int):
    """(cap (R,), tl (T, nb)) of K4's in-kernel shadow loop: each
    relevant ray's root exit along its shadow ray (-1 for the others),
    and each tile's admission of each cluster by the cone of its
    relevant rays (the kernel's slab_scalar: the entry-t lower bound,
    +inf where the cone cannot reach the cluster)."""
    cap = torch.where(rel, ray_root_exit(const[3:6], const[6:9], *p, *sd),
                      -1.0)
    blk0 = const_offsets(ns, nmat, nb)[1]
    return cap, shadow_cone_entry(p, sd, rel, const, blk0, nb)


def frame_shadow_rays(args, kw, t, face):
    """K4's in-kernel shadow wavefront at its arguments (mode "inkernel")
    and its sweep's winners (t, face): a dict of p, sd (the shadow rays'
    origins and directions, 3 planes each), live (relevant and not
    occluded by a sphere), cap and tl (shadow_admission)."""
    const, dx, dy, dz, fpack, oterm = (args[2], *args[3:6], args[7],
                                       args[8])
    nb = args[0].shape[1]
    out = {}

    def mesh_occ(p, sd, rel, occ):
        out.update(p=p, sd=sd, live=rel & (occ == 0.0))
        out["cap"], out["tl"] = shadow_admission(p, sd, rel, const, kw["ns"],
                                                 kw["nmat"], nb)
        return torch.zeros_like(occ)
    frame_from_sweep(t, face, const, dx, dy, dz, fpack, oterm, mesh_occ,
                     ns=kw["ns"], nmat=kw["nmat"],
                     near=kw.get("near", 0.01), far=kw.get("far", 100.0),
                     mode="inkernel")
    return out


def frame_culled(tlb, order, const, dx, dy, dz, texit, fpack, oterm, dc,
                 blk_lo=None, blk_hi=None, *, ns: int, nmat: int,
                 block_f: int, near: float = 0.01, far: float = 100.0,
                 mode: str = "sched"):
    """K4's culled walks in plain PyTorch: the planes as frame's,
    blk_lo/blk_hi (nb, 3) the face blocks' boxes (None: boxes every ray
    enters). The sweep is K1's walk from the camera (const[:3]) with each
    block's box test at the ray's best t as it stands
    (sched_closest_culled, live_best); mode "inkernel" traces the
    winners' shadow rays with inkernel_shadow_culled."""
    if blk_lo is None:
        blk_lo, blk_hi = open_boxes(tlb.shape[1], dx.device)
    t, face, _ = sched_closest_culled(
        tlb, order, dx, dy, dz, texit, fpack, oterm,
        const[:3].contiguous(), blk_lo, blk_hi, block_f=block_f,
        live_best=True)

    def mesh_occ(p, sd, rel, occ):
        return inkernel_shadow_culled(p, sd, rel, occ, const, ns, nmat,
                                      fpack, dc, blk_lo, blk_hi,
                                      block_f=block_f)
    return frame_from_sweep(t, face, const, dx, dy, dz, fpack, oterm,
                            mesh_occ, ns=ns, nmat=nmat, near=near, far=far,
                            mode=mode)


def extend_shadow_culled(words_a, words_b, dx, dy, dz, ox, oy, oz, sdx, sdy,
                         sdz, sox, soy, soz, act, fpack, dc, blk_lo, blk_hi,
                         *, block_f: int):
    """K8's culled walk in plain PyTorch: (t, face, occ) as
    extend_shadow's, blk_lo/blk_hi (nb, 3) the face blocks' boxes."""
    n_tiles = dx.shape[0] // TILE_R
    nb = fpack.shape[0] // block_f
    t, face = culled_closest(mask_tiles(words_a, n_tiles, nb), blk_lo,
                             blk_hi, dx, dy, dz, ox, oy, oz, fpack, dc,
                             block_f)
    occ = culled_anyhit(mask_tiles(words_b, n_tiles, nb), blk_lo, blk_hi,
                        sdx, sdy, sdz, sox, soy, soz, act, fpack, dc,
                        block_f)
    return t, face, occ


def stream_perray_culled(mask3, order2, tlb3, dx, dy, dz, ox, oy, oz, texit,
                         spack, blk_lo, blk_hi):
    """K10's culled walk in plain PyTorch: (t, face) as
    stream_closest_hit_perray's, blk_lo/blk_hi (F / 32, 3) the 32-face
    blocks' boxes. Blocks in index order, not the kernel's word order:
    the result does not depend on it."""
    del order2, texit
    return culled_closest(admitted_subtiles(mask3, tlb3), blk_lo, blk_hi,
                          dx, dy, dz, ox, oy, oz, spack, spack[:, SC_DC:],
                          BLOCK_F)


def item_walks(mask3, order2, tlb3, seg: int):
    """(subtile, j0, j1) of each work item of K9's and K11's walks:
    stream_sweep.walk_items' segments of each subtile's visit order."""
    n_sub = mask3.shape[0] * (mask3.shape[1] - 1)
    pre, off = walk_items(mask3, order2, tlb3, seg)
    pre, off = pre.cpu(), off.tolist()
    out = []
    for u in range(n_sub):
        for q in range(off[u + 1] - off[u]):
            j0, j1 = (int(torch.searchsorted(pre[u], x)) for x in (
                q * seg, (q + 1) * seg))
            out.append((u, j0, j1))
    return out


def word_walk(mask3, order2, tlb3, u: int, j0: int, j1: int, b: float,
              bound, visit, stop_below_zero: bool) -> None:
    """One item of the streamed kernels' walk: subtile u's words
    [j0, j1) of its batch's visit order from bound b. A word whose own
    mask word is 0 or whose own entry bound exceeds b is skipped; the
    walk stops at the first word whose batch-minimum bound exceeds b (K11
    also at b < 0); each admitted word's set bits go to visit(block) in
    bit order, then b = bound()."""
    nsub = mask3.shape[1] - 1
    batch, sub = divmod(u, nsub)
    own_mask, own_tlb = mask3[batch, sub].tolist(), tlb3[batch, sub].tolist()
    batch_tlb, order = tlb3[batch, nsub].tolist(), order2[batch].tolist()
    for j in range(j0, j1):
        if stop_below_zero and b < 0.0:
            break
        s = order[j]
        if not batch_tlb[s] <= b:
            break
        word = own_mask[s] & 0xFFFFFFFF
        if word == 0 or not own_tlb[s] <= b:
            continue
        for bit in range(32):
            if word >> bit & 1:
                visit(s * 32 + bit)
        b = bound()


def stream_shared_culled(mask3, order2, tlb3, dx, dy, dz, texit, spack,
                         oterm, origin, blk_lo, blk_hi):
    """K9's culled walk in plain PyTorch: (t, face) as
    stream_closest_hit's, the rays from `origin` (3,), blk_lo/blk_hi
    (F / 32, 3) the 32-face blocks' boxes. The items run last first (the
    kernel runs them in any order); each starts from the winners as they
    stand. A zero t keeps the winning face's own sign."""
    r = dx.shape[0]
    t = torch.full((r,), F32_INF, dtype=torch.float32, device=dx.device)
    face = torch.zeros(r, dtype=torch.int32, device=dx.device)
    lane = torch.arange(TILE_R, device=dx.device)
    items = item_walks(mask3, order2, tlb3, stream_sweep.SEG)
    for u, j0, j1 in reversed(items):
        idx = u * TILE_R + lane
        x, y, z, cap = dx[idx], dy[idx], dz[idx], texit[idx]
        aimed = (x != 0.0) | (y != 0.0) | (z != 0.0)
        o = [origin[a].expand_as(x) for a in range(3)]

        def visit(j):
            ok, entry = ray_box_enter(blk_lo[j], blk_hi[j], *o, x, y, z)
            keep = (aimed & ok & (entry <= t[idx])).nonzero().squeeze(1)
            if keep.numel() == 0:
                return
            rows = slice(j * BLOCK_F, (j + 1) * BLOCK_F)
            tm = shared_plane_t(spack[rows], oterm[rows], x[keep],
                                y[keep], z[keep])
            merge_own(t, face, idx[keep], tm, j * BLOCK_F)

        def bound():
            return float(torch.minimum(t[idx], cap).max())
        word_walk(mask3, order2, tlb3, u, j0, j1, bound(), bound, visit,
                  False)
    return t, face


def stream_anyhit_culled(mask3, order2, tlb3, dx, dy, dz, ox, oy, oz, act,
                         texit, spack, blk_lo, blk_hi):
    """K11's culled walk in plain PyTorch: occ as stream_anyhit's. Each
    item keeps its live rays (active, not occluded so far, by it or by an
    item before it) and box-tests only those; a ray leaves the walk once
    occluded; the bound is the largest root exit of a live ray, -1 when
    none is left. Items run last first."""
    occ = torch.zeros_like(dx)
    lane = torch.arange(TILE_R, device=dx.device)
    dc = spack[:, SC_DC:]
    items = item_walks(mask3, order2, tlb3, stream_sweep.SEG)
    for u, j0, j1 in reversed(items):
        idx = u * TILE_R + lane
        live = (act[idx] > 0.0) & (occ[idx] == 0.0)

        def visit(j):
            ray = idx[live]
            if ray.numel() == 0:
                return
            planes = [p[ray] for p in (dx, dy, dz, ox, oy, oz)]
            ok, _ = ray_box_enter(blk_lo[j], blk_hi[j], *planes[3:],
                                  *planes[:3])
            ray = ray[ok]
            if ray.numel() == 0:
                return
            rows = slice(j * BLOCK_F, (j + 1) * BLOCK_F)
            _, hit = perray_plane_test(spack[rows], dc[rows], *(
                p[ray] for p in (dx, dy, dz, ox, oy, oz)))
            shut = ray[hit.any(dim=0)]
            occ[shut] = act[shut]
            live[shut - u * TILE_R] = False

        def bound():
            caps = texit[idx][live]
            return max(-1.0, float(caps.max())) if caps.numel() else -1.0
        word_walk(mask3, order2, tlb3, u, j0, j1, bound(), bound, visit,
                  True)
    return occ


def mask_pairs(words, n_tiles: int, nb: int):
    """(tiles, blocks) (P,) int64: the (tile, block) pairs that packed
    (tiles * nwords,) mask words admit."""
    nwords = words.shape[0] // n_tiles
    w = words.view(n_tiles, nwords).to(torch.int64) & 0xFFFFFFFF
    c = torch.arange(nb, device=words.device)
    bits = ((w[:, c >> 5] >> (c & 31)) & 1).bool()
    tiles, blocks = bits.nonzero(as_tuple=True)
    return tiles, blocks


def sched_pairs(tlb, reach=None):
    """(tiles, blocks) (P,) int64: the (tile, block) pairs a front-to-back
    schedule (tlb (tiles, nb)) admits: a finite entry bound and, with
    reach (tiles,) given, at most the tile's reach (the walk stops
    before the others)."""
    ok = torch.isfinite(tlb)
    if reach is not None:
        ok = ok & (tlb <= reach[:, None])
    return ok.nonzero(as_tuple=True)


def stream_pairs(mask3, tlb3, reach=None):
    """(subtiles, blocks) (P,) int64: the (subtile, 32-face block) pairs
    the streamed schedule admits: the set bits of the words whose entry
    bound is finite and, with reach (n_sub,) given, at most the
    subtile's reach (the walk skips the others)."""
    nsub, n_super = mask3.shape[1] - 1, mask3.shape[2]
    words = mask3[:, :nsub].reshape(-1, n_super).to(torch.int64)
    tl = tlb3[:, :nsub].reshape(-1, n_super)
    ok = torch.isfinite(tl)
    if reach is not None:
        ok = ok & (tl <= reach[:, None])
    bits = ((words[:, :, None] >> torch.arange(32, device=words.device))
            & 1).bool() & ok[:, :, None]
    tiles, word, bit = bits.nonzero(as_tuple=True)
    return tiles, word * 32 + bit


def walk_counts(pairs, blo, bhi, dx, dy, dz, ox, oy, oz, lanes,
                t_final=None, occ=None, chunk: int = 4096) -> dict:
    """What the culled walk over the admitted (tile, block) `pairs`
    must do, as lower bounds of what K8 or K10 does (dict of ints):

    - admitted: (ray, block) pairs of the mask walk over the `lanes`
      (R,) bool that take a test (aimed rays, or active shadow rays);
      the unculled walk face-tests every one of them;
    - entered: those whose line enters the block's box;
    - box_tests: the ray-box tests: closest hit (t_final given) every
      admitted pair; any hit (occ given) every admitted pair of the
      lanes that end unoccluded and one per occluded lane (a ray leaves
      the walk once occluded);
    - face_pairs: the pairs whose faces must be tested: closest hit,
      the entered pairs whose entry lies at or below the ray's final t
      (the walk's best t never drops below it, so it keeps at least
      these); any hit, the entered pairs of the lanes that end
      unoccluded and one per occluded lane;
    - blocks: the distinct blocks those pairs need (each staged at
      least once)."""
    tiles, blocks = pairs
    closest = t_final is not None
    open_ = lanes if closest else lanes & (occ == 0)
    lane = torch.arange(TILE_R, device=dx.device)
    n = dict(admitted=0, entered=0, box_tests=0, face_pairs=0)
    needed = torch.zeros(blo.shape[0], dtype=torch.bool, device=dx.device)
    for c0 in range(0, tiles.shape[0], chunk):
        tb, bb = tiles[c0:c0 + chunk], blocks[c0:c0 + chunk]
        idx = tb[:, None] * TILE_R + lane
        live = lanes[idx]
        ok, entry = ray_box_enter(blo[bb][:, None, :], bhi[bb][:, None, :],
                                  ox[idx], oy[idx], oz[idx],
                                  dx[idx], dy[idx], dz[idx])
        ent = ok & live
        tested = ent & (entry <= t_final[idx]) if closest else \
            ent & open_[idx]
        n["admitted"] += int(live.sum())
        n["entered"] += int(ent.sum())
        n["box_tests"] += int(open_[idx].sum())
        n["face_pairs"] += int(tested.sum())
        needed[bb[tested.any(dim=1)]] = True
    if not closest:
        shut = int((lanes & (occ != 0)).sum())
        n["box_tests"] += shut
        n["face_pairs"] += shut
    n["blocks"] = int(needed.sum())
    return n


# the ray sets of adversarial_rays
ADVERSARIAL_KINDS = ("axis", "on_face", "inside", "in_plane", "grazing")
# the cameras of adversarial_camera: the ray sets' kinds from one origin,
# and a camera on a face's plane
CAMERA_KINDS = ADVERSARIAL_KINDS + ("on_face_plane",)


def _grid_faces(v0, du, dv, n, m, verts, faces):
    """An n x m quad grid from corner v0 along du, dv (two triangles a
    quad), appended to verts / faces (1-based OBJ indices)."""
    base = len(verts)
    for j in range(m + 1):
        for i in range(n + 1):
            verts.append(v0 + du * (i / n) + dv * (j / m))
    for j in range(m):
        for i in range(n):
            a = base + j * (n + 1) + i + 1
            b, c, d = a + 1, a + n + 2, a + n + 1
            faces += [(a, b, c), (a, c, d)]


def write_grid_mesh(path: str, cells: int) -> None:
    """An OBJ of flat, axis-aligned faces: a cells x cells grid in the
    plane z = -3 over [-1.5, 1.5]^2, a 12 x 12 grid at z = -2.5 over
    [-0.5, 0.5]^2 and an 8 x 8 wall in the plane x = 0.3125. Every face
    lies in a plane of its cluster's box and grid lines are edges shared
    by clusters. cells 16: 928 faces (8-face clusters); 48: 5,024
    (32-face clusters); both pad to whole 1024-face superblocks."""
    verts, faces = [], []
    _grid_faces(np.array([-1.5, -1.5, -3.0]), np.array([3.0, 0, 0]),
                np.array([0, 3.0, 0]), cells, cells, verts, faces)
    _grid_faces(np.array([-0.5, -0.5, -2.5]), np.array([1.0, 0, 0]),
                np.array([0, 1.0, 0]), 12, 12, verts, faces)
    _grid_faces(np.array([0.3125, -1.0, -3.0]), np.array([0, 2.0, 0]),
                np.array([0, 0, 1.0]), 8, 8, verts, faces)
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in verts]
    lines += [f"f {a} {b} {c}" for a, b, c in faces]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def _unit(v):
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def adversarial_rays(kind: str, cells: int, blk_lo, blk_hi, seed: int,
                     n: int = 2048):
    """(o, d, so, sd) (3, n) f32 numpy each and act (n,) bool: one seeded
    ray set of `kind` against write_grid_mesh(cells)'s scene, whose
    cluster boxes are blk_lo / blk_hi. Kinds: "axis" (directions with one
    or two zero components), "on_face" (origins on box faces), "inside"
    (origins inside boxes), "in_plane" (rays in the grids' planes),
    "grazing" (rays through grid vertices and points of grid lines, a
    third from within 0.05: t ties between blocks). Shadow rays leave the
    same origins, half straight up; 70% active; 15% of the extension rays
    parked (origin 1e9, zero direction)."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(blk_lo.cpu())
    hi = np.asarray(blk_hi.cpu())
    real = np.isfinite(lo).all(1)
    lo, hi = lo[real], hi[real]
    box = rng.integers(0, lo.shape[0], n)
    d = _unit(rng.normal(size=(n, 3)))
    if kind == "axis":
        o = rng.uniform((-1.6, -1.6, -3.4), (1.6, 1.6, -1.8), (n, 3))
        pattern = rng.integers(0, 4, n)
        d[pattern == 0] = (0.0, 0.0, -1.0)
        for axis in (0, 1, 2):
            d[pattern == axis + 1, axis] = 0.0
        d = _unit(d)
    elif kind == "on_face":
        o = rng.uniform(lo[box], hi[box])
        axis = rng.integers(0, 3, n)
        side = rng.uniform(size=n) < 0.5
        o[np.arange(n), axis] = np.where(side, lo[box, axis], hi[box, axis])
        d[rng.uniform(size=n) < 0.3, 2] = 0.0
        d = _unit(d)
    elif kind == "inside":
        o = rng.uniform(lo[box], hi[box])
    elif kind == "in_plane":
        o = rng.uniform((-1.6, -1.6, 0.0), (1.6, 1.6, 0.0), (n, 3))
        o[:, 2] = np.where(rng.uniform(size=n) < 0.5, -3.0, -2.5)
        d[:, 2] = 0.0
        d = _unit(d)
    elif kind == "grazing":
        k = rng.integers(0, cells + 1, (n, 2)) * (3.0 / cells) - 1.5
        on_line = rng.uniform(size=n) < 0.5
        k[on_line, 0] += rng.uniform(0, 3.0 / cells, on_line.sum())
        target = np.stack([k[:, 0], k[:, 1], np.full(n, -3.0)], 1)
        d[:, 2] = -np.abs(d[:, 2]) - 0.05
        d = _unit(d)
        s = np.where(rng.uniform(size=n) < 0.3, rng.uniform(2e-3, 5e-2, n),
                     rng.uniform(0.2, 2.0, n))
        o = target - d * s[:, None]
    else:
        raise ValueError(f"unknown ray set {kind!r}")
    o = o.astype(np.float32)
    so = o.copy()
    sd = np.where(rng.uniform(size=(n, 1)) < 0.5,
                  np.array([[0.0, 0.0, 1.0]], np.float32),
                  _unit(rng.normal(size=(n, 3)) + (0.0, 0.0, 1.5)))
    act = rng.uniform(size=n) < 0.7
    parked = rng.uniform(size=n) < 0.15
    o[parked] = 1e9
    d[parked] = 0.0
    return (o.T.copy(), d.T.copy(), so.T.copy(),
            sd.astype(np.float32).T.copy(), act)


def plane_camera_config(obj_path: str, cells: int, seed: int,
                        width: int = 48, height: int = 32):
    """The port's SceneConfig of a split frame of write_grid_mesh(cells)
    at `obj_path`, with the reference's spheres and shadows, from a
    camera on the z = -3 grid's plane (adversarial_camera's
    "on_face_plane" origin) looking along it: the rays that leave the
    plane hit the faces holding the eye at t = +0.0 on one side and -0.0
    on the other, and the frame's depth (1/t) draws the faces or not by
    that sign."""
    from .. import config

    o, _ = adversarial_camera("on_face_plane", cells, None, None, seed)
    eye = tuple(float(v) for v in o)
    return config.SceneConfig(
        spheres=config.reference_scene().spheres,
        meshes=(config.MeshConfig(obj_path=obj_path,
                                  light_direction=(6.0, -1.0, 1.0)),),
        camera=config.CameraConfig(eye=eye, target=(eye[0] + 1.0,
                                                    eye[1] + 0.3, -3.0)),
        render=config.RenderConfig(width=width, height=height,
                                   shadows=True))


def adversarial_camera(kind: str, cells: int, blk_lo, blk_hi, seed: int,
                       n: int = 2048):
    """(origin (3,), d (3, n)) f32 numpy: one seeded camera of `kind`
    (CAMERA_KINDS) against write_grid_mesh(cells)'s scene, for the
    shared-origin sweep K9. The ray-set kinds take adversarial_rays'
    first unparked origin and its directions (the parked ones drawn
    anew); "grazing" aims from it at grid vertices and points of grid
    lines (t ties between blocks). "on_face_plane" puts the camera on the
    z = -3 grid, at a vertex, on an edge or inside a face (by seed), with
    random directions: every ray that leaves the plane hits the faces
    holding the origin at t = +0.0 or -0.0, the lowest face id winning
    the tie."""
    rng = np.random.default_rng(seed)
    if kind == "on_face_plane":
        step = 3.0 / cells
        k = rng.integers(1, cells - 1, 2)
        o = np.array([-1.5 + k[0] * step, -1.5 + k[1] * step, -3.0])
        o[:2] += ((0.0, 0.0), (0.5 * step, 0.0),
                  (0.3 * step, 0.6 * step))[seed % 3]
        return o.astype(np.float32), _unit(rng.normal(size=(n, 3))).T.copy()
    o, d, _, _, _ = adversarial_rays(kind, cells, blk_lo, blk_hi, seed, n)
    parked = (d == 0.0).all(axis=0)
    origin = o[:, np.argmin(parked)].copy()
    if kind == "grazing":
        k = rng.integers(0, cells + 1, (n, 2)) * (3.0 / cells) - 1.5
        on_line = rng.uniform(size=n) < 0.5
        k[on_line, 0] += rng.uniform(0, 3.0 / cells, on_line.sum())
        target = np.stack([k[:, 0], k[:, 1], np.full(n, -3.0)], 1)
        return origin, _unit(target - origin.astype(np.float64)).T.copy()
    d[:, parked] = _unit(rng.normal(size=(int(parked.sum()), 3))).T
    return origin, d
