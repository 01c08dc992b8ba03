"""Geometry-parallel (gp) rendering: the scene's face axis sharded over
ranks (JAX parallel/geometry_sharding.py), on torch.distributed.

The face soup is Morton-sorted and cut into equal superblock-aligned
shards in order, so the global face order is (shard, local face)
lexicographic. Each rank renders the whole image against its shard with
the unchanged frame program (the spheres, textures and materials
replicated). The rank that holds a pixel's global mesh winner (the
lexicographic min of (t, global face), the single-device sweep's rule)
composited exactly that winner with the spheres, so its pixel is the
single-device pixel; collectives find it and take its planes:

    tmin  = MIN(t), fmin = MIN(where(t == tmin, gface, big))   over gp
    wrank = MIN(where(t == tmin & gface == fmin, gp index, n))
    plane = SUM(where(rank == wrank, plane, -0.0))   # one winner a pixel

(t, face) come from the shard's closest-hit sweep of the frame's primary
rays, run once more beside the frame. The JAX package merges on the
composited depth (MIN of depth, then the lowest rank); that agrees
except where a zero t ties across shards: t = +0 draws a face (depth
-inf), t = -0 does not, and a camera on a face's plane meets both. One
rank contributes each pixel's value and every other rank -0.0, and -0.0
+ x is x for every x, so the SUM returns the winner's bits (the sign of a
zero included, which the JAX package's +0 fill does not keep). Where
every shard misses, rank 0's pixel (the spheres or the background, the
same on every rank) wins.

Shadows take a second stage: the merged winner wavefront (the split
frame stopped at its shadow rays, render_megakernel(...,
emit_shadow_planes=True)) is traced by every rank against its own faces,
the occlusion bits are ORed (a SUM > 0), and the replicated spheres'
occlusion is added on every rank: a union over disjoint shards tests the
same faces as the single-device any-hit.

The path tracer runs its whole per-ray state machine on every rank and
shards only its three mesh-intersection passes through the hooks of
render_pathtrace: the closest hits merge on (t, global face) with the
global face = local face + gp index * shard size, carried as f32 values
(exact below 2^24), and the occlusion ORs over the shards.

Every rank issues the same collectives in the same order, whatever its
shard holds: the decisions before a collective read only replicated
state (the shard size, the frame's options).

The lit frame of a shard at most STREAM_FACES faces takes the fused
frame (K4), as render_megakernel picks; larger shards take the streamed
split frame. The dp axis composes: each row slab's gp group merges its
own rows, and the slabs gather over dp.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.camera import CameraUniforms
from ..core.scene import GPACK_ROWS, STREAM_COLS, SUPER_F, SceneData
from ..ops.kernels import KERNELS, KernelSet
from ..ops.megakernel import (BLOCK_F, GBuffer, _frame_shape, _rcp,
                              _should_stream, _spheres_occlude_planar,
                              anyhit_reordered, anyhit_rays,
                              extend_shadow_rays, gbuffer, mesh_occlusion,
                              present_planar, raygen_planar,
                              raygen_planar_tiled, render_megakernel,
                              tiled_to_image)
from ..ops.pathtrace import fold_in, render_pathtrace
from .mesh import RankMesh, make_gp_mesh

# every per-face field of SceneData (sliced over gp); blk, spack and
# gpack have layouts of their own
FACE_FIELDS = ("tri_p0", "tri_n", "tri_d", "tri_g", "tri_c",
               "tri_inv_denom", "tri_uv", "tri_vn", "tri_mat",
               "tri_valid", "tri_orig", "tri_tangent", "tri_bitangent",
               "tri_uvscale")
SHADOW_PLANES = ("cr", "cg", "cb", "w_ar", "w_ag", "w_ab", "covered",
                 "relevant", "px", "py", "pz", "sdx", "sdy", "sdz")
_BIG = float(2 ** 30)  # a global face id no shard has


def _pad_axis(x: torch.Tensor, n: int, axis: int = 0, fill=0.0):
    """x padded with `fill` to n along axis."""
    pad = n - x.shape[axis]
    if pad <= 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    tail = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, tail], dim=axis)


def shard_scene_faces(sd: SceneData, n: int) -> Tuple[Dict, SceneData]:
    """The face soup in n equal superblock-aligned shards. Returns
    (stacked, rest): stacked maps a field name to a tensor with a leading
    (n,) shard axis (FACE_FIELDS, blk_lo/blk_hi per cluster, spack
    (n, per, STREAM_COLS), gpack (n, GPACK_ROWS, per)); rest is the
    SceneData with those fields emptied and num_faces the shard size.
    The tail is padded with the scene's own padding (zero face rows,
    which every test rejects; +inf/-inf cluster boxes; tri_valid 0)."""
    f = sd.padded_faces
    if f == 0:
        raise ValueError("geometry sharding needs a mesh")
    per = max(SUPER_F, -(-f // (n * SUPER_F)) * SUPER_F)
    tot = per * n
    stacked = {}
    for name in FACE_FIELDS:
        x = getattr(sd, name)
        stacked[name] = _pad_axis(x, tot).reshape((n, per) + x.shape[1:])
    g = f // sd.blk_lo.shape[0]  # faces a cull cluster (8 or 32)
    assert per % g == 0, (per, g)
    stacked["blk_lo"] = _pad_axis(sd.blk_lo, tot // g, fill=float("inf")
                                  ).reshape(n, per // g, 3)
    stacked["blk_hi"] = _pad_axis(sd.blk_hi, tot // g, fill=float("-inf")
                                  ).reshape(n, per // g, 3)
    if sd.spack is not None and sd.spack.shape[0]:
        stacked["spack"] = _pad_axis(sd.spack, tot).reshape(
            n, per, STREAM_COLS)
    else:
        stacked["spack"] = sd.spack.new_zeros((n, 0, STREAM_COLS))
    gpk = _pad_axis(sd.gpack, tot, axis=1)  # (GPACK_ROWS, tot)
    stacked["gpack"] = gpk.reshape(GPACK_ROWS, n, per).permute(1, 0, 2)
    empties = {name: getattr(sd, name)[:0] for name in FACE_FIELDS}
    empties.update(blk_lo=sd.blk_lo[:0], blk_hi=sd.blk_hi[:0],
                   spack=sd.spack[:0], gpack=sd.gpack[:, :0])
    rest = dataclasses.replace(
        sd, num_faces=per, bvh_nodes=0,
        bvh_pack=sd.bvh_pack.new_zeros((9, 1)), **empties)
    return stacked, rest


def local_shard(stacked: Dict, rest: SceneData, i: int) -> SceneData:
    """Shard i of shard_scene_faces as a SceneData of its own."""
    return dataclasses.replace(
        rest, **{k: v[i].contiguous() for k, v in stacked.items()})


def _dp_slab(mesh: RankMesh, height: int):
    """(rows, row0, total_height) of this rank's row slab: row0 and
    total_height None without a dp axis."""
    dp = mesh.size("dp")
    if height % dp:
        raise ValueError(f"height {height} does not split into dp={dp}")
    rows = height // dp
    if dp == 1:
        return rows, None, None
    return rows, mesh.index("dp") * rows, height


def _select(mesh: RankMesh, win, planes):
    """The winning rank's value of every plane, by one SUM over gp of the
    planes stacked as f32 (bool as 0/1; the winner's value, -0.0
    elsewhere)."""
    st = torch.stack([p.to(torch.float32) for p in planes])
    st = torch.where(win.reshape((1,) + win.shape + (1,) * (
        st.dim() - 1 - win.dim())), st, -0.0)
    return list(mesh.all_reduce(st, "gp").unbind(0))


def _winner(mesh: RankMesh, t, face, per: int):
    """(bool mask of the pixels this rank wins, the global face as f32):
    the (t, global face)-lexicographic min of the shards' closest hits
    (global face = face + gp index * per), the single-device sweep's own
    rule, so a zero t's sign ties as it does there; where every shard
    misses, rank 0."""
    n = mesh.size("gp")
    gpi = mesh.index("gp")
    hit = torch.isfinite(t)
    face = torch.where(hit, face.to(torch.float32) + gpi * per, 0.0)
    gface = torch.where(hit, face, _BIG)
    tmin = mesh.all_reduce(t.clone(), "gp", dist.ReduceOp.MIN)
    fmin = mesh.all_reduce(torch.where(t == tmin, gface, _BIG), "gp",
                           dist.ReduceOp.MIN)
    best = (t == tmin) & (gface == fmin)
    cand = torch.where(best, float(gpi), float(n))
    wrank = mesh.all_reduce(cand.clone(), "gp", dist.ReduceOp.MIN)
    return best & (cand == wrank), face


def _merge_gbuffer(mesh: RankMesh, gb: GBuffer, per: int) -> GBuffer:
    """The closest hit over the gp shards (_winner), each plane the
    winner's own bits (a zero t keeps its sign)."""
    win, face = _winner(mesh, gb.t, gb.face, per)
    sel = _select(mesh, win, [gb.t, face, gb.u, gb.v, gb.nd, gb.uvx, gb.uvy,
                              gb.nx, gb.ny, gb.nz, gb.mat])
    return GBuffer(sel[0], sel[1].to(gb.face.dtype), *sel[2:])


def _frame_winner(mesh: RankMesh, local: SceneData, uni_flat, *, width,
                  rows, row0, th, accel, kernels):
    """(_winner's mask of the frame's pixels, in the frame's ray order,
    and that order, _frame_shape): the shard's closest hits of the frame's
    primary rays (the sweep, once more) merged over gp. The rank holding
    a pixel's global mesh winner composited that winner with the
    replicated spheres exactly as one device does, so its pixel is the
    single-device pixel (a merge on depth alone would not be: a zero t
    draws or not by its sign, and the shards' signs differ)."""
    uni = CameraUniforms.unflat(np.asarray(
        uni_flat.cpu() if isinstance(uni_flat, torch.Tensor) else uni_flat,
        np.float32))
    origin = torch.as_tensor(uni.origin, dtype=torch.float32,
                             device=local.tri_n.device)
    shape = _frame_shape(width, rows, row0, th)
    if shape is not None:
        rays = raygen_planar_tiled(width, shape[2], uni, device=origin.device,
                                   row0=row0, total_height=th or rows,
                                   tile_h=shape[0], tile_w=shape[1])
    else:
        rays = raygen_planar(width, rows, uni, device=origin.device,
                             row0=row0, total_height=th)
    gb = gbuffer(local, origin, *rays, accel=accel, with_spheres=False,
                 kernels=kernels)[0]
    return _winner(mesh, gb.t, gb.face, local.padded_faces)[0], shape


def _occ_or(mesh: RankMesh, occ):
    """The occlusion bits ORed over gp."""
    return mesh.all_reduce(occ.to(torch.float32), "gp") > 0


def render_sharded_gp(scene: SceneData, uni_flat, mesh: RankMesh, *,
                      width: int, height: int, shadows: bool = False,
                      quantize: bool = True, accel: str = "cull",
                      background=(0.0, 0.0, 0.0),
                      normal_mapping: bool = False, mip: bool = False,
                      near: float = 0.01, far: float = 100.0,
                      kernels: KernelSet = KERNELS):
    """One frame with the face soup sharded over the mesh's gp axis (and
    rows over dp, where it has one). Returns (color (H, W, 3), depth
    (H, W)) on every rank, bit for bit the single-device
    render_megakernel (module docstring)."""
    rows, row0, th = _dp_slab(mesh, height)
    stacked, rest = shard_scene_faces(scene, mesh.size("gp"))
    local = local_shard(stacked, rest, mesh.index("gp"))
    del stacked
    common = dict(width=width, height=rows, quantize=quantize, accel=accel,
                  background=background, normal_mapping=normal_mapping,
                  mip=mip, near=near, far=far, row0=row0, total_height=th,
                  kernels=kernels)
    win, shape = _frame_winner(mesh, local, uni_flat, width=width, rows=rows,
                               row0=row0, th=th, accel=accel,
                               kernels=kernels)
    if not shadows:
        color, depth = render_megakernel(local, uni_flat, shadows=False,
                                         **common)
        if shape is not None:  # the mask in the image's pixel order
            win = tiled_to_image(win, width, shape[2], shape[0],
                                 shape[1])[:rows]
        else:
            win = win.reshape(rows, width)
        *cols, depth = _select(mesh, win, [*color.unbind(-1), depth])
        color = torch.stack(cols, dim=-1)
    else:
        pl = render_megakernel(local, uni_flat, shadows=True,
                               emit_shadow_planes=True, fused=False,
                               **common)
        depth, *merged = _select(mesh, win, [pl["depth"]]
                                 + [pl[k] for k in SHADOW_PLANES])
        m = {k: v > 0 if pl[k].dtype == torch.bool else v
             for k, v in zip(SHADOW_PLANES, merged)}
        # stage 2: the merged wavefront against this rank's faces, ORed
        rays = [m[k] for k in ("px", "py", "pz", "sdx", "sdy", "sdz")]
        occ = _occ_or(mesh, mesh_occlusion(local, *rays, m["relevant"],
                                           accel=accel, kernels=kernels))
        occ = occ | _spheres_occlude_planar(local, *rays)
        shadowed = m["covered"] & occ
        cols = [torch.where(shadowed, m[f"w_a{c}"], m[f"c{c}"])
                for c in "rgb"]
        color, depth = present_planar(*cols, depth, width=width,
                                      height=rows, shape=shape,
                                      quantize=quantize)
    return (mesh.gather_rows(color, height),
            mesh.gather_rows(depth, height))


def render_pathtrace_gp(scene: SceneData, uni_flat, key, mesh: RankMesh, *,
                        width: int, height: int, bounces: int = 4,
                        spp: int = 1, background=(0.0, 0.0, 0.0),
                        kernels: KernelSet = KERNELS):
    """Path tracing with the face soup sharded over gp: the per-ray state
    machine runs on every rank, the primary closest hit, the fused
    extend+shadow sweep and the last any-hit on the rank's shard, merged
    each bounce (module docstring). Returns the spp SUM of radiance
    (H, W, 3) on every rank, bit for bit render_pathtrace's; with an sp
    axis each sp rank traces fold_in(key, sp index) and the result is
    the MEAN over sp * spp samples; dp shards the rows."""
    sp = mesh.size("sp")
    rows, row0, th = _dp_slab(mesh, height)
    stacked, rest = shard_scene_faces(scene, mesh.size("gp"))
    local = local_shard(stacked, rest, mesh.index("gp"))
    del stacked
    per = rest.num_faces
    streamed = _should_stream(local.padded_faces, BLOCK_F)

    def merge_gb(gb: GBuffer) -> GBuffer:
        return _merge_gbuffer(mesh, gb, per)

    def chp(_s, origin, dx, dy, dz, kernels=kernels):
        return merge_gb(gbuffer(local, origin, dx, dy, dz,
                                with_spheres=False, kernels=kernels)[0])

    def es(_s, *rays_act, kernels=kernels):
        gb, occ = extend_shadow_rays(local, *rays_act, kernels=kernels)
        return merge_gb(gb), _occ_or(mesh, occ)

    def ahw(_s, px, py, pz, dx, dy, dz, act, kernels=kernels):
        if streamed:
            occ = anyhit_reordered(local, px, py, pz, dx, dy, dz, act,
                                   kernels=kernels)
        else:
            occ = anyhit_rays(local, px, py, pz, dx, dy, dz, act,
                              act_cull=True, kernels=kernels)
        return _occ_or(mesh, occ)

    k = fold_in(key, mesh.index("sp")) if sp > 1 else key
    color = render_pathtrace(local, uni_flat, k, width=width, height=rows,
                             bounces=bounces, spp=spp, background=background,
                             row0=row0, total_height=th, chp_fn=chp,
                             es_fn=es, ah_fn=ahw, kernels=kernels)
    if sp > 1:
        color = mesh.all_reduce(color, "sp") * _rcp(spp * sp)
    return mesh.gather_rows(color, height)


__all__ = ["FACE_FIELDS", "shard_scene_faces", "local_shard",
           "make_gp_mesh", "render_sharded_gp", "render_pathtrace_gp"]
