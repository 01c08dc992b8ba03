"""Instancing and the per-frame refit (BASELINE config 5).

Counterpart of the JAX package's ops/instances.py. The reference
computes a 10x10 quaternion-rotated instance grid but never renders it
(src/lib.rs:114-134); here N transformed copies of a base mesh render as
one triangle soup, and all per-frame work (the vertex transform, the
edge-plane precompute, the cluster-AABB refit, the streaming record and
the winner-attribute table) runs on the template's device in
`instantiate`: the analogue of a BVH refit, a few elementwise passes
over the N * F faces and no host round trip.

Transforms are (N, 3, 4) affine rows [R | t]. Each instance's faces stay
contiguous and cluster-aligned (padded to FACE_PAD, or to SUPER_F once
the soup passes STREAM_FACES), so the Morton locality of the base mesh
carries over and the 32-face cluster AABBs are refit exactly.

The refit is eager PyTorch and rounds as the JAX package's jitted refit
does: the K=3 contractions (JAX einsums at Precision.HIGHEST) are
explicit products summed in index order, the cross products keep
jnp.cross's expression order, square roots go through ops/rounding, and
1/max(denom, 1e-30) divides by a tensor. The scene it returns is a full
SceneData; `num_faces` is a count of real faces, not a prefix length
(padding is interleaved per instance; tri_valid marks the real faces).
The host-built LBVH describes the untransformed mesh, so the refit scene
has none (bvh_nodes 0, bvh_pack the meshless (9, 1) zeros): accel="bvh"
culls from the refit blk_lo/blk_hi (ops/hier_cull.py), as in JAX.

    inst = InstancedScene.from_config(MeshConfig(obj_path="builtin:cube"),
                                      16, device="cuda")
    data = inst.instantiate(grid_transforms(16, z=-6.0, angle=0.05))
    color, depth = render_megakernel(data, uni, width=..., height=...)

The Renderer reaches it through SceneConfig.instances
(runtime/renderer.py): set-up builds the InstancedScene, and render()
refits it whenever Renderer.set_instance_transforms gave new transforms.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..core.scene import (CULL_BLOCK, FACE_PAD, STREAM_COLS, STREAM_FACES,
                          SUPER_F, Scene, SceneData, _pad_rows,
                          _precompute_faces)
from .intersect import _dot3
from .megakernel import _f32
from .rounding import sqrt
from .scenepacks import gpack_from_stream, pack_stream_columns

F32_INF = float("inf")


def _rotate(r: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """(N, K, 3): out[n, k, i] = sum_j r[n, i, j] * vecs[k, j], summed in
    index order (JAX einsum "nij,kj->nki" at Precision.HIGHEST)."""
    a = r[:, None, :, :]  # (N, 1, 3, 3)
    v = vecs[None, :, None, :]  # (1, K, 1, 3)
    return (a[..., 0] * v[..., 0] + a[..., 1] * v[..., 1]
            + a[..., 2] * v[..., 2])


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.cross over the last axis, in its expression order."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _norm3(x: torch.Tensor) -> torch.Tensor:
    """(F,) Euclidean norms of (F, 3) rows (jnp.linalg.norm, axis=1)."""
    return sqrt(_dot3(x, x) + 0.0)


@dataclass
class InstancedScene:
    """Base mesh + template SceneData; `instantiate(transforms)` returns a
    complete SceneData for any placement of the instances."""

    template: SceneData  # Scene.build of the base mesh, on the device
    base_pos: torch.Tensor  # (V, 3) base vertices
    base_faces: torch.Tensor  # (Fb, 3) i64, padded per instance
    base_uv3: torch.Tensor  # (Fb, 3, 2)
    base_vn3: torch.Tensor  # (Fb, 3, 3)
    base_mat: torch.Tensor  # (Fb,) i32
    base_valid: torch.Tensor  # (Fb,) f32
    base_tan: torch.Tensor  # (Fb, 3) per-face tangent at this padding (the
    base_bit: torch.Tensor  # template's differ once the soup aligns to
    #                         superblocks)
    n_instances: int
    fb_real: int  # real faces per instance

    @property
    def device(self) -> torch.device:
        return self.base_pos.device

    @staticmethod
    def from_config(mesh_cfg, n_instances: int, *,
                    device) -> "InstancedScene":
        """Load the base mesh (every OBJ group with its material ids, or a
        builtin mesh), Morton-sort it once, precompute its tangent frames
        and pad it per instance; on the host with NumPy, then moved to
        `device`."""
        from ..config import RenderConfig, SceneConfig
        from ..models.triangle_list import TriangleList
        from .bvh import morton_order

        meshes, _ = TriangleList(mesh_cfg).load()
        pos_l, uv_l, nrm_l, faces_l, fmat_l = [], [], [], [], []
        off = 0
        for m in meshes:
            p = (m.positions * np.float32(mesh_cfg.scale)
                 + np.asarray(mesh_cfg.translation, np.float32))
            pos_l.append(p)
            uv_l.append(m.uvs)
            nrm_l.append(m.normals)
            faces_l.append(m.faces + off)
            fmat_l.append(np.full((m.faces.shape[0],), m.material_id,
                                  np.int32))
            off += p.shape[0]
        pos = np.concatenate(pos_l).astype(np.float32)
        uvs = np.concatenate(uv_l).astype(np.float32)
        nrms = np.concatenate(nrm_l).astype(np.float32)
        faces = np.concatenate(faces_l).astype(np.int32)
        face_mat = np.concatenate(fmat_l)

        order = morton_order(pos[faces[:, 0]], pos[faces[:, 1]],
                             pos[faces[:, 2]])
        faces = faces[order]
        face_mat = face_mat[order]
        (_, _, _, _, _, _, _, _, tangent,
         bitangent) = _precompute_faces(pos, uvs, nrms, faces)

        fb_real = faces.shape[0]
        fb = -(-fb_real // FACE_PAD) * FACE_PAD
        if n_instances * fb > STREAM_FACES:
            # whole superblocks per instance, so the streamed sweeps see
            # whole 1024-face superblocks over the soup
            fb = -(-fb_real // SUPER_F) * SUPER_F
        pad = fb - fb_real
        faces_p = np.concatenate([faces, np.zeros((pad, 3), np.int32)])
        valid = np.concatenate([np.ones(fb_real, np.float32),
                                np.zeros(pad, np.float32)])

        template = Scene.build(SceneConfig(
            meshes=(mesh_cfg,),
            render=RenderConfig(width=8, height=8))).data.to(device)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return InstancedScene(
            template=template,
            base_pos=dev(pos),
            base_faces=dev(faces_p.astype(np.int64)),
            base_uv3=dev(uvs[faces_p].astype(np.float32)),
            base_vn3=dev(nrms[faces_p].astype(np.float32)),
            base_mat=dev(_pad_rows(face_mat, fb)),
            base_valid=dev(valid),
            base_tan=dev(_pad_rows(tangent, fb)),
            base_bit=dev(_pad_rows(bitangent, fb)),
            n_instances=n_instances,
            fb_real=fb_real)

    def instantiate(self, transforms) -> SceneData:
        """(N, 3, 4) affine transforms -> SceneData on the template's
        device: the per-frame refit (JAX _instantiate_jit)."""
        t = torch.as_tensor(transforms, dtype=torch.float32).to(self.device)
        if tuple(t.shape) != (self.n_instances, 3, 4):
            raise ValueError(f"transforms: shape {tuple(t.shape)}, expected "
                             f"{(self.n_instances, 3, 4)}")
        n = self.n_instances
        fb = self.base_faces.shape[0]
        nf = n * fb
        # read here, so that a test may patch the module's STREAM_FACES
        build_spack = nf > STREAM_FACES and nf % SUPER_F == 0
        r = t[:, :, :3]

        # transformed vertices per instance: (N, V, 3)
        v = _rotate(r, self.base_pos) + t[:, None, :, 3]
        f = self.base_faces
        p0 = v[:, f[:, 0], :].reshape(-1, 3)  # (N*Fb, 3)
        p1 = v[:, f[:, 1], :].reshape(-1, 3)
        p2 = v[:, f[:, 2], :].reshape(-1, 3)

        e0 = p1 - p0
        e1 = p2 - p1
        e2 = p0 - p2
        nrm = _cross(e0, p2 - p0)
        # jnp.sum(a * b, axis=1): + 0.0 because XLA's reduction starts
        # from +0 (three -0 products sum to +0 there, -0 in index order)
        denom = _dot3(nrm, nrm) + 0.0
        d = -(_dot3(nrm, p0) + 0.0)
        g0 = _cross(nrm, e0)
        g1 = _cross(nrm, e1)
        g2 = _cross(nrm, e2)
        c0 = _dot3(p0, g0) + 0.0
        c1 = _dot3(p1, g1) + 0.0
        c2 = _dot3(p2, g2) + 0.0
        valid = self.base_valid.repeat(n)
        one = torch.ones_like(denom)
        inv_denom = torch.where(
            (denom > 0) & (valid > 0),
            one / torch.clamp_min(denom, _f32(1e-30)), 0.0)
        nrm = nrm * valid[:, None]  # padding faces: N = 0, never hit

        # cluster-AABB refit: min / max over CULL_BLOCK runs, padding
        # faces +inf / -inf
        nb = nf // CULL_BLOCK
        real = valid[:, None] > 0

        def seg(p, fill, red):
            x = torch.where(real, p, fill).reshape(nb, CULL_BLOCK, 3)
            return red(x, dim=1)

        blk_lo = torch.minimum(torch.minimum(
            seg(p0, F32_INF, torch.amin), seg(p1, F32_INF, torch.amin)),
            seg(p2, F32_INF, torch.amin))
        blk_hi = torch.maximum(torch.maximum(
            seg(p0, -F32_INF, torch.amax), seg(p1, -F32_INF, torch.amax)),
            seg(p2, -F32_INF, torch.amax))

        def rot_dirs(vecs):
            out = _rotate(r, vecs).reshape(-1, 3)
            length = _norm3(out)[:, None]
            return out / torch.where(length > _f32(1e-12), length, 1.0)

        # uv density for mip sampling: uv areas are transform-invariant,
        # the world area is |refit N| / 2
        uv3 = self.base_uv3.repeat(n, 1, 1)
        duv1 = uv3[:, 1] - uv3[:, 0]
        duv2 = uv3[:, 2] - uv3[:, 0]
        uvdet = (duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]).abs()
        nlen = _norm3(nrm)
        uvscale = sqrt(torch.where(
            nlen > _f32(1e-30), uvdet / torch.clamp_min(nlen, _f32(1e-30)),
            0.0)) * valid

        dev = self.device
        sd = dataclasses.replace(
            self.template,
            tri_uvscale=uvscale,
            tri_tangent=rot_dirs(self.base_tan),
            tri_bitangent=rot_dirs(self.base_bit),
            tri_p0=p0,
            tri_n=nrm,
            tri_d=d * valid,
            tri_g=torch.stack([g0, g1, g2], dim=1) * valid[:, None, None],
            tri_c=torch.stack([c0, c1, c2], dim=1),
            tri_inv_denom=inv_denom,
            tri_uv=uv3,
            tri_vn=self.base_vn3.repeat(n, 1, 1),
            tri_mat=self.base_mat.repeat(n),
            tri_valid=valid,
            tri_orig=torch.arange(nf, dtype=torch.int32, device=dev),
            blk_lo=blk_lo,
            blk_hi=blk_hi,
            bvh_pack=torch.zeros((9, 1), dtype=torch.float32, device=dev),
            bvh_nodes=0,
            spack=torch.zeros((0, STREAM_COLS), dtype=torch.float32,
                              device=dev),
            num_faces=int(n * self.fb_real),
        )
        # the template's records describe the untransformed mesh: rebuild
        # them from the refit columns, once a frame, so that every kernel
        # of the frame shares them
        sp = pack_stream_columns(sd)
        if build_spack:
            return dataclasses.replace(sd, spack=sp,
                                       gpack=gpack_from_stream(sp))
        return dataclasses.replace(sd, gpack=gpack_from_stream(sp))


def grid_transforms(n: int, spacing: float = 2.5, z: float = -10.0,
                    angle: float = 0.0):
    """A sqrt(n) x sqrt(n) grid of y-rotated instances (the analogue of
    the reference's dead 10x10 instance grid, src/lib.rs:114-134)."""
    side = int(np.ceil(np.sqrt(n)))
    ts = []
    ca, sa = np.cos(angle), np.sin(angle)
    rot = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]], np.float32)
    for i in range(n):
        gx = (i % side) - (side - 1) / 2.0
        gy = (i // side) - (side - 1) / 2.0
        t = np.concatenate(
            [rot, np.array([[gx * spacing], [gy * spacing], [z]],
                           np.float32)], axis=1)
        ts.append(t)
    return np.stack(ts)  # (n, 3, 4)
