"""Scene assembly: configs + assets -> SoA tensors.

The counterpart of the JAX package's core/scene.py. Scene.build is the
same NumPy program (Morton-sorted triangle soup, per-face edge planes,
cluster AABBs, the packed u16 texel pool and the winner-attribute table
`gpack`); only its closing conversion differs: torch tensors on the CPU
instead of jnp arrays. `SceneData.to(device)` moves the scene to the
card.

Intersection precompute (derivation): the reference's kernel
(triangle_list/compute.wgsl:82-148) computes, per (ray, face),
    N = e0 x (p2-p0),  t = -(N.O + d)/(N.D),  P = O + tD
and three inside-outside values dot(N, cross(edge_i, P - p_i)). Using the
scalar-triple identity (a x b).c = (b x c).a, each inside-outside value is
    (P - p_i).(N x edge_i) = O.g_i + t*(D.g_i) - p_i.g_i,  g_i = N x edge_i
— affine in the ray, which is what the closest-hit and any-hit kernels
evaluate per (face, ray).

Texel pools: the (12, N) pool holds, for each texel, its clamped 2x2
neighbourhood [t00, t01, t10, t11] x RGB as 16-bit linear-light values.
torch's uint16 supports few operations, so the pool keeps the same BITS
in an int16 tensor: the texshade kernel reads them as unsigned short,
and texshade_plain widens with `& 0xFFFF` after the int32 cast.

The bump pool (normal mapping) is a second pool of the same layout,
built from the materials' map_Bump images loaded raw (not
sRGB-decoded); mat_bump_base is -1 for a material without one.

The streaming record `spack` (meshes above STREAM_FACES) is built on the
host as the JAX package builds it; the streamed sweep kernels read its
plane columns and plane constants (ops/megakernel.py).

The oracle (ops/oracle.py) reads the f32 texture stack `textures` with
its true sizes `tex_hw`, the diffuse texture index `mat_tex` and the
face mask `tri_valid`. Mip sampling (ops/miptex.py, RenderConfig.mip)
reads a third pool of the same layout, `tex_mips`, holding each diffuse
texture's box-filtered pyramid (level 0 included, so the parity pool
stays as it is), its per-(material, level) tables and the per-face uv
density `tri_uvscale`. `bvh_pack` is the LBVH over the real cluster
leaves in skip-pointer order (ops/bvh.py linearize_bvh); the walk over
it is ops/traverse.py bvh_walk_mask_words, which no render path runs:
accel="bvh" renders through the two-level cut (ops/hier_cull.py), as in
the JAX package.

Not carried over from the JAX SceneData: the material columns no
shading reads (mat_diffuse, mat_shininess).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import SceneConfig, resolve_asset
from ..io.obj import ObjMaterial
from ..io.textures import TextureData, load_texture_file, solid_texture

# Pad face count to a multiple of this.
FACE_PAD = 128
# Faces per cull cluster (= the intersection kernels' face-block size).
CULL_BLOCK = 32
# Small scenes cull at finer granularity (8-face clusters below 4096
# faces); the kernels read the granularity off blk_lo's shape.
SMALL_CULL_BLOCK = 8
SMALL_CLUSTER_FACES = 4096
# Streaming superblock (one packed mask word) and the all-on-chip limit:
# meshes above STREAM_FACES pad to SUPER_F and take the streamed sweeps.
SUPER_F = 32 * CULL_BLOCK
STREAM_FACES = 16384

# Streaming record layout, one 128-column f32 row per face (the JAX
# package's, kept so the record carries across as it is):
#   0-39   the static per-face columns (ops/scenepacks.py pack_face_columns)
#   40-43  [d, c0, c1, c2] plane constants (per-ray-origin sweeps)
#   48-55  reserved for the shared-origin terms (the port's sweep reads
#          them from the per-frame (F, 8) origin-term tensor instead)
STREAM_COLS = 128
SC_DC = 40
SC_OT = 48

# Winner-attribute table (GPACK_ROWS, F): rows resolved after the
# (t, face) sweep by one gather (ops/megakernel.py expand_tf_gbuffer).
GP_INVD = 0
GP_UN = 1  # 1-3 unit normal
GP_UV = 4  # 4-9 uv corners (u0,v0,u1,v1,u2,v2)
GP_MAT = 10
GP_VN = 11  # 11-19 per-corner vertex normals
GP_TAN = 20  # 20-22 tangent, 23-25 bitangent
GP_N = 26  # 26-28 unnormalized geometric normal (ndotd recompute)
GP_G1 = 29  # 29-31 edge plane g1 (h1 recompute)
GP_G2 = 32  # 32-34 edge plane g2 (h2 recompute)
GP_C1 = 35  # plane constants c1/c2 (per-ray-origin h recompute)
GP_C2 = 36
GPACK_ROWS = 37
# the streaming-record column of each gpack row (the JAX package's
# GPACK_SRC_COLS): gpack == spack[:, GPACK_SRC_COLS].T for a fresh record
GPACK_SRC_COLS = ([12, 13, 14, 15] + list(range(16, 22)) + [22]
                  + list(range(30, 39)) + list(range(24, 30))
                  + [0, 1, 2] + [6, 7, 8] + [9, 10, 11]
                  + [SC_DC + 2, SC_DC + 3])


def _pad_rows(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    if a.shape[0] == n:
        return a
    pad = np.full((n - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def _stream_pack_np(padded: int, n, d, g, c, inv_denom, uv3, vn3,
                    face_mat, orig_ids, tangent, bitangent) -> np.ndarray:
    """Host build of the (padded, STREAM_COLS) streaming face record,
    the JAX package's _stream_pack_np: pack_face_columns' columns 0-39
    plus the [d, c] plane constants at SC_DC. Padding faces are all-zero
    rows."""
    f = n.shape[0]
    pack = np.zeros((padded, STREAM_COLS), np.float32)
    nlen = np.linalg.norm(n, axis=1, keepdims=True)
    un = np.where(nlen > 0, n / np.maximum(nlen, 1e-30), 0.0)
    pack[:f, 0:3] = n
    pack[:f, 3:12] = g.reshape(f, 9)
    pack[:f, 12] = inv_denom
    pack[:f, 13:16] = un
    pack[:f, 16:22] = uv3.reshape(f, 6)
    pack[:f, 22] = face_mat.astype(np.float32)
    pack[:f, 23] = orig_ids.astype(np.float32)
    pack[:f, 24:27] = tangent
    pack[:f, 27:30] = bitangent
    pack[:f, 30:39] = vn3.reshape(f, 9)
    pack[:f, SC_DC] = d
    pack[:f, SC_DC + 1:SC_DC + 4] = c
    return pack


def _face_uvscale(n: np.ndarray, uv3: np.ndarray) -> np.ndarray:
    """(F,) uv-per-world-unit density sqrt(uv_area / world_area): the
    per-face static factor of the ray-cone mip footprint (ops/miptex.py).
    n = unnormalized geometric normal (|n| = 2 * world area); uv areas
    from the 2D cross of the uv edge deltas. Degenerate faces -> 0."""
    duv1 = uv3[:, 1] - uv3[:, 0]
    duv2 = uv3[:, 2] - uv3[:, 0]
    det = np.abs(duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0])
    nlen = np.linalg.norm(n, axis=1)
    return np.sqrt(np.where(nlen > 1e-30, det / np.maximum(nlen, 1e-30),
                            0.0)).astype(np.float32)


def _mip_chain(img: np.ndarray):
    """Linear-light box-filter pyramid [level0, level1, ...] down to
    1x1. Odd sizes edge-replicate one row/col before the 2x2 mean
    (clamp-to-edge-consistent)."""
    levels = [img.astype(np.float32)]
    cur = levels[0]
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        if cur.shape[0] % 2:
            cur = np.concatenate([cur, cur[-1:]], axis=0)
        if cur.shape[1] % 2:
            cur = np.concatenate([cur, cur[:, -1:]], axis=1)
        h2, w2 = cur.shape[0] // 2, cur.shape[1] // 2
        cur = cur.reshape(h2, 2, w2, 2, 3).mean(axis=(1, 3),
                                                dtype=np.float32)
        levels.append(cur)
    return levels


def _gpack_sources_np(padded: int, n, g, c, inv_denom, uv3, vn3,
                      face_mat, tangent, bitangent) -> np.ndarray:
    """(GPACK_ROWS, padded) winner-attribute table from the planar
    source arrays; padding faces are all-zero columns."""
    f = n.shape[0]
    out = np.zeros((GPACK_ROWS, padded), np.float32)
    nlen = np.linalg.norm(n, axis=1, keepdims=True)
    un = np.where(nlen > 0, n / np.maximum(nlen, 1e-30), 0.0)
    out[GP_INVD, :f] = inv_denom
    out[GP_UN:GP_UN + 3, :f] = un.T
    out[GP_UV:GP_UV + 6, :f] = uv3.reshape(f, 6).T
    out[GP_MAT, :f] = face_mat.astype(np.float32)
    out[GP_VN:GP_VN + 9, :f] = vn3.reshape(f, 9).T
    out[GP_TAN:GP_TAN + 3, :f] = tangent.T
    out[GP_TAN + 3:GP_TAN + 6, :f] = bitangent.T
    out[GP_N:GP_N + 3, :f] = n.T
    out[GP_G1:GP_G1 + 3, :f] = g[:, 1, :].T
    out[GP_G2:GP_G2 + 3, :f] = g[:, 2, :].T
    out[GP_C1, :f] = c[:, 1]
    out[GP_C2, :f] = c[:, 2]
    return out


@dataclass
class SceneData:
    """The scene as tensors on one device.

    Faces across all meshes are concatenated in pass order and then
    Morton-sorted; padding faces are all-zero rows, which make the plane
    math produce NaN that every kernel rejects by comparison.
    """

    # --- spheres (pass order precedes meshes, src/lib.rs:1106-1184) ---
    sphere_center: torch.Tensor  # (S,3) f32
    sphere_radius: torch.Tensor  # (S,)  f32
    sphere_color: torch.Tensor  # (S,3) f32
    sphere_coeff: torch.Tensor  # (S,3) f32  [ambient, diffuse, specular]
    sphere_light: torch.Tensor  # (S,3) f32  per-sphere light dir (quirk)

    # --- triangle soup (F = padded face count) ---
    tri_p0: torch.Tensor  # (F,3) f32
    tri_n: torch.Tensor  # (F,3) f32   geometric normal (unnormalized)
    tri_d: torch.Tensor  # (F,)  f32   -N.p0
    tri_g: torch.Tensor  # (F,3,3) f32 g_i = N x edge_i  for i=0,1,2
    tri_c: torch.Tensor  # (F,3)  f32  c_i = p_i.g_i
    tri_inv_denom: torch.Tensor  # (F,) f32  1/(N.N), 0 for padding faces
    tri_uv: torch.Tensor  # (F,3,2) f32 per-corner uvs
    tri_vn: torch.Tensor  # (F,3,3) f32 per-corner shading normals
    tri_mat: torch.Tensor  # (F,) i32 material id
    tri_valid: torch.Tensor  # (F,) f32 1.0 for real faces, 0.0 for padding
    tri_orig: torch.Tensor  # (F,) i32 original (pre-Morton-sort) face index
    tri_tangent: torch.Tensor  # (F,3) f32 per-face tangent (uv-aligned)
    tri_bitangent: torch.Tensor  # (F,3) f32

    # --- acceleration (Morton clusters; ops/bvh.py) ---
    blk_lo: torch.Tensor  # (F/cluster, 3) f32 cluster AABB min
    blk_hi: torch.Tensor  # (F/cluster, 3) f32 cluster AABB max
    # LBVH over the real cluster leaves, DFS order with skip pointers
    # (ops/bvh.py linearize_bvh); (9, 1) zeros for a meshless scene
    bvh_pack: torch.Tensor  # (9, M) f32

    # --- materials ---
    mat_ambient: torch.Tensor  # (M,3) f32
    mat_specular: torch.Tensor  # (M,3) f32
    mat_light: torch.Tensor  # (M,3) f32 light dir for faces of this material
    mat_tex: torch.Tensor  # (M,) i32 diffuse texture index into `textures`

    # --- the f32 texture stack (the oracle), padded to a common size ---
    textures: torch.Tensor  # (T, TH, TW, 3) f32 linear
    tex_hw: torch.Tensor  # (T, 2) i32 true (h, w) per texture

    # --- diffuse texel pool (see module docstring) ---
    tex_packed: torch.Tensor  # (12, N) int16 holding u16 bits
    mat_tex_base: torch.Tensor  # (M,) i32 texel offset of the diffuse map
    mat_tex_h: torch.Tensor  # (M,) f32
    mat_tex_w: torch.Tensor  # (M,) f32

    # --- bump texel pool (normal mapping), same layout ---
    tex_packed_bump: torch.Tensor  # (12, Nb) int16 holding u16 bits
    mat_bump: torch.Tensor  # (M,) i32 bump texture index, -1 = none
    mat_bump_base: torch.Tensor  # (M,) i32 texel offset, -1 = none
    mat_bump_h: torch.Tensor  # (M,) f32
    mat_bump_w: torch.Tensor  # (M,) f32

    # --- mip pyramid pool (RenderConfig.mip), same layout; tables are
    # (M, L), rows padded by repeating the texture's last level ---
    tex_mips: torch.Tensor  # (12, Nm) int16 holding u16 bits
    mat_mip_base: torch.Tensor  # (M, L) i32 texel offset per level
    mat_mip_h: torch.Tensor  # (M, L) f32
    mat_mip_w: torch.Tensor  # (M, L) f32
    tri_uvscale: torch.Tensor  # (F,) f32 sqrt(uv area / world area)

    # (GPACK_ROWS, F) f32 winner-attribute table
    gpack: torch.Tensor

    # (F, STREAM_COLS) f32 streaming record past STREAM_FACES faces,
    # (0, STREAM_COLS) otherwise (ops/scenepacks.py stream_pack)
    spack: torch.Tensor

    num_faces: int = 0
    num_spheres: int = 0
    bvh_nodes: int = 0  # nodes of bvh_pack's tree, 0 without a mesh
    # pyramid levels (level 0 included) in the mip tables
    mip_levels: int = 0

    @property
    def padded_faces(self) -> int:
        return self.tri_p0.shape[0]

    def tensors(self) -> Dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)}

    def to(self, device) -> "SceneData":
        return dataclasses.replace(
            self, **{k: v.to(device) for k, v in self.tensors().items()})


STATIC_FIELDS = ("num_faces", "num_spheres", "bvh_nodes", "mip_levels")


def _tensor_fields() -> List[str]:
    return [f.name for f in dataclasses.fields(SceneData)
            if f.name not in STATIC_FIELDS]


def scene_data_from_numpy(fields: Dict[str, np.ndarray],
                          **static) -> SceneData:
    """Build a SceneData from NumPy arrays keyed by field name — the
    bridge that carries the JAX package's SceneData (each field through
    np.asarray) into the port. Fields the port does not use are
    ignored; u16 texel pools keep their bits as int16. `static` holds
    the STATIC_FIELDS (num_faces, num_spheres, bvh_nodes, mip_levels)."""
    out = {}
    for name in _tensor_fields():
        a = np.asarray(fields[name])
        if a.dtype == np.uint16:
            a = a.view(np.int16)
        out[name] = torch.from_numpy(np.array(a, copy=True))
    return SceneData(**out, **static)


TRAIN_PARAMS = ("sphere_color", "mat_ambient")


def params_from_numpy(arrays: Dict[str, np.ndarray], *,
                      device="cpu") -> Dict[str, torch.Tensor]:
    """The train step's parameters (parallel/tile_sharding.
    make_train_step) from NumPy arrays keyed by name, e.g. a JAX step's
    params through np.asarray: f32 tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(arrays[k], np.float32),
                               device=device).clone()
            for k in TRAIN_PARAMS}


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str,
                                                            np.ndarray]:
    """The train step's parameters as NumPy arrays (f32, on the host)."""
    return {k: params[k].detach().cpu().numpy().astype(np.float32)
            for k in TRAIN_PARAMS}


def _precompute_faces(positions: np.ndarray, uvs: np.ndarray, normals: np.ndarray,
                      faces: np.ndarray):
    """Per-face edge-plane precompute (see module docstring)."""
    p0 = positions[faces[:, 0]]
    p1 = positions[faces[:, 1]]
    p2 = positions[faces[:, 2]]
    e0 = p1 - p0
    e1 = p2 - p1
    e2 = p0 - p2
    n = np.cross(e0, p2 - p0)
    denom = np.einsum("fi,fi->f", n, n)
    d = -np.einsum("fi,fi->f", n, p0)
    g0 = np.cross(n, e0)
    g1 = np.cross(n, e1)
    g2 = np.cross(n, e2)
    c0 = np.einsum("fi,fi->f", p0, g0)
    c1 = np.einsum("fi,fi->f", p1, g1)
    c2 = np.einsum("fi,fi->f", p2, g2)
    with np.errstate(divide="ignore"):
        inv_denom = np.where(denom > 0, 1.0 / np.maximum(denom, 1e-30), 0.0)
    uv3 = uvs[faces]  # (F,3,2)
    vn3 = normals[faces]  # (F,3,3)
    g = np.stack([g0, g1, g2], axis=1)  # (F,3,3)
    c = np.stack([c0, c1, c2], axis=1)  # (F,3)

    # per-face tangent frame from uv deltas (standard tangent-space
    # construction; flat per face, matching the flat geometric normals)
    duv1 = uv3[:, 1] - uv3[:, 0]  # (F,2)
    duv2 = uv3[:, 2] - uv3[:, 0]
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    inv_det = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det),
                       0.0)
    ep1 = p1 - p0
    ep2 = p2 - p0
    tangent = (ep1 * duv2[:, 1:2] - ep2 * duv1[:, 1:2]) * inv_det[:, None]
    bitangent = (ep2 * duv1[:, 0:1] - ep1 * duv2[:, 0:1]) * inv_det[:, None]

    def _norm_rows(x):
        l = np.linalg.norm(x, axis=1, keepdims=True)
        return np.where(l > 1e-12, x / np.maximum(l, 1e-12), 0.0)

    tangent = _norm_rows(tangent).astype(np.float32)
    bitangent = _norm_rows(bitangent).astype(np.float32)

    return (p0, n, d, g, c, inv_denom.astype(np.float32), uv3, vn3,
            tangent, bitangent)


def _pack_neighborhoods(rgb_linear: np.ndarray) -> np.ndarray:
    """(h*w, 12) u16: each texel's clamped 2x2 neighborhood."""
    lin16 = np.clip(rgb_linear * 65535.0 + 0.5, 0,
                    65535).astype(np.uint16)
    h, w = rgb_linear.shape[:2]
    yy1 = np.minimum(np.arange(h) + 1, h - 1)
    xx1 = np.minimum(np.arange(w) + 1, w - 1)
    out = np.zeros((h, w, 12), np.uint16)
    out[:, :, 0:3] = lin16
    out[:, :, 3:6] = lin16[:, xx1]
    out[:, :, 6:9] = lin16[yy1, :]
    out[:, :, 9:12] = lin16[yy1][:, xx1]
    return out.reshape(-1, 12)


@dataclass
class Scene:
    """Host-side scene: config + loaded assets + the SceneData."""

    config: SceneConfig
    data: SceneData
    mesh_names: List[str]

    @staticmethod
    def build(config: SceneConfig) -> "Scene":
        """Assemble the scene on the host; returns CPU tensors."""
        from ..models.sphere import Sphere
        from ..models.triangle_list import TriangleList

        # ---- spheres ----
        spheres = config.spheres
        s_center, s_radius, s_color, s_coeff, s_light = Sphere.soa(spheres)

        # ---- meshes -> one soup ----
        all_pos: List[np.ndarray] = []
        all_uv: List[np.ndarray] = []
        all_nrm: List[np.ndarray] = []
        all_faces: List[np.ndarray] = []
        all_face_mat: List[np.ndarray] = []
        mesh_names: List[str] = []
        materials: List[ObjMaterial] = []
        mat_light: List[Tuple[float, float, float]] = []
        vert_off = 0

        for mesh_cfg in config.meshes:
            model = TriangleList(mesh_cfg)
            meshes, mats = model.load()
            mat_off = len(materials)
            materials.extend(mats)
            mat_light.extend([mesh_cfg.light_direction] * len(mats))
            for m in meshes:
                pos = model.world_positions(m)
                all_pos.append(pos)
                all_uv.append(m.uvs)
                all_nrm.append(m.normals)
                all_faces.append(m.faces + vert_off)
                all_face_mat.append(
                    np.full((m.faces.shape[0],), mat_off + m.material_id, dtype=np.int32))
                vert_off += pos.shape[0]
                mesh_names.append(m.name)

        if all_pos:
            positions = np.concatenate(all_pos, axis=0).astype(np.float32)
            uvs = np.concatenate(all_uv, axis=0).astype(np.float32)
            normals = np.concatenate(all_nrm, axis=0).astype(np.float32)
            faces = np.concatenate(all_faces, axis=0).astype(np.int32)
            face_mat = np.concatenate(all_face_mat, axis=0)
        else:
            positions = np.zeros((3, 3), np.float32)
            uvs = np.zeros((3, 2), np.float32)
            normals = np.zeros((3, 3), np.float32)
            faces = np.zeros((0, 3), np.int32)
            face_mat = np.zeros((0,), np.int32)

        if not materials:
            materials = [ObjMaterial(name="default")]
            mat_light = [(1.0, -1.0, -5.0)]

        num_faces = faces.shape[0]
        pad_unit = SUPER_F if num_faces > STREAM_FACES else FACE_PAD
        padded = max(pad_unit, -(-max(num_faces, 1) // pad_unit) * pad_unit)

        if num_faces:
            # Morton-sort faces by centroid so fixed-size clusters are
            # spatially compact (ops/bvh.py). Stable sort: equal codes
            # keep buffer order.
            from ..ops.bvh import (build_lbvh, cluster_aabbs, linearize_bvh,
                                   morton3d, morton_order)

            order = morton_order(positions[faces[:, 0]],
                                 positions[faces[:, 1]],
                                 positions[faces[:, 2]])
            faces = faces[order]
            face_mat = face_mat[order]
            orig_ids = order.astype(np.int32)

            (p0, n, d, g, c, inv_denom, uv3, vn3, tangent,
             bitangent) = _precompute_faces(positions, uvs, normals, faces)
            uvscale = _face_uvscale(n, uv3)
            cull = (SMALL_CULL_BLOCK if num_faces <= SMALL_CLUSTER_FACES
                    else CULL_BLOCK)
            blk_lo, blk_hi = cluster_aabbs(
                _pad_rows(positions[faces[:, 0]], padded),
                _pad_rows(positions[faces[:, 1]], padded),
                _pad_rows(positions[faces[:, 2]], padded),
                cull, num_faces)
            # LBVH over the real cluster leaves; the leaf keys are the
            # sorted face codes at the cluster starts (non-decreasing, as
            # the Karras build requires)
            n_real_clusters = -(-num_faces // cull)
            codes_sorted = morton3d((positions[faces[:, 0]]
                                     + positions[faces[:, 1]]
                                     + positions[faces[:, 2]]) / 3.0)
            bvh = build_lbvh(codes_sorted[np.arange(n_real_clusters) * cull],
                             blk_lo[:n_real_clusters].copy(),
                             blk_hi[:n_real_clusters].copy())
            bvh_pack = linearize_bvh(bvh)
            bvh_nodes = 2 * n_real_clusters - 1
            gpack_np = _gpack_sources_np(padded, n, g, c, inv_denom,
                                         uv3, vn3, face_mat,
                                         tangent, bitangent)
            if num_faces > STREAM_FACES:
                spack_np = _stream_pack_np(padded, n, d, g, c, inv_denom,
                                           uv3, vn3, face_mat, orig_ids,
                                           tangent, bitangent)
            else:
                spack_np = np.zeros((0, STREAM_COLS), np.float32)
        else:
            p0 = np.zeros((0, 3), np.float32)
            n = np.zeros((0, 3), np.float32)
            d = np.zeros((0,), np.float32)
            g = np.zeros((0, 3, 3), np.float32)
            c = np.zeros((0, 3), np.float32)
            inv_denom = np.zeros((0,), np.float32)
            uv3 = np.zeros((0, 3, 2), np.float32)
            vn3 = np.zeros((0, 3, 3), np.float32)
            tangent = np.zeros((0, 3), np.float32)
            bitangent = np.zeros((0, 3), np.float32)
            uvscale = np.zeros((0,), np.float32)
            orig_ids = np.zeros((0,), np.int32)
            nb = padded // CULL_BLOCK
            blk_lo = np.full((nb, 3), np.inf, np.float32)
            blk_hi = np.full((nb, 3), -np.inf, np.float32)
            bvh_pack = np.zeros((9, 1), np.float32)
            bvh_nodes = 0
            gpack_np = np.zeros((GPACK_ROWS, 0), np.float32)
            spack_np = np.zeros((0, STREAM_COLS), np.float32)

        # ---- textures (diffuse sRGB-decoded, bump maps raw),
        # deduplicated by (path, srgb) ----
        textures: List[TextureData] = []
        tex_cache: dict = {}
        mat_tex: List[int] = []
        mat_bump: List[int] = []

        def tex_id(key, loader):
            if key not in tex_cache:
                tex_cache[key] = len(textures)
                textures.append(loader())
            return tex_cache[key]

        for mat in materials:
            if mat.map_kd:
                path = resolve_asset(mat.map_kd)
                mat_tex.append(tex_id((path, True),
                                      lambda p=path: load_texture_file(p)))
            else:
                mat_tex.append(tex_id(("__solid_white__", True),
                                      lambda: solid_texture((1.0,) * 3)))
        for mat in materials:
            if mat.map_bump:
                path = resolve_asset(mat.map_bump)
                mat_bump.append(tex_id(
                    (path, False),
                    lambda p=path: load_texture_file(p, srgb=False)))
            else:
                mat_bump.append(-1)
        th = max(t.height for t in textures)
        tw = max(t.width for t in textures)
        tex_stack = np.zeros((len(textures), th, tw, 3), np.float32)
        tex_hw = np.zeros((len(textures), 2), np.int32)
        for i, t in enumerate(textures):
            tex_stack[i, : t.height, : t.width] = t.rgb_linear
            tex_hw[i] = (t.height, t.width)

        def build_pool(tex_ids):
            base = {}
            chunks = []
            off = 0
            for t_id in tex_ids:
                t = textures[t_id]
                base[t_id] = off
                chunks.append(_pack_neighborhoods(t.rgb_linear))
                off += t.height * t.width
            pool = (np.concatenate(chunks, axis=0) if chunks
                    else np.zeros((1, 12), np.uint16))
            return np.ascontiguousarray(pool.T), base

        diffuse_ids = sorted(set(mat_tex))
        pool_d, base_d = build_pool(diffuse_ids)
        pool_b, base_b = build_pool(sorted(set(b for b in mat_bump
                                               if b >= 0)))

        # ---- the mip pyramid pool: every diffuse texture's chain, level
        # 0 included; tables padded with the texture's last level ----
        mip_chains = {t_id: _mip_chain(textures[t_id].rgb_linear)
                      for t_id in diffuse_ids}
        mip_levels = max((len(c) for c in mip_chains.values()), default=0)
        mip_base: dict = {}
        mip_chunks = []
        moff = 0
        for t_id in diffuse_ids:
            for lv, img in enumerate(mip_chains[t_id]):
                mip_base[(t_id, lv)] = (moff, img.shape[0], img.shape[1])
                mip_chunks.append(_pack_neighborhoods(img))
                moff += img.shape[0] * img.shape[1]
        mip_pool = (np.ascontiguousarray(
            np.concatenate(mip_chunks, axis=0).T) if mip_chunks
            else np.zeros((12, 1), np.uint16))
        n_lv = max(mip_levels, 1)
        m_mip_base = np.zeros((len(materials), n_lv), np.int32)
        m_mip_h = np.ones((len(materials), n_lv), np.float32)
        m_mip_w = np.ones((len(materials), n_lv), np.float32)
        for mi, t_id in enumerate(mat_tex):
            last = len(mip_chains[t_id]) - 1
            for lv in range(n_lv):
                m_mip_base[mi, lv], m_mip_h[mi, lv], m_mip_w[mi, lv] = \
                    mip_base[(t_id, min(lv, last))]

        # i32 base offsets: exact at any pool size (f32 loses integers
        # past 2^24 texels — see ops/megakernel.py _mat_const)
        m_tex_base = np.array([base_d[t] for t in mat_tex], np.int32)
        m_tex_h = np.array([textures[t].height for t in mat_tex], np.float32)
        m_tex_w = np.array([textures[t].width for t in mat_tex], np.float32)
        m_bump_base = np.array([base_b[b] if b >= 0 else -1
                                for b in mat_bump], np.int32)
        m_bump_h = np.array([textures[b].height if b >= 0 else 1
                             for b in mat_bump], np.float32)
        m_bump_w = np.array([textures[b].width if b >= 0 else 1
                             for b in mat_bump], np.float32)

        def tens(a):
            return torch.from_numpy(np.ascontiguousarray(a))

        data = SceneData(
            sphere_center=tens(s_center),
            sphere_radius=tens(s_radius),
            sphere_color=tens(s_color),
            sphere_coeff=tens(s_coeff),
            sphere_light=tens(s_light),
            tri_p0=tens(_pad_rows(p0.astype(np.float32), padded)),
            tri_n=tens(_pad_rows(n.astype(np.float32), padded)),
            tri_d=tens(_pad_rows(d.astype(np.float32), padded)),
            tri_g=tens(_pad_rows(g.astype(np.float32), padded)),
            tri_c=tens(_pad_rows(c.astype(np.float32), padded)),
            tri_inv_denom=tens(_pad_rows(inv_denom, padded)),
            tri_uv=tens(_pad_rows(uv3.astype(np.float32), padded)),
            tri_vn=tens(_pad_rows(vn3.astype(np.float32), padded)),
            tri_mat=tens(_pad_rows(face_mat, padded)),
            tri_valid=tens(_pad_rows(np.ones((num_faces,), np.float32),
                                     padded)),
            tri_orig=tens(_pad_rows(orig_ids, padded)),
            tri_tangent=tens(_pad_rows(tangent, padded)),
            tri_bitangent=tens(_pad_rows(bitangent, padded)),
            blk_lo=tens(blk_lo),
            blk_hi=tens(blk_hi),
            bvh_pack=tens(bvh_pack),
            mat_ambient=tens(
                np.array([m.ambient for m in materials], np.float32)),
            mat_specular=tens(
                np.array([m.specular for m in materials], np.float32)),
            mat_light=tens(np.array(mat_light, np.float32).reshape(-1, 3)),
            mat_tex=tens(np.array(mat_tex, np.int32)),
            textures=tens(tex_stack),
            tex_hw=tens(tex_hw),
            tex_packed=tens(pool_d.view(np.int16)),
            mat_tex_base=tens(m_tex_base),
            mat_tex_h=tens(m_tex_h),
            mat_tex_w=tens(m_tex_w),
            tex_packed_bump=tens(pool_b.view(np.int16)),
            mat_bump=tens(np.array(mat_bump, np.int32)),
            mat_bump_base=tens(m_bump_base),
            mat_bump_h=tens(m_bump_h),
            mat_bump_w=tens(m_bump_w),
            tex_mips=tens(mip_pool.view(np.int16)),
            mat_mip_base=tens(m_mip_base),
            mat_mip_h=tens(m_mip_h),
            mat_mip_w=tens(m_mip_w),
            tri_uvscale=tens(_pad_rows(uvscale, padded)),
            gpack=tens(gpack_np),
            spack=tens(spack_np),
            num_faces=num_faces,
            num_spheres=len(spheres),
            bvh_nodes=bvh_nodes,
            mip_levels=mip_levels,
        )
        return Scene(config=config, data=data, mesh_names=mesh_names)
