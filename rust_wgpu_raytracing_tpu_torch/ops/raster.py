"""Forward raster pipeline: the reference's dead raster model path.

Counterpart of the JAX package's ops/raster.py. The reference carries a
complete but disabled forward rasterizer from the learn-wgpu tutorial
it grew from: src/shader.wgsl:1-51 (textured VS/FS), the DrawModel
trait (src/model.rs:130-197), the raster load_model
(src/resources.rs:68-161), the 10x10 quaternion-rotated instance grid
(src/lib.rs:66,114-134,400-421), the forward CameraUniform
(src/lib.rs:68-84) and a commented Depth32Float / CompareFunction::Less
attachment (src/lib.rs:713-719, src/texture.rs:13-54). None of it is
called; it is here so that a user of the reference finds it.

The JAX module runs no Pallas kernel (a jitted loop over face chunks),
so its port is plain PyTorch, on the device of its inputs. rasterize
tests a chunk of triangles against every pixel at once and merges the
chunk's winners into the carried (z, key, b0, b1) state; the chunk size
comes from a budget of (triangle, pixel) pairs, MAX_CHUNK_PAIRS, so that
memory stays bounded at any resolution, and the output does not depend
on it: within a chunk the winner of a pixel is the smallest z and, among
equal z, the smallest key (taken with an explicit min over the keys, not
from a reduction's tie order), and it replaces the carried winner only
when strictly closer, which is the sequential per-triangle Less.
Triangles that can never draw (back faces, w <= 1e-6) are dropped
before the chunks; the others keep their draw-order keys.

Pipeline state, as in the commented wgpu pipeline (src/lib.rs:679-729):
- front face Ccw in NDC, cull_mode Back, REPLACE blend;
- depth Less with writes: an equal z keeps the earlier triangle, and the
  attachment's seeded value (key INT32_MAX) loses only to a strictly
  closer fragment; a fragment at z exactly 1.0 fails against the clear;
- clip = (OPENGL_TO_WGPU @ proj @ view) @ model @ [p, 1]
  (shader.wgsl:25-39);
- fs_main samples the diffuse texture only, with NO V-flip (the dead
  loader passes tex_coords raw, resources.rs:131);
- pixel centres at +0.5, the top-left fill rule, perspective-correct
  interpolation; no near-plane clipping: a triangle with a corner at
  w <= 1e-6 is dropped whole.

Every f32 expression keeps the JAX operation order, so the winners and
the depth are JAX's bit for bit on the same clip coordinates. The
vertex stage (VP @ M @ p over every instance) sums each element's four
products in the order XLA's CPU dot takes at that shape (_dot4), so the
clip coordinates are JAX's too.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from .rounding import fma
from .shade import sample_texture_bilinear

F32_INF = float("inf")
_KEY_MAX = int(np.iinfo(np.int32).max)
# (triangle, pixel) pairs a chunk tests at once
MAX_CHUNK_PAIRS = 1 << 23
_W_MIN = float(np.float32(1e-6))


# --- instance grid (src/lib.rs:66,114-134,400-421) -------------------


def quat_axis_angle(axis, deg: float) -> np.ndarray:
    """cgmath Quaternion::from_axis_angle — (w, x, y, z), axis unit."""
    half = np.deg2rad(deg) / 2.0
    a = np.asarray(axis, np.float64)
    return np.concatenate([[np.cos(half)], np.sin(half) * a])


def quat_to_matrix(q) -> np.ndarray:
    """cgmath Matrix4::from(Quaternion) — rotation about the origin."""
    w, x, y, z = [float(v) for v in q]
    return np.array(
        [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y), 0],
         [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x), 0],
         [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y), 0],
         [0, 0, 0, 1]], np.float64)


def reference_instance_grid(n_per_row: int = 10,
                            spacing: float = 3.0) -> np.ndarray:
    """The reference's instance grid (src/lib.rs:400-421): for z, x in
    [0, N)^2, position = SPACE_BETWEEN * (i - N/2) on x/z, y = 0;
    rotation 45 deg about normalize(position) (identity at the origin).
    Returns (N*N, 4, 4) model matrices = translation @ rotation
    (Instance::to_raw, src/lib.rs:119-127)."""
    mats = []
    for z in range(n_per_row):
        for x in range(n_per_row):
            px = spacing * (x - n_per_row / 2.0)
            pz = spacing * (z - n_per_row / 2.0)
            p = np.array([px, 0.0, pz], np.float64)
            norm = np.linalg.norm(p)
            if norm == 0.0:
                rot = quat_to_matrix(quat_axis_angle([0, 0, 1], 0.0))
            else:
                rot = quat_to_matrix(quat_axis_angle(p / norm, 45.0))
            m = rot.copy()
            m[:3, 3] = p
            mats.append(m)
    return np.stack(mats).astype(np.float32)


# --- depth texture + compare sampler (src/texture.rs:13-54) ----------


@dataclasses.dataclass
class DepthTexture:
    """Depth32Float texture + LessEqual compare sampler (the
    create_depth_texture helper, texture.rs:13-54): the raster pass's
    depth attachment, with comparison sampling (PCF)."""

    data: torch.Tensor  # (H, W) f32

    @staticmethod
    def create(height: int, width: int, fill: float = 1.0, *,
               device) -> "DepthTexture":
        return DepthTexture(torch.full((height, width), fill,
                                       dtype=torch.float32, device=device))

    def sample_compare(self, u, v, ref):
        """Bilinear-filtered LessEqual comparison sample (WGSL
        textureSampleCompare with the helper's sampler): per texel
        `ref <= texel` gives 0/1, the 2x2 results are filtered linearly,
        addressing clamps to the edge. u, v, ref broadcast; f32 in
        [0, 1]."""
        h, w = self.data.shape
        dev = self.data.device
        u, v, ref = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                     for a in (u, v, ref))
        x = u * w - 0.5
        y = v * h - 0.5
        x0f, y0f = torch.floor(x), torch.floor(y)
        fx, fy = x - x0f, y - y0f
        xi, yi = x0f.to(torch.int32), y0f.to(torch.int32)
        x0 = xi.clamp(0, w - 1).long()
        x1 = (xi + 1).clamp(0, w - 1).long()
        y0 = yi.clamp(0, h - 1).long()
        y1 = (yi + 1).clamp(0, h - 1).long()

        def cmp(yy, xx):
            return (ref <= self.data[yy, xx]).to(torch.float32)

        top = cmp(y0, x0) * (1.0 - fx) + cmp(y0, x1) * fx
        bot = cmp(y1, x0) * (1.0 - fx) + cmp(y1, x1) * fx
        return top * (1.0 - fy) + bot * fy


# --- rasterization rules ----------------------------------------------


def _edge(ax, ay, bx, by, px, py):
    """Edge function (b-a) x (p-a) in screen space (y down)."""
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax)


def _top_left(ax, ay, bx, by):
    """Top-left fill rule for edge a->b under the positive-interior
    orientation (y down): a top edge is horizontal with b.x > a.x, a left
    edge points up (b.y < a.y)."""
    return ((ay == by) & (bx > ax)) | (by < ay)


def _covers(w, is_tl):
    """Fragment ownership: strictly inside, or ON a top-left edge."""
    return (w > 0.0) | ((w == 0.0) & is_tl)


def screen_triangles(tri_clip: torch.Tensor, width: int,
                     height: int) -> torch.Tensor:
    """(T, 3, 4) per corner (screen x, screen y, ndc z, clip w): the
    vertex post-processing of JAX rasterize. y flips (NDC y up ->
    framebuffer row 0 at the top); z is already in [0, 1]."""
    w_clip = tri_clip[:, :, 3]
    safe_w = torch.where(w_clip.abs() > _W_MIN, w_clip, 1.0)
    ndc = tri_clip[:, :, :3] / safe_w[:, :, None]
    return torch.stack([(ndc[:, :, 0] * 0.5 + 0.5) * width,
                        (0.5 - ndc[:, :, 1] * 0.5) * height,
                        ndc[:, :, 2], w_clip], dim=-1)


def _front(tri_scr: torch.Tensor) -> torch.Tensor:
    """(T,) bool: the triangles that can draw, front-facing (negative
    screen-space area: Ccw in NDC) with every corner at w > 1e-6."""
    X0, Y0 = tri_scr[:, 0, 0], tri_scr[:, 0, 1]
    X1, Y1 = tri_scr[:, 1, 0], tri_scr[:, 1, 1]
    X2, Y2 = tri_scr[:, 2, 0], tri_scr[:, 2, 1]
    area2 = (X1 - X0) * (Y2 - Y0) - (Y1 - Y0) * (X2 - X0)
    return (area2 < 0.0) & (tri_scr[:, :, 3] > _W_MIN).all(dim=1)


def _face_chunk(tri_scr, keys, px, py, best):
    """Rasterize a (C,) chunk of screen-space triangles against all
    pixels and merge its winners into `best` = (z, key, b0, b1), each
    (P,). The triangles are ones `_front` keeps; keys (C,) i32 are their
    draw-order indices, ascending."""
    c = tri_scr.shape[0]
    t = tri_scr[:, :, :, None]  # (C, 3, 4, 1): corners broadcast over P
    X0, Y0, Z0 = t[:, 0, 0], t[:, 0, 1], t[:, 0, 2]
    X1, Y1, Z1 = t[:, 1, 0], t[:, 1, 1], t[:, 1, 2]
    X2, Y2, Z2 = t[:, 2, 0], t[:, 2, 1], t[:, 2, 2]
    area2 = (X1 - X0) * (Y2 - Y0) - (Y1 - Y0) * (X2 - X0)

    # reversed edges -> positive interior weights for front faces
    w0 = _edge(X2, Y2, X1, Y1, px, py)
    w1 = _edge(X0, Y0, X2, Y2, px, py)
    w2 = _edge(X1, Y1, X0, Y0, px, py)
    inside = (_covers(w0, _top_left(X2, Y2, X1, Y1))
              & _covers(w1, _top_left(X0, Y0, X2, Y2))
              & _covers(w2, _top_left(X1, Y1, X0, Y0)))
    a2 = -area2
    a2s = torch.where(a2 != 0.0, a2, 1.0)
    l0, l1 = w0 / a2s, w1 / a2s  # screen-space barycentrics
    # z interpolates linearly in screen space (it is already z/w)
    z = l0 * Z0 + l1 * Z1 + (1.0 - l0 - l1) * Z2
    inside = inside & (z >= 0.0) & (z <= 1.0)
    z_cand = torch.where(inside, z, F32_INF)

    # the chunk's winner: the smallest z, and among equal z the earliest
    zmin = z_cand.amin(dim=0)
    slot = torch.arange(c, dtype=torch.int64, device=z.device)[:, None]
    first = torch.where(z_cand == zmin[None, :], slot, c).amin(dim=0)
    first = first.clamp_max(c - 1)[None, :]
    bz, bk, bb0, bb1 = best
    # Less: strictly closer replaces the carried (earlier) winner
    take = zmin < bz
    return (torch.where(take, zmin, bz),
            torch.where(take, keys[first[0]], bk),
            torch.where(take, l0.gather(0, first)[0], bb0),
            torch.where(take, l1.gather(0, first)[0], bb1))


def rasterize_winners(tri_scr: torch.Tensor, width: int, height: int,
                      depth: Optional[torch.Tensor] = None,
                      chunk: Optional[int] = None):
    """The per-pixel winners of screen-space triangles under depth Less
    in draw order: (z, key, b0, b1), each (H*W,), key INT32_MAX where no
    triangle won over the attachment `depth` (1.0 when None). `chunk`
    triangles go at a time (None: MAX_CHUNK_PAIRS // pixels); the result
    does not depend on it."""
    dev = tri_scr.device
    p = width * height
    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    ys = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    px = xs.repeat(height)
    py = ys.repeat_interleave(width)
    best = (torch.ones((p,), dtype=torch.float32, device=dev)
            if depth is None else depth.reshape(-1).to(torch.float32),
            torch.full((p,), _KEY_MAX, dtype=torch.int32, device=dev),
            torch.zeros((p,), dtype=torch.float32, device=dev),
            torch.zeros((p,), dtype=torch.float32, device=dev))
    keys = torch.nonzero(_front(tri_scr))[:, 0]
    tris = tri_scr.index_select(0, keys)
    keys = keys.to(torch.int32)
    if chunk is None:
        chunk = max(1, MAX_CHUNK_PAIRS // max(p, 1))
    for c0 in range(0, tris.shape[0], chunk):
        best = _face_chunk(tris[c0:c0 + chunk], keys[c0:c0 + chunk],
                           px, py, best)
    return best


def rasterize(tri_clip, tri_uv, width: int, height: int, tex,
              color=None, depth=None, chunk: Optional[int] = None):
    """Rasterize pre-transformed clip-space triangles, on their device.

    tri_clip: (T, 3, 4) f32 clip positions (vs_main output); tri_uv:
    (T, 3, 2) f32 tex_coords; tex: (TH, TW, 3) linear diffuse.
    color/depth: existing attachments to composite over (LoadOp::Load);
    None clears to black / 1.0. Returns (color (H, W, 3) linear f32,
    depth (H, W) f32)."""
    t = tri_clip.shape[0]
    p = width * height
    dev = tri_clip.device
    best_z, best_key, b0, b1 = rasterize_winners(
        screen_triangles(tri_clip, width, height), width, height,
        depth=depth, chunk=chunk)

    hit = best_key != _KEY_MAX
    tri_idx = torch.where(hit, torch.clamp_max(best_key, t - 1),
                          0).long()
    # perspective-correct UV from the winner's screen barycentrics:
    # persp_i = (l_i / w_i) / sum_j (l_j / w_j)
    w_c = tri_clip[:, :, 3]
    inv_w = torch.ones_like(w_c) / torch.clamp_min(w_c, _W_MIN)  # (T, 3)
    iw = inv_w[tri_idx]  # (P, 3)
    l2 = 1.0 - b0 - b1
    q0, q1, q2 = b0 * iw[:, 0], b1 * iw[:, 1], l2 * iw[:, 2]
    qs = q0 + q1 + q2
    qs = torch.where(qs != 0.0, qs, 1.0)
    uvw = tri_uv[tri_idx]  # (P, 3, 2)
    uv = (q0[:, None] * uvw[:, 0] + q1[:, None] * uvw[:, 1]
          + q2[:, None] * uvw[:, 2]) / qs[:, None]

    # fs_main: textureSample(t_diffuse), bilinear clamp-to-edge, no V-flip
    tex = torch.as_tensor(tex, dtype=torch.float32, device=dev)
    rgb = sample_texture_bilinear(
        tex[None], torch.tensor([[tex.shape[0], tex.shape[1]]],
                                dtype=torch.int32, device=dev),
        torch.zeros((p,), dtype=torch.int32, device=dev), uv[:, 0], uv[:, 1])

    base_c = (torch.zeros((p, 3), dtype=torch.float32, device=dev)
              if color is None else color.reshape(p, 3))
    base_d = (torch.ones((p,), dtype=torch.float32, device=dev)
              if depth is None else depth.reshape(-1))
    out_c = torch.where(hit[:, None], rgb, base_c).reshape(height, width, 3)
    out_d = torch.where(hit, best_z, base_d).reshape(height, width)
    return out_c, out_d


# --- DrawModel (src/model.rs:130-197) ---------------------------------


@dataclasses.dataclass
class RasterMaterial:
    """model::Material for the raster path (model.rs:108-115): name,
    diffuse texture (the array plays the bind group), Ka/Kd/Ks."""

    name: str
    diffuse: np.ndarray  # (TH, TW, 3) linear f32
    ambient: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    diffuse_k: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    specular: Tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclasses.dataclass
class RasterMesh:
    """model::Mesh (model.rs:117-123) without the GPU buffer handles:
    ModelVertex SoA (position, RAW tex_coords, normal; model.rs:37-43),
    the index list and the material slot."""

    name: str
    positions: np.ndarray  # (V, 3) f32
    tex_coords: np.ndarray  # (V, 2) f32
    normals: np.ndarray  # (V, 3) f32
    faces: np.ndarray  # (F, 3) i32
    material: int = 0


@dataclasses.dataclass
class RasterModel:
    meshes: List[RasterMesh]
    materials: List[RasterMaterial]


def load_model_raster(obj_path: str) -> RasterModel:
    """The dead load_model (resources.rs:68-161): OBJ -> per-mesh
    ModelVertex arrays + per-material diffuse textures, tex_coords kept
    RAW (the raster path has no V-flip anywhere)."""
    from ..config import resolve_asset
    from ..io.obj import load_obj
    from ..io.textures import load_texture_file, solid_texture

    path = resolve_asset(obj_path)
    meshes, materials = load_obj(path)
    rmats = []
    for m in materials:
        if m.map_kd:
            tex = load_texture_file(
                os.path.join(os.path.dirname(path), m.map_kd))
        else:
            tex = solid_texture((1.0, 1.0, 1.0))
        rmats.append(RasterMaterial(
            name=m.name, diffuse=tex.rgb_linear, ambient=m.ambient,
            diffuse_k=m.diffuse, specular=m.specular))
    rmeshes = [RasterMesh(
        name=ms.name, positions=ms.positions, tex_coords=ms.uvs,
        normals=ms.normals, faces=ms.faces, material=ms.material_id)
        for ms in meshes]
    return RasterModel(rmeshes, rmats)


def _dot4(a: torch.Tensor, b: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """a @ b over the last two axes (broadcast batch) with an inner
    dimension of 4, each element's four products summed as XLA's CPU dot
    sums them for the (m x 4) @ (4 x n) matrix product it lowers the
    einsum to (measured by shape with --xla_cpu_max_isa=SSE4_2, jax
    0.9.0):
    - n == 1 (a matrix-vector product): in index order;
    - m == 4 and n < 8, or m >= 20 and n < 48: a fused multiply-add
      chain in index order (the library kernel XLA calls there fuses);
    - otherwise pairwise, (p0 + p1) + (p2 + p3). With m >= 20 and
      n >= 48 XLA's order varies with m (pairwise at most m, a fused
      chain or neither at others), and the port's sum can be an ulp off."""
    p = [a[..., :, k:k + 1] * b[..., k:k + 1, :] for k in range(4)]
    if n == 1:
        return ((p[0] + p[1]) + p[2]) + p[3]
    if (m == 4 and n < 8) or (m >= 20 and n < 48):
        acc = p[0]
        for k in range(1, 4):
            acc = fma(a[..., :, k:k + 1].expand_as(acc),
                      b[..., k:k + 1, :].expand_as(acc), acc)
        return acc
    return (p[0] + p[1]) + (p[2] + p[3])


def instance_triangles(mesh: RasterMesh, model_mats, view_proj, *,
                       device):
    """The vertex stage of a draw (vs_main, shader.wgsl:25-39): clip =
    VP @ M @ [p, 1] for every instance's vertices. Returns (tri_clip
    (I*F, 3, 4), tri_uv (I*F, 3, 2)) on `device`, instance-major."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    mm = f32(model_mats)  # (I, 4, 4)
    pos = f32(mesh.positions)
    pos_h = torch.cat([pos, torch.ones((pos.shape[0], 1),
                                       dtype=torch.float32, device=device)],
                      dim=1)
    n_inst, n_vert = mm.shape[0], pos.shape[0]
    # einsum("ab,ibc->iac"): (4 x 4) @ (4 x 4I); "iab,vb->iva": (4I x 4)
    # @ (4 x V)
    mvp = _dot4(f32(view_proj)[None], mm, 4, 4 * n_inst)  # (I, 4, 4)
    clip = _dot4(mvp, pos_h.t()[None], 4 * n_inst, n_vert).transpose(1, 2)
    faces = torch.as_tensor(np.asarray(mesh.faces, np.int64), device=device)
    tri_clip = clip[:, faces].reshape(-1, 3, 4)
    uvf = f32(mesh.tex_coords)[faces]  # (F, 3, 2)
    tri_uv = uvf[None].expand((mm.shape[0],) + tuple(uvf.shape))
    return tri_clip, tri_uv.reshape(-1, 3, 2)


class RasterEncoder:
    """The RenderPass + DrawModel surface (model.rs:130-197), on one
    device.

    Owns the pass's colour and depth attachments; each draw_* composites
    into them under the pipeline rules above. `view_proj` plays the
    camera bind group (the forward CameraUniform = OPENGL_TO_WGPU @ proj
    @ view); the material's texture plays group 0. Instanced draws take
    (I, 4, 4) model matrices (the InstanceRaw vertex buffer,
    lib.rs:129-134)."""

    def __init__(self, width: int, height: int,
                 clear_color=(0.0, 0.0, 0.0), *, device):
        self.width, self.height = width, height
        self.device = torch.device(device)
        self.color = torch.as_tensor(
            np.asarray(clear_color, np.float32), device=self.device
        ).expand(height, width, 3).contiguous()
        # create_depth_texture + Clear(1.0) (texture.rs:13-54)
        self.depth = DepthTexture.create(height, width, device=self.device)

    def _draw(self, mesh: RasterMesh, material: RasterMaterial,
              model_mats, view_proj):
        tri_clip, tri_uv = instance_triangles(mesh, model_mats, view_proj,
                                              device=self.device)
        tex = torch.as_tensor(np.asarray(material.diffuse, np.float32),
                              device=self.device)
        self.color, d = rasterize(tri_clip, tri_uv, self.width, self.height,
                                  tex, color=self.color,
                                  depth=self.depth.data)
        self.depth = DepthTexture(d)
        return self

    # the four DrawModel methods (model.rs:130-197)
    def draw_mesh(self, mesh, material, view_proj):
        """draw_mesh = draw_mesh_instanced(0..1) (model.rs:158-166)."""
        return self.draw_mesh_instanced(
            mesh, material, np.eye(4, dtype=np.float32)[None], view_proj)

    def draw_mesh_instanced(self, mesh, material, instances, view_proj):
        return self._draw(mesh, material, instances, view_proj)

    def draw_model(self, model: RasterModel, view_proj):
        """draw_model = draw_model_instanced(0..1) (model.rs:182-184)."""
        return self.draw_model_instanced(
            model, np.eye(4, dtype=np.float32)[None], view_proj)

    def draw_model_instanced(self, model: RasterModel, instances,
                             view_proj):
        """Every mesh with its own material slot (model.rs:186-197)."""
        for mesh in model.meshes:
            self._draw(mesh, model.materials[mesh.material],
                       instances, view_proj)
        return self
