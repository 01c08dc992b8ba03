"""Shading for the oracle, and the framebuffer quantization (JAX
ops/shade.py).

Matches the reference kernels' shading exactly:
- spheres (sphere/compute.wgsl:137-152): hardcoded coefficients
  (ambient .1, diffuse 1, specular .5), material color red, shininess 32,
  light dir (1,-5,1);
- meshes (triangle_list/compute.wgsl:217-234): ambient/specular from the
  MTL material uniform, diffuse from the texture sample * lambert,
  shininess hardcoded 32, light dir (1,-1,-5), UV V-flip at :223.

Texture sampling reproduces textureSampleGrad with zero gradients on a
clamp-to-edge linear-mag sampler (texture.rs:151-158): bilinear at mip 0,
from the f32 texture stack SceneData.textures. Rays are (R, 3) here.
The frames shade in ops/megakernel.py and ops/fusedframe.py from the
packed u16 pools; these functions are the oracle's.

Float semantics as the JAX package's: three-term sums in index order,
lengths sqrt(x*x + y*y + z*z) (rounding.sqrt), the specular power
torch's pow (within 1 ulp of XLA's) with its denormals flushed
(rounding.ftz).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.scene import SceneData
from .intersect import _dot3
from .rounding import ftz, sqrt

SHININESS = 32.0  # hardcoded in both kernels (sphere/compute.wgsl:145)
# the f32 constant the JAX package folds on the host (no divide op)
_INV255 = float(np.float32(1.0 / 255.0))
_EPS12 = float(np.float32(1e-12))


def _normalize(v):
    """v / |v| over the last axis."""
    return v / sqrt(_dot3(v, v))[..., None]


def blinn_phong(normal, ray_dir, light_dir, diffuse_color, ambient_color,
                specular_color, lit=None):
    """Shared Blinn-Phong core.

    color = ambient_color + diffuse_color * max(0, n.(-L))
          + specular_color * max(0, h.n)^32,   h = normalize(-L - D)
    with L = normalize(light_dir). `lit` (optional bool mask) zeroes the
    direct terms for shadowed points (shadow extension)."""
    l = _normalize(light_dir)
    lam = _dot3(normal, -l).clamp_min(0.0)
    half = _normalize(-l - ray_dir)
    spec = ftz(_dot3(half, normal).clamp_min(0.0) ** SHININESS)
    if lit is not None:
        lam = torch.where(lit, lam, 0.0)
        spec = torch.where(lit, spec, 0.0)
    return (ambient_color + diffuse_color * lam[..., None]
            + specular_color * spec[..., None])


def shade_sphere(scene: SceneData, i: int, normal, ray_dir, lit=None):
    """Sphere shading (sphere/compute.wgsl:137-152): diffuse_color is the
    sphere's flat color scaled by the diffuse coefficient; ambient scales
    the SAME color; specular is white * coefficient."""
    coeff = scene.sphere_coeff[i]  # [ambient, diffuse, specular]
    color = scene.sphere_color[i]
    return blinn_phong(normal, ray_dir, scene.sphere_light[i],
                       diffuse_color=color * coeff[1],
                       ambient_color=color * coeff[0],
                       specular_color=coeff[2].expand(3), lit=lit)


def sample_texture_bilinear(textures, tex_hw, tex_id, u, v):
    """Bilinear clamp-to-edge sample from the stacked texture array.

    textures: (T, TH, TW, 3); tex_hw: (T, 2) true sizes; tex_id: (R,)
    integer; u, v: (R,) f32 normalized coords (v NOT yet flipped — the
    caller applies the reference's V-flip). WGSL linear filtering: texel
    centers at integer+0.5, footprint clamped to the edge."""
    tex_id = tex_id.long()
    h = tex_hw[tex_id, 0].to(torch.float32)
    w = tex_hw[tex_id, 1].to(torch.float32)

    x = u * w - 0.5
    y = v * h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[:, None]
    fy = (y - y0f)[:, None]

    hi_x = (w - 1.0).to(torch.int64)
    hi_y = (h - 1.0).to(torch.int64)
    xi = x0f.to(torch.int32).to(torch.int64)
    yi = y0f.to(torch.int32).to(torch.int64)
    x0 = torch.minimum(xi.clamp_min(0), hi_x)
    x1 = torch.minimum((xi + 1).clamp_min(0), hi_x)
    y0 = torch.minimum(yi.clamp_min(0), hi_y)
    y1 = torch.minimum((yi + 1).clamp_min(0), hi_y)

    c00 = textures[tex_id, y0, x0]
    c10 = textures[tex_id, y0, x1]
    c01 = textures[tex_id, y1, x0]
    c11 = textures[tex_id, y1, x1]

    top = c00 * (1.0 - fx) + c10 * fx
    bot = c01 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def shade_mesh_hit(scene: SceneData, face, u, v, n_dot_d, ray_dir, lit=None,
                   normal_mapping: bool = False):
    """Mesh-hit shading from G-buffer values (face index + barycentrics),
    triangle_list/compute.wgsl:208-234: barycentric UV interpolation with
    weights (u, v, 1-u-v) on corners (0,1,2), V-flip, bilinear texture
    fetch, Blinn-Phong with MTL ambient/specular. The geometric normal is
    normalize(N) flipped against the ray (compute.wgsl:140-147). With
    normal_mapping: the interpolated vertex normal where there is one,
    aligned with the geometric normal, then the map_Bump perturbation in
    the face's tangent frame."""
    w = 1.0 - u - v
    uv3 = scene.tri_uv[face]  # (R, 3, 2)
    uv = (u[:, None] * uv3[:, 0, :] + v[:, None] * uv3[:, 1, :]
          + w[:, None] * uv3[:, 2, :])
    tex_u = uv[:, 0]
    tex_v = 1.0 - uv[:, 1]  # V-flip (compute.wgsl:223)

    n = _normalize(scene.tri_n[face])
    n = torch.where(n_dot_d[:, None] > 0.0, -n, n)

    if normal_mapping:
        vn3 = scene.tri_vn[face]
        vn = (u[:, None] * vn3[:, 0, :] + v[:, None] * vn3[:, 1, :]
              + w[:, None] * vn3[:, 2, :])
        has_vn = _dot3(vn, vn)[:, None] > _EPS12
        vn = torch.where(has_vn, _normalize(torch.where(has_vn, vn, 1.0)), n)
        vn = torch.where(_dot3(vn, n)[:, None] < 0.0, -vn, vn)
        n = vn

        bump_id = scene.mat_bump[scene.tri_mat[face].long()]
        has_bump = bump_id >= 0
        brgb = sample_texture_bilinear(scene.textures, scene.tex_hw,
                                       bump_id.clamp_min(0), tex_u, tex_v)
        nt = 2.0 * brgb - 1.0
        tangent = scene.tri_tangent[face]
        bitangent = scene.tri_bitangent[face]
        frame_ok = _dot3(tangent, tangent)[:, None] > _EPS12
        pert = (nt[:, 0:1] * tangent + nt[:, 1:2] * bitangent
                + nt[:, 2:3] * n)
        plen = sqrt(_dot3(pert, pert))[:, None]
        pert = pert / torch.where(plen > _EPS12, plen, 1.0)
        use = has_bump[:, None] & frame_ok & (plen > _EPS12)
        n = torch.where(use, pert, n)

    mat = scene.tri_mat[face].long()
    tex_rgb = sample_texture_bilinear(scene.textures, scene.tex_hw,
                                      scene.mat_tex[mat], tex_u, tex_v)
    return blinn_phong(n, ray_dir, scene.mat_light[mat],
                       diffuse_color=tex_rgb,
                       ambient_color=scene.mat_ambient[mat],
                       specular_color=scene.mat_specular[mat], lit=lit)


def quantize_rgba8(color: torch.Tensor) -> torch.Tensor:
    """Model the rgba8unorm storage-texture write (sphere/compute.wgsl:2):
    clamp to [0,1] and round to 8-bit levels.

    The dequantize multiplies by an EXPLICIT f32 reciprocal instead of
    dividing, exactly as the JAX package's shade.quantize_rgba8 does, so
    the two agree bit for bit."""
    c = color.clamp(0.0, 1.0)
    return torch.floor(c * 255.0 + 0.5) * _INV255
