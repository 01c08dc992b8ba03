"""The plain reference's lit frame of a normal-mapped scene
(rtbench/scenes/normalmapped.py), in plain PyTorch, from the benchmark's
own inputs: nothing of the program.

It follows reference.frame.lit_pixels (each sphere with its hard shadow
test, then the mesh; a pass folds in where its nonlinear depth is
strictly less; Blinn-Phong with shininess 32; the rgba8 quantize) and
shades each mesh hit with its perturbed normal:

- n: the geometric normal, flipped toward the ray;
- the vertex normals interpolated with the hit's barycentric weights,
  normalized and turned to n's side, take n's place where their squared
  length is over 1e-12;
- the face's tangent frame (T, B) from its uv deltas, each normalized,
  zero where the uvs are degenerate;
- the map_Bump texel s at (u, 1 - v), bilinear with clamp to edge, from
  the raw u8 / 255 values;
- nt = 2 s - 1 and p = nt.x T + nt.y B + nt.z n, which is the normal,
  normalized, where T is not zero and |p| > 1e-12.

The shadow ray leaves hit + p * 1e-3 toward -light, against the mesh and
the spheres. This departs twice from the usual published convention,
MikkTSpace per-vertex tangents: the tangent frame is flat per face, and
the bump map's bytes are read as they are, with no sRGB decode (which
the map_Kd texture's bytes do get).

Every tensor is made in the scene's dtype, so the same code is the f32
reference and, in bfloat16, its control.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rtbench.reference import scene as ref_scene
from rtbench.reference import trace
from rtbench.reference.frame import (SHADOW_EPS, _blinn, _nonlinear_depth,
                                     _shadow_lit, pixel_dirs)
from rtbench.reference.scene import RefScene

TINY = 1e-12  # the squared lengths and lengths below which a term drops


@dataclass
class NMScene:
    ref: RefScene  # triangles, planes, texture, material, spheres
    vn3: torch.Tensor  # (F, 3, 3) each corner's vertex normal
    tangent: torch.Tensor  # (F, 3) unit, or zero on degenerate uvs
    bitangent: torch.Tensor  # (F, 3)
    bump: torch.Tensor  # (BH, BW, 3) raw u8 / 255

    @property
    def dtype(self):
        return self.ref.dtype


def _unit_rows(x):
    length = torch.sqrt((x * x).sum(-1, keepdim=True))
    return torch.where(length > TINY, x / length.clamp_min(TINY), 0.0)


def tangent_frame(pos, uv, faces):
    """(T, B) (F, 3) of each face from its corners' positions and uvs."""
    p0, p1, p2 = pos[faces[:, 0]], pos[faces[:, 1]], pos[faces[:, 2]]
    t0, t1, t2 = uv[faces[:, 0]], uv[faces[:, 1]], uv[faces[:, 2]]
    duv1, duv2 = t1 - t0, t2 - t0
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    inv = torch.where(det.abs() > TINY,
                      1.0 / torch.where(det == 0, 1.0, det), 0.0)[:, None]
    e1, e2 = p1 - p0, p2 - p0
    t = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * inv
    b = (e2 * duv1[:, 0:1] - e1 * duv2[:, 0:1]) * inv
    return _unit_rows(t), _unit_rows(b)


def build(inputs, *, device, dtype=torch.float32) -> NMScene:
    """`inputs`: the kind's NormalMappedInputs."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32),
                               device=device).to(dtype)

    pos = t(inputs.positions) * float(inputs.scale) + t(inputs.translation)
    faces = torch.as_tensor(inputs.faces, device=device).long()
    tan, bit = tangent_frame(pos, t(inputs.uvs), faces)
    return NMScene(ref=ref_scene.build(inputs, device=device, dtype=dtype),
                   vn3=t(inputs.normals)[faces], tangent=tan, bitangent=bit,
                   bump=t(np.asarray(inputs.bump_u8, np.float32) / 255.0))


def shading_normal(s: NMScene, mh: trace.MeshHit, tu, tv):
    """(R, 3) the perturbed normal of each mesh hit (module docstring),
    whose texture coordinates are (tu, tv) (trace.mesh_uv)."""
    n = trace.normalize(s.ref.n[mh.face])
    n = torch.where(mh.nd[:, None] > 0.0, -n, n)
    vn3 = s.vn3[mh.face]
    w = 1.0 - mh.u - mh.v
    vn = (mh.u[:, None] * vn3[:, 0] + mh.v[:, None] * vn3[:, 1]
          + w[:, None] * vn3[:, 2])
    vl2 = (vn * vn).sum(-1, keepdim=True)
    has_vn = vl2 > TINY
    vn = vn / torch.sqrt(torch.where(has_vn, vl2, 1.0))
    side = torch.where((vn * n).sum(-1, keepdim=True) < 0.0, -1.0, 1.0)
    n = torch.where(has_vn, vn * side, n)

    nt = 2.0 * trace.sample_texture(s.bump, tu, tv) - 1.0
    tan, bit = s.tangent[mh.face], s.bitangent[mh.face]
    p = nt[:, 0:1] * tan + nt[:, 1:2] * bit + nt[:, 2:3] * n
    plen = torch.sqrt((p * p).sum(-1, keepdim=True))
    use = ((tan * tan).sum(-1, keepdim=True) > TINY) & (plen > TINY)
    return torch.where(use, p / torch.where(plen > TINY, plen, 1.0), n)


def lit_pixels(scene: NMScene, cam, xs, ys, *, width, height, render,
               near=0.01, far=100.0, background=(0.0, 0.0, 0.0)):
    """(P, 3) linear colour, quantized to rgba8 levels, at pixels
    (xs, ys) of a width x height frame seen from `cam`, with shadows
    where render["shadows"] (the scene kind's reference_lit)."""
    s = scene.ref
    shadows = bool(render["shadows"])
    dt = s.dtype
    d = pixel_dirs(cam, xs, ys, width, height, dt)
    o = torch.as_tensor(cam.uniforms()[2], device=d.device).to(dt)
    p_n = d.shape[0]
    color = torch.tensor(background, device=d.device).to(dt).expand(
        p_n, 3).clone()
    depth = torch.ones((p_n,), dtype=dt, device=d.device)

    def fold(color, depth, pc, t, hit):
        z = _nonlinear_depth(t, near, far)
        write = hit & (z < depth)
        return (torch.where(write[:, None], pc, color),
                torch.where(write, z, depth))

    for i in range(s.num_spheres):
        t = trace.sphere_t(s.sph_center[i], s.sph_radius[i], o, d)
        hit = torch.isfinite(t)
        ts = torch.where(hit, t, 0.0)
        nrm = trace.normalize(o + d * ts[:, None] - s.sph_center[i])
        nrm = torch.where(hit[:, None], nrm, 0.0)
        lit = None
        if shadows:
            p = o + d * ts[:, None] + nrm * SHADOW_EPS
            lit = _shadow_lit(s, p, s.sph_light[i], hit)
        col = s.sph_color[i]
        coeff = s.sph_coeff[i]
        pc = _blinn(nrm, d, s.sph_light[i], col * coeff[1], col * coeff[0],
                    coeff[2].expand(3), lit)
        color, depth = fold(color, depth, pc, t, hit)

    if s.num_faces:
        mh = trace.closest_mesh(s, o, d, 0.0)
        hit = torch.isfinite(mh.t)
        tu, tv = trace.mesh_uv(s, mh)
        nrm = shading_normal(scene, mh, tu, tv)
        lit = None
        if shadows:
            ts = torch.where(hit, mh.t, 0.0)
            p = o + d * ts[:, None] + nrm * SHADOW_EPS
            lit = _shadow_lit(s, p, s.light, hit)
        tex = trace.sample_texture(s.tex, tu, tv)
        pc = _blinn(nrm, d, s.light, tex, s.ambient, s.specular, lit)
        pc = torch.where(hit[:, None], pc, 0.0)
        color, depth = fold(color, depth, pc, mh.t, hit)
    return torch.floor(color.float().clamp(0.0, 1.0) * 255.0 + 0.5) / 255.0
