"""The reference's lit frame at chosen pixels (the reference rust project's
pass choreography, src/lib.rs:1012-1230, with the shadow extension).

Passes in order: each sphere with its hard shadow test, then the mesh
with its shadow rays; each folds into the framebuffer where it hits and
its nonlinear depth is strictly less (sphere/compute.wgsl:128-156), so an
earlier pass wins a tie. Blinn-Phong with shininess 32: spheres take
their colour, coefficients and light; the mesh takes the MTL ambient and
specular, the texture sample times Lambert, and its light. Then the
rgba8 quantize. Returns linear colour per pixel.
"""

from __future__ import annotations

import numpy as np
import torch

from . import trace
from .camera import Camera
from .scene import RefScene

SHADOW_EPS = 1e-3
SHININESS = 32.0


def pixel_dirs(cam: Camera, xs, ys, width: int, height: int, dtype,
               jitter=None):
    """Normalized directions (P, 3) through pixel centres (xs, ys), texel
    row 0 at the bottom; `jitter` = (jx, jy) NDC offsets."""
    m, const = cam.ray_matrix()
    dev = xs.device
    x = (2.0 * (xs.to(torch.float32) + 0.5)) * float(
        np.float32(1.0) / np.float32(width)) - 1.0
    y = (2.0 * (ys.to(torch.float32) + 0.5)) * float(
        np.float32(1.0) / np.float32(height)) - 1.0
    if jitter is not None:
        x, y = x + jitter[0], y + jitter[1]
    x, y = x.to(dtype), y.to(dtype)
    mt = torch.as_tensor(m, device=dev).to(dtype)
    ct = torch.as_tensor(const, device=dev).to(dtype)
    d = x[:, None] * mt[None, :, 0] + y[:, None] * mt[None, :, 1] + ct[None]
    return trace.normalize(d)


def _blinn(n, d, light, diffuse, ambient, specular, lit):
    lgt = trace.normalize(light.expand(n.shape))
    lam = (n * -lgt).sum(-1).clamp_min(0.0)
    half = trace.normalize(-lgt - d)
    spec = (half * n).sum(-1).clamp_min(0.0) ** SHININESS
    if lit is not None:
        lam = torch.where(lit, lam, 0.0)
        spec = torch.where(lit, spec, 0.0)
    return ambient + diffuse * lam[:, None] + specular * spec[:, None]


def _nonlinear_depth(t, near, far):
    return ((1.0 / t) - 1.0 / near) / (1.0 / far - 1.0 / near)


def _shadow_lit(s: RefScene, p, light, hit):
    sd = (-trace.normalize(light.expand(p.shape))).contiguous()
    idx = hit.nonzero().squeeze(1)
    ps, ds = p[idx], sd[idx]
    occ = trace.occluded_mesh(s, ps, ds, SHADOW_EPS)
    occ |= trace.occluded_spheres(s, ps, ds, SHADOW_EPS)
    lit = torch.ones(hit.shape, dtype=torch.bool, device=hit.device)
    lit[idx] = ~occ
    return lit


def lit_pixels(s: RefScene, cam: Camera, xs, ys, *, width, height,
               shadows=True, near=0.01, far=100.0,
               background=(0.0, 0.0, 0.0)):
    """(P, 3) linear colour, quantized to rgba8 levels, at pixels
    (xs, ys) of a width x height frame seen from `cam`."""
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
        nrm = trace.normalize(s.n[mh.face])
        nrm = torch.where(mh.nd[:, None] > 0.0, -nrm, nrm)
        lit = None
        if shadows:
            ts = torch.where(hit, mh.t, 0.0)
            p = o + d * ts[:, None] + nrm * SHADOW_EPS
            lit = _shadow_lit(s, p, s.light, hit)
        tu, tv = trace.mesh_uv(s, mh)
        tex = trace.sample_texture(s.tex, tu, tv)
        pc = _blinn(nrm, d, s.light, tex, s.ambient, s.specular, lit)
        pc = torch.where(hit[:, None], pc, 0.0)
        color, depth = fold(color, depth, pc, mh.t, hit)
    return torch.floor(color.float().clamp(0.0, 1.0) * 255.0 + 0.5) / 255.0
