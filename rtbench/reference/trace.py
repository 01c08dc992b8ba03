"""Brute-force ray queries for the reference: every ray against every face.

Semantics of the reference rust project's kernels, as the program states
them: a face is hit where |N.D| >= 1e-6, t >= t_min and all three
inside-outside values are >= 0 (edges and vertices hit); the first face
of least t wins. Spheres: the full quadratic (sphere/compute.wgsl:63-85),
the near root where it is >= t_min, else the far one.

Rays run in blocks of at most MAX_PAIRS (ray, face) pairs, so the (rays,
faces) temporaries stay bounded at any mesh size.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .scene import RefScene

K_EPSILON = 1e-6
MAX_PAIRS = 1 << 26
INF = float("inf")


class MeshHit(NamedTuple):
    t: torch.Tensor  # (R,), inf on a miss
    face: torch.Tensor  # (R,) int64
    u: torch.Tensor  # barycentric weight of corner 0
    v: torch.Tensor  # of corner 1
    nd: torch.Tensor  # N.D of the winner


def _blocks(n_rays: int, n_faces: int):
    step = max(1, MAX_PAIRS // max(n_faces, 1))
    return range(0, n_rays, step), step


def _dot(a, b):
    """(R, F) dots of rays (R, 3) with face vectors (F, 3)."""
    return (a[:, None, 0] * b[None, :, 0] + a[:, None, 1] * b[None, :, 1]
            + a[:, None, 2] * b[None, :, 2])


def _planes(s: RefScene, o, d, t_min):
    nd = _dot(d, s.n)
    t = -(_dot(o, s.n) + s.d[None, :]) / nd
    hit = (nd.abs() >= K_EPSILON) & (t >= t_min)
    h = []
    for i in range(3):
        hi = (_dot(o, s.g[:, i]) - s.c[None, :, i]) + t * _dot(d, s.g[:, i])
        hit &= hi >= 0.0
        h.append(hi)
    return t, nd, hit, h


def closest_mesh(s: RefScene, o, d, t_min: float = 0.0) -> MeshHit:
    """Closest hit of rays (R, 3) from origins o (R, 3) or (3,)."""
    o = o.expand(d.shape)
    r = d.shape[0]
    out = [torch.full((r,), INF, dtype=d.dtype, device=d.device),
           torch.zeros((r,), dtype=torch.int64, device=d.device),
           torch.zeros((r,), dtype=d.dtype, device=d.device),
           torch.zeros((r,), dtype=d.dtype, device=d.device),
           torch.zeros((r,), dtype=d.dtype, device=d.device)]
    if s.num_faces == 0:
        return MeshHit(*out)
    starts, step = _blocks(r, s.num_faces)
    for r0 in starts:
        sl = slice(r0, r0 + step)
        t, nd, hit, h = _planes(s, o[sl], d[sl], t_min)
        tmin, face = torch.where(hit, t, INF).min(dim=1)
        idx = face[:, None]
        won = torch.isfinite(tmin)
        out[0][sl] = tmin
        out[1][sl] = face
        # a miss keeps zero attributes (its planes may be nan)
        for k, plane in ((2, h[1]), (3, h[2])):
            out[k][sl] = torch.where(
                won, plane.gather(1, idx)[:, 0] * s.inv_denom[face], 0.0)
        out[4][sl] = torch.where(won, nd.gather(1, idx)[:, 0], 0.0)
    return MeshHit(*out)


def occluded_mesh(s: RefScene, o, d, t_min: float = 1e-3):
    """Any hit of rays (R, 3) from origins (R, 3) at t >= t_min."""
    o = o.expand(d.shape)
    r = d.shape[0]
    occ = torch.zeros((r,), dtype=torch.bool, device=d.device)
    if s.num_faces == 0 or r == 0:
        return occ
    starts, step = _blocks(r, s.num_faces)
    for r0 in starts:
        sl = slice(r0, r0 + step)
        occ[sl] = _planes(s, o[sl], d[sl], t_min)[2].any(dim=1)
    return occ


def sphere_t(center, radius, o, d, t_min: float = 0.0):
    """(R,) distance to one sphere, inf on a miss."""
    oc = o - center
    a = (d * d).sum(-1)
    b = 2.0 * (oc * d).sum(-1)
    c = (oc * oc).sum(-1) - radius * radius
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(disc.clamp_min(0.0))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    t = torch.where(t1 >= t_min, t1, torch.where(t2 >= t_min, t2, INF))
    return torch.where((disc < 0.0) | (a <= 0.0), INF, t)


def occluded_spheres(s: RefScene, o, d, t_min: float = 1e-3):
    occ = torch.zeros(d.shape[:1], dtype=torch.bool, device=d.device)
    for i in range(s.num_spheres):
        occ |= torch.isfinite(sphere_t(s.sph_center[i], s.sph_radius[i],
                                       o, d, t_min))
    return occ


def normalize(v):
    return v / torch.sqrt((v * v).sum(-1, keepdim=True))


def sample_texture(tex, u, v):
    """Bilinear, clamp to edge, texel centres at integer + 0.5 (the
    reference's linear sampler at mip 0); v already flipped."""
    h, w = tex.shape[0], tex.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0f)[:, None], (y - y0f)[:, None]
    xi, yi = x0f.long(), y0f.long()
    x0, x1 = xi.clamp(0, w - 1), (xi + 1).clamp(0, w - 1)
    y0, y1 = yi.clamp(0, h - 1), (yi + 1).clamp(0, h - 1)
    top = tex[y0, x0] * (1.0 - fx) + tex[y0, x1] * fx
    bot = tex[y1, x0] * (1.0 - fx) + tex[y1, x1] * fx
    return top * (1.0 - fy) + bot * fy


def mesh_uv(s: RefScene, hit: MeshHit):
    """Interpolated texture coordinates (u, 1 - v): the V flip of
    triangle_list/compute.wgsl:223."""
    uv3 = s.uv3[hit.face]
    w = 1.0 - hit.u - hit.v
    uv = (hit.u[:, None] * uv3[:, 0] + hit.v[:, None] * uv3[:, 1]
          + w[:, None] * uv3[:, 2])
    return uv[:, 0], 1.0 - uv[:, 1]
