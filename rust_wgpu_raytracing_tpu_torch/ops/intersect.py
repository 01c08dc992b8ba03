"""Ray-primitive intersection, vectorized over rays and faces (JAX
ops/intersect.py): the oracle's executable spec of the reference's WGSL
intersectors, which the sweep kernels implement tiled.

Conventions:
- ray directions are normalized f32; the primary-ray origin is shared
  (the eye) but a per-ray origin is supported for shadow rays;
- "miss" is encoded as t = +inf;
- all faces are the padded triangle soup of core/scene.py; padding faces
  have inv_denom == 0 and tri_valid == 0 and can never hit.

Rays are (R, 3) here (callers flatten), faces (F, ...). The JAX package
computes the K=3 contractions N.D, O.g_i and D.g_i as HIGHEST-precision
matmuls; here they are explicit products summed in index order, which
is what XLA's f32 dot computes, on any backend and without TF32. The
(R, F, 3) edge-plane tensor of the JAX code is never formed: each edge
plane is an (R, F) tensor of its own, and the winner's barycentric
planes are recomputed from its face with the same expressions (the same
floats).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.scene import SceneData
from .rounding import sqrt

K_EPSILON = 1e-6  # reference kEpsilon, triangle_list/compute.wgsl:53
INF = float("inf")


class SphereHit(NamedTuple):
    t: torch.Tensor  # (R,) f32, +inf on miss
    normal: torch.Tensor  # (R, 3) f32


class TriHit(NamedTuple):
    t: torch.Tensor  # (R,) f32, +inf on miss
    face: torch.Tensor  # (R,) i64 index of winning face (first-min wins)
    u: torch.Tensor  # (R,) f32 barycentric weight of corner 0
    v: torch.Tensor  # (R,) f32 barycentric weight of corner 1
    n_dot_d: torch.Tensor  # (R,) f32 sign decides normal flip


def _dot3(a, b):
    """Last-axis dot of two broadcasting (..., 3) tensors, in index order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _face_dot(rays, planes):
    """(R, F) rays (R, 3) . planes (F, 3), in index order."""
    return (rays[:, None, 0] * planes[None, :, 0]
            + rays[:, None, 1] * planes[None, :, 1]
            + rays[:, None, 2] * planes[None, :, 2])


def intersect_sphere(center, radius, origin, dirs) -> SphereHit:
    """Analytic sphere intersection (sphere/compute.wgsl:63-85): the full
    quadratic with a = D.D, b = 2 oc.D, a strict discriminant < 0 miss,
    then t1 (near) if >= 0 else t2 (far) if >= 0. `origin` broadcasts
    against `dirs` (R, 3)."""
    oc = origin - center
    a = _dot3(dirs, dirs)
    b = 2.0 * _dot3(oc, dirs)
    c = _dot3(oc, oc) - radius * radius

    disc = b * b - 4.0 * a * c
    sq = sqrt(disc.clamp_min(0.0))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)

    t = torch.where(t1 >= 0.0, t1, torch.where(t2 >= 0.0, t2, INF))
    t = torch.where(disc < 0.0, INF, t)

    point = origin + dirs * t[:, None]
    n = point - center
    normal = n / sqrt(_dot3(n, n))[:, None]
    return SphereHit(t=t, normal=normal)


def _face_origin_terms(scene: SceneData, origin):
    """Per-face affine constants for a ray origin O (3,):
    t_num = -(N.O + d);  h_c[i] = O.g_i - c_i.  Shapes (F,), (F,3)."""
    t_num = -(_dot3(scene.tri_n, origin) + scene.tri_d)
    h_c = _dot3(scene.tri_g, origin) - scene.tri_c
    return t_num, h_c


def intersect_tris(scene: SceneData, origin, dirs, t_max=None) -> TriHit:
    """Brute-force all-faces intersection for rays (R, 3) with a SHARED
    origin (3,): the reference loop's semantics
    (triangle_list/compute.wgsl:82-148,186-202):
    - parallel reject: |N.D| < kEpsilon (N unnormalized);
    - behind reject: t < 0;
    - inside-outside: all three edge-plane values >= 0 (edges and
      vertices hit);
    - the first face of minimal t wins (argmin of where(hit, t, inf))."""
    t_num, h_c = _face_origin_terms(scene, origin)
    ndotd = _face_dot(dirs, scene.tri_n)
    t = t_num[None, :] / ndotd

    hit = (ndotd.abs() >= K_EPSILON) & (t >= 0.0) & \
        (scene.tri_valid[None, :] > 0.0)
    for i in range(3):
        hit &= h_c[None, :, i] + t * _face_dot(dirs, scene.tri_g[:, i]) >= 0.0
    if t_max is not None:
        hit &= t < t_max
    tmin, face = torch.where(hit, t, INF).min(dim=1)

    # the winner's planes, recomputed with the sweep's expressions
    nd = ndotd.gather(1, face[:, None])[:, 0]
    tw = t.gather(1, face[:, None])[:, 0]
    g = scene.tri_g[face]  # (R, 3, 3)
    u_raw = h_c[face, 1] + tw * _dot3(dirs, g[:, 1])
    v_raw = h_c[face, 2] + tw * _dot3(dirs, g[:, 2])
    inv_denom = scene.tri_inv_denom[face]
    return TriHit(t=tmin, face=face, u=u_raw * inv_denom,
                  v=v_raw * inv_denom, n_dot_d=nd)


def occluded_tris(scene: SceneData, origins, dirs, t_min=1e-3, t_max=None):
    """Any-hit query for shadow rays with PER-RAY origins (R, 3) (or one
    origin broadcasting): (R,) bool, True if any valid face intersects
    in [t_min, t_max)."""
    o2 = origins.expand(dirs.shape)
    ndotd = _face_dot(dirs, scene.tri_n)
    ndoto = _face_dot(o2, scene.tri_n)
    t = -(ndoto + scene.tri_d[None, :]) / ndotd

    hit = (ndotd.abs() >= K_EPSILON) & (t >= t_min) & \
        (scene.tri_valid[None, :] > 0.0)
    for i in range(3):
        g = scene.tri_g[:, i]
        og = _face_dot(o2, g) - scene.tri_c[None, :, i]
        hit &= og + t * _face_dot(dirs, g) >= 0.0
    if t_max is not None:
        hit &= t < t_max
    return hit.any(dim=1)


def occluded_spheres(scene: SceneData, origins, dirs, t_min=1e-3):
    """Any-hit of rays (R, 3) against all spheres."""
    occ = torch.zeros(dirs.shape[:-1], dtype=torch.bool, device=dirs.device)
    for i in range(scene.num_spheres):
        sh = intersect_sphere(scene.sphere_center[i], scene.sphere_radius[i],
                              origins, dirs)
        occ = occ | ((sh.t >= t_min) & torch.isfinite(sh.t))
    return occ
