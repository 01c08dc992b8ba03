"""Single-triangle model (reference src/models/triangle/triangle.rs).

The reference's Triangle is DEAD CODE — exported by models/mod.rs:2 but
never instantiated; its kernel is a hardcoded-uniform, no-barycentrics
variant of the list kernel (triangle/compute.wgsl:65-125). Kept for API
completeness, as in the JAX package (models/triangle.py): a one-face
mesh with flat shading, over planar rays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..ops.composite import to_nonlinear_depth
from ..ops.intersect import K_EPSILON


@dataclass(frozen=True)
class Triangle:
    p0: Tuple[float, float, float]
    p1: Tuple[float, float, float]
    p2: Tuple[float, float, float]
    color: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    light_direction: Tuple[float, float, float] = (1.0, -1.0, -5.0)

    def intersect(self, origin, dx, dy, dz):
        """Planar plane-based intersection, same math as the soup kernel
        (triangle/compute.wgsl:65-125: no barycentric outputs). The
        plane constants are f32 on the host. Returns (t, hit, nx, ny,
        nz)."""
        p0 = np.asarray(self.p0, np.float32)
        p1 = np.asarray(self.p1, np.float32)
        p2 = np.asarray(self.p2, np.float32)
        n = np.cross(p1 - p0, p2 - p0)
        d = float(-np.dot(n, p0))
        g = [np.cross(n, e) for e in (p1 - p0, p2 - p1, p0 - p2)]
        c = [float(np.dot(p, gi)) for p, gi in zip((p0, p1, p2), g)]

        o = torch.as_tensor(origin, dtype=torch.float32, device=dx.device)
        n0, n1, n2 = (float(x) for x in n)
        ndotd = n0 * dx + n1 * dy + n2 * dz
        t = -((n0 * o[0] + n1 * o[1] + n2 * o[2]) + d) / ndotd
        hit = (ndotd.abs() >= K_EPSILON) & (t >= 0.0)
        for gi, ci in zip(g, c):
            g0, g1, g2 = (float(x) for x in gi)
            og = g0 * o[0] + g1 * o[1] + g2 * o[2] - ci
            dg = g0 * dx + g1 * dy + g2 * dz
            hit = hit & (og + t * dg >= 0.0)
        un = n / np.linalg.norm(n)
        flip = ndotd > 0.0
        nx, ny, nz = (torch.where(flip, -float(x), float(x)) for x in un)
        return t, hit, nx, ny, nz

    def render_pass(self, state, origin, dx, dy, dz, near=0.01, far=100.0):
        """Fold this triangle's pass into planar state (cr, cg, cb,
        depth): the triangle kernel's hardcoded ambient 0.1 and specular
        0.5, the strict nonlinear-depth test."""
        from ..ops.megakernel import blinn_phong_planar

        cr, cg, cb, depth = state
        t, hit, nx, ny, nz = self.intersect(origin, dx, dy, dz)
        light = torch.tensor(self.light_direction, dtype=torch.float32,
                             device=dx.device)
        lam, spec = blinn_phong_planar(nx, ny, nz, dx, dy, dz, light)
        shade = 0.1 + lam  # triangle kernel's hardcoded coefficients
        pr = self.color[0] * shade + 0.5 * spec
        pg = self.color[1] * shade + 0.5 * spec
        pb = self.color[2] * shade + 0.5 * spec
        d = to_nonlinear_depth(torch.where(hit, t, 1.0), near, far)
        write = hit & (d < depth)
        return (torch.where(write, pr, cr), torch.where(write, pg, cg),
                torch.where(write, pb, cb), torch.where(write, d, depth))
