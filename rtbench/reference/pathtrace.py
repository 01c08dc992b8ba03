"""The reference's progressive path tracer at chosen pixels.

Diffuse global illumination as the program states it (BASELINE config
4): one jittered path a pixel and sample, next-event estimation toward
the hit surface's directional light with a hard shadow ray, then a
cosine-weighted bounce; albedo is the mesh's texture (or the sphere's
colour), a miss adds the background. Hit points are offset 1e-3 along
the normal facing the ray; bounces and shadow rays count hits at t >=
1e-3, the camera rays at t >= 0; a sphere wins over the mesh only when
strictly closer.

The random draws are keyed per sample n as fold_in(PRNGKey(seed), n),
then fold_in(., 0) for the sample's path set; its split gives the x and
y jitter, and fold_in(., b + 1) the bounce b's two cosine draws. Each
draw is taken at the pixel's lane: its index in the frame's ray order,
1024-ray screen tiles over rows padded to the tile height (`lane_ids`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import prng, trace
from .camera import Camera
from .frame import pixel_dirs
from .scene import RefScene

TILE_R = 1024
EPS = 1e-3
TWO_PI = float(np.float32(2.0 * math.pi))


def tile_shape(width: int, height: int):
    """(tile_h, tile_w, padded_height) of the squarest 1024-ray tile whose
    width divides the frame's, unless its row padding passes height / 8
    (then the least padded); None for scanline order."""
    cands = []
    for tile_w in (32, 64, 128):
        if width % tile_w == 0:
            tile_h = TILE_R // tile_w
            cands.append((tile_h, tile_w, -(-height // tile_h) * tile_h))
    if not cands:
        return None
    choice = cands[0]
    if (choice[2] - height) * 8 > height:
        choice = min(cands, key=lambda c: c[2])
    return None if choice[2] > 2 * height else choice


def lane_ids(xs, ys, width: int, height: int):
    shape = tile_shape(width, height)
    if shape is None:
        return ys * width + xs
    tile_h, tile_w, _ = shape
    tiles_x = width // tile_w
    tile = (ys // tile_h) * tiles_x + xs // tile_w
    return tile * TILE_R + (ys % tile_h) * tile_w + xs % tile_w


def _cosine(n, u1, u2):
    nx, ny, nz = n.unbind(-1)
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    lx, ly = r * torch.cos(phi), r * torch.sin(phi)
    lz = torch.sqrt((1.0 - u1).clamp_min(0.0))
    sign = torch.where(nz >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t1 = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], -1)
    t2 = torch.stack([b, sign + ny * ny * a, -ny], -1)
    return lx[:, None] * t1 + ly[:, None] * t2 + lz[:, None] * n


def path_sample(s: RefScene, cam: Camera, xs, ys, *, width, height,
                bounces, key, background=(0.0, 0.0, 0.0)):
    """One sample's radiance (P, 3) at pixels (xs, ys) under the sample
    key `key` (fold_in(PRNGKey(seed), n))."""
    dt = s.dtype
    dev = xs.device
    lanes = lane_ids(xs, ys, width, height)
    ks = prng.fold_in(key, 0)
    kx, ky = prng.split(ks)
    jx = (prng.uniform_at(kx, lanes) - 0.5) * float(np.float32(2.0 / width))
    jy = (prng.uniform_at(ky, lanes) - 0.5) * float(np.float32(2.0 / height))
    d = pixel_dirs(cam, xs, ys, width, height, dt, jitter=(jx, jy))
    p_n = d.shape[0]
    o = torch.as_tensor(cam.uniforms()[2], device=dev).to(dt).expand(
        p_n, 3).contiguous()
    bg = torch.tensor(background, device=dev).to(dt)
    active = torch.ones((p_n,), dtype=torch.bool, device=dev)
    beta = torch.ones((p_n, 3), dtype=dt, device=dev)
    rad = torch.zeros((p_n, 3), dtype=dt, device=dev)
    for b in range(bounces + 1):
        t_min = 0.0 if b == 0 else EPS
        mh = trace.closest_mesh(s, o, d, t_min)
        mesh_hit = torch.isfinite(mh.t) & active
        t = torch.where(mesh_hit, mh.t, float("inf"))
        n = trace.normalize(s.n[mh.face])
        n = torch.where(mh.nd[:, None] > 0.0, -n, n)
        tu, tv = trace.mesh_uv(s, mh)
        albedo = trace.sample_texture(s.tex, tu, tv)
        light = s.light.expand(p_n, 3)
        for i in range(s.num_spheres):
            ts = trace.sphere_t(s.sph_center[i], s.sph_radius[i], o, d, t_min)
            closer = torch.isfinite(ts) & active & (ts < t)
            t = torch.where(closer, ts, t)
            pn = o + d * torch.where(closer, ts, 0.0)[:, None] - s.sph_center[i]
            ln = torch.sqrt((pn * pn).sum(-1, keepdim=True))
            pn = pn / torch.where(ln > 0, ln, 1.0)
            n = torch.where(closer[:, None], pn, n)
            albedo = torch.where(closer[:, None], s.sph_color[i], albedo)
            light = torch.where(closer[:, None], s.sph_light[i], light)
        hit = active & torch.isfinite(t)
        rad = rad + torch.where((active & ~hit)[:, None], beta * bg, 0.0)

        sd = -trace.normalize(light)
        p = o + d * torch.where(hit, t, 0.0)[:, None] + n * EPS
        occ = torch.zeros_like(hit)
        idx = hit.nonzero().squeeze(1)
        occ[idx] = (trace.occluded_mesh(s, p[idx], sd[idx].contiguous(), EPS)
                    | trace.occluded_spheres(s, p[idx], sd[idx], EPS))
        lam = (n * sd).sum(-1).clamp_min(0.0)
        lam = torch.where(hit & ~occ, lam, 0.0)
        rad = rad + beta * albedo * lam[:, None]
        if b == bounces:
            break
        k1, k2 = prng.split(prng.fold_in(ks, b + 1))
        nd = _cosine(n, prng.uniform_at(k1, lanes).to(dt),
                     prng.uniform_at(k2, lanes).to(dt))
        d = torch.where(hit[:, None], nd, 0.0)
        o = torch.where(hit[:, None], p, 1e9)
        active = hit
        beta = beta * torch.where(hit[:, None], albedo, 0.0)
    return rad


def accumulate(s: RefScene, cam: Camera, xs, ys, *, width, height, bounces,
               seed: int, samples: int, background=(0.0, 0.0, 0.0),
               means_at=()):
    """Sum of samples 0 .. samples-1 at the pixels; returns {n: mean of
    the first n samples} for each n in means_at (and `samples`)."""
    base = prng.prng_key(seed)
    acc = None
    want = set(means_at) | {samples}
    out = {}
    for n in range(samples):
        r = path_sample(s, cam, xs, ys, width=width, height=height,
                        bounces=bounces, key=prng.fold_in(base, n),
                        background=background)
        acc = r if acc is None else acc + r
        if n + 1 in want:
            out[n + 1] = (acc / (n + 1)).float()
    return out
