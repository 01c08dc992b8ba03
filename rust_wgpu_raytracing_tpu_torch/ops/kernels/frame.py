"""The fused frame kernel (kernel K4).

The wrapper `frame` launches csrc/frame.cu for CUDA tensors and runs
`frame_plain` for CPU tensors; each launch adds 1 to the counter
`launches.frame` (runtime/profiler.py). Both compute the JAX package's
fusedframe._make_frame_kernel: per 1024-ray tile, the closest-hit (t,
face) sweep, the winner's shading attributes, the analytic sphere
passes, Blinn-Phong factors with the light direction per material (and
`pow32`), and the composite in the reference's pass order by strict
nonlinear depth. The mode picks the branch and the planes written, each
(R,) f32, in this order:

    all modes  depth, kind, occ, uvx, uvy, mat, lam, spec
    "sched"    + wt, wnx, wny, wnz, wlx, wly, wlz, wrel  (the winner's
               shadow-ray inputs, traced afterwards by kernel K3)
    "nm"       + nx, ny, nz (flipped geometric normal), vnx, vny, vnz,
               tx, ty, tz, bx, by, bz (no mesh Blinn: lam and spec
               are 0 where the mesh wins)
    "none"     no shadows; occ is 0
    "inkernel" the kernel traces the winner's shadow ray itself and
               writes occ

kind is 0 for the background, s + 1 for sphere s and S + 1 for the
mesh. The attributes come from the winner face's own expressions
(_ch_block, ops/megakernel.py:490-577), so they equal the JAX kernel's
merged picks by value (a pick is a sum and turns -0.0 into +0.0).

frame_plain sweeps with closest_hit_plain and traces the in-kernel
shadow rays with anyhit_plain over every cluster the per-tile slab test
(ops/traverse.py, the math of the kernel's slab_scalar) admits; the
kernel additionally stops at the wavefront's root-exit bound, which only
skips clusters that cannot occlude (the JAX kernel's own argument), so
both give the same occ. frame_from_sweep is everything after the sweep,
with the in-kernel shadow rays' mesh occlusion as an argument
(testing/raycull.py frame_culled composes the kernel's culled walks
with it).

The kernel also takes the face blocks' boxes (blk_lo, blk_hi: one row
per block, the cluster AABBs) and tests a block's faces only for the
rays whose line from the camera enters its box at or below their best t
so far, a cluster's faces only for the live shadow rays whose line
enters its box (testing/raycull.py models both walks). The planes are
the same, so the plain version ignores the boxes. Without boxes the
kernel admits every aimed ray of an admitted block.

The const vector (one flat f32 tensor per frame, the JAX layout):
origin (3), root AABB lo (3) and hi (3), 13 floats per sphere
(center, radius, colour, coefficients, light), 3 per material (light
direction), 6 per cluster (AABB lo, hi; empty clusters +inf / -inf),
and nb cluster ids as floats: the in-kernel shadow loop's visit order.
"""

from __future__ import annotations

import numpy as np
import torch

from ...runtime.profiler import count
from ..composite import depth_constants
from ..rounding import ftz, sqrt
from ..traverse import slab_interval_entry, tile_ray_bounds
from . import common
from .anyhit import anyhit_plain
from .build import check, library
from .closest_hit import closest_hit_plain
from .common import (TILE_R, box_args, is_cuda_call, open_boxes, ptr,
                     require, stream_ptr)

F32_INF = float("inf")
C_ORIGIN = 0
C_SPH = 9
SPH_STRIDE = 13
MAT_STRIDE = 3
MODES = {"none": 0, "sched": 1, "nm": 2, "inkernel": 3}
N_OUT = {"none": 8, "sched": 16, "nm": 20, "inkernel": 8}
PARK = 1e9  # shadow-ray origin of a parked ray


def _f32(c) -> float:
    return float(np.float32(c))


def const_offsets(ns: int, nmat: int, nb: int):
    """(mat0, blk0, shord0): where the material lights, the cluster
    AABBs and the cluster order start in the const vector."""
    mat0 = C_SPH + SPH_STRIDE * ns
    blk0 = mat0 + MAT_STRIDE * nmat
    return mat0, blk0, blk0 + 6 * nb


def pow32(x):
    """x**32 by five squarings, each product rounded on its own: the
    multiply chain of the JAX fused frame (fusedframe._pow32). It is not
    torch's or XLA's pow: the two differ by up to 25 ulp. A denormal
    result is flushed to zero, as the JAX package's arithmetic flushes
    it (for x in [0, 1] no product before the last is denormal unless
    the last is, so flushing the result equals flushing every step)."""
    x2 = x * x
    x4 = x2 * x2
    x8 = x4 * x4
    x16 = x8 * x8
    return ftz(x16 * x16)


def blinn(nx, ny, nz, dx, dy, dz, lx, ly, lz):
    """The fused frame's Blinn-Phong factors (fusedframe._blinn) with a
    light vector of scalars or planes: (lambert, pow32(N.H))."""
    ll = sqrt(lx * lx + ly * ly + lz * lz)
    ll = torch.where(ll > 0, ll, 1.0)
    ulx, uly, ulz = lx / ll, ly / ll, lz / ll
    lam = (-(nx * ulx + ny * uly + nz * ulz)).clamp_min(0.0)
    hx, hy, hz = -ulx - dx, -uly - dy, -ulz - dz
    hl = sqrt(hx * hx + hy * hy + hz * hz)
    hl = torch.where(hl > 0, hl, 1.0)
    hdotn = ((hx * nx + hy * ny + hz * nz) / hl).clamp_min(0.0)
    return lam, pow32(hdotn)


def sphere_quadratic(cx, cy, cz, rad, ox, oy, oz, dx, dy, dz, t_min):
    """fusedframe._sphere_quadratic: the sphere's t (+inf on a miss),
    roots below t_min rejected, |a| <= 1e-20 (a zero direction) a
    miss. Not the split frame's sphere_pass_planar."""
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    a = dx * dx + dy * dy + dz * dz
    b = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
    c = (ocx * ocx + ocy * ocy + ocz * ocz) - rad * rad
    disc = b * b - 4.0 * a * c
    sq = sqrt(disc.clamp_min(0.0))
    tiny = _f32(1e-20)
    a_s = torch.where(a.abs() > tiny, a, 1.0)
    t1 = (-b - sq) / (2.0 * a_s)
    t2 = (-b + sq) / (2.0 * a_s)
    t = torch.where(t1 >= t_min, t1,
                    torch.where(t2 >= t_min, t2, F32_INF))
    return torch.where((disc < 0.0) | (a.abs() <= tiny), F32_INF, t)


def _check(tlb, order, const, planes, fpack, oterm, dc, ns, nmat, block_f,
           mode):
    n_tiles, nb = tlb.shape
    r = n_tiles * TILE_R
    f = nb * block_f
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}, expected one of {sorted(MODES)}")
    require(tlb, "tlb", torch.float32, (n_tiles, nb))
    require(order, "order", torch.int32, (n_tiles, nb))
    require(const, "const", torch.float32,
            (const_offsets(ns, nmat, nb)[2] + nb,))
    for name, x in zip(("dx", "dy", "dz", "texit"), planes):
        require(x, name, torch.float32, (r,))
    require(fpack, "fpack", torch.float32, (f, 40))
    require(oterm, "oterm", torch.float32, (f, 8))
    require(dc, "dc", torch.float32, (f, 8))
    if not 1 <= block_f <= 32:
        raise ValueError(f"block_f {block_f} outside 1..32")
    if nmat < 1:
        raise ValueError("at least one material")
    return n_tiles, nb


def frame(tlb, order, const, dx, dy, dz, texit, fpack, oterm, dc,
          blk_lo=None, blk_hi=None, *, ns: int, nmat: int, block_f: int,
          near: float = 0.01, far: float = 100.0, mode: str = "sched"):
    """The mode's planes (module docstring), each (R,) f32, for R =
    tiles * 1024 shared-origin rays. tlb/order (T, nb), texit, fpack
    and oterm as for closest_hit; const the frame's const vector; dc
    (F, 8) [d, c0, c1, c2, ...] for the in-kernel shadow rays; blk_lo /
    blk_hi (nb, 3) f32 the blocks' boxes, or None."""
    n_tiles, nb = _check(tlb, order, const, (dx, dy, dz, texit), fpack,
                         oterm, dc, ns, nmat, block_f, mode)
    boxes = box_args(blk_lo, blk_hi, nb)
    if not is_cuda_call(tlb, order, const, dx, dy, dz, texit, fpack, oterm,
                        dc, *boxes):
        return frame_plain(tlb, order, const, dx, dy, dz, texit, fpack,
                           oterm, dc, *boxes, ns=ns, nmat=nmat,
                           block_f=block_f, near=near, far=far, mode=mode)
    lo, hi = boxes or open_boxes(nb, dx.device)
    r = dx.shape[0]
    out = torch.empty((N_OUT[mode], r), dtype=torch.float32,
                      device=dx.device)
    inv_near, rcp_span = depth_constants(near, far)
    err = library().rt_frame(
        ptr(tlb), ptr(order), ptr(const), ptr(dx), ptr(dy), ptr(dz),
        ptr(texit), ptr(fpack), ptr(oterm), ptr(dc), ptr(lo), ptr(hi),
        n_tiles, nb, block_f, ns, nmat, MODES[mode],
        common.RAY_MAJOR["anyhit"], inv_near, rcp_span, ptr(out),
        stream_ptr(dx.device))
    check(err, "rt_frame")
    count("launches.frame")
    return tuple(out.unbind(0))


def _resolve(t, face, fpack, oterm, dx, dy, dz, nm: bool):
    """The winner's shading attributes from the (t, face) sweep:
    _ch_block's expressions on the winner face, zero on a miss."""
    hit = t < F32_INF
    g = fpack.index_select(0, face.long())
    o = oterm.index_select(0, face.long())
    ts = torch.where(hit, t, 0.0)

    def m(x):
        return torch.where(hit, x, 0.0)

    def c(k):
        return g[:, k]

    nd = c(0) * dx + c(1) * dy + c(2) * dz
    h1 = o[:, 2] + ts * (c(6) * dx + c(7) * dy + c(8) * dz)
    h2 = o[:, 3] + ts * (c(9) * dx + c(10) * dy + c(11) * dz)
    u_n = h1 * c(12)
    v_n = h2 * c(12)
    w_n = 1.0 - u_n - v_n
    att = dict(
        nd=m(nd), nx=m(c(13)), ny=m(c(14)), nz=m(c(15)), mat=m(c(22)),
        uvx=m(u_n * c(16) + v_n * c(18) + w_n * c(20)),
        uvy=m(u_n * c(17) + v_n * c(19) + w_n * c(21)))
    if nm:
        for ax, k in enumerate("xyz"):
            att[f"vn{k}"] = m(u_n * c(30 + ax) + v_n * c(33 + ax)
                              + w_n * c(36 + ax))
            att[f"t{k}"] = m(c(24 + ax))
            att[f"b{k}"] = m(c(27 + ax))
    return att


def frame_plain(tlb, order, const, dx, dy, dz, texit, fpack, oterm, dc,
                blk_lo=None, blk_hi=None, *, ns: int, nmat: int,
                block_f: int, near: float = 0.01, far: float = 100.0,
                mode: str = "sched"):
    """Plain PyTorch version of frame (same arguments, same planes): the
    boxes unread."""
    del blk_lo, blk_hi
    nb = tlb.shape[1]
    blk0 = const_offsets(ns, nmat, nb)[1]
    tm, face, _ = closest_hit_plain(tlb, order, dx, dy, dz, texit, fpack,
                                    oterm, const[:3], block_f=block_f)

    def mesh_occ(p, sd, rel, occ):
        del occ  # the spheres' occlusion: every relevant ray is tested
        relf = torch.where(rel, 1.0, 0.0)
        return anyhit_plain(shadow_cone_entry(p, sd, rel, const, blk0, nb),
                            order, *sd, *p, relf, texit, fpack, dc,
                            block_f=block_f)
    return frame_from_sweep(tm, face, const, dx, dy, dz, fpack, oterm,
                            mesh_occ, ns=ns, nmat=nmat, near=near, far=far,
                            mode=mode)


def shadow_cone_entry(p, sd, rel, const, blk0: int, nb: int):
    """(T, nb) the admission of each cluster (AABBs at const[blk0:], 6
    floats each) by each tile's cone of relevant shadow rays (rel (R,)
    bool; origins p, directions sd, 3 planes each): the entry-t lower
    bound, +inf where the cone cannot reach the cluster (the kernel's
    slab_scalar)."""
    omin, omax, dmin, dmax = tile_ray_bounds(*p, *sd, TILE_R, act=rel)
    boxes = const[blk0:blk0 + 6 * nb].view(nb, 6)
    _, entry = slab_interval_entry(boxes[None, :, :3] - omax[:, None, :],
                                   boxes[None, :, 3:] - omin[:, None, :],
                                   dmin[:, None, :], dmax[:, None, :])
    return entry


def frame_from_sweep(tm, face, const, dx, dy, dz, fpack, oterm, mesh_occ, *,
                     ns: int, nmat: int, near: float = 0.01,
                     far: float = 100.0, mode: str = "sched"):
    """frame_plain after its sweep: the mode's planes from the mesh
    winners (tm, face). In mode "inkernel", mesh_occ(p, sd, rel, occ)
    gives the winners' shadow rays' mesh occlusion (R,) f32: 1.0 where a
    relevant ray (rel (R,) bool; origins p, directions sd, 3 planes
    each) hits a face at t >= 1e-3, else 0; it may leave out the rays
    the spheres occlude (occ (R,) f32, 1.0 where one does)."""
    mat0 = const_offsets(ns, nmat, 0)[0]
    inv_near, rcp_span = depth_constants(near, far)

    def nld(t):
        return ((1.0 / t) - inv_near) * rcp_span

    att = _resolve(tm, face, fpack, oterm, dx, dy, dz, mode == "nm")
    hit_m = tm < F32_INF
    ox, oy, oz = const[C_ORIGIN], const[C_ORIGIN + 1], const[C_ORIGIN + 2]

    # ---- mesh shading factors ----
    flip = att["nd"] > 0.0
    mnx = torch.where(flip, -att["nx"], att["nx"])
    mny = torch.where(flip, -att["ny"], att["ny"])
    mnz = torch.where(flip, -att["nz"], att["nz"])
    mat = att["mat"]
    ml = [const[mat0 + ax].expand(dx.shape) for ax in range(3)]
    for k in range(1, nmat):
        sel = mat == float(k)
        ml = [torch.where(sel, const[mat0 + MAT_STRIDE * k + ax], ml[ax])
              for ax in range(3)]
    zero = torch.zeros_like(dx)
    if mode == "nm":
        m_lam, m_spec = zero, zero
    else:
        m_lam, m_spec = blinn(mnx, mny, mnz, dx, dy, dz, *ml)

    # ---- composite (reference pass order: spheres, then mesh) ----
    depth = torch.ones_like(dx)
    kind = zero
    win = dict(t=zero, nx=zero, ny=zero, nz=zero, lx=zero, ly=zero,
               lz=torch.ones_like(dx), lam=zero, spec=zero, rel=zero)

    def composite(hit, t, kind_val, vals):
        nonlocal depth, kind
        d = nld(torch.where(hit, t, 1.0))
        w = hit & (d < depth)
        depth = torch.where(w, d, depth)
        kind = torch.where(w, kind_val, kind)
        for key, v in vals.items():
            win[key] = torch.where(w, v, win[key])

    for s in range(ns):
        o_ = C_SPH + SPH_STRIDE * s
        cx, cy, cz, rad = (const[o_ + i] for i in range(4))
        slx, sly, slz = const[o_ + 10], const[o_ + 11], const[o_ + 12]
        t = sphere_quadratic(cx, cy, cz, rad, ox, oy, oz, dx, dy, dz, 0.0)
        hit = t < F32_INF
        ts = torch.where(hit, t, 0.0)
        pxs = ox + dx * ts - cx
        pys = oy + dy * ts - cy
        pzs = oz + dz * ts - cz
        l = sqrt(pxs * pxs + pys * pys + pzs * pzs)
        l = torch.where(l > 0, l, 1.0)
        snx, sny, snz = pxs / l, pys / l, pzs / l
        lam, spec = blinn(snx, sny, snz, dx, dy, dz, slx, sly, slz)
        composite(hit, t, float(s + 1), dict(
            t=t, nx=snx, ny=sny, nz=snz, lx=slx, ly=sly, lz=slz, lam=lam,
            spec=spec, rel=torch.where((lam > 0.0) | (spec > 0.0), 1.0,
                                       0.0)))
    composite(hit_m, tm, float(ns + 1), dict(
        t=tm, nx=mnx, ny=mny, nz=mnz, lx=ml[0], ly=ml[1], lz=ml[2],
        lam=m_lam, spec=m_spec,
        rel=torch.where((m_lam > 0.0) | (m_spec > 0.0), 1.0, 0.0)))

    occ = zero
    head = [depth, kind, occ, att["uvx"], att["uvy"], mat, win["lam"],
            win["spec"]]
    if mode == "none":
        return tuple(head)
    if mode == "sched":
        return tuple(head + [win[k] for k in ("t", "nx", "ny", "nz", "lx",
                                              "ly", "lz", "rel")])
    if mode == "nm":
        return tuple(head + [mnx, mny, mnz] + [att[k] for k in (
            "vnx", "vny", "vnz", "tx", "ty", "tz", "bx", "by", "bz")])

    # ---- "inkernel": the winner's shadow ray, traced here ----
    rel = (kind > 0.0) & (win["rel"] > 0.0)
    ll = sqrt(win["lx"] * win["lx"] + win["ly"] * win["ly"]
              + win["lz"] * win["lz"])
    ll = torch.where(ll > 0, ll, 1.0)
    sd = [torch.where(rel, -win[k] / ll, 0.0) for k in ("lx", "ly", "lz")]
    tw = torch.where(rel, win["t"], 0.0)
    p = [torch.where(rel, o + d * tw + win[k] * _f32(1e-3), PARK)
         for o, d, k in ((ox, dx, "nx"), (oy, dy, "ny"), (oz, dz, "nz"))]
    for s in range(ns):
        o_ = C_SPH + SPH_STRIDE * s
        t = sphere_quadratic(const[o_], const[o_ + 1], const[o_ + 2],
                             const[o_ + 3], *p, *sd, _f32(1e-3))
        occ = torch.maximum(occ, torch.where(t < F32_INF, 1.0, 0.0))
    head[2] = torch.maximum(occ, mesh_occ(p, sd, rel, occ))
    return tuple(head)
