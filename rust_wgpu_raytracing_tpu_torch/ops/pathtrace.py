"""Path tracing with progressive accumulation (BASELINE config 4).

Counterpart of the JAX package's ops/pathtrace.py, function for
function: diffuse global illumination
with next-event estimation toward each surface's directional light,
cosine-weighted bounces, one jittered path per pixel and sample.

- Paths are planar ray state ((R,) tensors per component) stepped
  through a fixed bounce loop. Bounce 0 takes the shared-origin
  closest-hit kernel (K1, `gbuffer` without sphere fusion); every later
  bounce gets its closest hit from the fused extend+shadow kernel (K8,
  `extend_shadow_rays`), which also answers the previous bounce's
  shadow rays, and the last bounce's shadow rays go to the any-hit
  kernel (K3, act-aware mask). Albedo is the texture filter kernel
  (K6). Terminated paths carry zero directions and far origins.
- Meshes above STREAM_FACES take the streamed sweeps, as in JAX: the
  primary pass K9, each bounce but the last the reordered pair of K10
  (extension rays) and K11 (shadow rays) in extend_shadow_rays'
  fallback, the last bounce's shadow rays anyhit_reordered (K11); and
  compact_cap="auto" does not compact there.
- Randomness replicates jax.random bit for bit (partitionable
  threefry-2x32, as JAX 0.9 runs it): keys are two u32 words held as
  Python ints on the host (PRNGKey, fold_in, split cost no device
  launch); only the per-lane draws (uniform, uniform_at) run on the
  device, in int64 lanes masked to 32 bits.
- Tile compaction (compact_cap): the hit wavefront after the primary
  pass is gathered tile by tile into a smaller wavefront, as JAX does
  under lax.cond; here the live-tile count comes to the host once per
  sample (a host sync, the wait "compact") and picks the branch (the
  counters "pt.compacted" and "pt.full" count the samples of each).
  The compacted wavefront holds exactly the live tiles. Both branches
  give the same bits.
- Spans (runtime/profiler.py): a sample's phases are "pt.raygen",
  "pt.primary", "pt.compact" (the count, and the compacted loop inside
  it), one "pt.bounce" per bounce (attribute bounce=i) and, once a
  call, "pt.accumulate"; the host waits on the card at the waits
  "uniforms" (the camera origin's copy), "background" and "compact".

Float semantics as in ops/megakernel.py: JAX's operation order, every
product rounded on its own, XLA's constant folding written out (the
f32 constants 2*pi and 2/width are folded in double and rounded once),
and the radiance products' denormals flushed as XLA and the TPU flush
them (rounding.ftz). cos and sin are torch's, within 1 ulp of XLA's
(tests/test_torch_pathtrace.py); everything else is bitwise the JAX
package's.

- Row slabs and hooks: row0/total_height trace the row slab [row0,
  row0 + height) of a taller image (parallel/'s dp axis); chp_fn, es_fn
  and ah_fn replace the three mesh-intersection passes (the primary
  closest hit, the fused extend+shadow sweep and the last bounce's
  any-hit), on the compacted loop too: the gp axis injects wrappers
  that merge the face shards' results (parallel/geometry_sharding.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.camera import CameraUniforms
from ..core.scene import SceneData
from ..runtime.profiler import count, span, wait
from .kernels import KERNELS, KernelSet
from .kernels.common import TILE_R
from .megakernel import (BLOCK_F, GBuffer, _directions, _f32, _mat_const,
                         _pick_tile_shape, _ray_matrix, _should_stream,
                         _spheres_occlude_planar, anyhit_reordered,
                         anyhit_rays, check_supported, extend_shadow_rays,
                         gbuffer, ndc_planes, sample_packed_texture,
                         sphere_pass_planar, tiled_to_image)
from .rounding import ftz, sqrt

F32_INF = float("inf")
_M32 = 0xFFFFFFFF
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_TWO_PI = _f32(2.0 * math.pi)  # jnp.pi * 2.0, folded in double


# ---------------------------------------------------------------------------
# jax.random, partitionable threefry-2x32
# ---------------------------------------------------------------------------

def _threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32, 20 rounds (JAX prng.threefry2x32), on u32 words:
    Python ints, or int64 tensors holding values in [0, 2^32)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[(i % 2) * 4:(i % 2) * 4 + 4]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & _M32
    return x0, x1


def PRNGKey(seed: int):
    """jax.random.PRNGKey(seed) for a 32-bit seed, as (k0, k1)."""
    return (0, int(seed) & _M32)


def fold_in(key, data: int):
    """jax.random.fold_in: the key hashed with the counter (0, data)."""
    return _threefry2x32(key[0], key[1], 0, int(data) & _M32)


def split(key, num: int = 2):
    """jax.random.split: key i is the key hashed with the counter (0, i)."""
    return [_threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def uniform_at(key, ids: torch.Tensor) -> torch.Tensor:
    """[0, 1) f32 uniforms for lane ids, bit for bit
    jax.random.uniform(key, (n,))[ids] (and JAX's pathtrace.uniform_at):
    x0 ^ x1 of threefry2x32(key, (0, id)), the top 23 bits stuffed into
    the mantissa of a float in [1, 2), minus 1."""
    lo = ids.to(torch.int64) & _M32
    x0, x1 = _threefry2x32(key[0], key[1], 0, lo)
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def uniform(key, n: int, *, device) -> torch.Tensor:
    """jax.random.uniform(key, (n,)) in f32."""
    return uniform_at(key, torch.arange(n, dtype=torch.int64, device=device))


# ---------------------------------------------------------------------------
# rays
# ---------------------------------------------------------------------------

def _jittered_dirs(width, height, uni: CameraUniforms, key, tile, *,
                   device, row0=None, total_height=None):
    """Raygen with a per-pixel sub-pixel jitter. With `tile` = (tile_h,
    tile_w, hpad) the rays come in screen-tile order over a row-padded
    grid (raygen_planar_tiled's order); otherwise W-major scanlines.
    row0/total_height: the row slab of a taller image (the jitter stays
    scaled by the slab's height, as in JAX)."""
    m, const = _ray_matrix(uni)
    th = total_height or height
    if tile is not None:
        tile_h, tile_w, hpad = tile
        r = width * hpad
        xr, yr = ndc_planes(width, hpad, th, tile_h, tile_w,
                            device=device, row0=row0)
    else:
        r = width * height
        xr, yr = ndc_planes(width, height, th, device=device, row0=row0)
    kx, ky = split(key)
    xr = xr + (uniform(kx, r, device=device) - 0.5) * _f32(2.0 / width)
    yr = yr + (uniform(ky, r, device=device) - 0.5) * _f32(2.0 / height)
    return _directions(m, const, xr, yr)


def _cosine_sample(nx, ny, nz, key, ids=None):
    """Cosine-weighted hemisphere directions about planar normals. ids
    (the lane ids of a compacted wavefront) draws each lane's uniforms
    by id, so compact and full frames agree; None draws full-shape."""
    k1, k2 = split(key)
    if ids is None:
        u1 = uniform(k1, nx.shape[0], device=nx.device)
        u2 = uniform(k2, nx.shape[0], device=nx.device)
    else:
        u1 = uniform_at(k1, ids)
        u2 = uniform_at(k2, ids)
    r = sqrt(u1)
    phi = _TWO_PI * u2
    lx = r * torch.cos(phi)
    ly = r * torch.sin(phi)
    lz = sqrt((1.0 - u1).clamp_min(0.0))

    # orthonormal basis about n (branchless Frisvad-style)
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t1x = 1.0 + sign * nx * nx * a
    t1y = sign * b
    t1z = -sign * nx
    t2x = b
    t2y = sign + ny * ny * a
    t2z = -ny

    dx = lx * t1x + ly * t2x + lz * nx
    dy = lx * t1y + ly * t2y + lz * ny
    dz = lx * t1z + ly * t2z + lz * nz
    return dx, dy, dz


def _closest_surface(gb_hit, gb: GBuffer, sph):
    """Merge the mesh G-buffer and the sphere hits into winner planes.
    sph: per-sphere (t, hit, nx, ny, nz). Returns (t, nx, ny, nz,
    is_mesh)."""
    t = torch.where(gb_hit, gb.t, F32_INF)
    flip = gb.nd > 0.0
    nx = torch.where(flip, -gb.nx, gb.nx)
    ny = torch.where(flip, -gb.ny, gb.ny)
    nz = torch.where(flip, -gb.nz, gb.nz)
    is_mesh = gb_hit
    for ts, hs, sx, sy, sz in sph:
        closer = hs & (ts < t)
        t = torch.where(closer, ts, t)
        nx = torch.where(closer, sx, nx)
        ny = torch.where(closer, sy, ny)
        nz = torch.where(closer, sz, nz)
        is_mesh = is_mesh & ~closer
    return t, nx, ny, nz, is_mesh


def _sphere_perray(scene: SceneData, i, ox, oy, oz, dx, dy, dz):
    """sphere_pass_planar with per-ray origins and the 1e-3 epsilon, for
    bounces; zero directions never hit."""
    cx, cy, cz = (scene.sphere_center[i, 0], scene.sphere_center[i, 1],
                  scene.sphere_center[i, 2])
    radius = scene.sphere_radius[i]
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    a = dx * dx + dy * dy + dz * dz
    b = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
    c = (ocx * ocx + ocy * ocy + ocz * ocz) - radius * radius
    disc = b * b - 4.0 * a * c
    a_safe = torch.where(a.abs() > _f32(1e-20), a, 1.0)
    sq = sqrt(disc.clamp_min(0.0))
    t1 = (-b - sq) / (2.0 * a_safe)
    t2 = (-b + sq) / (2.0 * a_safe)
    eps = _f32(1e-3)
    t = torch.where(t1 >= eps, t1, torch.where(t2 >= eps, t2, F32_INF))
    t = torch.where((disc < 0.0) | (a.abs() <= _f32(1e-20)), F32_INF, t)
    hit = torch.isfinite(t)
    ts = torch.where(hit, t, 0.0)
    nx = (ox + dx * ts) - cx
    ny = (oy + dy * ts) - cy
    nz = (oz + dz * ts) - cz
    l = sqrt(nx * nx + ny * ny + nz * nz)
    l = torch.where(l > 0, l, 1.0)
    return t, hit, nx / l, ny / l, nz / l


# ---------------------------------------------------------------------------
# the bounce loop
# ---------------------------------------------------------------------------

def _compact_tiles(active, tile_r: int):
    """Indices of the ray tiles that hold an active lane, in tile order
    (one host sync: the count decides the shape)."""
    return active.view(-1, tile_r).any(dim=1).nonzero().squeeze(1)


def _bounce_loop(scene: SceneData, gb, sph, ox, oy, oz, dx, dy, dz, active,
                 ids, ks, *, bounces, bg, has_mesh, kernels, es_fn=None,
                 ah_fn=None):
    """The per-lane path state machine: next-event estimation and cosine
    bounces over a planar wavefront of any length, full (ids=None) or
    compacted (ids = the lanes' ids for by-id draws). Returns the
    radiance planes (lr, lg, lb)."""
    r = dx.shape[0]
    dev = dx.device

    def full(v):
        return torch.full((r,), v, dtype=torch.float32, device=dev)

    beta_r, beta_g, beta_b = full(1.0), full(1.0), full(1.0)
    lr, lg, lb = full(0.0), full(0.0), full(0.0)

    for bounce in range(bounces + 1):
        with span("pt.bounce", bounce=bounce):
            kb = fold_in(ks, bounce + 1)

            if gb is not None:
                gb_hit = torch.isfinite(gb.t) & active
                t, nx, ny, nz, is_mesh = _closest_surface(
                    gb_hit, gb, [(ts, hs & active, sx, sy, sz)
                                 for ts, hs, sx, sy, sz in sph])
            else:
                t = full(F32_INF)
                nx = ny = nz = full(0.0)
                is_mesh = torch.zeros(r, dtype=torch.bool, device=dev)
                for ts, hs, sx, sy, sz in sph:
                    closer = hs & active & (ts < t)
                    t = torch.where(closer, ts, t)
                    nx = torch.where(closer, sx, nx)
                    ny = torch.where(closer, sy, ny)
                    nz = torch.where(closer, sz, nz)

            hit = active & torch.isfinite(t)
            # environment on miss
            miss = active & ~hit
            lr = lr + torch.where(miss, beta_r * bg[0], 0.0)
            lg = lg + torch.where(miss, beta_g * bg[1], 0.0)
            lb = lb + torch.where(miss, beta_b * bg[2], 0.0)

            # ---- albedo of the winning surface ----
            if gb is not None:
                tex_base = _mat_const(scene, gb.mat,
                                      lambda k: scene.mat_tex_base[k])
                hw_h = _mat_const(scene, gb.mat, lambda k: scene.mat_tex_h[k])
                hw_w = _mat_const(scene, gb.mat, lambda k: scene.mat_tex_w[k])
                ar, ag, ab = sample_packed_texture(
                    scene.tex_packed, tex_base, hw_h, hw_w, gb.uvx,
                    1.0 - gb.uvy, kernels=kernels)
                lx = _mat_const(scene, gb.mat, lambda k: scene.mat_light[k, 0])
                ly = _mat_const(scene, gb.mat, lambda k: scene.mat_light[k, 1])
                lz = _mat_const(scene, gb.mat, lambda k: scene.mat_light[k, 2])
            else:
                ar = ag = ab = full(0.0)
                lx, ly, lz = full(1.0), full(-1.0), full(-5.0)
            for i in range(scene.num_spheres):
                ts, hs = sph[i][:2]
                sel = hit & ~is_mesh & hs & (ts == t)
                ar = torch.where(sel, scene.sphere_color[i, 0], ar)
                ag = torch.where(sel, scene.sphere_color[i, 1], ag)
                ab = torch.where(sel, scene.sphere_color[i, 2], ab)
                lx = torch.where(sel, scene.sphere_light[i, 0], lx)
                ly = torch.where(sel, scene.sphere_light[i, 1], ly)
                lz = torch.where(sel, scene.sphere_light[i, 2], lz)

            # ---- next-event estimation toward the directional light ----
            ll = sqrt(lx * lx + ly * ly + lz * lz)
            ll = torch.where(ll > 0, ll, 1.0)
            sdx, sdy, sdz = -lx / ll, -ly / ll, -lz / ll
            ts_safe = torch.where(hit, t, 0.0)
            px = ox + dx * ts_safe + nx * 1e-3
            py = oy + dy * ts_safe + ny * 1e-3
            pz = oz + dz * ts_safe + nz * 1e-3

            last = bounce == bounces
            if not last:
                # the next extension wavefront: its closest hit does not
                # depend on this bounce's occlusion, so both ray sets share
                # one fused sweep
                bdx, bdy, bdz = _cosine_sample(nx, ny, nz, kb, ids)
                ndx = torch.where(hit, bdx, 0.0)
                ndy = torch.where(hit, bdy, 0.0)
                ndz = torch.where(hit, bdz, 0.0)
                # park terminated paths far away so the tile cull drops them
                far = 1e9
                nox = torch.where(hit, px, far)
                noy = torch.where(hit, py, far)
                noz = torch.where(hit, pz, far)

            occ = torch.zeros(r, dtype=torch.bool, device=dev)
            gb_next = None
            if has_mesh and not last:
                gb_next, occ = (es_fn or extend_shadow_rays)(
                    scene, nox, noy, noz, ndx, ndy, ndz, px, py, pz,
                    sdx, sdy, sdz, hit, kernels=kernels)
            elif has_mesh and ah_fn is not None:
                occ = ah_fn(scene, px, py, pz, sdx, sdy, sdz, hit,
                            kernels=kernels)
            elif has_mesh and _should_stream(scene.padded_faces, BLOCK_F):
                # streamed: the Morton-sorted wavefront (act-aware there)
                occ = anyhit_reordered(scene, px, py, pz, sdx, sdy, sdz, hit,
                                       kernels=kernels)
            elif has_mesh:
                # the last shadow wavefront is mostly dead lanes: fold the
                # activity into the cull mask (act_cull)
                occ = anyhit_rays(scene, px, py, pz, sdx, sdy, sdz, hit,
                                  act_cull=True, kernels=kernels)
            occ = occ | _spheres_occlude_planar(scene, px, py, pz,
                                                sdx, sdy, sdz)
            lam = ftz((nx * sdx + ny * sdy + nz * sdz).clamp_min(0.0))
            lam = torch.where(hit & ~occ, lam, 0.0)
            lr = lr + ftz(ftz(beta_r * ar) * lam)
            lg = lg + ftz(ftz(beta_g * ag) * lam)
            lb = lb + ftz(ftz(beta_b * ab) * lam)

            if last:
                break

            # ---- advance the wavefront ----
            active = hit
            dx, dy, dz = ndx, ndy, ndz
            ox, oy, oz = nox, noy, noz
            beta_r = ftz(beta_r * torch.where(active, ar, 0.0))
            beta_g = ftz(beta_g * torch.where(active, ag, 0.0))
            beta_b = ftz(beta_b * torch.where(active, ab, 0.0))
            gb = gb_next
            sph = [_sphere_perray(scene, i, ox, oy, oz, dx, dy, dz)
                   for i in range(scene.num_spheres)]

    return lr, lg, lb


def render_pathtrace(scene: SceneData, uni_flat, key, *, width: int,
                     height: int, bounces: int = 4, spp: int = 1,
                     background=(0.0, 0.0, 0.0), accum=None,
                     compact_cap=None, row0=None, total_height=None,
                     chp_fn=None, es_fn=None, ah_fn=None,
                     kernels: KernelSet = KERNELS):
    """Trace `spp` paths per pixel on the scene's device; returns the SUM
    of radiance (H, W, 3), plus `accum` when given (the Renderer divides
    by the samples accumulated). key: a (k0, k1) key from PRNGKey /
    fold_in; sample s draws from fold_in(key, s).

    compact_cap: None runs the bounce loop on every lane; "auto"
    compacts the post-primary hit wavefront when the frame holds at
    least 8 tiles of 1024 rays, at most r // 8 lanes' worth of tiles
    are live and the mesh is not streamed (the JAX package's choice);
    an int is an explicit capacity in lanes. The frame is the same bits either way. The sweeps always
    take the flat cull mask, as in the JAX package. `kernels` picks the
    kernel implementations (PLAIN composes the frame from the plain
    PyTorch versions).

    row0/total_height: the row slab [row0, row0 + height) of a
    total_height-tall image. chp_fn(scene, origin, dx, dy, dz, kernels=)
    -> GBuffer, es_fn (extend_shadow_rays' signature) -> (GBuffer, occ)
    and ah_fn(scene, px, py, pz, dx, dy, dz, active, kernels=) -> occ
    replace the primary closest hit, the fused extend+shadow sweep and
    the last bounce's any-hit (module docstring)."""
    check_supported(scene)
    device = scene.tri_n.device
    uni = CameraUniforms.unflat(np.asarray(
        uni_flat.cpu() if isinstance(uni_flat, torch.Tensor) else uni_flat,
        np.float32))
    with wait("uniforms"):
        origin = torch.as_tensor(uni.origin, dtype=torch.float32,
                                 device=device)
    has_mesh = scene.num_faces > 0
    tile = _pick_tile_shape(width, height)
    r = width * (tile[2] if tile is not None else height)
    with wait("background"):
        bg = torch.tensor(background, dtype=torch.float32, device=device)
    tr = TILE_R

    if compact_cap == "auto":
        streamed = has_mesh and _should_stream(scene.padded_faces, BLOCK_F)
        compact_cap = (r // 8) if (has_mesh and not streamed
                                   and r % tr == 0 and r >= 8 * tr) else None
    loop_kw = dict(bounces=bounces, bg=bg, has_mesh=has_mesh, kernels=kernels,
                   es_fn=es_fn, ah_fn=ah_fn)

    samples = []
    for s in range(spp):
        ks = fold_in(key, s)
        with span("pt.raygen"):
            dx, dy, dz = _jittered_dirs(width, height, uni, ks, tile,
                                        device=device, row0=row0,
                                        total_height=total_height)
            ox, oy, oz = (torch.full((r,), float(v), dtype=torch.float32,
                                     device=device) for v in uni.origin)

        # primary closest hit (shared origin, spheres separate); later
        # bounces come from the fused extend+shadow sweep
        with span("pt.primary"):
            if not has_mesh:
                gb = None
            elif chp_fn is not None:
                gb = chp_fn(scene, origin, dx, dy, dz, kernels=kernels)
            else:
                gb = gbuffer(scene, origin, dx, dy, dz, with_spheres=False,
                             kernels=kernels)[0]
            sph = [sphere_pass_planar(scene, i, origin, dx, dy, dz)
                   for i in range(scene.num_spheres)]

        lanes = None
        if compact_cap is not None and r % tr == 0:
            # only lanes whose PRIMARY ray hit something enter the loop;
            # misses get one background add
            with span("pt.compact"):
                hit0 = (torch.isfinite(gb.t) if gb is not None
                        else torch.zeros(r, dtype=torch.bool, device=device))
                for _, hs, *_rest in sph:
                    hit0 = hit0 | hs
                with wait("compact"):
                    tidx = _compact_tiles(hit0, tr)
                if tidx.numel() <= max(1, int(compact_cap) // tr):
                    lanes = _compact_loop(scene, gb, sph, (ox, oy, oz),
                                          (dx, dy, dz), hit0, tidx, ks,
                                          loop_kw)
        count("pt.full" if lanes is None else "pt.compacted")
        if lanes is None:
            lanes = _bounce_loop(
                scene, gb, sph, ox, oy, oz, dx, dy, dz,
                active=torch.ones(r, dtype=torch.bool, device=device),
                ids=None, ks=ks, **loop_kw)
        samples.append(lanes)

    with span("pt.accumulate"):
        acc = [torch.zeros(r, dtype=torch.float32, device=device)
               for _ in range(3)]
        for lanes in samples:
            acc = [a + p for a, p in zip(acc, lanes)]
        if tile is not None:
            tile_h, tile_w, hpad = tile
            color = torch.stack(
                [tiled_to_image(p, width, hpad, tile_h, tile_w)[:height]
                 for p in acc], dim=-1)
        else:
            color = torch.stack([p.reshape(height, width) for p in acc],
                                dim=-1)
        if accum is not None:
            color = color + accum
    return color


def _compact_loop(scene, gb, sph, o, d, hit0, tidx, ks, loop_kw):
    """The bounce loop on the live tiles only (tidx), scattered back:
    lanes of dead tiles get 0, primary misses the background."""
    tr = TILE_R
    n_tiles = hit0.shape[0] // tr
    bg = loop_kw["bg"]
    out = [torch.zeros((n_tiles, tr), dtype=torch.float32,
                       device=hit0.device) for _ in range(3)]
    if tidx.numel():
        def take(a):
            return a.view(n_tiles, tr).index_select(0, tidx).reshape(-1)

        gbc = (GBuffer(*(None if p is None else take(p) for p in gb))
               if gb is not None else None)
        sphc = [tuple(take(p) for p in planes) for planes in sph]
        ids = (tidx[:, None] * tr + torch.arange(
            tr, dtype=torch.int64, device=hit0.device)[None, :]).reshape(-1)
        lanes = _bounce_loop(scene, gbc, sphc, *map(take, o), *map(take, d),
                             active=take(hit0), ids=ids, ks=ks, **loop_kw)
        for full, p in zip(out, lanes):
            full.index_add_(0, tidx, p.view(-1, tr))
    mb = (~hit0).to(torch.float32)
    return tuple(full.reshape(-1) + mb * b
                 for full, b in zip(out, (bg[0], bg[1], bg[2])))
