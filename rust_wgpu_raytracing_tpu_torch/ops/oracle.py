"""The oracle renderer: plain vectorized PyTorch, on any device (JAX
ops/oracle.py).

A direct, fully vectorized transcription of the reference's frame
(src/lib.rs:1012-1230 pass choreography + the WGSL kernels), with no
kernel of this package: the executable spec the frames are held against
and the always-correct fallback. It is brute force: every ray against
every face, so it costs (rays x faces) work and is no yardstick for the
frames' speed.

The passes run in the JAX package's order: the spheres in config order,
each with its hard-shadow test, then the mesh pass with its shadow rays,
then composite_pass, then quantize_rgba8. The rays, flattened in row
order, run in blocks in a Python loop (JAX: lax.map over row blocks).
Each ray's result depends on that ray alone, so the frame does not
depend on the block size; a block holds at most max_block_rays rays
(JAX's bound) and at most MAX_BLOCK_PAIRS (ray, face) pairs, down to a
single ray, so the (R, F) temporaries stay bounded at any mesh size.

The shadow rays of a pass are traced only for the rays that hit in it:
the JAX code traces every ray and then discards the others' result
(composite_pass writes hit pixels only, and the mesh pass zeroes the
others' colour), so the frame is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.camera import CameraUniforms
from ..core.scene import SceneData
from .composite import clear, composite_pass
from .intersect import (intersect_sphere, intersect_tris, occluded_spheres,
                        occluded_tris)
from .raygen import ray_directions
from .shade import _normalize, quantize_rgba8, shade_mesh_hit, shade_sphere

SHADOW_EPS = 1e-3
# (ray, face) pairs per block: its (R, F) f32 temporaries take 256 MiB
# each
MAX_BLOCK_PAIRS = 1 << 26


def block_rays(faces: int, max_block_rays: int) -> int:
    """Rays a block: at most max_block_rays, and at most MAX_BLOCK_PAIRS
    (ray, face) pairs against `faces` faces, but at least one ray."""
    return max(1, min(max_block_rays, MAX_BLOCK_PAIRS // max(faces, 1)))


def _shadow_lit(scene: SceneData, p, light_dir, hit):
    """Hard-shadow visibility toward a directional light from the hit
    points p (R, 3) (already offset along the normal), in direction
    -normalize(L) (L (3,) or (R, 3)): True where lit. Traced for the rays
    that hit only; the others read True."""
    sdir = (-_normalize(light_dir)).expand(p.shape)
    idx = hit.nonzero().squeeze(1)
    ps, ds = p.index_select(0, idx), sdir.index_select(0, idx)
    occ = occluded_tris(scene, ps, ds, t_min=SHADOW_EPS)
    occ = occ | occluded_spheres(scene, ps, ds, t_min=SHADOW_EPS)
    lit = torch.ones(hit.shape, dtype=torch.bool, device=hit.device)
    return lit.index_put((idx,), ~occ)


def trace_rays(scene: SceneData, origin, dirs, *, near: float = 0.01,
               far: float = 100.0, background=(0.0, 0.0, 0.0),
               shadows: bool = False, normal_mapping: bool = False):
    """The oracle's passes for rays (R, 3) from one origin: the spheres in
    config order, each with its hard-shadow test, then the mesh pass,
    each folded with composite_pass. Returns (color (R, 3), depth (R,)),
    unquantized. Differentiable in the scene's colours (the sharded train
    step, parallel/tile_sharding.py)."""
    color, depth = clear(dirs.shape[:1], background, device=dirs.device)

    # --- sphere passes, in config order (src/lib.rs:1106-1148) ---
    for i in range(scene.num_spheres):
        sh = intersect_sphere(scene.sphere_center[i], scene.sphere_radius[i],
                              origin, dirs)
        hit = torch.isfinite(sh.t)
        safe_n = torch.where(hit[:, None], sh.normal, 0.0)
        lit = None
        if shadows:
            p = (origin + dirs * torch.where(hit, sh.t, 0.0)[:, None]
                 + safe_n * SHADOW_EPS)
            lit = _shadow_lit(scene, p, scene.sphere_light[i], hit)
        pc = shade_sphere(scene, i, safe_n, dirs, lit=lit)
        color, depth = composite_pass(color, depth, pc, sh.t, hit, near, far)

    # --- mesh pass (src/lib.rs:1174-1184) ---
    if scene.num_faces > 0:
        th = intersect_tris(scene, origin, dirs)
        hit = torch.isfinite(th.t)
        lit = None
        if shadows:
            n = _normalize(scene.tri_n[th.face])
            n = torch.where(th.n_dot_d[:, None] > 0.0, -n, n)
            light = scene.mat_light[scene.tri_mat[th.face].long()]
            p = (origin + dirs * torch.where(hit, th.t, 0.0)[:, None]
                 + n * SHADOW_EPS)
            lit = _shadow_lit(scene, p, light, hit)
        pc = shade_mesh_hit(scene, th.face, th.u, th.v, th.n_dot_d, dirs,
                            lit=lit, normal_mapping=normal_mapping)
        pc = torch.where(hit[:, None], pc, 0.0)
        color, depth = composite_pass(color, depth, pc, th.t, hit, near, far)
    return color, depth


def render_oracle(scene: SceneData, uni_flat, *, width: int, height: int,
                  near: float = 0.01, far: float = 100.0,
                  background=(0.0, 0.0, 0.0), shadows: bool = False,
                  quantize: bool = True, normal_mapping: bool = False,
                  max_block_rays: int = 32768):
    """Render one frame on the scene's device. Returns (color (H,W,3)
    f32, depth (H,W) f32).

    `uni_flat` is CameraUniforms.flat(), the only per-frame input (the
    analogue of the reference's two queue.write_buffer calls,
    src/lib.rs:999-1009)."""
    device = scene.tri_n.device
    uni = CameraUniforms.unflat(np.asarray(
        uni_flat.cpu() if isinstance(uni_flat, torch.Tensor) else uni_flat,
        np.float32))
    origin = torch.as_tensor(uni.origin, dtype=torch.float32, device=device)
    dirs_all = ray_directions(width, height, uni, device=device).reshape(-1, 3)

    block = block_rays(scene.padded_faces if scene.num_faces > 0 else 1,
                       max_block_rays)
    colors, depths = [], []
    for r0 in range(0, height * width, block):
        color, depth = trace_rays(scene, origin, dirs_all[r0:r0 + block],
                                  near=near, far=far, background=background,
                                  shadows=shadows,
                                  normal_mapping=normal_mapping)
        colors.append(color)
        depths.append(depth)

    color = torch.cat(colors).reshape(height, width, 3)
    depth = torch.cat(depths).reshape(height, width)
    if quantize:
        color = quantize_rgba8(color)
    return color, depth
