"""Multi-device rendering over image rows and samples (JAX
parallel/tile_sharding.py), on torch.distributed.

- dp (tile parallel): image rows are split into one slab a rank; the
  scene is replicated, and the frame comes back whole on every rank
  (RankMesh.gather_rows: one SUM of the disjoint slabs);
- sp (sample parallel): each sp rank renders its own jittered samples,
  and their mean is one SUM over sp;
- the inverse-rendering train step mean-reduces its loss and gradients
  over both axes, the collective pattern of data-parallel training.

Every function runs on every rank of the mesh's process group, with the
same arguments (the scene replicated on each rank's device); each
returns the whole result on every rank. A mesh of one rank needs no
process group. The jitter keys are jax.random's, bit for bit (the port's
replica in ops/pathtrace.py), so a rank draws what the same JAX device
draws.

Float semantics as in ops/: the sample mean multiplies by the f32
reciprocal of sp * spp, as XLA's simplifier turns JAX's division by that
constant. With sp = 2 the sum of two ranks is order-free; with sp > 2
gloo's reduction order need not be XLA's, and the mean can differ in the
last bits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.camera import CameraUniforms
from ..core.scene import SceneData
from ..ops.kernels import KERNELS, KernelSet
from ..ops.megakernel import _f32, _rcp, _ray_matrix, render_megakernel
from ..ops.oracle import MAX_BLOCK_PAIRS, trace_rays
from ..ops.pathtrace import PRNGKey, fold_in, render_pathtrace, uniform
from ..ops.rounding import sqrt
from ..ops.shade import quantize_rgba8
from .mesh import RankMesh, make_render_mesh


def _rows_of(mesh: RankMesh, height: int) -> int:
    dp = mesh.size("dp")
    if height % dp:
        raise ValueError(f"height {height} does not split into dp={dp}")
    return height // dp


def _uniforms(uni_flat) -> CameraUniforms:
    return CameraUniforms.unflat(np.asarray(
        uni_flat.detach().cpu() if isinstance(uni_flat, torch.Tensor)
        else uni_flat, np.float32))


def _render_rows(scene: SceneData, uni_flat, width: int, total_height: int,
                 row0, rows: int, jitter=None, near=0.01, far=100.0,
                 background=(0.0, 0.0, 0.0)):
    """The differentiable row-slab renderer: the oracle's passes (no
    shadows) over rows [row0, row0 + rows) of a total_height-tall image,
    on the scene's device. jitter (2,) f32 adds a sub-pixel offset in
    NDC units; None keeps the pixel centres. Returns (color (rows, W, 3),
    depth (rows, W)), differentiable in the scene's colours."""
    device = scene.tri_n.device
    uni = _uniforms(uni_flat)
    origin = torch.as_tensor(uni.origin, dtype=torch.float32, device=device)
    m, const = _ray_matrix(uni)
    x = torch.arange(width, dtype=torch.float32, device=device)
    y = torch.arange(rows, dtype=torch.float32, device=device) + float(row0)
    x_nds = (2.0 * (x + 0.5)) * _rcp(width) - 1.0
    y_nds = (2.0 * (y + 0.5)) * _rcp(total_height) - 1.0
    if jitter is not None:
        x_nds = x_nds + jitter[0]
        y_nds = y_nds + jitter[1]
    col = [torch.tensor(m[:, k], dtype=torch.float32, device=device)
           for k in (0, 1)]
    c = torch.tensor(const, dtype=torch.float32, device=device)
    d = (col[0][None, None, :] * x_nds[None, :, None]
         + col[1][None, None, :] * y_nds[:, None, None] + c[None, None, :])
    dirs = (d / sqrt(d[..., 0:1] * d[..., 0:1] + d[..., 1:2] * d[..., 1:2]
                     + d[..., 2:3] * d[..., 2:3])).reshape(-1, 3)
    block = max(1, MAX_BLOCK_PAIRS // max(scene.padded_faces, 1))
    parts = [trace_rays(scene, origin, dirs[r:r + block], near=near,
                        far=far, background=background)
             for r in range(0, dirs.shape[0], block)]
    color = torch.cat([p[0] for p in parts]).reshape(rows, width, 3)
    depth = torch.cat([p[1] for p in parts]).reshape(rows, width)
    return color, depth


def _jitter(key, width: int, height: int, device) -> torch.Tensor:
    """(uniform(key, (2,)) - 0.5) * [2/width, 2/height] in f32."""
    scale = torch.tensor([_f32(2.0 / width), _f32(2.0 / height)],
                         dtype=torch.float32, device=device)
    return (uniform(key, 2, device=device) - 0.5) * scale


def render_sharded(scene: SceneData, uni_flat, mesh: RankMesh, *,
                   width: int, height: int, spp: int = 1, seed: int = 0,
                   quantize: bool = True):
    """One frame of the oracle math sharded over the mesh: rows over dp,
    jittered sub-pixel samples over sp (sample s of sp rank i draws from
    fold_in(fold_in(PRNGKey(seed), i), s); no jitter when sp * spp is
    1). Returns the whole (H, W, 3) frame on every rank."""
    sp = mesh.size("sp")
    rows = _rows_of(mesh, height)
    row0 = mesh.index("dp") * rows
    spi = mesh.index("sp")
    device = scene.tri_n.device
    acc = torch.zeros((rows, width, 3), dtype=torch.float32, device=device)
    for s in range(spp):
        jit_xy = torch.zeros(2, dtype=torch.float32, device=device)
        if spp * sp != 1:
            jit_xy = _jitter(fold_in(fold_in(PRNGKey(seed), spi), s),
                             width, height, device)
        c, _ = _render_rows(scene, uni_flat, width, height, row0, rows,
                            jitter=jit_xy)
        acc = acc + c
    color = mesh.all_reduce(acc, "sp") * _rcp(spp * sp)
    color = mesh.gather_rows(color, height)
    return quantize_rgba8(color) if quantize else color


def render_sharded_megakernel(scene: SceneData, uni_flat, mesh: RankMesh, *,
                              width: int, height: int,
                              shadows: bool = False, quantize: bool = True,
                              fused: Optional[bool] = None,
                              kernels: KernelSet = KERNELS):
    """The kernel frame on each rank's row slab (render_megakernel with
    row0 and total_height; the scene replicated, no traffic until the
    frame's gather). fused picks the frame program as
    render_megakernel's does. Returns the whole (H, W, 3) frame on every
    rank."""
    rows = _rows_of(mesh, height)
    c, _ = render_megakernel(
        scene, uni_flat, width=width, height=rows, shadows=shadows,
        quantize=quantize, row0=mesh.index("dp") * rows,
        total_height=height, fused=fused, kernels=kernels)
    return mesh.gather_rows(c, height)


def render_pathtrace_sharded(scene: SceneData, uni_flat, key,
                             mesh: RankMesh, *, width: int, height: int,
                             bounces: int = 4, spp: int = 1,
                             background=(0.0, 0.0, 0.0),
                             kernels: KernelSet = KERNELS):
    """Path tracing with rows over dp and samples over sp: each rank
    traces fold_in(fold_in(key, sp index), dp index) on its slab.
    Returns the MEAN radiance over all sp * spp samples, (H, W, 3) on
    every rank (render_pathtrace returns the spp sum; only this function
    knows the mesh-wide count)."""
    sp = mesh.size("sp")
    rows = _rows_of(mesh, height)
    dpi = mesh.index("dp")
    k = fold_in(fold_in(key, mesh.index("sp")), dpi)
    color = render_pathtrace(scene, uni_flat, k, width=width, height=rows,
                             bounces=bounces, spp=spp,
                             background=background, row0=dpi * rows,
                             total_height=height, kernels=kernels)
    color = mesh.all_reduce(color, "sp") * _rcp(spp * sp)
    return mesh.gather_rows(color, height)


# ---------------------------------------------------------------------------
# inverse rendering: the sharded training step
# ---------------------------------------------------------------------------

def _apply_params(scene: SceneData, params) -> SceneData:
    """The scene with the trainable parameters put in."""
    return dataclasses.replace(scene, sphere_color=params["sphere_color"],
                               mat_ambient=params["mat_ambient"])


def make_train_step(scene: SceneData, mesh: RankMesh, *, width: int,
                    height: int, lr: float = 0.05):
    """A sharded inverse-rendering step: render the rank's rows with the
    current params and a jittered sample (key fold_in(PRNGKey(0),
    seed * 977 + sp index)), MSE against the target's rows, loss and
    gradients mean-reduced over every rank, one SGD update. Returns
    step(params, scene, uni_flat, target (H, W, 3), seed) -> (new params,
    loss), params a dict of tensors {"sphere_color", "mat_ambient"} on
    the scene's device; plain autograd through _render_rows."""
    del scene  # the step takes the scene each call, as JAX's does
    rows = _rows_of(mesh, height)
    n = int(np.prod(list(mesh.shape.values())))

    def train_step(params, scene_rep, uni_flat, target, seed):
        row0 = mesh.index("dp") * rows
        key = fold_in(PRNGKey(0), seed * 977 + mesh.index("sp"))
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        device = scene_rep.tri_n.device
        c, _ = _render_rows(_apply_params(scene_rep, p), uni_flat, width,
                            height, row0, rows,
                            jitter=_jitter(key, width, height, device))
        target_rows = torch.as_tensor(target, device=device)[
            row0:row0 + rows]
        loss = ((c - target_rows) ** 2).mean()
        names = sorted(p)
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        flat = torch.cat([loss.detach().reshape(1)]
                         + [g.reshape(-1) for g in grads])
        flat = mesh.all_reduce(flat, mesh.names) * _rcp(n)
        new, off = {}, 1
        for k in names:
            g = flat[off:off + p[k].numel()].reshape(p[k].shape)
            off += p[k].numel()
            new[k] = params[k] - lr * g
        return new, flat[0]

    return train_step


# ---------------------------------------------------------------------------
# driver dry run
# ---------------------------------------------------------------------------

def dryrun_scene(width: int, height: int):
    """dryrun_multichip's scene: one sphere and builtin:cube."""
    from ..config import (CameraConfig, MeshConfig, RenderConfig,
                          SceneConfig, SphereConfig)

    return SceneConfig(
        spheres=(SphereConfig(center=(0.5, 0.2, -3.0), radius=0.6),),
        meshes=(MeshConfig(obj_path="builtin:cube",
                           translation=(-0.6, 0.0, -3.0), scale=0.8),),
        camera=CameraConfig(),
        render=RenderConfig(width=width, height=height))


def dryrun_multichip(n_devices: int, *, device="cuda") -> None:
    """On every rank of an n-rank process group: build the meshes, run
    each sharded function once on tiny shapes (the oracle frame, both
    kernel frame programs, the path tracer, the gp frames lit and
    shadowed and the gp path tracer, dp x gp, and one train step) and
    check their shapes."""
    from ..core.camera import Camera
    from ..core.scene import Scene
    from .geometry_sharding import (make_gp_mesh, render_pathtrace_gp,
                                    render_sharded_gp)

    sp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_render_mesh(n_devices, sp=sp, device=device)
    dp = mesh.size("dp")
    w = 64
    h = dp * max(4, -(-16 // dp))
    cfg = dryrun_scene(w, h)
    data = Scene.build(cfg).data.to(mesh.device)
    uni = Camera.from_config(cfg.camera, aspect=w / h).uniforms().flat()

    color = render_sharded(data, uni, mesh, width=w, height=h)
    assert tuple(color.shape) == (h, w, 3)
    for fused in (None, True):
        c = render_sharded_megakernel(data, uni, mesh, width=w, height=h,
                                      fused=fused)
        assert tuple(c.shape) == (h, w, 3)
    c = render_pathtrace_sharded(data, uni, PRNGKey(0), mesh, width=w,
                                 height=h, bounces=1)
    assert tuple(c.shape) == (h, w, 3) and bool(torch.isfinite(c).all())

    gp_mesh = make_gp_mesh(n_devices, device=device)
    for shadows in (False, True):
        c, d = render_sharded_gp(data, uni, gp_mesh, width=w, height=h,
                                 shadows=shadows)
        assert tuple(c.shape) == (h, w, 3) and tuple(d.shape) == (h, w)
    c = render_pathtrace_gp(data, uni, PRNGKey(0), gp_mesh, width=w,
                            height=h, bounces=1)
    assert tuple(c.shape) == (h, w, 3) and bool(torch.isfinite(c).all())
    if n_devices >= 4 and n_devices % 2 == 0 and h % 2 == 0:
        c, _ = render_sharded_gp(data, uni,
                                 make_gp_mesh(n_devices, dp=2,
                                              device=device),
                                 width=w, height=h)
        assert tuple(c.shape) == (h, w, 3)

    params = {"sphere_color": data.sphere_color,
              "mat_ambient": data.mat_ambient}
    step = make_train_step(data, mesh, width=w, height=h)
    new, loss = step(params, data, uni, color, 0)
    assert bool(torch.isfinite(loss))
    for k in params:
        assert new[k].shape == params[k].shape
