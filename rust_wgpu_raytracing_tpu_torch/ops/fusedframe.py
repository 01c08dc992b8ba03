"""The fused frame: one frame kernel per 1024-ray tile, then a short tail.

Counterpart of the JAX package's ops/fusedframe.render_frame_fused, the
frame render_megakernel draws by default on an eligible scene (a mesh
of at most STREAM_FACES faces, and not normal mapping with shadows).
The frame kernel (kernels.frame, K4) runs the closest-hit sweep, the
winner's shading attributes, the sphere passes, the Blinn-Phong
factors and the composite in one launch, on the arguments frame_args
makes (the blocks' boxes it tests per ray are the cluster AABBs). The
tail traces the winner shadow wavefront with the scheduled any-hit
kernel (K3, shadow_mode "sched"), perturbs the normal through the bump
sample (K6, normal mapping), gathers the texels once and shades them
(K2), selects the colours, quantizes and de-tiles. The phases are the
spans "frame.raygen", "frame.gbuffer" (the cull mask, the schedule and
K4), "frame.shadow", "frame.shade" and "frame.present"
(runtime/profiler.py), with "frame.normal_map" inside "frame.shade"
around perturb_normal (K4 writes the normal-mapping planes).

shadow_mode: "sched" (and "auto") emits the winner's shadow-ray inputs
and traces them with K3 over the split frame's per-tile schedule;
"inkernel" traces them inside the frame kernel over the static
near-to-far cluster order. Both give the same occlusion bit for bit.

The frame equals the split frame bit for bit at the quantized frame:
its Blinn-Phong specular is the JAX kernel's multiply chain `pow32`,
within 25 ulp of the split frame's pow, so unquantized colours differ
in the last bits on a few pixels (the JAX package's frames do the same).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.scene import SceneData
from ..runtime.profiler import span
from .kernels import KERNELS, KernelSet
from .megakernel import (_mat_const, blinn_phong_planar, frame_rays,
                         gather_packed_taps, pack_origin_cols, perturb_normal,
                         present_planar, sweep_inputs, winner_occlusion)
from .scenepacks import frame_const, pack_face_columns, pack_plane_consts

SHADOW_MODES = ("auto", "sched", "inkernel")


def frame_args(scene: SceneData, origin, dx, dy, dz, *, accel: str = "cull",
               kernels: KernelSet = KERNELS):
    """(args, kw): the frame kernel's arguments, but near, far and mode,
    for the shared-origin rays dx, dy, dz from `origin` (3,)."""
    rs = sweep_inputs(scene, origin, dx, dy, dz, accel=accel, stream=False,
                      kernels=kernels)
    args = [*rs.sched, frame_const(scene, origin), *rs.planes, rs.texit,
            pack_face_columns(scene), pack_origin_cols(scene, origin),
            pack_plane_consts(scene), *rs.boxes]
    return args, dict(ns=scene.num_spheres, nmat=scene.mat_ambient.shape[0],
                      block_f=rs.block_f)


def render_frame_fused(scene: SceneData, uni_flat, *, width: int,
                       height: int, near: float = 0.01, far: float = 100.0,
                       background=(0.0, 0.0, 0.0), shadows: bool = False,
                       quantize: bool = True, accel: str = "cull",
                       normal_mapping: bool = False,
                       shadow_mode: str = "auto", row0=None,
                       total_height=None, kernels: KernelSet = KERNELS,
                       camera=None):
    """One fused frame (module docstring). Returns (color (H,W,3) f32,
    depth (H,W) f32), bit for bit the JAX package's render_frame_fused
    under the same rounding rules. Normal mapping excludes shadows here
    (the shadow gate needs the perturbed normal): render_megakernel
    sends that case to the split frame. row0/total_height: the row slab
    [row0, row0 + height) of a taller image, in the split frame's ray
    order (_frame_shape). camera: the frame's camera vector on the
    scene's device, as render_megakernel takes it."""
    if normal_mapping and shadows:
        raise ValueError("the fused frame has no normal mapping with "
                         "shadows; render it with fused=False")
    if shadow_mode not in SHADOW_MODES:
        raise ValueError(f"shadow_mode {shadow_mode!r}, expected one of "
                         f"{SHADOW_MODES}")
    device = scene.tri_n.device
    with span("frame.raygen"):
        camera, shape, (dx, dy, dz) = frame_rays(
            uni_flat, camera, width, height, row0, total_height, device)
        origin = camera[:3]

    ns = scene.num_spheres
    nrays = dx.shape[0]
    use_sched = shadows and shadow_mode != "inkernel"
    if normal_mapping:
        mode = "nm"
    elif not shadows:
        mode = "none"
    else:
        mode = "sched" if use_sched else "inkernel"
    with span("frame.gbuffer"):
        args, kw = frame_args(scene, origin, dx, dy, dz, accel=accel,
                              kernels=kernels)
        outs = kernels.frame(*args, **kw, near=near, far=far, mode=mode)
        outs = [p[:nrays] for p in outs]
    depth, kind, occ, uvx, uvy, mat, lam, spec = outs[:8]

    if use_sched:
        # the split frame's shadow pass on the winner planes
        with span("frame.shadow"):
            w_rel = outs[15]
            occ = winner_occlusion(
                scene, origin, dx, dy, dz, (kind > 0.0) & (w_rel > 0.0),
                *outs[8:15], accel=accel,
                kernels=kernels).to(torch.float32)

    # ---- tail: one texture gather + shade, final select ----
    def mc(getter):
        return _mat_const(scene, mat, getter)

    with span("frame.shade"):
        amb = [mc(lambda k, c=c: scene.mat_ambient[k, c]) for c in range(3)]
        spc = [mc(lambda k, c=c: scene.mat_specular[k, c])
               for c in range(3)]

        lam_mesh, spec_mesh = lam, spec
        if normal_mapping:
            with span("frame.normal_map"):
                nx, ny, nz = perturb_normal(scene, mat, *outs[8:20], uvx,
                                            1.0 - uvy, kernels=kernels)
            light = [mc(lambda k, c=c: scene.mat_light[k, c])
                     for c in range(3)]
            lam_mesh, spec_mesh = blinn_phong_planar(nx, ny, nz, dx, dy, dz,
                                                     light)

        taps, fxw, fyw = gather_packed_taps(
            scene.tex_packed, mc(lambda k: scene.mat_tex_base[k]),
            mc(lambda k: scene.mat_tex_h[k]),
            mc(lambda k: scene.mat_tex_w[k]), uvx, 1.0 - uvy)
        mr, mg, mb = kernels.texshade(taps, fxw, fyw, lam_mesh, spec_mesh,
                                      *amb, *spc)

        cr, cg, cb = (torch.full((nrays,), float(np.float32(v)),
                                 dtype=torch.float32, device=device)
                      for v in background)
        shadowed = (kind > 0.0) & (occ > 0.0)
        for s in range(ns):
            sel = kind == float(s + 1)
            col = scene.sphere_color[s]
            co = scene.sphere_coeff[s]
            shade = co[0] + co[1] * lam
            pr = col[0] * shade + co[2] * spec
            pg = col[1] * shade + co[2] * spec
            pb = col[2] * shade + co[2] * spec
            cr = torch.where(sel, torch.where(shadowed, col[0] * co[0], pr),
                             cr)
            cg = torch.where(sel, torch.where(shadowed, col[1] * co[0], pg),
                             cg)
            cb = torch.where(sel, torch.where(shadowed, col[2] * co[0], pb),
                             cb)
        mesh_sel = kind == float(ns + 1)
        cr = torch.where(mesh_sel, torch.where(shadowed, amb[0], mr), cr)
        cg = torch.where(mesh_sel, torch.where(shadowed, amb[1], mg), cg)
        cb = torch.where(mesh_sel, torch.where(shadowed, amb[2], mb), cb)
    with span("frame.present"):
        return present_planar(cr, cg, cb, depth, width=width,
                              height=height, shape=shape, quantize=quantize)
