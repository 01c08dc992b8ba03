"""Mip-chain minification (trilinear): RenderConfig.mip (JAX
ops/miptex.py).

The reference forces mip level 0 for every sample via
`textureSampleGrad(..., vec2(0.), vec2(0.))` (triangle_list/compute.wgsl
:225), so distant or grazing textured geometry aliases. This module adds
the classic fix, OFF by default (RenderConfig.mip=True /
render_megakernel(..., mip=True)); the parity path and its packed level-0
pool are untouched (core/scene.py builds the pyramid into a SEPARATE
pool, SceneData.tex_mips).

- LOD comes from an isotropic RAY CONE: the angular width of a pixel is
  measured from the planar ray directions (adjacent lanes of a row are
  adjacent pixels), scaled by hit distance, surface inclination and the
  per-face uv density SceneData.tri_uvscale.
- The trilinear blend is two bilinear taps of the pyramid pool
  (ops/megakernel.py sample_packed_texture: one gather and one launch of
  the texture filter kernel K6 each) and one lerp.

Float semantics as the JAX package's; the LOD's log2 is torch's, which
may differ from XLA's by an ulp, so at an integer LOD the two packages
may pick neighbouring levels (the frames are held at the frame bar).
"""

from __future__ import annotations

import torch

from ..core.scene import SceneData
from .kernels import KERNELS, KernelSet
from .rounding import sqrt

_TINY = 2.0 ** -16


def pixel_dir_delta(dx, dy, dz, row_w: int):
    """(R,) |d_next_pixel - d_this_pixel| for planar rays whose lanes
    run in x-contiguous rows of row_w (tile rows in tiled order, full
    scanlines otherwise). Edge lanes reuse their inward difference.
    Same parameter scale as d itself, so `t * delta` is the world-space
    pixel footprint at hit distance t."""
    def delta(p):
        m = p.reshape(-1, row_w)
        d = m[:, 1:] - m[:, :-1]
        return torch.cat([d, d[:, -1:]], dim=1).reshape(-1)

    ddx, ddy, ddz = delta(dx), delta(dy), delta(dz)
    return sqrt(ddx * ddx + ddy * ddy + ddz * ddz)


def ray_cone_lod(scene: SceneData, gb, dx, dy, dz, row_w: int,
                 max_cos_boost: float = 0.08):
    """(R,) f32 mip LOD for the G-buffer's winner surfaces.

    footprint_texels = t * |pixel dir delta| / max(cos theta, clamp)
                       * uvscale(face) * sqrt(tex_w * tex_h)
    lod = log2(footprint_texels), clamped to the pyramid range by the
    sampler. cos theta is clamped (default 0.08) so grazing surfaces
    don't blow up to the 1x1 level."""
    from .megakernel import _mat_const

    f = scene.tri_uvscale.shape[0]
    idx = gb.face.clamp(0, max(f - 1, 0)).long()
    uvs = scene.tri_uvscale.index_select(0, idx)

    dlen = sqrt(dx * dx + dy * dy + dz * dz)
    cos = (gb.nx * dx + gb.ny * dy + gb.nz * dz).abs() / dlen.clamp_min(1e-30)
    dpix = pixel_dir_delta(dx, dy, dz, row_w)
    ts = torch.where(torch.isfinite(gb.t), gb.t, 0.0)
    fw = ts * dpix / cos.clamp_min(max_cos_boost)

    th = _mat_const(scene, gb.mat, lambda k: scene.mat_mip_h[k, 0])
    tw = _mat_const(scene, gb.mat, lambda k: scene.mat_mip_w[k, 0])
    ft = fw * uvs * sqrt(th * tw)
    return torch.log2(ft.clamp_min(_TINY))


def sample_mip_trilinear(scene: SceneData, mat_f32, lod, u, v, *,
                         kernels: KernelSet = KERNELS):
    """Trilinear sample of the pyramid pool: two bilinear level taps
    (floor(lod), floor(lod)+1, both clamped to the chain) blended by
    the lod fraction. u/v in [0,1] with v already flipped — the
    addressing of sample_packed_texture; lod <= 0 degenerates to EXACTLY
    the level-0 bilinear tap (frac 0, both levels 0)."""
    from .megakernel import _mat_const, sample_packed_texture

    levels = scene.mip_levels
    assert levels > 0, "scene has no mip pyramid"
    lodc = lod.clamp(0.0, float(levels - 1))
    l0f = torch.floor(lodc)
    frac = lodc - l0f
    l0 = l0f.to(torch.int32)
    l1 = torch.clamp_max(l0 + 1, levels - 1)

    def lv_const(table, li):
        out = _mat_const(scene, mat_f32, lambda k: table[k, 0])
        for lv in range(1, levels):
            row = _mat_const(scene, mat_f32, lambda k: table[k, lv])
            out = torch.where(li == lv, row, out)
        return out

    def tap(li):
        return sample_packed_texture(
            scene.tex_mips, lv_const(scene.mat_mip_base, li),
            lv_const(scene.mat_mip_h, li), lv_const(scene.mat_mip_w, li),
            u, v, kernels=kernels)

    r0, g0, b0 = tap(l0)
    r1, g1, b1 = tap(l1)
    w0 = 1.0 - frac
    return (r0 * w0 + r1 * frac, g0 * w0 + g1 * frac,
            b0 * w0 + b1 * frac)
