"""PyTorch port: mip sampling (ops/miptex.py, RenderConfig.mip) against
the JAX package's.

The pyramid build and its scene tables are NumPy in both packages and
held bitwise; pixel_dir_delta and ray_cone_lod on seeded inputs within
1e-6 of JAX's (both under jit, as the frame runs them); the trilinear
sample at LOD <= 0 bitwise the level-0 tap; the mip frame (split, the
texture filter kernel's plain version on the CPU) against JAX's
render_megakernel(mip=True, interpret=True) at the frame bar (its LOD's
log2 may pick the neighbouring level where XLA's rounds the other way),
near and far; the far view's aliasing drops as in tests/test_miptex.py;
a meshless scene ignores the flag.
"""

import dataclasses as dc
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_wgpu_raytracing_tpu import config as jcfg
from rust_wgpu_raytracing_tpu.core.camera import Camera as JCamera
from rust_wgpu_raytracing_tpu.core.scene import Scene as JScene
from rust_wgpu_raytracing_tpu.core.scene import _mip_chain as jax_mip_chain
from rust_wgpu_raytracing_tpu.ops import miptex as jmip
from rust_wgpu_raytracing_tpu.ops.megakernel import \
    render_megakernel as jax_render
from rust_wgpu_raytracing_tpu_torch import Renderer
from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
from rust_wgpu_raytracing_tpu_torch.core.scene import Scene, _mip_chain
from rust_wgpu_raytracing_tpu_torch.io.image_out import encode_png
from rust_wgpu_raytracing_tpu_torch.ops import kernels as K
from rust_wgpu_raytracing_tpu_torch.ops import miptex
from rust_wgpu_raytracing_tpu_torch.ops.megakernel import (
    GBuffer, render_megakernel, sample_packed_texture)
from test_torch_host import assert_frame_bar, port_config, u8_levels

SIZE = 64


def checker_quad_config(root, tex_px=16, z=-3.0, scale=1.0):
    """tests/test_miptex.py's standalone textured quad (2 triangles over
    [-1,1]^2, uv [0,1]^2) with a checkerboard map_Kd, written with the
    port's PNG encoder; built from the JAX config module."""
    yy, xx = np.mgrid[0:tex_px, 0:tex_px]
    cell = ((yy + xx) % 2).astype(np.uint8) * 255
    with open(os.path.join(root, "checker.png"), "wb") as fh:
        fh.write(encode_png(np.stack([cell] * 3, axis=-1)))
    with open(os.path.join(root, "quad.mtl"), "w") as fh:
        fh.write("newmtl checker\nKa 0.0 0.0 0.0\nKd 0.8 0.8 0.8\n"
                 f"Ks 0.0 0.0 0.0\nmap_Kd {root}/checker.png\n")
    with open(os.path.join(root, "quad.obj"), "w") as fh:
        fh.write("mtllib quad.mtl\nv -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\n"
                 "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nusemtl checker\n"
                 "f 1/1 2/2 3/3\nf 1/1 3/3 4/4\n")
    return jcfg.SceneConfig(
        meshes=(jcfg.MeshConfig(obj_path=os.path.join(root, "quad.obj"),
                                translation=(0.0, 0.0, z), scale=scale,
                                light_direction=(0.0, 0.0, -1.0)),),
        camera=jcfg.CameraConfig(eye=(0.0, 0.0, 0.0),
                                 target=(0.0, 0.0, -1.0)),
        render=jcfg.RenderConfig(width=SIZE, height=SIZE))


VIEWS = {  # the near view and the far view of tests/test_miptex.py
    "near": dict(tex_px=16, z=-2.0),
    "far": dict(tex_px=64, z=-40.0, scale=8.0),
}


def frames(root, view, **kw):
    """(JAX mip frame, port mip frame, port parity frame) of a view."""
    jc = checker_quad_config(str(root), **VIEWS[view])
    uni = JCamera.from_config(jc.camera, 1.0).uniforms().flat()
    want, _ = jax_render(JScene.build(jc).data, jnp.asarray(uni), width=SIZE,
                         height=SIZE, mip=True, interpret=True, **kw)
    data = Scene.build(port_config(jc)).data
    got, _ = render_megakernel(data, uni, width=SIZE, height=SIZE, mip=True,
                               **kw)
    parity, _ = render_megakernel(data, uni, width=SIZE, height=SIZE, **kw)
    return np.asarray(want), got, parity


@pytest.mark.parametrize("hw", [(4, 4), (3, 5), (16, 16), (7, 1), (1, 1)])
def test_mip_chain_matches_jax(hw):
    img = np.random.default_rng(hw[0] * 31 + hw[1]).uniform(
        size=hw + (3,)).astype(np.float32)
    want = jax_mip_chain(img)
    got = _mip_chain(img)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_scene_mip_tables_match_jax(tmp_path):
    jc = checker_quad_config(str(tmp_path), tex_px=12)
    jd = JScene.build(jc).data
    pd = Scene.build(port_config(jc)).data
    assert pd.mip_levels == jd.mip_levels == 5  # 12, 6, 3, 2, 1
    np.testing.assert_array_equal(pd.tex_mips.numpy(),
                                  np.asarray(jd.tex_mips).view(np.int16))
    for name in ("mat_mip_base", "mat_mip_h", "mat_mip_w", "tri_uvscale"):
        np.testing.assert_array_equal(getattr(pd, name).numpy(),
                                      np.asarray(getattr(jd, name)), name)
    # level 0 mirrors the parity tables
    np.testing.assert_array_equal(pd.mat_mip_h[:, 0], pd.mat_tex_h)
    np.testing.assert_array_equal(pd.mat_mip_w[:, 0], pd.mat_tex_w)


def gbuffer_inputs(data, n, seed=5):
    """Seeded planar rays and winner planes (4 rows of n // 4 lanes)."""
    rng = np.random.default_rng(seed)
    d = rng.normal([0.0, 0.0, -1.0], 0.3, (n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
        np.float32)
    t = rng.uniform(0.5, 60.0, n).astype(np.float32)
    t[::7] = np.inf  # misses
    face = rng.integers(0, data.num_faces, n).astype(np.int32)
    return d, nrm, t, face


def test_pixel_dir_delta_and_lod_match_jax(tmp_path):
    jc = checker_quad_config(str(tmp_path))
    jd = JScene.build(jc).data
    pd = Scene.build(port_config(jc)).data
    n, row_w = 256, 64
    d, nrm, t, face = gbuffer_inputs(pd, n)
    mat = np.zeros(n, np.float32)
    jgb = dict(t=t, face=face, nx=nrm[:, 0], ny=nrm[:, 1], nz=nrm[:, 2],
               mat=mat)

    def jax_side(scene, gb, dx, dy, dz):
        g = type("GB", (), {})()
        for k, v in gb.items():
            setattr(g, k, v)
        return (jmip.pixel_dir_delta(dx, dy, dz, row_w),
                jmip.ray_cone_lod(scene, g, dx, dy, dz, row_w))

    want = jax.jit(jax_side)(jd, jgb, *(d[:, k] for k in range(3)))
    zero = torch.zeros(n)
    gb = GBuffer(t=torch.from_numpy(t), face=torch.from_numpy(face), u=zero,
                 v=zero, nd=zero, uvx=zero, uvy=zero,
                 nx=torch.from_numpy(nrm[:, 0].copy()),
                 ny=torch.from_numpy(nrm[:, 1].copy()),
                 nz=torch.from_numpy(nrm[:, 2].copy()),
                 mat=torch.from_numpy(mat))
    dx, dy, dz = (torch.from_numpy(d[:, k].copy()) for k in range(3))
    got = (miptex.pixel_dir_delta(dx, dy, dz, row_w),
           miptex.ray_cone_lod(pd, gb, dx, dy, dz, row_w))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    assert float(got[1].min()) == -16.0 and float(got[1].max()) > 1.0


def test_lod0_is_bitwise_the_level0_tap(tmp_path):
    pd = Scene.build(port_config(checker_quad_config(str(tmp_path)))).data
    rng = np.random.default_rng(1)
    n = 256
    u = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
    v = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
    ref = sample_packed_texture(
        pd.tex_packed, pd.mat_tex_base[0].expand(n), pd.mat_tex_h[0].expand(n),
        pd.mat_tex_w[0].expand(n), u, v)
    mat = torch.zeros(n)
    for lod in (0.0, -7.0):
        got = miptex.sample_mip_trilinear(pd, mat, torch.full((n,), lod),
                                          u, v)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_mip_frame_matches_jax(tmp_path, view):
    want, got, parity = frames(tmp_path, view, shadows=True)
    hit = u8_levels(got).sum(-1) > 0
    assert hit.sum() > 50  # the quad is on screen
    assert_frame_bar(got, want)
    if view == "near":  # magnified: level 0, the parity frame's texels
        assert_frame_bar(got, parity)
    else:  # minified: the pyramid's deeper levels
        assert not torch.equal(got, parity)


def test_far_view_reduces_aliasing(tmp_path):
    """tests/test_miptex.py's bar: a 64-px checker quad squeezed into a
    few screen pixels aliases without mips (pixels snap to black or
    white); with them its spread halves and its mean stays."""
    _, got, parity = frames(tmp_path, "far")
    a0, a1 = parity.numpy(), got.numpy()
    hit = a0.sum(axis=-1) > 0
    assert hit.sum() > 50
    s0, s1 = a0[hit][:, 0].std(), a1[hit][:, 0].std()
    assert s1 < 0.5 * s0, (s0, s1)
    assert abs(a1[hit][:, 0].mean() - a0[hit][:, 0].mean()) < 0.15


def test_mip_frame_runs_the_texture_filter(tmp_path):
    """The mip path shades through two texture filter calls (K6 on the
    card) and no texshade call; the Renderer takes the split frame, and
    variant="fused" with mip raises ValueError."""
    cfg = port_config(checker_quad_config(str(tmp_path), **VIEWS["near"]))
    cfg = dc.replace(cfg, render=dc.replace(cfg.render, mip=True))
    calls = []

    def rec(fn):
        def call(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k)
        return call

    r = Renderer(cfg, device="cpu")
    assert r.variant_chosen == "split"
    color, _ = r.render()
    uni = r.camera.uniforms().flat()
    again, _ = render_megakernel(
        r.data, uni, width=SIZE, height=SIZE, mip=True,
        kernels=K.KernelSet(*(rec(f) for f in K.KERNELS)))
    assert torch.equal(color, again)
    assert calls.count("texfilter") == 2 and "texshade" not in calls
    with pytest.raises(ValueError):
        render_megakernel(r.data, uni, width=SIZE, height=SIZE, mip=True,
                          fused=True)
    with pytest.raises(ValueError):
        Renderer(dc.replace(cfg, render=dc.replace(cfg.render,
                                                   variant="fused")),
                 device="cpu")


def test_meshless_mip_is_a_no_op():
    cfg = port_config(jcfg.SceneConfig(
        spheres=jcfg.reference_scene().spheres,
        render=jcfg.RenderConfig(width=48, height=32, shadows=True)))
    data = Scene.build(cfg).data
    uni = Camera.from_config(cfg.camera, 1.5).uniforms().flat()
    a = render_megakernel(data, uni, width=48, height=32, shadows=True,
                          mip=True)
    b = render_megakernel(data, uni, width=48, height=32, shadows=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    mip_cfg = dc.replace(cfg, render=dc.replace(cfg.render, mip=True))
    c, _ = Renderer(mip_cfg, device="cpu").render()
    assert torch.equal(c, a[0])


def test_streamed_mip_frame_matches_jax():
    """A mesh above STREAM_FACES (terrain:92, streamed sweeps) takes the
    same mip tail: at the frame bar of JAX's mip frame."""
    from test_torch_host import terrain_config

    jc = terrain_config(jcfg, grid=92, width=64, height=64)
    uni = JCamera.from_config(jc.camera, 1.0).uniforms().flat()
    want, _ = jax_render(JScene.build(jc).data, jnp.asarray(uni), width=64,
                         height=64, shadows=True, mip=True, interpret=True)
    data = Scene.build(port_config(jc)).data
    assert data.padded_faces > 16384 and data.mip_levels > 1
    got, depth = render_megakernel(data, uni, width=64, height=64,
                                   shadows=True, mip=True)
    assert bool((depth < 1).any())
    assert_frame_bar(got, np.asarray(want))
