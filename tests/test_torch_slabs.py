"""PyTorch port: row slabs (row0, total_height) and the staged shadow
planes (emit_shadow_planes) on one device, against the JAX package.

Each slab of the split, fused, streamed and path-traced frames is held
bit for bit against the JAX function called with the same row0 (the
compositions of the JAX package's tests/test_sharding.py, run in one
process; the JAX side runs in a fresh interpreter with XLA's CPU code
generation capped below FMA, test_torch_host.jax_reference): depth and
the quantized colour bit for bit, the unquantized colour within 1 ulp
(the split frame's Blinn-Phong power is torch's pow, within 1 ulp of
XLA's; 2 of 1,536 subpixels measured on the cube's slabs). The path
tracer without bounces is held bit for bit, with bounces at
test_torch_pathtrace's bar (1e-6; torch's cos/sin are 1 ulp off XLA's
on a few inputs). Inside the port the slabs stacked give the whole
frame bit for bit, unquantized colour and depth (the rays of a pixel
are the same floats in any ray order; JAX holds its own at 2e-5).
"""

import numpy as np
import pytest
import torch

from rust_wgpu_raytracing_tpu_torch import config as pcfg
from rust_wgpu_raytracing_tpu_torch.core import scene as pscene
from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
from rust_wgpu_raytracing_tpu_torch.core.scene import Scene
from rust_wgpu_raytracing_tpu_torch.ops import kernels as K
from rust_wgpu_raytracing_tpu_torch.ops import megakernel as pmk
from rust_wgpu_raytracing_tpu_torch.ops import pathtrace as ppt
from rust_wgpu_raytracing_tpu_torch.ops.shade import quantize_rgba8
from test_torch_host import (jax_config, jax_reference, sphere_cube_config,
                             stream_faces, terrain_config)

W, H = 64, 32
PT_SEED = 7
# the streamed case: STREAM_FACES lowered so that builtin:terrain:64
# (7,938 faces, 32-face clusters) pads to superblocks and streams
STREAM_LOW = 2048
PLANES = ("depth", "cr", "cg", "cb", "w_ar", "w_ag", "w_ab", "covered",
          "relevant", "px", "py", "pz", "sdx", "sdy", "sdz")


def scene_config(kind):
    if kind == "cube":
        return sphere_cube_config(pcfg, W, H)
    return terrain_config(pcfg, grid=64 if kind == "stream" else 23,
                          width=W, height=H)


# name: (scene, program, options, dp); program "split" / "fused" /
# "pt" (options: bounces)
CASES = {
    "split_shadows_dp2": ("terrain", "split", dict(shadows=True), 2),
    "split_shadows_dp4": ("terrain", "split", dict(shadows=True), 4),
    "split_lit_dp2": ("terrain", "split", dict(shadows=False), 2),
    "split_cube_dp4": ("cube", "split", dict(shadows=False), 4),
    "fused_shadows_dp2": ("terrain", "fused", dict(shadows=True), 2),
    "fused_shadows_dp4": ("terrain", "fused", dict(shadows=True), 4),
    "stream_shadows_dp2": ("stream", "split", dict(shadows=True), 2),
    "pt_b0_dp2": ("terrain", "pt", dict(bounces=0), 2),
    "pt_b2_dp4": ("terrain", "pt", dict(bounces=2), 4),
}


def jax_slabs(out):
    import jax
    import jax.numpy as jnp

    from rust_wgpu_raytracing_tpu.core import scene as jscene
    from rust_wgpu_raytracing_tpu.core.camera import Camera as JCamera
    from rust_wgpu_raytracing_tpu.core.scene import Scene as JScene
    from rust_wgpu_raytracing_tpu.ops import megakernel as jmk
    from rust_wgpu_raytracing_tpu.ops.pathtrace import render_pathtrace
    from rust_wgpu_raytracing_tpu.ops.shade import quantize_rgba8

    res = {}
    for name, (kind, program, opts, dp) in CASES.items():
        low = STREAM_LOW if kind == "stream" else jscene.STREAM_FACES
        with stream_faces(low, jscene, jmk):
            cfg = jax_config(scene_config(kind))
            data = JScene.build(cfg).data
            uni = jnp.asarray(JCamera.from_config(cfg.camera, W / H)
                              .uniforms().flat())
            rows = H // dp
            for i in range(dp):
                row0 = jnp.float32(i * rows)
                if program == "pt":
                    c = render_pathtrace(
                        data, uni, jax.random.PRNGKey(PT_SEED), width=W,
                        height=rows, spp=1, interpret=True, row0=row0,
                        total_height=H, **opts)
                    res[f"{name}.{i}.color"] = np.asarray(c)
                    continue
                c, d = jmk.render_megakernel(
                    data, uni, width=W, height=rows, interpret=True,
                    quantize=False, fused=program == "fused", row0=row0,
                    total_height=H, **opts)
                res[f"{name}.{i}.color"] = np.asarray(c)
                res[f"{name}.{i}.color_u8"] = np.asarray(quantize_rgba8(c))
                res[f"{name}.{i}.depth"] = np.asarray(d)
            if name == "split_shadows_dp2":
                planes = jmk.render_megakernel(
                    data, uni, width=W, height=H // 2, interpret=True,
                    shadows=True, fused=False, emit_shadow_planes=True,
                    row0=jnp.float32(H // 2), total_height=H)
                for k in PLANES:
                    res[f"planes.{k}"] = np.asarray(planes[k])
    np.savez(out, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return jax_reference("test_torch_slabs", "jax_slabs",
                         tmp_path_factory.mktemp("slabs"))


def port_scene(kind):
    cfg = scene_config(kind)
    return (Scene.build(cfg).data,
            Camera.from_config(cfg.camera, W / H).uniforms().flat())


def port_slab(name, data, uni, row0, rows):
    kind, program, opts, dp = CASES[name]
    if program == "pt":
        return ppt.render_pathtrace(data, uni, ppt.PRNGKey(PT_SEED),
                                    width=W, height=rows, spp=1, row0=row0,
                                    total_height=H, **opts), None
    return pmk.render_megakernel(data, uni, width=W, height=rows,
                                 quantize=False, fused=program == "fused",
                                 row0=row0, total_height=H, **opts)


def bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_slabs_match_jax_and_stack_to_the_frame(ref, name):
    kind, program, opts, dp = CASES[name]
    low = STREAM_LOW if kind == "stream" else pscene.STREAM_FACES
    with stream_faces(low, pscene, pmk):
        data, uni = port_scene(kind)
        if kind == "stream":
            assert pmk._should_stream(data.padded_faces,
                                      pmk._natural_block_f(
                                          data, data.padded_faces))
        rows = H // dp
        before = K.launch_counts()
        slabs = [port_slab(name, data, uni, i * rows, rows)
                 for i in range(dp)]
        assert K.launch_counts() == before  # CPU tensors: plain versions
        whole = port_slab(name, data, uni, None, H)
    for i, (c, d) in enumerate(slabs):
        want = ref[f"{name}.{i}.color"]
        if program == "pt" and opts["bounces"] > 0:
            np.testing.assert_allclose(c.numpy(), want, rtol=0, atol=1e-6)
            assert (c.numpy() != want).mean() <= 0.01
        elif program == "pt":
            np.testing.assert_array_equal(bits(c), bits(want))
        else:
            np.testing.assert_array_equal(
                bits(quantize_rgba8(c)), bits(ref[f"{name}.{i}.color_u8"]))
            gap = np.abs(bits(c).astype(np.int64) - bits(want))
            assert gap.max() <= 1, f"{gap.max()} ulp from JAX"
        if d is not None:
            np.testing.assert_array_equal(bits(d), bits(
                ref[f"{name}.{i}.depth"]))
    stacked = torch.cat([c for c, _ in slabs])
    assert float(stacked.sum()) > 0
    if program == "pt":
        # a slab draws its own jitter and bounces (scaled by the slab's
        # height, as in JAX): the stack is another sample of the frame
        assert np.isfinite(stacked.numpy()).all()
        return
    np.testing.assert_array_equal(bits(stacked), bits(whole[0]))
    np.testing.assert_array_equal(
        bits(torch.cat([d for _, d in slabs])), bits(whole[1]))


def test_emit_shadow_planes_match_jax(ref):
    data, uni = port_scene("terrain")
    planes = pmk.render_megakernel(
        data, uni, width=W, height=H // 2, shadows=True, fused=False,
        emit_shadow_planes=True, row0=H // 2, total_height=H)
    assert sorted(planes) == sorted(PLANES)
    for k in PLANES:
        got = planes[k].numpy()
        want = ref[f"planes.{k}"]
        if got.dtype == np.bool_:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_array_equal(bits(got), bits(want))
    assert planes["relevant"].any() and planes["covered"].any()
    # present_planar finishes the staged frame: the occlusion of the
    # staged wavefront gives the shadowed slab
    shape = pmk._frame_shape(W, H // 2, H // 2, H)
    rays = [planes[k] for k in ("px", "py", "pz", "sdx", "sdy", "sdz")]
    occ = (pmk.mesh_occlusion(data, *rays, planes["relevant"])
           | pmk._spheres_occlude_planar(data, *rays))
    sh = planes["covered"] & occ
    cols = [torch.where(sh, planes[f"w_a{c}"], planes[f"c{c}"])
            for c in "rgb"]
    color, depth = pmk.present_planar(*cols, planes["depth"], width=W,
                                      height=H // 2, shape=shape,
                                      quantize=False)
    want, wdepth = pmk.render_megakernel(
        data, uni, width=W, height=H // 2, shadows=True, fused=False,
        quantize=False, row0=H // 2, total_height=H)
    np.testing.assert_array_equal(bits(color), bits(want))
    np.testing.assert_array_equal(bits(depth), bits(wdepth))


def test_emit_shadow_planes_needs_the_split_shadowed_frame():
    data, uni = port_scene("terrain")
    for kw in (dict(shadows=False, fused=False), dict(shadows=True,
                                                      fused=True)):
        with pytest.raises(ValueError):
            pmk.render_megakernel(data, uni, width=W, height=H,
                                  emit_shadow_planes=True, **kw)


@pytest.mark.parametrize("width,rows,row0,want", [
    (1920, 540, 540, None),  # a 1080p frame's dp=2 slab: scanlines
    (1920, 1080, None, (32, 32, 1088)),
    (1920, 270, 270, None),
    (128, 32, 32, (32, 32, 32)),
    (128, 8, 8, (8, 128, 8)),
    (64, 8, 8, None),
])
def test_frame_shape_of_slabs(width, rows, row0, want):
    """_frame_shape: a slab keeps _pick_tile_shape's tiling when it pads
    no row, takes 8 x 128 tiles when they fit and scanlines otherwise."""
    from rust_wgpu_raytracing_tpu.ops.megakernel import _frame_shape

    got = pmk._frame_shape(width, rows, row0, None if row0 is None
                           else 2 * rows)
    assert got == want
    assert got == _frame_shape(width, rows, row0,
                               None if row0 is None else 2 * rows)


def test_intersect_and_occluded_tris_pallas_match_the_oracle():
    """The drop-ins run the sweeps (gbuffer, anyhit_rays) and answer as
    the oracle's brute-force queries do (JAX tests/test_megakernel.py)."""
    from rust_wgpu_raytracing_tpu_torch.ops.intersect import (
        intersect_tris, occluded_tris)
    from rust_wgpu_raytracing_tpu_torch.ops.raygen import ray_directions
    from rust_wgpu_raytracing_tpu_torch.core.camera import CameraUniforms

    cfg = terrain_config(pcfg, width=32, height=16, spheres=False)
    data = Scene.build(cfg).data
    u = CameraUniforms.unflat(Camera.from_config(cfg.camera, 2.0)
                              .uniforms().flat())
    origin = torch.as_tensor(u.origin, dtype=torch.float32)
    dirs = ray_directions(32, 16, u, device="cpu")
    got = pmk.intersect_tris_pallas(data, origin, dirs)
    want = intersect_tris(data, origin, dirs.reshape(-1, 3))
    hit = torch.isfinite(want.t).reshape(16, 32)
    assert bool(hit.any()) and not bool(hit.all())
    np.testing.assert_array_equal(torch.isfinite(got.t).numpy(),
                                  hit.numpy())
    np.testing.assert_array_equal(got.face[hit].numpy(),
                                  want.face.reshape(16, 32)[hit].numpy())
    np.testing.assert_allclose(got.t[hit].numpy(),
                               want.t.reshape(16, 32)[hit].numpy(),
                               rtol=1e-6)
    p = origin + dirs * torch.where(hit, got.t, 0.0)[..., None] * 0.999
    sdir = -torch.tensor([6.0, -1.0, 1.0]) / float(np.sqrt(38.0))
    sdir = sdir.expand(dirs.shape)  # toward the terrain's low sun
    occ = pmk.occluded_tris_pallas(data, p, sdir)
    assert occ.shape == (16, 32)
    np.testing.assert_array_equal(
        occ.numpy(), occluded_tris(data, p.reshape(-1, 3),
                                   sdir.reshape(-1, 3)).reshape(16, 32)
        .numpy())
    assert bool(occ.any())
