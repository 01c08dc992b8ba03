"""PyTorch port: the whole split frame against the JAX package.

The port's render_megakernel (CPU tensors, so the kernels' plain
versions) and its Renderer(device="cpu") against the JAX package's
render_megakernel(fused=False, interpret=True) and its oracle
render_oracle, at the frame bar of tests/test_goldens.py: at most 1
linear u8 level, at least 99.9% of subpixels exact. The JAX side runs
in this process as its own tests run it (XLA may contract float ops
here, so the bar, not bit equality, is the contract; the streamed
frames are held bitwise in tests/test_torch_hiercull.py). Inside the
port every accel renders the same frame bit for bit.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_wgpu_raytracing_tpu import config as jcfg
from rust_wgpu_raytracing_tpu.core.camera import Camera as JCamera
from rust_wgpu_raytracing_tpu.core.controls import \
    CircleCameraController as JController
from rust_wgpu_raytracing_tpu.core.scene import Scene as JScene
from rust_wgpu_raytracing_tpu.ops.megakernel import \
    render_megakernel as jax_render
from rust_wgpu_raytracing_tpu.ops.oracle import render_oracle
from rust_wgpu_raytracing_tpu_torch import Renderer
from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
from rust_wgpu_raytracing_tpu_torch.core.scene import Scene
from rust_wgpu_raytracing_tpu_torch.io.image_out import (framebuffer_to_image,
                                                        read_png)
from rust_wgpu_raytracing_tpu_torch.ops.megakernel import render_megakernel
from test_torch_host import (assert_frame_bar, port_config, terrain_config,
                             textured_config, u8_levels,
                             write_textured_assets)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "terrain_shadows.png")
_jax_frames = {}


def jax_frames(cfg, key):
    """(megakernel split frame, oracle frame) of a JAX config, cached."""
    if key not in _jax_frames:
        rc = cfg.render
        data = JScene.build(cfg).data
        uni = jnp.asarray(JCamera.from_config(
            cfg.camera, rc.width / rc.height).uniforms().flat())
        mk, _ = jax_render(data, uni, width=rc.width, height=rc.height,
                           shadows=rc.shadows, interpret=True, fused=False)
        orc, _ = render_oracle(data, uni, width=rc.width, height=rc.height,
                               shadows=rc.shadows)
        _jax_frames[key] = (np.asarray(mk), np.asarray(orc))
    return _jax_frames[key]


def port_frame(cfg, accel=None):
    rc = cfg.render
    data = Scene.build(cfg).data
    uni = Camera.from_config(cfg.camera, rc.width / rc.height).uniforms()
    color, depth = render_megakernel(
        data, uni.flat(), width=rc.width, height=rc.height,
        shadows=rc.shadows, accel=accel or rc.accel, fused=False)
    return color, depth


@pytest.mark.parametrize("accel", ["brute", "cull", "bvh"])
@pytest.mark.parametrize("shadows", [False, True])
@pytest.mark.parametrize("w,h", [(64, 64), (96, 64)])
def test_frame_matches_jax(w, h, shadows, accel):
    jc = terrain_config(jcfg, width=w, height=h, shadows=shadows)
    mk, orc = jax_frames(jc, (w, h, shadows))
    color, depth = port_frame(port_config(jc), accel)
    assert color.shape == (h, w, 3) and depth.shape == (h, w)
    assert u8_levels(color).max() > 0  # something is lit
    assert_frame_bar(color, mk)
    assert_frame_bar(color, orc)
    other, _ = port_frame(port_config(jc),
                          "cull" if accel == "brute" else "brute")
    assert torch.equal(color, other), "brute and cull frames differ"


def test_textured_frame_matches_jax(tmp_path, monkeypatch):
    write_textured_assets(str(tmp_path))
    monkeypatch.setenv("RWRT_ASSETS", str(tmp_path))
    jc = textured_config(jcfg)
    mk, orc = jax_frames(jc, "textured")
    color, _ = port_frame(port_config(jc))
    assert len(np.unique(u8_levels(color))) > 20  # the texture shows
    assert_frame_bar(color, mk)
    assert_frame_bar(color, orc)


def test_meshless_frame_matches_jax():
    jc = jcfg.SceneConfig(spheres=jcfg.reference_scene().spheres,
                          render=jcfg.RenderConfig(width=48, height=40,
                                                   shadows=True))
    mk, orc = jax_frames(jc, "spheres")
    color, _ = port_frame(port_config(jc))
    assert_frame_bar(color, mk)
    assert_frame_bar(color, orc)


def test_renderer_orbit_matches_jax():
    """Drive the port's Renderer like a user (orbit key held) and hold
    each frame against the JAX split frame at the same camera."""
    jc = terrain_config(jcfg, width=64, height=48)
    r = Renderer(port_config(jc), device="cpu")
    cam = JCamera.from_config(jc.camera, 64 / 48)
    ctl = JController(speed=0.2)
    data = JScene.build(jc).data
    for key in ("d", "s"):
        r.controller.process_key(key, True)
        ctl.process_key(key, True)
    for _ in range(2):
        r.update()
        ctl.update_camera(cam)
        color, depth = r.render(block=True)
        mk, _ = jax_render(data, jnp.asarray(cam.uniforms().flat()),
                           width=64, height=48, shadows=True,
                           interpret=True, fused=False)
        assert_frame_bar(color, np.asarray(mk))
    np.testing.assert_array_equal(r.camera.eye, cam.eye)
    assert r.frame_count == 2
    assert r.last_frame_ms > 0 and r.mrays_per_s > 0


def test_frame_matches_terrain_golden():
    """The only asset-free golden: the PNG holds the sRGB encode of the
    oracle's linear u8 levels; a level off is a neighbour's code."""
    jc = dict(width=160, height=160, shadows=True)
    cfg = port_config(jcfg.SceneConfig(
        meshes=terrain_config(jcfg).meshes,
        camera=terrain_config(jcfg).camera,
        render=jcfg.RenderConfig(**jc)))
    color, _ = Renderer(cfg, device="cpu").render(block=True)
    golden = read_png(GOLDEN)[::-1].astype(np.int32)  # back to bottom-up
    lut = np.array([framebuffer_to_image(
        np.full((1, 1, 3), k / 255.0, np.float32))[0, 0, 0]
        for k in range(256)], np.int32)
    lv = u8_levels(color)
    exact = lut[lv] == golden
    near = exact | (lut[np.clip(lv - 1, 0, 255)] == golden) | \
        (lut[np.clip(lv + 1, 0, 255)] == golden)
    assert near.all()
    assert exact.mean() >= 0.999


def test_present_and_save_png(tmp_path):
    cfg = port_config(terrain_config(jcfg, width=48, height=32))
    r = Renderer(cfg, device="cpu")
    r.render(block=True)
    path = str(tmp_path / "frame.png")
    r.save_png(path)
    host = framebuffer_to_image(r._last[0])
    np.testing.assert_array_equal(read_png(path), host)
    dev = r.present_image()
    assert dev.shape == host.shape
    assert np.abs(dev.astype(int) - host.astype(int)).max() <= 1


@pytest.mark.parametrize("change,exc", [
    # the fused frame cannot take mip sampling (the split frame does)
    (dict(variant="fused", mip=True), ValueError),
    # mip renders, but not with an unknown accel
    (dict(mip=True, accel="octree"), ValueError),
    (dict(accel="octree"), ValueError),
    (dict(variant="bogus"), ValueError),
])
def test_unported_options_raise(change, exc):
    import dataclasses as dc

    cfg = port_config(terrain_config(jcfg, width=32, height=32))
    cfg = dc.replace(cfg, render=dc.replace(cfg.render, **change))
    with pytest.raises(exc):
        Renderer(cfg, device="cpu")


@pytest.mark.parametrize("accel", ["cull", "bvh"])
def test_streamed_renderer_matches_jax(accel):
    """A mesh above STREAM_FACES (terrain:92, 16,562 faces) through the
    Renderer: variant "auto" takes the split frame with the streamed
    sweeps, under either cull, at the frame bar of the JAX frame."""
    import dataclasses as dc

    jc = terrain_config(jcfg, grid=92, width=64, height=64, accel=accel)
    r = Renderer(port_config(jc), device="cpu")
    assert r.variant_chosen == "split"
    color, _ = r.render(block=True)
    data = JScene.build(jc).data
    uni = jnp.asarray(JCamera.from_config(jc.camera, 1.0).uniforms().flat())
    mk, _ = jax_render(data, uni, width=64, height=64, shadows=True,
                       interpret=True, fused=False, accel=accel)
    assert_frame_bar(color, np.asarray(mk))
    fused = dc.replace(r.config, render=dc.replace(r.config.render,
                                                   variant="fused"))
    with pytest.raises(ValueError, match="STREAM_FACES"):
        Renderer(fused, device="cpu")


def test_unported_scenes_raise():
    """Normal mapping with mip sampling and the oracle backend render
    (the split frame; the oracle's own frame); so does the
    geometry-parallel backend, which outside a process group renders its
    one shard: the megakernel frame bit for bit."""
    import dataclasses as dc

    cfg = port_config(terrain_config(jcfg, width=32, height=32))
    nm = dc.replace(cfg, meshes=(dc.replace(cfg.meshes[0],
                                            normal_mapping=True),),
                    render=dc.replace(cfg.render, mip=True))
    r = Renderer(nm, device="cpu")
    assert r.variant_chosen == "split"
    color, depth = r.render()
    assert color.shape == (32, 32, 3) and bool((depth < 1).any())
    color, depth = Renderer(cfg, backend="oracle", device="cpu").render()
    assert color.shape == (32, 32, 3) and bool((depth < 1).any())
    rg = Renderer(cfg, backend="megakernel_gp", device="cpu")
    assert rg.variant_chosen == "gp"
    color, depth = rg.render()
    want = Renderer(cfg, device="cpu").render()
    assert torch.equal(color, want[0]) and torch.equal(depth, want[1])


def test_device_is_explicit():
    """The device defaults to the card; a caller asks for the CPU
    explicitly, and the card raises where there is none."""
    import inspect

    cfg = port_config(terrain_config(jcfg, width=32, height=32))
    assert inspect.signature(Renderer).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Renderer(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            Renderer(cfg, device="cuda")
