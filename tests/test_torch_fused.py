"""PyTorch port: the fused frame and normal mapping against the JAX
package, and the frame-program choice.

The JAX side runs in a separate interpreter with XLA's CPU code
generation capped below FMA (test_torch_host.jax_reference), Pallas in
interpret mode. Under those rounding rules the port's fused frame is
held to BIT equality with JAX render_frame_fused (colour and depth), in
each shadow mode, and to the frame bar (at most 1 linear u8 level, at
least 99.9% exact) against the oracle. Inside the port the fused and
split frames are equal after quantization on these views: the fused
frame's specular power is the multiply chain pow32, the split frame's
torch's pow, which differ by a few ulp before quantization, exactly as
the JAX package's two frames do. The normal-mapped frames (fused
without shadows, split with and without) meet the same bars against
JAX's normal-mapped frames and its oracle.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from rust_wgpu_raytracing_tpu_torch import Renderer
from rust_wgpu_raytracing_tpu_torch import config as pcfg
from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
from rust_wgpu_raytracing_tpu_torch.core.scene import Scene
from rust_wgpu_raytracing_tpu_torch.ops import kernels as K
from rust_wgpu_raytracing_tpu_torch.ops.fusedframe import render_frame_fused
from rust_wgpu_raytracing_tpu_torch.ops.megakernel import render_megakernel
from test_torch_host import (assert_frame_bar, jax_config, jax_reference,
                             terrain_config, textured_config, u8_levels,
                             write_textured_assets)

# the terrain-golden view and a dense view of the same terrain
VIEWS = {
    "golden": lambda: terrain_config(pcfg, width=96, height=64),
    "dense": lambda: dataclasses.replace(
        terrain_config(pcfg, width=96, height=64),
        camera=pcfg.CameraConfig(eye=(0.0, -0.3, -2.2),
                                 target=(0.0, 0.0, -3.0))),
}
SHADOW_MODES = ("sched", "inkernel")


def scene_and_uni(cfg):
    rc = cfg.render
    data = Scene.build(cfg).data
    uni = Camera.from_config(cfg.camera, rc.width / rc.height).uniforms()
    return data, uni.flat(), dict(width=rc.width, height=rc.height)


def jax_fused(out, assets):
    import jax.numpy as jnp

    from rust_wgpu_raytracing_tpu.core.camera import Camera as JCamera
    from rust_wgpu_raytracing_tpu.core.scene import Scene as JScene
    from rust_wgpu_raytracing_tpu.ops.fusedframe import \
        render_frame_fused as jfused
    from rust_wgpu_raytracing_tpu.ops.megakernel import \
        render_megakernel as jsplit
    from rust_wgpu_raytracing_tpu.ops.oracle import render_oracle

    os.environ["RWRT_ASSETS"] = assets
    res = {}

    def setup(port_cfg):
        cfg = jax_config(port_cfg)
        rc = cfg.render
        uni = jnp.asarray(JCamera.from_config(
            cfg.camera, rc.width / rc.height).uniforms().flat())
        return JScene.build(cfg).data, uni, dict(width=rc.width,
                                                  height=rc.height)

    for view, make in VIEWS.items():
        data, uni, wh = setup(make())
        for mode in SHADOW_MODES:
            c, d = jfused(data, uni, shadows=True, shadow_mode=mode,
                          interpret=True, **wh)
            res[f"{view}_{mode}_color"], res[f"{view}_{mode}_depth"] = c, d
        c, d = jfused(data, uni, shadows=False, interpret=True, **wh)
        res[f"{view}_none_color"], res[f"{view}_none_depth"] = c, d
        res[f"{view}_oracle"] = render_oracle(data, uni, shadows=True,
                                              **wh)[0]
    data, uni, wh = setup(textured_config(pcfg, bump=True))
    c, d = jfused(data, uni, normal_mapping=True, interpret=True, **wh)
    res["nm_fused_color"], res["nm_fused_depth"] = c, d
    for shadows in (False, True):
        tag = "shadows" if shadows else "plain"
        res[f"nm_split_{tag}"] = jsplit(data, uni, shadows=shadows,
                                        normal_mapping=True, fused=False,
                                        interpret=True, **wh)[0]
        res[f"nm_oracle_{tag}"] = render_oracle(
            data, uni, shadows=shadows, normal_mapping=True, **wh)[0]
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("assets")
    write_textured_assets(str(root), bump=True)
    return str(root)


@pytest.fixture(scope="module")
def ref(tmp_path_factory, assets):
    return jax_reference("test_torch_fused", "jax_fused",
                         tmp_path_factory.mktemp("fused"), assets=assets)


@pytest.fixture
def nm_scene(assets, monkeypatch):
    monkeypatch.setenv("RWRT_ASSETS", assets)
    return scene_and_uni(textured_config(pcfg, bump=True))


def eq(got, want):
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", SHADOW_MODES + ("none",))
@pytest.mark.parametrize("view", sorted(VIEWS))
def test_fused_frame_matches_jax(ref, view, mode):
    data, uni, wh = scene_and_uni(VIEWS[view]())
    before = K.launch_counts()
    if mode == "inkernel":
        color, depth = render_frame_fused(data, uni, shadows=True,
                                          shadow_mode=mode, **wh)
    else:  # the frame render_megakernel draws
        color, depth = render_megakernel(data, uni, shadows=mode != "none",
                                         fused=True, **wh)
    assert K.launch_counts() == before  # CPU tensors: plain versions only
    eq(color, ref[f"{view}_{mode}_color"])
    eq(depth, ref[f"{view}_{mode}_depth"])
    if mode != "none":  # the oracle frame is the shadowed one
        assert_frame_bar(color, ref[f"{view}_oracle"])
    assert u8_levels(color).max() > 0


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_inkernel_shadows_equal_sched(view):
    data, uni, wh = scene_and_uni(VIEWS[view]())
    sched = render_frame_fused(data, uni, shadows=True, shadow_mode="sched",
                               quantize=False, **wh)
    ink = render_frame_fused(data, uni, shadows=True,
                             shadow_mode="inkernel", quantize=False, **wh)
    assert torch.equal(sched[0], ink[0]) and torch.equal(sched[1], ink[1])


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_fused_equals_split_when_quantized(view):
    data, uni, wh = scene_and_uni(VIEWS[view]())
    for shadows in (False, True):
        f, fd = render_megakernel(data, uni, shadows=shadows, fused=True,
                                  **wh)
        s, sd = render_megakernel(data, uni, shadows=shadows, fused=False,
                                  **wh)
        assert_frame_bar(f, s)
        assert torch.equal(f, s), "quantized fused and split frames differ"
        assert torch.equal(fd, sd)
        fu, _ = render_megakernel(data, uni, shadows=shadows, fused=True,
                                  quantize=False, **wh)
        su, _ = render_megakernel(data, uni, shadows=shadows, fused=False,
                                  quantize=False, **wh)
        assert_frame_bar(fu, su)
        assert (fu - su).abs().max() < 1e-6  # a few ulp of the spec power


def test_nm_fused_matches_jax(ref, nm_scene):
    data, uni, wh = nm_scene
    color, depth = render_megakernel(data, uni, normal_mapping=True, **wh)
    # the bump map shows: normal mapping changes the frame
    plain, _ = render_megakernel(data, uni, **wh)
    assert not torch.equal(color, plain)
    for key in ("nm_fused_color", "nm_split_plain", "nm_oracle_plain"):
        assert_frame_bar(color, ref[key])
    eq(color, ref["nm_fused_color"])
    eq(depth, ref["nm_fused_depth"])


@pytest.mark.parametrize("shadows", [False, True])
def test_nm_split_matches_jax(ref, nm_scene, shadows):
    data, uni, wh = nm_scene
    tag = "shadows" if shadows else "plain"
    color, _ = render_megakernel(data, uni, normal_mapping=True,
                                 shadows=shadows, fused=False, **wh)
    eq(color, ref[f"nm_split_{tag}"])
    assert_frame_bar(color, ref[f"nm_oracle_{tag}"])
    if not shadows:
        assert_frame_bar(color, ref["nm_fused_color"])


def counting_kernels():
    """A KernelSet of the plain versions that counts calls by name."""
    calls = {f.__name__: 0 for f in K.KERNELS}

    def wrap(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call
    return K.KernelSet(*(wrap(f.__name__, p)
                         for f, p in zip(K.KERNELS, K.PLAIN))), calls


def test_default_frame_choice_follows_jax(nm_scene):
    """fused=None: the fused frame for an eligible scene (with or without
    shadows, normal mapping without shadows); the split frame for normal
    mapping with shadows and for a scene without a mesh."""
    data, uni, wh = nm_scene
    for nm, shadows, fused in ((False, True, True), (True, False, True),
                               (True, True, False)):
        ks, calls = counting_kernels()
        render_megakernel(data, uni, normal_mapping=nm, shadows=shadows,
                          kernels=ks, **wh)
        assert (calls["frame"] == 1) == fused
        assert (calls["closest_hit"] == 1) == (not fused)
        assert calls["texfilter"] == int(nm)
    spheres = scene_and_uni(pcfg.SceneConfig(
        spheres=pcfg.reference_scene().spheres,
        render=pcfg.RenderConfig(width=32, height=32)))
    ks, calls = counting_kernels()
    render_megakernel(spheres[0], spheres[1], shadows=True, kernels=ks,
                      **spheres[2])
    assert calls["frame"] == 0
    with pytest.raises(ValueError):
        render_megakernel(spheres[0], spheres[1], fused=True, **spheres[2])
    with pytest.raises(ValueError):
        render_megakernel(data, uni, normal_mapping=True, shadows=True,
                          fused=True, **wh)


def test_renderer_auto_times_both_variants():
    cfg = terrain_config(pcfg, width=32, height=32)
    r = Renderer(cfg, device="cpu")
    assert r.variant_chosen is None and r.variant_ms == {}
    color, _ = r.render(block=True)
    assert set(r.variant_ms) == {"split", "fused"}
    assert all(ms > 0 for ms in r.variant_ms.values())
    assert r.variant_chosen == min(r.variant_ms, key=r.variant_ms.get)
    want, _ = render_megakernel(
        r.data, r.camera.uniforms().flat(), width=32, height=32,
        shadows=True, fused=r.variant_chosen == "fused")
    assert torch.equal(color, want)
    assert r.last_frame_ms > 0


@pytest.mark.parametrize("variant", ["split", "fused"])
def test_renderer_fixed_variant(variant):
    cfg = terrain_config(pcfg, width=32, height=32)
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, variant=variant))
    r = Renderer(cfg, device="cpu")
    assert r.variant_chosen == variant
    color, _ = r.render(block=True)
    assert r.variant_ms == {}
    want, _ = render_megakernel(r.data, r.camera.uniforms().flat(),
                                width=32, height=32, shadows=True,
                                fused=variant == "fused")
    assert torch.equal(color, want)


def test_renderer_resize_retimes_auto():
    """resize under variant="auto" puts the timing back, as JAX's
    _build_frame_fn does: the next render times both programs anew (the
    host clock on the CPU) and draws at the new size."""
    cfg = terrain_config(pcfg, width=32, height=32)
    r = Renderer(cfg, device="cpu")
    timed = []
    time_frames = r._time_frames

    def counted(fn, *a, **kw):
        timed.append(fn)
        return time_frames(fn, *a, **kw)
    r._time_frames = counted
    r.render(block=True)
    assert len(timed) == 2 and set(r.variant_ms) == {"split", "fused"}
    first = dict(r.variant_ms)
    r.resize(48, 24)
    assert r.variant_chosen is None and r.variant_ms == {}
    color, _ = r.render(block=True)
    assert len(timed) == 4 and set(r.variant_ms) == {"split", "fused"}
    assert all(ms > 0 for ms in r.variant_ms.values())
    assert r.variant_ms is not first
    assert r.variant_chosen == min(r.variant_ms, key=r.variant_ms.get)
    want, _ = render_megakernel(
        r.data, r.camera.uniforms().flat(), width=48, height=24,
        shadows=True, fused=r.variant_chosen == "fused")
    assert color.shape == (24, 48, 3) and torch.equal(color, want)
    r.render(block=True)
    assert len(timed) == 4  # timed once per size


@pytest.mark.parametrize("variant", ["split", "fused", "auto_no_mesh"])
def test_renderer_resize_keeps_a_fixed_choice(variant):
    """A fixed variant, and auto on a scene the fused frame cannot draw,
    keep their choice through resize and time nothing."""
    if variant == "auto_no_mesh":
        cfg = pcfg.SceneConfig(spheres=pcfg.reference_scene().spheres,
                               render=pcfg.RenderConfig(width=32, height=32))
        want = "split"
    else:
        cfg = terrain_config(pcfg, width=32, height=32)
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, variant=variant))
        want = variant
    r = Renderer(cfg, device="cpu")
    r.render(block=True)
    r.resize(40, 24)
    assert r.variant_chosen == want and r.variant_ms == {}
    color, _ = r.render(block=True)
    assert color.shape == (24, 40, 3) and r.variant_ms == {}


def test_renderer_nm_with_shadows_renders_split(assets, monkeypatch):
    monkeypatch.setenv("RWRT_ASSETS", assets)
    cfg = textured_config(pcfg, width=32, height=32, bump=True)
    r = Renderer(cfg, device="cpu")
    assert r.variant_chosen == "split"  # auto falls back: not eligible
    r.render(block=True)
    assert r.variant_ms == {}
    fused = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, variant="fused"))
    with pytest.raises(ValueError):
        Renderer(fused, device="cpu")


def test_renderer_fused_needs_a_mesh():
    cfg = pcfg.SceneConfig(spheres=pcfg.reference_scene().spheres,
                           render=pcfg.RenderConfig(width=32, height=32,
                                                    variant="fused"))
    with pytest.raises(ValueError):
        Renderer(cfg, device="cpu")
    auto = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, variant="auto"))
    assert Renderer(auto, device="cpu").variant_chosen == "split"


def test_unknown_shadow_mode_raises():
    data, uni, wh = scene_and_uni(VIEWS["golden"]())
    with pytest.raises(ValueError):
        render_frame_fused(data, uni, shadows=True, shadow_mode="bogus",
                           **wh)
