"""PyTorch port: the progressive path tracer against the JAX package's
render_pathtrace (its Pallas kernels in interpret mode) and its
Renderer's path-tracing mode.

Tolerance. Everything in the path tracer but the cosine sampler's cos
and sin is bitwise the JAX package's. torch's cos/sin and XLA's differ
by 1 ulp on ~5% of inputs (1M seeded phases; within the sampler 3.5% of
the direction components differ), so a frame with bounces can differ
in the last bits where a bounce lands on a textured or curved surface.
Measured: on the textured heightfield below (bounces=2, spp=2, 64x32)
5 of 6,144 subpixels differ, by at most 4.47e-8; on the terrain none
(flat, untextured faces: the face a bounce hits, not the point, sets
its colour). The bar: every subpixel within 1e-6 and at most 1% of
them not bitwise equal.
Frames without bounces (no trig) are held bitwise, and so are the
compacted and full bounce loops of the port against each other.
"""

import dataclasses as dc
import os
from unittest import mock

import numpy as np
import pytest
import torch

from rust_wgpu_raytracing_tpu_torch import config as pcfg
from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
from rust_wgpu_raytracing_tpu_torch.core.scene import Scene
from rust_wgpu_raytracing_tpu_torch.ops import kernels as K
from rust_wgpu_raytracing_tpu_torch.ops import pathtrace as P
from rust_wgpu_raytracing_tpu_torch.runtime.profiler import (count_ops,
                                                           counters)
from rust_wgpu_raytracing_tpu_torch.runtime.renderer import Renderer
from test_torch_host import (heightfield_config, jax_config, jax_reference,
                             terrain_config, textured_config,
                             write_heightfield_assets, write_textured_assets)

BG = (0.1, 0.2, 0.3)
SEED = 3
ATOL = 1e-6
MAX_DIFFERING = 0.01
# name: (scene, width, height, bounces, spp)
CASES = {"terrain_b0": ("terrain", 32, 32, 0, 2),
         "box_b0": ("box", 32, 32, 0, 1),
         "field_b2": ("field", 64, 32, 2, 2)}
PT_RENDER = dict(pt_bounces=1, pt_spp=3, seed=5)


def scene_config(kind, width, height):
    if kind == "terrain":
        return terrain_config(pcfg, width=width, height=height,
                              shadows=False)
    if kind == "box":
        return textured_config(pcfg, width=width, height=height,
                               shadows=False)
    return heightfield_config(pcfg, width=width, height=height)


def renderer_config():
    cfg = scene_config("terrain", 32, 32)
    return dc.replace(cfg, render=dc.replace(cfg.render, **PT_RENDER))


def jax_pathtrace(out, assets):
    import jax

    from rust_wgpu_raytracing_tpu.core.camera import Camera as JCamera
    from rust_wgpu_raytracing_tpu.core.scene import Scene as JScene
    from rust_wgpu_raytracing_tpu.ops.pathtrace import render_pathtrace
    from rust_wgpu_raytracing_tpu.runtime.renderer import \
        Renderer as JRenderer

    os.environ["RWRT_ASSETS"] = assets
    res = {}
    for name, (kind, w, h, bounces, spp) in CASES.items():
        cfg = jax_config(scene_config(kind, w, h))
        data = JScene.build(cfg).data
        uni = JCamera.from_config(cfg.camera, w / h).uniforms().flat()
        res[name] = render_pathtrace(
            data, uni, jax.random.PRNGKey(SEED), width=w, height=h,
            bounces=bounces, spp=spp, background=BG, interpret=True)
    r = JRenderer(jax_config(renderer_config()), backend="oracle")
    for i in range(2):
        res[f"renderer_{i}"] = r.render()[0]
    r.controller.process_key("d", True)
    r.update()
    res["renderer_reset"] = r.render()[0]
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("pt_assets")
    write_textured_assets(str(root))
    write_heightfield_assets(str(root))
    return str(root)


@pytest.fixture(scope="module")
def ref(tmp_path_factory, assets):
    return jax_reference("test_torch_pathtrace", "jax_pathtrace",
                         tmp_path_factory.mktemp("pt"), assets=assets)


def port_frame(name, assets, **kw):
    kind, w, h, bounces, spp = CASES[name]
    cfg = scene_config(kind, w, h)
    with mock.patch.dict(os.environ, {"RWRT_ASSETS": assets}):
        data = Scene.build(cfg).data
    uni = Camera.from_config(cfg.camera, w / h).uniforms().flat()
    kw = dict(dict(bounces=bounces, spp=spp, background=BG), **kw)
    return P.render_pathtrace(data, uni, P.PRNGKey(SEED), width=w,
                              height=h, **kw)


def assert_within_trig_gap(got, want):
    got = np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert (got != want).mean() <= MAX_DIFFERING


@pytest.mark.parametrize("name", ["terrain_b0", "box_b0"])
def test_pathtrace_without_bounces_is_bitwise(ref, assets, name):
    got = port_frame(name, assets).numpy()
    want = ref[name]
    assert want.min() >= 0 and want.max() > 0.05
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_pathtrace_with_bounces_within_trig_gap(ref, assets):
    got = port_frame("field_b2", assets)
    want = ref["field_b2"]
    # the bounces add light over the direct term alone
    direct = port_frame("field_b2", assets, bounces=0)
    assert float(got.sum()) > float(direct.sum())
    assert_within_trig_gap(got, want)


@pytest.mark.parametrize("size,cap,compacts", [
    ((32, 32), 32 * 32, True),   # one tile, capacity one tile
    ((32, 32), 8, True),         # capacity rounds up to one tile
    ((64, 64), 4 * 1024, True),  # room for every tile
    ((64, 64), 8, False),        # more live tiles than room: full loop
])
def test_compact_equals_full(assets, size, cap, compacts):
    kind = "terrain"
    w, h = size
    cfg = scene_config(kind, w, h)
    data = Scene.build(cfg).data
    uni = Camera.from_config(cfg.camera, w / h).uniforms().flat()
    kw = dict(width=w, height=h, bounces=2, spp=2, background=BG)
    full = P.render_pathtrace(data, uni, P.PRNGKey(SEED), **kw)
    compacted = counters().get("pt.compacted", 0)
    got = P.render_pathtrace(data, uni, P.PRNGKey(SEED), compact_cap=cap,
                             **kw)
    assert (counters().get("pt.compacted", 0) - compacted) == (
        2 if compacts else 0)
    assert torch.equal(got, full)


def test_compact_drops_dead_tiles():
    """A cube off-centre in a 64x64 frame: some ray tiles see nothing,
    the compacted loop runs on the live ones only, and the frame is the
    full loop's."""
    cfg = pcfg.SceneConfig(
        meshes=(pcfg.MeshConfig(obj_path="builtin:cube",
                                translation=(0.8, 0.8, -3.0), scale=0.8),),
        render=pcfg.RenderConfig(width=64, height=64))
    data = Scene.build(cfg).data
    uni = Camera.from_config(cfg.camera, 1.0).uniforms().flat()
    kw = dict(width=64, height=64, bounces=3, spp=1, background=BG)
    full = P.render_pathtrace(data, uni, P.PRNGKey(SEED), **kw)
    compacted = counters().get("pt.compacted", 0)
    got = P.render_pathtrace(data, uni, P.PRNGKey(SEED),
                             compact_cap=2 * 1024, **kw)
    assert counters().get("pt.compacted", 0) == compacted + 1
    assert torch.equal(got, full)


def test_pathtrace_runs_the_kernels_of_its_path():
    """Primary closest hit (K1), the fused sweep (K8), the last shadow
    any-hit (K3) and the albedo filter (K6), and the culled sweeps' front
    end (K13) once a ray set: the primary rays, K8's two sets at each
    bounce and the last shadow rays; no frame kernel, texshade or per-ray
    closest hit. Each threefry draw is 169 torch operations,
    two per sample and two per bounce (ROADMAP.md item 8)."""
    cfg = scene_config("terrain", 32, 32)
    data = Scene.build(cfg).data
    uni = Camera.from_config(cfg.camera, 1.0).uniforms().flat()
    counts = count_ops(lambda ks: P.render_pathtrace(
        data, uni, P.PRNGKey(SEED), width=32, height=32, bounces=3, spp=1,
        kernels=ks), K.PLAIN)
    assert {k: v for k, v in counts.items() if k.startswith("kernel")} == {
        "kernel closest_hit_plain": 1, "kernel extend_shadow_plain": 3,
        "kernel anyhit_plain": 1, "kernel texfilter_plain": 4,
        "kernel sweep_front_plain": 1 + 2 * 3 + 1}
    assert counts["aten.bitwise_xor"] == 21 * (2 + 2 * 3)
    draw = count_ops(lambda ks: P.uniform(P.PRNGKey(1), 64, device="cpu"),
                     K.PLAIN)
    assert sum(draw.values()) == 169


def test_renderer_progressive_matches_jax(ref):
    r = Renderer(renderer_config(), device="cpu")
    assert r.pathtrace and r.spp_done == 0
    for i in range(2):
        color, depth = r.render()
        assert r.spp_done == i + 1
        assert torch.equal(depth, torch.ones(32, 32))
        assert_within_trig_gap(color, ref[f"renderer_{i}"])
    # orbiting resets the accumulation
    r.controller.process_key("d", True)
    r.update()
    assert r.spp_done == 0
    color, _ = r.render()
    assert r.spp_done == 1
    assert_within_trig_gap(color, ref["renderer_reset"])


def test_renderer_stops_at_pt_spp_and_resets():
    r = Renderer(renderer_config(), device="cpu")
    frames = [r.render()[0] for _ in range(5)]
    assert r.spp_done == 3 and r.pt_converged
    # the finished mean is re-presented, no more samples
    assert torch.equal(frames[3], frames[2])
    assert torch.equal(frames[4], frames[2])
    assert not torch.equal(frames[1], frames[2])
    r.update()  # no key held: the camera stays, so does the mean
    assert r.spp_done == 3
    r.resize(32, 32)
    assert r.spp_done == 0


def test_renderer_unbounded_accumulation():
    """pt_spp <= 0 accumulates without end; pt_converged reads
    spp_done >= pt_spp, as the JAX Renderer's does."""
    cfg = renderer_config()
    cfg = dc.replace(cfg, render=dc.replace(cfg.render, pt_spp=0))
    r = Renderer(cfg, device="cpu")
    for i in range(4):
        color, _ = r.render()
        assert r.spp_done == i + 1 and r.pt_converged
        assert bool(torch.isfinite(color).all())


# the streamed path tracer: terrain:92 (past STREAM_FACES) under the
# close camera of the JAX package's streamed PT benchmark (config 8)
STREAM_CASES = {"stream_b0": 0, "stream_b2": 2}
STREAM_W = 64


def stream_config():
    cfg = terrain_config(pcfg, grid=92, width=STREAM_W, height=STREAM_W,
                         shadows=False)
    return dc.replace(cfg, camera=pcfg.CameraConfig(
        eye=(0.0, -0.4, -1.2), target=(0.0, 0.0, -3.0)))


def jax_stream_pathtrace(out, name):
    import jax

    from rust_wgpu_raytracing_tpu.core.camera import Camera as JCamera
    from rust_wgpu_raytracing_tpu.core.scene import Scene as JScene
    from rust_wgpu_raytracing_tpu.ops.pathtrace import render_pathtrace

    cfg = jax_config(stream_config())
    data = JScene.build(cfg).data
    uni = JCamera.from_config(cfg.camera, 1.0).uniforms().flat()
    np.savez(out, sample=np.asarray(render_pathtrace(
        data, uni, jax.random.PRNGKey(SEED), width=STREAM_W,
        height=STREAM_W, bounces=STREAM_CASES[name], spp=1, background=BG,
        interpret=True, compact_cap="auto")))


@pytest.mark.parametrize("name", sorted(STREAM_CASES))
def test_streamed_pathtrace_matches_jax(tmp_path, name):
    """The path tracer past STREAM_FACES (K9 primary, the reordered K10 +
    K11 bounces, K11 last-bounce shadows): bitwise without bounces,
    within the trig gap with them. compact_cap="auto" does not compact
    a streamed mesh, in either package."""
    cfg = stream_config()
    data = Scene.build(cfg).data
    uni = Camera.from_config(cfg.camera, 1.0).uniforms().flat()
    compacted = counters().get("pt.compacted", 0)
    calls = {}

    def counted(fn):
        def call(*a, **kw):
            calls[fn.__name__] = calls.get(fn.__name__, 0) + 1
            return fn(*a, **kw)
        return call
    ks = K.KernelSet(*(counted(p) for p in K.PLAIN))
    got = P.render_pathtrace(
        data, uni, P.PRNGKey(SEED), width=STREAM_W, height=STREAM_W,
        bounces=STREAM_CASES[name], spp=1, background=BG,
        compact_cap="auto", kernels=ks)
    assert counters().get("pt.compacted", 0) == compacted
    want = jax_reference("test_torch_pathtrace", "jax_stream_pathtrace",
                         tmp_path, name=name)["sample"]
    assert want.max() > 0.05
    bounces = STREAM_CASES[name]
    assert calls["stream_closest_hit_plain"] == 1
    assert calls.get("stream_closest_hit_perray_plain", 0) == bounces
    assert calls["stream_anyhit_plain"] == bounces + 1
    assert not {"closest_hit_plain", "extend_shadow_plain", "anyhit_plain",
                "closest_hit_perray_plain"} & set(calls)
    if bounces == 0:
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))
    else:
        assert_within_trig_gap(got, want)


def test_renderer_path_traces_streamed_scenes():
    """Renderer(pt_bounces > 0) on a mesh above STREAM_FACES accumulates
    like any other (no refusal)."""
    cfg = stream_config()
    cfg = dc.replace(cfg, render=dc.replace(cfg.render, pt_bounces=1,
                                            pt_spp=2, width=32, height=32))
    r = Renderer(cfg, device="cpu")
    assert r.data.padded_faces > 16384
    for _ in range(3):
        color, _ = r.render()
    assert r.spp_done == 2 and r.pt_converged
    assert bool(torch.isfinite(color).all()) and float(color.sum()) > 0
