"""PyTorch port: geometry-parallel rendering (parallel/geometry_sharding.py)
on gloo CPU ranks, against the JAX package and the port's single-device
frames.

The cases of the JAX package's TestGeometrySharded
(tests/test_sharding.py): the lit and the shadowed frame of a terrain
sharded four ways, shards streamed past a lowered STREAM_FACES, dp x gp,
the gp path tracer (gp and sp x gp) and replicated spheres; plus the
Renderer's "megakernel_gp" backend inside the process group and
shard_scene_faces' layouts. The ranks run in one launch a group of cases
(parallel.launch.spawn: 4 ranks, then 2 for the streamed shards); the
JAX side runs once, in a fresh interpreter with 8 virtual CPU devices
and XLA capped below FMA (test_torch_host.jax_reference).

Bars. Every gp frame equals the port's single-device frame bit for bit
(colour and depth; the path tracer's radiance). Against JAX's sharded
functions: the frames without row slabs bit for bit; dp x gp at the
quantized frame bit for bit, its unquantized colour within 1 ulp (the
split frame's pow, as in test_torch_slabs); the path tracer with
bounces within 1e-6, at most 1% of subpixels not bitwise
(test_torch_pathtrace's bar: torch's cos/sin).
"""

import concurrent.futures
import contextlib
import os
from unittest import mock

import numpy as np
import pytest
import torch

from rust_wgpu_raytracing_tpu_torch import config as pcfg
from rust_wgpu_raytracing_tpu_torch.core import scene as pscene
from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
from rust_wgpu_raytracing_tpu_torch.core.scene import Scene
from rust_wgpu_raytracing_tpu_torch.ops import megakernel as pmk
from rust_wgpu_raytracing_tpu_torch.ops import pathtrace as ppt
from rust_wgpu_raytracing_tpu_torch.parallel import geometry_sharding as G
from rust_wgpu_raytracing_tpu_torch.parallel.launch import spawn
from rust_wgpu_raytracing_tpu_torch.testing.raycull import write_grid_mesh
from test_torch_host import jax_reference, sphere_cube_config, stream_faces

# builtin:terrain:47 (4,232 faces in 32-face clusters) past a lowered
# STREAM_FACES pads to 5,120 faces, two shards of 3,072: streamed
STREAM_LOW = 1024
PT_KEYS = {"pt_gp": 3, "pt_sp_gp": 5}
LAYOUT_FIELDS = G.FACE_FIELDS + ("blk_lo", "blk_hi", "spack", "gpack")


def terrain(cfg_mod, w, h, light=True, grid=64):
    return cfg_mod.SceneConfig(
        meshes=(cfg_mod.MeshConfig(
            obj_path=f"builtin:terrain:{grid}", translation=(0.0, 0.0, -3.0),
            **(dict(light_direction=(6.0, -1.0, 1.0)) if light else {})),),
        camera=cfg_mod.CameraConfig(eye=(0.0, -2.0, -1.0),
                                    target=(0.0, 0.0, -3.2)),
        render=cfg_mod.RenderConfig(width=w, height=h))


def with_sphere(cfg_mod, cfg):
    import dataclasses as dc

    return dc.replace(cfg, spheres=(cfg_mod.SphereConfig(
        center=(0.5, 0.2, -3.0), radius=0.6),))


# name: (scene builder (config module -> SceneConfig), program, mesh
# (dp, sp, gp), options); program "frame" (render_sharded_gp) or "pt"
# (render_pathtrace_gp)
CASES = {
    "lit": (lambda m: terrain(m, 64, 32, light=False), "frame", (1, 1, 4),
            dict(shadows=False)),
    "shadowed": (lambda m: terrain(m, 64, 32), "frame", (1, 1, 4),
                 dict(shadows=True)),
    "dp_gp_shadowed": (lambda m: terrain(m, 64, 32), "frame", (2, 1, 2),
                       dict(shadows=True, quantize=False)),
    "spheres": (sphere_cube_config, "frame", (1, 1, 4),
                dict(shadows=False)),
    "pt_gp": (lambda m: with_sphere(m, terrain(m, 64, 32)), "pt",
              (1, 1, 4), dict(bounces=2)),
    "pt_sp_gp": (lambda m: terrain(m, 64, 32), "pt", (1, 2, 2),
                 dict(bounces=1)),
    "streamed": (lambda m: terrain(m, 32, 32, grid=47), "frame",
                 (1, 1, 2), dict(shadows=True)),
}
GROUPS = {4: [k for k, c in CASES.items() if np.prod(c[2]) == 4],
          2: [k for k, c in CASES.items() if np.prod(c[2]) == 2]
          + ["plane"]}


def low_stream(name, *modules):
    return (stream_faces(STREAM_LOW, *modules) if name == "streamed"
            else contextlib.nullcontext())


def jax_geometry_sharding(out):
    import jax
    import jax.numpy as jnp

    from rust_wgpu_raytracing_tpu import config as jcfg
    from rust_wgpu_raytracing_tpu.core import scene as jscene
    from rust_wgpu_raytracing_tpu.core.camera import Camera as JCamera
    from rust_wgpu_raytracing_tpu.core.scene import Scene as JScene
    from rust_wgpu_raytracing_tpu.ops import megakernel as jmk
    from rust_wgpu_raytracing_tpu.parallel import geometry_sharding as JG

    res = {}
    for name, (build, program, (dp, sp, gp), opts) in CASES.items():
        with low_stream(name, jscene, jmk):
            cfg = build(jcfg)
            rc = cfg.render
            data = JScene.build(cfg).data
            uni = JCamera.from_config(cfg.camera, rc.width / rc.height) \
                .uniforms().flat()
            mesh = JG.make_gp_mesh(dp * sp * gp, dp=dp, sp=sp)
            if program == "pt":
                res[f"{name}.color"] = np.asarray(JG.render_pathtrace_gp(
                    data, uni, jax.random.PRNGKey(PT_KEYS[name]), mesh,
                    width=rc.width, height=rc.height, spp=1, **opts))
                continue
            c, d = JG.render_sharded_gp(data, uni, mesh, width=rc.width,
                                        height=rc.height, **opts)
            res[f"{name}.color"], res[f"{name}.depth"] = c, d
            if name in ("lit", "streamed"):
                stacked, rest = JG.shard_scene_faces(data, gp)
                for k in LAYOUT_FIELDS:
                    res[f"{name}.layout.{k}"] = np.asarray(stacked[k])
                res[f"{name}.layout.per"] = np.asarray(rest.num_faces)
            if name == "dp_gp_shadowed":
                from rust_wgpu_raytracing_tpu.ops.shade import \
                    quantize_rgba8

                res[f"{name}.color_u8"] = quantize_rgba8(jnp.asarray(c))
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})


def port_scene(build):
    cfg = build(pcfg)
    rc = cfg.render
    return (cfg, Scene.build(cfg).data,
            Camera.from_config(cfg.camera, rc.width / rc.height)
            .uniforms().flat())


def rank_cases(names):
    """On every rank: each case's gp result and, on the same rank, the
    single-device frame it must equal; the Renderer's gp backend."""
    from rust_wgpu_raytracing_tpu_torch import Renderer

    res = {}
    for name in [k for k in names if k in CASES]:
        build, program, (dp, sp, gp), opts = CASES[name]
        with low_stream(name, pscene, pmk):
            cfg, data, uni = port_scene(build)
            rc = cfg.render
            wh = dict(width=rc.width, height=rc.height)
            mesh = G.make_gp_mesh(dp=dp, sp=sp, device="cpu")
            if name == "streamed":
                st, rest = G.shard_scene_faces(data, gp)
                res[f"{name}.streams"] = pmk._should_stream(
                    rest.num_faces, pmk.BLOCK_F)
            if program == "pt":
                key = ppt.PRNGKey(PT_KEYS[name])
                res[f"{name}.color"] = G.render_pathtrace_gp(
                    data, uni, key, mesh, spp=1, **wh, **opts)
                keys = ([ppt.fold_in(key, i) for i in range(sp)]
                        if sp > 1 else [key])
                single = sum(ppt.render_pathtrace(data, uni, k, spp=1, **wh,
                                                  **opts) for k in keys)
                res[f"{name}.single"] = single * (1.0 / len(keys))
                continue
            c, d = G.render_sharded_gp(data, uni, mesh, **wh, **opts)
            sc, sd = pmk.render_megakernel(data, uni, **wh, **opts)
            res.update({f"{name}.color": c, f"{name}.depth": d,
                         f"{name}.single_color": sc,
                         f"{name}.single_depth": sd})
            if name in ("lit", "streamed"):
                stacked, rest = G.shard_scene_faces(data, gp)
                for k in LAYOUT_FIELDS:
                    res[f"{name}.layout.{k}"] = stacked[k]
                res[f"{name}.layout.per"] = rest.num_faces
    if "plane" in names:
        res.update(plane_camera_case())
    if "shadowed" in names:
        import dataclasses as dc

        cfg = CASES["shadowed"][0](pcfg)
        cfg = dc.replace(cfg, render=dc.replace(cfg.render, shadows=True))
        r = Renderer(cfg, backend="megakernel_gp", device="cpu")
        res["renderer.gp"] = r.render()
        res["renderer.ranks"] = r._gp_mesh.size("gp")
        res["renderer.single"] = Renderer(cfg, device="cpu").render()
    return res


def plane_camera_case():
    """The hazard of a zero t through the merges: the camera on the grid
    mesh's face plane (raycull.plane_camera_config; the rays hit the
    faces holding the eye at t = +0.0 on one side, -0.0 on the other),
    its shadowed frame over 2 shards and the merged primary G-buffer,
    beside the single-device ones."""
    from rust_wgpu_raytracing_tpu_torch.core.camera import CameraUniforms
    from rust_wgpu_raytracing_tpu_torch.testing.raycull import \
        plane_camera_config

    cfg = plane_camera_config("bf32.obj", 48, 600)
    cfg, data, uni = port_scene(lambda _m: cfg)
    rc = cfg.render
    wh = dict(width=rc.width, height=rc.height)
    mesh = G.make_gp_mesh(device="cpu")
    res = {}
    res["plane.gp"] = G.render_sharded_gp(data, uni, mesh, shadows=True,
                                          **wh)
    res["plane.single"] = pmk.render_megakernel(data, uni, shadows=True,
                                                fused=False, **wh)
    origin = torch.as_tensor(CameraUniforms.unflat(uni).origin)
    dirs = pmk.raygen_planar(rc.width, rc.height, CameraUniforms.unflat(uni),
                             device="cpu")
    stacked, rest = G.shard_scene_faces(data, 2)
    local = G.local_shard(stacked, rest, mesh.index("gp"))
    merged = G._merge_gbuffer(mesh, pmk.gbuffer(
        local, origin, *dirs, with_spheres=False)[0], rest.num_faces)
    single = pmk.gbuffer(data, origin, *dirs, with_spheres=False)[0]
    for k in ("t", "face", "u", "v", "nd", "nx", "mat"):
        res[f"plane.gb.{k}"] = getattr(merged, k)
        res[f"plane.gb_single.{k}"] = getattr(single, k)
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's results, the ranks' results): the JAX interpreter runs in a
    thread while the ranks run."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(jax_reference, "test_torch_geometry_sharding",
                              "jax_geometry_sharding",
                              tmp_path_factory.mktemp("gp"), host_devices=8)
        assets = tmp_path_factory.mktemp("grid")
        write_grid_mesh(str(assets / "bf32.obj"), 48)
        out = {}
        with mock.patch.dict(os.environ, {"RWRT_ASSETS": str(assets)}):
            for n, names in GROUPS.items():
                out.update(spawn(rank_cases, n, names))
        return jax_run.result(), out


@pytest.fixture(scope="module")
def ref(runs):
    return runs[0]


@pytest.fixture(scope="module")
def port(runs):
    return runs[1]


def bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("name", [k for k, c in CASES.items()
                                  if c[1] == "frame"])
def test_gp_frame_matches_single_device_and_jax(ref, port, name):
    opts = CASES[name][3]
    c, d = port[f"{name}.color"], port[f"{name}.depth"]
    assert (d < 1.0).any()
    np.testing.assert_array_equal(bits(c), bits(port[f"{name}.single_color"]))
    np.testing.assert_array_equal(bits(d), bits(port[f"{name}.single_depth"]))
    np.testing.assert_array_equal(bits(d), bits(ref[f"{name}.depth"]))
    if opts.get("quantize", True):
        np.testing.assert_array_equal(bits(c), bits(ref[f"{name}.color"]))
    else:
        gap = np.abs(bits(c).astype(np.int64) - bits(ref[f"{name}.color"]))
        assert gap.max() <= 1, f"{gap.max()} ulp from JAX"
        if f"{name}.color_u8" in ref:
            from rust_wgpu_raytracing_tpu_torch.ops.shade import \
                quantize_rgba8

            np.testing.assert_array_equal(
                bits(quantize_rgba8(torch.from_numpy(c))),
                bits(ref[f"{name}.color_u8"]))
    if name == "streamed":
        assert port["streamed.streams"]


@pytest.mark.parametrize("name", sorted(PT_KEYS))
def test_gp_pathtrace_matches_single_device_and_jax(ref, port, name):
    c = port[f"{name}.color"]
    assert c.sum() > 0 and np.isfinite(c).all()
    np.testing.assert_array_equal(bits(c), bits(port[f"{name}.single"]))
    np.testing.assert_allclose(c, ref[f"{name}.color"], rtol=0, atol=1e-6)
    assert (c != ref[f"{name}.color"]).mean() <= 0.01


@pytest.mark.parametrize("name", ["lit", "streamed"])
def test_shard_scene_faces_layouts_match_jax(ref, port, name):
    assert int(port[f"{name}.layout.per"]) == int(ref[f"{name}.layout.per"])
    for k in LAYOUT_FIELDS:
        got, want = port[f"{name}.layout.{k}"], ref[f"{name}.layout.{k}"]
        if want.dtype == np.uint16:
            want = want.view(np.int16)
        assert got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def test_renderer_gp_backend_in_the_group(port):
    """Renderer(backend="megakernel_gp") built on every rank of a 4-rank
    group shards over all 4 and draws the single-device frame."""
    assert port["renderer.ranks"] == 4
    for got, want in zip(port["renderer.gp"], port["renderer.single"]):
        np.testing.assert_array_equal(bits(got), bits(want))


def test_plane_camera_merge_keeps_the_zero_sign(port):
    """On raycull.plane_camera_config's camera: the 2-shard merged
    G-buffer equals the single-device one bit for bit, a zero t's sign
    included (the merge fills the losers with -0.0, not +0.0), and the
    shadowed gp frame the single-device frame."""
    t = port["plane.gb.t"]
    zero = t == 0.0
    negative = zero & np.signbit(t)
    assert negative.sum() > 100 and (zero & ~negative).sum() > 100
    for k in ("t", "face", "u", "v", "nd", "nx", "mat"):
        np.testing.assert_array_equal(bits(port[f"plane.gb.{k}"]),
                                      bits(port[f"plane.gb_single.{k}"]),
                                      err_msg=k)
    for got, want in zip(port["plane.gp"], port["plane.single"]):
        np.testing.assert_array_equal(bits(got), bits(want))


def test_local_shard_keeps_the_face_order():
    """The shards hold the soup's faces in order, padded at the tail:
    concatenated, their faces are the scene's."""
    cfg, data, _ = port_scene(CASES["lit"][0])
    stacked, rest = G.shard_scene_faces(data, 3)
    f = data.padded_faces
    assert rest.num_faces % pscene.SUPER_F == 0
    shards = [G.local_shard(stacked, rest, i) for i in range(3)]
    cat = torch.cat([s.tri_n for s in shards])
    assert torch.equal(cat[:f], data.tri_n) and not cat[f:].any()
    assert torch.isinf(torch.cat([s.blk_lo for s in shards])[
        data.blk_lo.shape[0]:]).all()
