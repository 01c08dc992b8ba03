"""PyTorch port: the oracle (ops/raygen, intersect, shade, composite,
oracle, models/triangle) against the JAX package's.

The unit functions are held on seeded numpy inputs against the JAX
functions run in a subprocess with XLA's code generation capped below
FMA (test_torch_host.jax_reference): ray directions bitwise, t and face
exactly where a ray hits, u/v within 1e-6, the occlusion bits equal.
The port's scene is the JAX scene carried across by the bridge
(core/scene.py scene_data_from_numpy). The frames are held at the frame
bar (at most 1 linear u8 level, at least 99.9% of subpixels exact)
against JAX's render_oracle and the committed terrain golden.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_wgpu_raytracing_tpu import config as jcfg
from rust_wgpu_raytracing_tpu.core.camera import Camera as JCamera
from rust_wgpu_raytracing_tpu.core.scene import Scene as JScene
from rust_wgpu_raytracing_tpu.ops.oracle import \
    render_oracle as jax_render_oracle
from rust_wgpu_raytracing_tpu_torch import Renderer
from rust_wgpu_raytracing_tpu_torch.__main__ import main
from rust_wgpu_raytracing_tpu_torch.core.camera import Camera, CameraUniforms
from rust_wgpu_raytracing_tpu_torch.core.scene import (STATIC_FIELDS, Scene,
                                                       scene_data_from_numpy)
from rust_wgpu_raytracing_tpu_torch.io.image_out import (framebuffer_to_image,
                                                        read_png)
from rust_wgpu_raytracing_tpu_torch.models.triangle import Triangle
from rust_wgpu_raytracing_tpu_torch.ops import intersect, oracle, raygen, shade
from rust_wgpu_raytracing_tpu_torch.ops.oracle import render_oracle
from test_torch_host import (assert_frame_bar, jax_reference, port_config,
                             terrain_config, textured_config, u8_levels,
                             write_textured_assets)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "terrain_shadows.png")
N_RAYS = 512
TRI = ((-0.7, -0.5, -2.5), (0.8, -0.4, -3.0), (0.1, 0.9, -2.2))


# ---------------------------------------------------------------------------
# the JAX side (runs in the jax_reference subprocess)
# ---------------------------------------------------------------------------

def unit_inputs(seed=20261017):
    """Seeded rays: per-ray origins in the terrain's box and unit
    directions, a shared origin above the terrain, lit bits, and a
    triangle's planar rays."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-1.2, -1.2, -3.4], [1.2, 1.2, -2.6],
                    (N_RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    eye = np.array([0.1, -2.0, -1.0], np.float32)
    aim = rng.uniform([-0.9, -0.9, -3.3], [0.9, 0.9, -2.9], (N_RAYS, 3))
    pd = aim - eye
    pd = (pd / np.linalg.norm(pd, axis=1, keepdims=True)).astype(np.float32)
    lit = rng.uniform(size=N_RAYS) < 0.7
    # toward the box of textured_config, from its camera
    beye = np.array([0.4, 0.6, 0.5], np.float32)
    bd = rng.uniform([-0.9, -0.9, -4.4], [0.9, 0.9, -2.6], (N_RAYS, 3)) - beye
    bd = (bd / np.linalg.norm(bd, axis=1, keepdims=True)).astype(np.float32)
    return dict(o=o, d=d, eye=eye, pd=pd, lit=lit, beye=beye, bd=bd)


def scene_fields(data, prefix):
    out = {f"{prefix}.{f.name}": np.asarray(getattr(data, f.name))
           for f in dataclasses.fields(data)
           if not f.metadata.get("static")}
    out.update({f"{prefix}.{k}": np.asarray(getattr(data, k))
                for k in STATIC_FIELDS})
    return out


def jax_unit_reference(out, asset_dir):
    """JAX results of the oracle's unit functions on unit_inputs(), each
    under jax.jit with its arrays as arguments, as render_oracle runs
    them (eager JAX divides by a constant where jit multiplies by its
    reciprocal)."""
    from types import SimpleNamespace

    import jax

    from rust_wgpu_raytracing_tpu.models.triangle import Triangle as JTri
    from rust_wgpu_raytracing_tpu.ops import intersect as ji
    from rust_wgpu_raytracing_tpu.ops import raygen as jr
    from rust_wgpu_raytracing_tpu.ops import shade as js

    def run(fn, *args):
        return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(*args))

    os.environ["RWRT_ASSETS"] = asset_dir
    x = {k: jnp.asarray(v) for k, v in unit_inputs().items()}
    res = {}
    tcfg = terrain_config(jcfg, width=40, height=24)
    terrain = JScene.build(tcfg).data
    res.update(scene_fields(terrain, "terrain"))
    uni = JCamera.from_config(tcfg.camera, 40 / 24).uniforms()
    res["uni"] = np.asarray(uni.flat())
    res["dirs"] = run(lambda p, v: jr.ray_directions(40, 24, SimpleNamespace(
        proj_inv_wgpu=p, view_inv=v)), jnp.asarray(uni.proj_inv_wgpu),
        jnp.asarray(uni.view_inv))
    res["ndc_x"], res["ndc_y"] = run(lambda: jr.ndc_grid(40, 24))
    res["ortho_o"], res["ortho_d"] = run(
        lambda o: jr.ray_directions_ortho(40, 24, o, 3.0),
        jnp.asarray([0.5, -0.25, 1.0], jnp.float32))

    th = run(ji.intersect_tris, terrain, x["eye"], x["pd"])
    for k in ("t", "face", "u", "v", "n_dot_d"):
        res[f"tri.{k}"] = getattr(th, k)
    res["occ_tris"] = run(ji.occluded_tris, terrain, x["o"], x["d"])
    res["occ_sph"] = run(ji.occluded_spheres, terrain, x["o"], x["d"])
    sh = run(lambda s, o, d: ji.intersect_sphere(
        s.sphere_center[1], s.sphere_radius[1], o, d), terrain, x["o"],
        x["d"])
    res["sph.t"], res["sph.normal"] = sh.t, sh.normal
    res["shade_sphere"] = run(lambda s, n, d, lit: js.shade_sphere(
        s, 0, n, d, lit=lit), terrain, x["d"], x["pd"], x["lit"])

    bump = JScene.build(textured_config(jcfg, bump=True)).data
    res.update(scene_fields(bump, "bump"))
    bh = run(ji.intersect_tris, bump, x["beye"], x["bd"])
    for k in ("t", "face", "u", "v", "n_dot_d"):
        res[f"bump.hit.{k}"] = getattr(bh, k)
    for nm in (False, True):
        res[f"shade_mesh.{nm}"] = run(
            lambda s, f, u, v, nd, d, lit: js.shade_mesh_hit(
                s, f, u, v, nd, d, lit=lit, normal_mapping=nm),
            bump, bh.face, bh.u, bh.v, bh.n_dot_d, x["bd"], x["lit"])

    tri = JTri(*TRI, color=(0.2, 0.7, 0.4), light_direction=(1.0, -2.0, -3.0))
    pd = (x["pd"][:, 0], x["pd"][:, 1], x["pd"][:, 2])
    for k, v in zip(("t", "hit", "nx", "ny", "nz"),
                    run(tri.intersect, x["eye"], *pd)):
        res[f"triangle.{k}"] = v
    state = (jnp.zeros(N_RAYS), jnp.zeros(N_RAYS), jnp.zeros(N_RAYS),
             jnp.ones(N_RAYS))
    res["triangle.pass"] = np.stack(run(tri.render_pass, state, x["eye"],
                                        *pd))
    np.savez(out, **res)


# ---------------------------------------------------------------------------
# the port side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    root = tmp_path_factory.mktemp("oracle_units")
    write_textured_assets(str(root), bump=True)
    return jax_reference("test_torch_oracle", "jax_unit_reference", root,
                         asset_dir=str(root))


def carried(ref, prefix):
    """The port scene carried across from the JAX scene's arrays."""
    fields = {k[len(prefix) + 1:]: v for k, v in ref.items()
              if k.startswith(prefix + ".")}
    static = {k: int(fields.pop(k)) for k in STATIC_FIELDS}
    return scene_data_from_numpy(fields, **static)


def t32(a):
    return torch.from_numpy(np.asarray(a))


def test_ray_directions_match_jax(ref):
    uni = CameraUniforms.unflat(ref["uni"])
    dirs = raygen.ray_directions(40, 24, uni, device="cpu")
    np.testing.assert_array_equal(dirs.numpy(), ref["dirs"])
    x, y = raygen.ndc_grid(40, 24, device="cpu")
    np.testing.assert_array_equal(x.numpy(), ref["ndc_x"])
    np.testing.assert_array_equal(y.numpy(), ref["ndc_y"])
    o, d = raygen.ray_directions_ortho(40, 24, (0.5, -0.25, 1.0), 3.0,
                                       device="cpu")
    np.testing.assert_array_equal(o.numpy(), ref["ortho_o"])
    np.testing.assert_array_equal(d.numpy(), ref["ortho_d"])


def test_intersect_tris_matches_jax(ref):
    scene = carried(ref, "terrain")
    x = unit_inputs()
    th = intersect.intersect_tris(scene, t32(x["eye"]), t32(x["pd"]))
    hit = np.isfinite(ref["tri.t"])
    assert 50 < hit.sum() < N_RAYS  # hits and misses both
    np.testing.assert_array_equal(th.t.numpy(), ref["tri.t"])
    np.testing.assert_array_equal(th.face.numpy()[hit], ref["tri.face"][hit])
    for k in ("u", "v"):
        np.testing.assert_allclose(getattr(th, k).numpy()[hit],
                                   ref[f"tri.{k}"][hit], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(th.n_dot_d.numpy()[hit],
                                  ref["tri.n_dot_d"][hit])


def test_occlusion_matches_jax(ref):
    scene = carried(ref, "terrain")
    x = unit_inputs()
    occ = intersect.occluded_tris(scene, t32(x["o"]), t32(x["d"]))
    assert 20 < int(occ.sum()) < N_RAYS - 20
    np.testing.assert_array_equal(occ.numpy(), ref["occ_tris"])
    occ_s = intersect.occluded_spheres(scene, t32(x["o"]), t32(x["d"]))
    np.testing.assert_array_equal(occ_s.numpy(), ref["occ_sph"])


def test_sphere_functions_match_jax(ref):
    scene = carried(ref, "terrain")
    x = unit_inputs()
    sh = intersect.intersect_sphere(scene.sphere_center[1],
                                    scene.sphere_radius[1], t32(x["o"]),
                                    t32(x["d"]))
    hit = np.isfinite(ref["sph.t"])
    assert hit.any()
    np.testing.assert_array_equal(sh.t.numpy(), ref["sph.t"])
    np.testing.assert_array_equal(sh.normal.numpy()[hit],
                                  ref["sph.normal"][hit])
    got = shade.shade_sphere(scene, 0, t32(x["d"]), t32(x["pd"]),
                             lit=t32(x["lit"]))
    np.testing.assert_allclose(got.numpy(), ref["shade_sphere"], rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("nm", [False, True])
def test_shade_mesh_hit_matches_jax(ref, nm):
    scene = carried(ref, "bump")
    x = unit_inputs()
    face = t32(ref["bump.hit.face"]).long()
    got = shade.shade_mesh_hit(
        scene, face, t32(ref["bump.hit.u"]), t32(ref["bump.hit.v"]),
        t32(ref["bump.hit.n_dot_d"]), t32(x["bd"]), lit=t32(x["lit"]),
        normal_mapping=nm)
    want = ref[f"shade_mesh.{nm}"]
    hit = np.isfinite(ref["bump.hit.t"])
    assert hit.sum() > N_RAYS // 2
    np.testing.assert_allclose(got.numpy()[hit], want[hit], rtol=0,
                               atol=1e-6)
    if nm:  # the bump map moves the shading
        assert not np.allclose(want[hit], ref["shade_mesh.False"][hit])


def test_triangle_matches_jax(ref):
    x = unit_inputs()
    tri = Triangle(*TRI, color=(0.2, 0.7, 0.4),
                   light_direction=(1.0, -2.0, -3.0))
    dx, dy, dz = (t32(x["pd"][:, k].copy()) for k in range(3))
    got = tri.intersect(x["eye"], dx, dy, dz)
    assert 0 < int(got[1].sum()) < N_RAYS
    for k, v in zip(("t", "hit", "nx", "ny", "nz"), got):
        np.testing.assert_array_equal(v.numpy(), ref[f"triangle.{k}"], k)
    state = (torch.zeros(N_RAYS), torch.zeros(N_RAYS), torch.zeros(N_RAYS),
             torch.ones(N_RAYS))
    out = torch.stack(tri.render_pass(state, x["eye"], dx, dy, dz))
    np.testing.assert_allclose(out.numpy(), ref["triangle.pass"], rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

def jax_oracle(cfg, **kw):
    rc = cfg.render
    data = JScene.build(cfg).data
    uni = jnp.asarray(JCamera.from_config(
        cfg.camera, rc.width / rc.height).uniforms().flat())
    color, depth = jax_render_oracle(data, uni, width=rc.width,
                                     height=rc.height, shadows=rc.shadows,
                                     **kw)
    return np.asarray(color), np.asarray(depth)


def port_oracle(cfg, **kw):
    rc = cfg.render
    data = Scene.build(cfg).data
    uni = Camera.from_config(cfg.camera, rc.width / rc.height).uniforms()
    return render_oracle(data, uni.flat(), width=rc.width, height=rc.height,
                         shadows=rc.shadows, **kw)


@pytest.mark.parametrize("shadows", [False, True])
def test_render_oracle_matches_jax(shadows):
    jc = terrain_config(jcfg, width=64, height=48, shadows=shadows)
    want, want_d = jax_oracle(jc)
    color, depth = port_oracle(port_config(jc))
    assert color.shape == (48, 64, 3) and u8_levels(color).max() > 0
    assert_frame_bar(color, want)
    np.testing.assert_array_equal(depth.numpy(), want_d)


@pytest.mark.parametrize("bump", [False, True])
def test_textured_oracle_matches_jax(tmp_path, monkeypatch, bump):
    write_textured_assets(str(tmp_path), bump=bump)
    monkeypatch.setenv("RWRT_ASSETS", str(tmp_path))
    jc = textured_config(jcfg, width=48, height=40, bump=bump)
    want, _ = jax_oracle(jc, normal_mapping=bump)
    color, _ = port_oracle(port_config(jc), normal_mapping=bump)
    assert len(np.unique(u8_levels(color))) > 20  # the texture shows
    assert_frame_bar(color, want)


def test_oracle_block_size_does_not_change_the_frame(monkeypatch):
    """Each ray's result depends on that ray alone: blocks of 7 rays
    (less than a row, not dividing the frame), blocks cut by the pair
    budget, or the whole frame in one, give the same frame bit for bit.
    The pair budget bounds a block at any mesh size, down to one ray."""
    cfg = port_config(terrain_config(jcfg, width=40, height=30))
    assert 40 * 30 * 1024 <= oracle.MAX_BLOCK_PAIRS  # one block fits all
    whole = port_oracle(cfg, max_block_rays=1 << 20)
    small = port_oracle(cfg, max_block_rays=7)
    monkeypatch.setattr(oracle, "MAX_BLOCK_PAIRS", 13 * 1024)
    assert oracle.block_rays(1024, 1 << 20) == 13
    paired = port_oracle(cfg, max_block_rays=1 << 20)
    for got in (small, paired):
        assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])
    monkeypatch.undo()
    faces = 522_240  # the streamed scene's padded faces
    assert oracle.block_rays(faces, 32768) * faces <= oracle.MAX_BLOCK_PAIRS
    assert oracle.block_rays(oracle.MAX_BLOCK_PAIRS * 2, 32768) == 1


def test_oracle_matches_terrain_golden():
    """The only asset-free golden (tests/goldens/terrain_shadows.png, the
    JAX oracle's frame): the PNG holds the sRGB encode of the linear u8
    levels; a level off is a neighbour's code."""
    cfg = port_config(jcfg.SceneConfig(
        meshes=terrain_config(jcfg).meshes,
        camera=terrain_config(jcfg).camera,
        render=jcfg.RenderConfig(width=160, height=160, shadows=True)))
    color, _ = Renderer(cfg, backend="oracle", device="cpu").render()
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


def test_renderer_oracle_backend(tmp_path):
    """Renderer(backend="oracle") draws render_oracle's frame on the
    device it is given (variant_chosen None, as in the JAX package); the
    CLI's --backend oracle writes it; "megakernel_gp" is a backend too
    (variant_chosen "gp") and an unknown name raises."""
    cfg = port_config(terrain_config(jcfg, width=48, height=32))
    r = Renderer(cfg, backend="oracle", device="cpu")
    assert r.backend == "oracle" and r.variant_chosen is None
    color, depth = r.render(block=True)
    want = port_oracle(cfg)
    assert torch.equal(color, want[0]) and torch.equal(depth, want[1])
    assert r.variant_chosen is None
    scene = tmp_path / "scene.json"
    scene.write_text(cfg.to_json())
    png = str(tmp_path / "oracle.png")
    assert main(["--shell", "headless", "--scene", str(scene), "--width",
                 "48", "--height", "32", "--shadows", "--backend", "oracle",
                 "--device", "cpu", "--out", png]) == 0
    assert read_png(png).shape == (32, 48, 3)
    assert Renderer(cfg, backend="megakernel_gp",
                    device="cpu").variant_chosen == "gp"
    with pytest.raises(ValueError, match="backend"):
        Renderer(cfg, backend="bogus", device="cpu")
