"""PyTorch port: Scene.build against the JAX package, field by field.

Scene.build is NumPy in both packages up to the closing conversion, so
every field the port keeps must be BIT-identical to the JAX field (the
u16 texel pool compared through its int16 view).
"""

import dataclasses

import numpy as np
import pytest
import torch

from rust_wgpu_raytracing_tpu import config as jcfg
from rust_wgpu_raytracing_tpu.core.scene import Scene as JScene
from rust_wgpu_raytracing_tpu_torch.core.scene import (STATIC_FIELDS, Scene,
                                                       SceneData,
                                                       scene_data_from_numpy)
from test_torch_host import (cube_config, port_config, terrain_config,
                             textured_config, write_textured_assets)

CONFIGS = {
    "cube_spheres": lambda: cube_config(jcfg),
    "terrain23_spheres": lambda: terrain_config(jcfg, grid=23),
    "terrain91": lambda: terrain_config(jcfg, grid=91, spheres=False),
    # past STREAM_FACES: the streaming record spack is built too
    "terrain92_spheres": lambda: terrain_config(jcfg, grid=92),
    "spheres_only": lambda: jcfg.SceneConfig(
        spheres=jcfg.reference_scene().spheres),
}


def port_fields():
    return [f.name for f in dataclasses.fields(SceneData)
            if f.name not in STATIC_FIELDS]


def assert_same_scene(port: SceneData, jax_data):
    """Every field the port keeps (the oracle's texture stack, the mip
    pyramid and its tables, the LBVH pack included) and every static
    count equal to the JAX scene's."""
    for name in port_fields():
        got = getattr(port, name).numpy()
        want = np.asarray(getattr(jax_data, name))
        if want.dtype == np.uint16:
            want = want.view(np.int16)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in STATIC_FIELDS:
        assert getattr(port, name) == getattr(jax_data, name), name


def carry(jd):
    """The bridge: a JAX SceneData's arrays and counts into the port."""
    fields = {f.name: np.asarray(getattr(jd, f.name))
              for f in dataclasses.fields(jd)
              if not f.metadata.get("static")}
    return scene_data_from_numpy(
        fields, **{k: getattr(jd, k) for k in STATIC_FIELDS})


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_scene_build_matches_jax(name):
    cfg = CONFIGS[name]()
    assert_same_scene(Scene.build(port_config(cfg)).data,
                      JScene.build(cfg).data)


def test_textured_scene_matches_jax(tmp_path, monkeypatch):
    write_textured_assets(str(tmp_path))
    monkeypatch.setenv("RWRT_ASSETS", str(tmp_path))
    cfg = textured_config(jcfg)
    port = Scene.build(port_config(cfg)).data
    assert_same_scene(port, JScene.build(cfg).data)
    # a real texture: the pool holds more than the solid white texel
    assert port.tex_packed.shape[1] > 16
    assert int(port.mat_tex_base.max()) >= 0


def test_scene_data_from_numpy_carries_jax_scene():
    cfg = CONFIGS["terrain23_spheres"]()
    jd = JScene.build(cfg).data
    assert_same_scene(carry(jd), jd)


def test_streamed_jax_scene_carried_renders_the_port_frame():
    """A JAX scene above STREAM_FACES carried across (spack included)
    renders the frame of the port's own Scene.build, bit for bit."""
    from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
    from rust_wgpu_raytracing_tpu_torch.ops.megakernel import \
        render_megakernel

    cfg = terrain_config(jcfg, grid=92, width=48, height=32)
    jd = JScene.build(cfg).data
    assert jd.spack.shape == (jd.padded_faces, 128)
    carried = carry(jd)
    own = Scene.build(port_config(cfg)).data
    uni = Camera.from_config(port_config(cfg).camera,
                             48 / 32).uniforms().flat()
    frames = [render_megakernel(d, uni, width=48, height=32, shadows=True)
              for d in (carried, own)]
    assert torch.equal(frames[0][0], frames[1][0])
    assert torch.equal(frames[0][1], frames[1][1])
    assert bool((frames[0][1] < 1).any())


def test_scene_data_from_numpy_roundtrip():
    data = Scene.build(port_config(CONFIGS["cube_spheres"]())).data
    fields = {k: v.numpy() for k, v in data.tensors().items()}
    back = scene_data_from_numpy(
        fields, **{k: getattr(data, k) for k in STATIC_FIELDS})
    for k, v in data.tensors().items():
        assert torch.equal(getattr(back, k), v), k
    assert back.padded_faces == data.padded_faces


def test_smoke_scene_sizes():
    """The 1080p smoke scene's mesh: the largest the all-on-chip path
    takes (just under STREAM_FACES), in 32-face cull blocks."""
    data = Scene.build(port_config(terrain_config(jcfg, grid=91))).data
    assert data.num_faces == 2 * 90 ** 2 == 16200
    assert data.padded_faces == 16256
    assert data.blk_lo.shape[0] == 508
    assert data.to("cpu").gpack.shape == (37, 16256)


@pytest.fixture
def bump_scene(tmp_path, monkeypatch):
    write_textured_assets(str(tmp_path), bump=True)
    monkeypatch.setenv("RWRT_ASSETS", str(tmp_path))
    return textured_config(jcfg, bump=True)


BUMP_FIELDS = ("tex_packed_bump", "mat_bump", "mat_bump_base", "mat_bump_h",
               "mat_bump_w")


def test_bump_pool_matches_jax(bump_scene):
    """The normal-mapping fields: the raw (not sRGB-decoded) bump pool and
    its i32 base offsets, against JAX Scene.build."""
    port = Scene.build(port_config(bump_scene)).data
    jd = JScene.build(bump_scene).data
    assert_same_scene(port, jd)
    assert port.tex_packed_bump.shape == (12, 64)  # the 8x8 map
    assert port.mat_bump_base.dtype == torch.int32
    assert port.mat_bump_base.tolist() == [0]
    assert port.mat_bump_h.tolist() == [8.0]
    assert not torch.equal(port.tex_packed_bump, port.tex_packed[:, :64])


def test_scene_without_bump_maps_has_empty_pool():
    port = Scene.build(port_config(CONFIGS["cube_spheres"]())).data
    assert port.tex_packed_bump.shape == (12, 1)
    assert set(port.mat_bump_base.tolist()) == {-1}
    assert set(port.mat_bump.tolist()) == {-1}


def test_scene_data_from_numpy_carries_bump_pool(bump_scene):
    jd = JScene.build(bump_scene).data
    carried = carry(jd)
    for name in BUMP_FIELDS:
        want = np.asarray(getattr(jd, name))
        if want.dtype == np.uint16:
            want = want.view(np.int16)
        np.testing.assert_array_equal(getattr(carried, name).numpy(), want)


def test_png_textures_load_without_pil(tmp_path, monkeypatch):
    """8-bit RGB and RGBA PNGs decode with the stdlib reader; any other
    image still needs PIL."""
    import sys

    from PIL import Image

    from rust_wgpu_raytracing_tpu_torch.io.textures import load_texture_file

    rng = np.random.default_rng(3)
    rgba = rng.integers(0, 256, (5, 7, 4), dtype=np.uint8)
    Image.fromarray(rgba).save(tmp_path / "a.png")
    Image.fromarray(rgba[..., :3]).save(tmp_path / "b.png")
    Image.fromarray(rgba[..., 0]).save(tmp_path / "gray.png")
    with_pil = {n: load_texture_file(str(tmp_path / n))
                for n in ("a.png", "b.png")}
    monkeypatch.setitem(sys.modules, "PIL", None)  # PIL absent
    for name in ("a.png", "b.png"):
        t = load_texture_file(str(tmp_path / name))
        np.testing.assert_array_equal(t.rgb_u8, rgba[..., :3])
        np.testing.assert_array_equal(t.rgb_linear,
                                      with_pil[name].rgb_linear)
    raw = load_texture_file(str(tmp_path / "b.png"), srgb=False)
    np.testing.assert_array_equal(
        raw.rgb_linear, rgba[..., :3].astype(np.float32) / 255.0)
    with pytest.raises(ImportError):
        load_texture_file(str(tmp_path / "gray.png"))


# the fields the oracle, mip sampling and the LBVH walk read
NEW_FIELDS = ("tri_valid", "mat_tex", "textures", "tex_hw", "tex_mips",
              "mat_mip_base", "mat_mip_h", "mat_mip_w", "tri_uvscale",
              "bvh_pack", "bvh_nodes", "mip_levels")


@pytest.fixture(scope="module")
def two_mesh_scenes(tmp_path_factory):
    """(port Scene.build, JAX Scene.build, the JAX scene carried across)
    of the bump-mapped box beside builtin:terrain:23: two materials, a
    diffuse and a bump texture, a 4-level pyramid, a 129-node LBVH."""
    import os

    root = tmp_path_factory.mktemp("two_mesh")
    write_textured_assets(str(root), bump=True)
    old = os.environ.get("RWRT_ASSETS")
    os.environ["RWRT_ASSETS"] = str(root)
    try:
        box = textured_config(jcfg, bump=True)
        cfg = dataclasses.replace(
            box, meshes=box.meshes + terrain_config(jcfg).meshes)
        jd = JScene.build(cfg).data
        port = Scene.build(port_config(cfg)).data
    finally:
        if old is None:
            del os.environ["RWRT_ASSETS"]
        else:
            os.environ["RWRT_ASSETS"] = old
    return port, jd, carry(jd)


@pytest.mark.parametrize("name", NEW_FIELDS)
def test_new_field_matches_jax(two_mesh_scenes, name):
    """Scene.build's field equals JAX's, and the bridge carries JAX's."""
    port, jd, carried = two_mesh_scenes
    want = getattr(jd, name)
    for got in (getattr(port, name), getattr(carried, name)):
        if name in STATIC_FIELDS:
            assert got == want
            continue
        want = np.asarray(want)
        if want.dtype == np.uint16:
            want = want.view(np.int16)
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)
    assert port.mip_levels == 4 and port.bvh_nodes > 100
