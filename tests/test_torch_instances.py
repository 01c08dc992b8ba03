"""PyTorch port: instancing and the per-frame refit (ops/instances.py)
against the JAX package, and the stale winner-attribute table.

The JAX side runs in the jax_reference subprocess (XLA without FMA), so
the refit is held field by field to bit equality (the sign of a zero
included): tri_*, blk_lo/hi, spack and gpack, for 1, 4 and 9 cubes and
for the superblock branch with STREAM_FACES patched to 100 in both
packages, where the port's one-shot record equals JAX's chunked one.
The instanced frames are held to the frame bar of tests/test_goldens.py
(at most 1 linear u8 level, at least 99.9% of subpixels exact) against
JAX render_megakernel(interpret=True) at 64x64: the 4-cube field (512
faces, 16 blocks of 32) through the fused and the split frame, the
superblock field, and a streamed field (33 heightfield instances,
33,792 faces). Inside the port, accel="bvh" draws the cull frame bit
for bit and the fused frame equals the split frame once quantized.
"""

import dataclasses
import os
import unittest.mock as mock

import numpy as np
import pytest
import torch

from rust_wgpu_raytracing_tpu_torch.config import CameraConfig, MeshConfig
from rust_wgpu_raytracing_tpu_torch.core.camera import Camera, CameraUniforms
from rust_wgpu_raytracing_tpu_torch.core.scene import (CULL_BLOCK,
                                                       GPACK_ROWS,
                                                       STREAM_COLS)
from rust_wgpu_raytracing_tpu_torch.ops import instances as pinst
from rust_wgpu_raytracing_tpu_torch.ops import megakernel as MK
from rust_wgpu_raytracing_tpu_torch.ops import scenepacks as SP
from rust_wgpu_raytracing_tpu_torch.ops.intersect import intersect_tris
from rust_wgpu_raytracing_tpu_torch.ops.oracle import render_oracle
from test_torch_host import (assert_frame_bar, jax_reference,
                             write_heightfield_assets)

FIELDS = ("tri_p0", "tri_n", "tri_d", "tri_g", "tri_c", "tri_inv_denom",
          "tri_uv", "tri_vn", "tri_mat", "tri_valid", "tri_orig",
          "tri_tangent", "tri_bitangent", "tri_uvscale", "blk_lo",
          "blk_hi", "spack", "gpack")
# name: (mesh, instances, STREAM_FACES patched to, or None)
CASES = {"cube1": ("builtin:cube", 1, None),
         "cube4": ("builtin:cube", 4, None),
         "cube9": ("builtin:cube", 9, None),
         "cube4_super": ("builtin:cube", 4, 100)}
# frames: name -> (case or the streamed field, camera eye, render kwargs)
NEAR_EYE = (0.3, -0.5, -1.5)
FAR_EYE = (0.3, -1.0, 3.0)
FRAMES = {"cube4_fused": ("cube4", NEAR_EYE, dict(fused=None)),
          "cube4_split": ("cube4", NEAR_EYE, dict(fused=False,
                                                   shadows=True)),
          "cube4_super": ("cube4_super", NEAR_EYE, dict(shadows=True)),
          "field33": ("field33", FAR_EYE, dict(shadows=True))}
TARGET = (0.0, 0.0, -6.0)
SIZE = 64


def transforms(n):
    """The bench_configs.py config-5 layout, turned by 0.3 rad."""
    return pinst.grid_transforms(n, spacing=2.5, z=-6.0, angle=0.3)


def uni_flat(eye):
    return Camera.from_config(CameraConfig(eye=eye, target=TARGET),
                              1.0).uniforms().flat()


# ---------------------------------------------------------------------------
# the JAX side (runs in the jax_reference subprocess)
# ---------------------------------------------------------------------------

def jax_instances_reference(out, asset_dir):
    import jax.numpy as jnp

    from rust_wgpu_raytracing_tpu.config import MeshConfig as JMesh
    from rust_wgpu_raytracing_tpu.ops import instances as ji
    from rust_wgpu_raytracing_tpu.ops.megakernel import (
        pack_stream_columns_chunked, render_megakernel)

    os.environ["RWRT_ASSETS"] = asset_dir
    res, scenes = {}, {}
    for name, (mesh, n, sf) in list(CASES.items()) + [
            ("field33", ("field.obj", 33, None))]:
        with mock.patch.object(ji, "STREAM_FACES", sf or ji.STREAM_FACES):
            inst = ji.InstancedScene.from_config(JMesh(obj_path=mesh), n)
            sd = inst.instantiate(transforms(n))
        scenes[name] = sd
        if name == "field33":
            continue
        for f in FIELDS:
            res[f"{name}.{f}"] = np.asarray(getattr(sd, f))
        res[f"{name}.num_faces"] = np.asarray(sd.num_faces)
        res[f"{name}.fb_real"] = np.asarray(inst.fb_real)
        if sf:
            res[f"{name}.chunked"] = np.asarray(
                pack_stream_columns_chunked(sd))
    for name, (case, eye, kw) in FRAMES.items():
        c, d = render_megakernel(scenes[case], jnp.asarray(uni_flat(eye)),
                                 width=SIZE, height=SIZE, interpret=True,
                                 **kw)
        res[f"frame.{name}"] = np.asarray(c)
        res[f"depth.{name}"] = np.asarray(d)
    for n, kw in ((4, {}), (9, dict(spacing=3.0, z=-12.0)),
                  (64, dict(spacing=2.5, z=-6.0, angle=0.05))):
        res[f"grid.{n}"] = ji.grid_transforms(n, **kw)
    np.savez(out, **res)


# ---------------------------------------------------------------------------
# the port side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("instance_assets")
    write_heightfield_assets(str(root))
    return str(root)


@pytest.fixture(scope="module")
def ref(assets, tmp_path_factory):
    return jax_reference("test_torch_instances", "jax_instances_reference",
                         tmp_path_factory.mktemp("instances_ref"),
                         asset_dir=assets)


_scenes = {}


def port_scene(name, assets=None):
    """(InstancedScene, its refit SceneData) of a case, on the CPU."""
    if name not in _scenes:
        mesh, n, sf = CASES.get(name, ("field.obj", 33, None))
        env = {"RWRT_ASSETS": assets} if assets else {}
        with mock.patch.dict(os.environ, env), \
                mock.patch.object(pinst, "STREAM_FACES",
                                  sf or pinst.STREAM_FACES):
            inst = pinst.InstancedScene.from_config(
                MeshConfig(obj_path=mesh), n, device="cpu")
            _scenes[name] = (inst, inst.instantiate(transforms(n)))
    return _scenes[name]


def bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("case", list(CASES))
def test_instantiate_matches_jax(ref, case):
    """Every refit field bit for bit (tolerance: none, the sign of a zero
    included), and num_faces a count of the real faces."""
    inst, sd = port_scene(case)
    for f in FIELDS:
        want = ref[f"{case}.{f}"]
        got = getattr(sd, f).numpy()
        assert got.shape == want.shape, (f, got.shape, want.shape)
        np.testing.assert_array_equal(bits(got), bits(want), err_msg=f)
    assert sd.num_faces == int(ref[f"{case}.num_faces"])
    assert inst.fb_real == int(ref[f"{case}.fb_real"])
    assert sd.num_faces == CASES[case][1] * inst.fb_real


def test_oneshot_record_matches_jax_chunked_record(ref):
    """The superblock branch (STREAM_FACES patched to 100 in both
    packages): instantiate attaches the port's one-shot record, equal to
    JAX's superblock-chunked build bit for bit, and its table."""
    _, sd = port_scene("cube4_super")
    assert tuple(sd.spack.shape) == (4 * 1024, STREAM_COLS)
    np.testing.assert_array_equal(bits(sd.spack.numpy()),
                                  bits(ref["cube4_super.chunked"]))
    np.testing.assert_array_equal(bits(SP.pack_stream_columns(sd).numpy()),
                                  bits(ref["cube4_super.chunked"]))
    assert tuple(sd.gpack.shape) == (GPACK_ROWS, 4 * 1024)
    np.testing.assert_array_equal(
        bits(SP.gpack_from_stream(sd.spack).numpy()),
        bits(ref["cube4_super.gpack"]))


@pytest.mark.parametrize("n", [4, 9, 64])
def test_grid_transforms_matches_jax(ref, n):
    kw = {4: {}, 9: dict(spacing=3.0, z=-12.0),
          64: dict(spacing=2.5, z=-6.0, angle=0.05)}[n]
    np.testing.assert_array_equal(pinst.grid_transforms(n, **kw),
                                  ref[f"grid.{n}"])


def port_frame(name, assets, **extra):
    case, eye, kw = FRAMES[name]
    _, sd = port_scene(case, assets)
    return MK.render_megakernel(sd, uni_flat(eye), width=SIZE, height=SIZE,
                                **dict(kw, **extra))


@pytest.mark.parametrize("name", list(FRAMES))
def test_instanced_frame_matches_jax(ref, assets, name):
    """The frame bar against JAX render_megakernel(interpret=True); the
    depth planes equal within the same bar's pixels."""
    color, depth = port_frame(name, assets)
    want = ref[f"frame.{name}"]
    assert color.shape == want.shape
    assert float((depth < 1).float().mean()) > 0.005  # the field is seen
    assert_frame_bar(color, want)


@pytest.mark.parametrize("name", ["cube4_split", "cube4_super", "field33"])
def test_bvh_draws_the_cull_frame(assets, name):
    """The refit scene has no tree (bvh_nodes 0); accel="bvh" culls from
    the refit cluster AABBs and draws the cull frame bit for bit."""
    _, sd = port_scene(FRAMES[name][0], assets)
    assert sd.bvh_nodes == 0 and tuple(sd.bvh_pack.shape) == (9, 1)
    cc, cd = port_frame(name, assets, accel="cull")
    bc, bd = port_frame(name, assets, accel="bvh")
    assert torch.equal(cc, bc) and torch.equal(cd, bd)


def test_fused_equals_split_quantized(assets):
    """The 4-cube field (16 blocks of 32 faces: the refit's clusters,
    not Scene.build's 8-face ones) through both frame programs, with and
    without shadows: equal once quantized (tolerance: none)."""
    _, sd = port_scene("cube4")
    assert MK._natural_block_f(sd, sd.padded_faces) == CULL_BLOCK
    assert sd.blk_lo.shape[0] == 16
    for shadows in (False, True):
        f = port_frame("cube4_fused", assets, fused=True, shadows=shadows)
        s = port_frame("cube4_fused", assets, fused=False, shadows=shadows)
        assert torch.equal(f[0], s[0]) and torch.equal(f[1], s[1])


def test_stale_gpack_is_rebuilt_not_clamped():
    """A table narrower than the scene (the template's, or an empty one)
    is rebuilt from the scene's tensors: the G-buffer equals the one from
    the fresh table, where indexing the stale one (clamped) would not."""
    _, sd = port_scene("cube4")
    uni = uni_flat(NEAR_EYE)
    fresh = SP.winner_table(sd)
    assert tuple(fresh.shape) == (GPACK_ROWS, sd.padded_faces)
    cu = CameraUniforms.unflat(np.asarray(uni, np.float32))
    origin = torch.as_tensor(cu.origin, dtype=torch.float32)
    dx, dy, dz = MK.raygen_planar(SIZE, SIZE, cu, device="cpu")
    gb_fresh, _ = MK.gbuffer(sd, origin, dx, dy, dz)
    hit = torch.isfinite(gb_fresh.t)
    assert int(hit.sum()) > 20
    for stale in (sd.gpack[:, :128].clone(),
                  torch.zeros((GPACK_ROWS, 0), dtype=torch.float32)):
        stale_sd = dataclasses.replace(sd, gpack=stale)
        assert SP.winner_table(stale_sd).shape == fresh.shape
        gb, _ = MK.gbuffer(stale_sd, origin, dx, dy, dz)
        for name in ("u", "v", "nd", "uvx", "uvy", "nx", "ny", "nz", "mat"):
            assert torch.equal(getattr(gb, name), getattr(gb_fresh, name))
    # the old reading: the faces past the stale width clamp to its last
    # column and shade with another face's attributes
    clamped = sd.gpack[:, :128].index_select(
        1, gb_fresh.face.clamp(0, 127).long())
    assert not torch.equal(clamped[1][hit], fresh[1][gb_fresh.face[hit]])


def test_identity_instance_matches_base():
    """JAX test_identity_instance_matches_base: a ray down -z from z=3
    hits the unit cube at z=0.5 (t=2.5, rtol 1e-5)."""
    inst = pinst.InstancedScene.from_config(
        MeshConfig(obj_path="builtin:cube"), 1, device="cpu")
    ident = np.zeros((1, 3, 4), np.float32)
    ident[0, :, :3] = np.eye(3)
    sd = inst.instantiate(ident)
    th = intersect_tris(sd, torch.tensor([0.0, 0.0, 3.0]),
                        torch.tensor([[0.0, 0.0, -1.0]]))
    np.testing.assert_allclose(th.t.numpy()[0], 2.5, rtol=1e-5)


def test_rotation_rotates_hits():
    """A 90-degree y-rotation moves the +z face to +x (rtol 1e-5)."""
    inst = pinst.InstancedScene.from_config(
        MeshConfig(obj_path="builtin:cube"), 1, device="cpu")
    sd = inst.instantiate(pinst.grid_transforms(1, z=0.0, angle=np.pi / 2))
    th = intersect_tris(sd, torch.tensor([3.0, 0.0, 0.0]),
                        torch.tensor([[-1.0, 0.0, 0.0]]))
    np.testing.assert_allclose(th.t.numpy()[0], 2.5, rtol=1e-5)


def test_instantiate_rejects_wrong_transforms():
    inst = pinst.InstancedScene.from_config(
        MeshConfig(obj_path="builtin:cube"), 2, device="cpu")
    with pytest.raises(ValueError, match="transforms"):
        inst.instantiate(pinst.grid_transforms(3))


def test_refit_moves_aabbs():
    """Shifting every instance +10 in x moves each real cluster box by
    10 (atol 1e-4); padding clusters stay +inf / -inf."""
    inst = pinst.InstancedScene.from_config(
        MeshConfig(obj_path="builtin:cube"), 2, device="cpu")
    t0 = pinst.grid_transforms(2, spacing=2.0, z=-5.0)
    t1 = t0.copy()
    t1[:, 0, 3] += 10.0
    lo0 = inst.instantiate(t0).blk_lo.numpy()
    lo1 = inst.instantiate(t1).blk_lo.numpy()
    real = np.isfinite(lo0[:, 0])
    assert real.any() and not real.all()
    np.testing.assert_allclose(lo1[real, 0] - lo0[real, 0], 10.0, atol=1e-4)
    assert np.all(lo1[~real] == np.inf)


def test_field_renders_through_the_oracle():
    """JAX test_render_field: a 3x3 field through the brute-force oracle,
    finite and visible."""
    inst = pinst.InstancedScene.from_config(
        MeshConfig(obj_path="builtin:cube"), 9, device="cpu")
    sd = inst.instantiate(pinst.grid_transforms(9, spacing=3.0, z=-12.0))
    cam = Camera.from_config(CameraConfig(), aspect=1.0)
    c, d = render_oracle(sd, cam.uniforms().flat(), width=48, height=48)
    assert bool(torch.isfinite(c).all())
    assert float((d < 1).float().mean()) > 0.01


def test_instanced_terrain_pads_to_superblocks():
    """BASELINE config 5 on the card's base mesh: 64 builtin:terrain:23
    instances (968 faces each) pad to whole superblocks (65,536 faces,
    streamed), 16 stay all on chip (16,384 faces)."""
    big = pinst.InstancedScene.from_config(
        MeshConfig(obj_path="builtin:terrain:23"), 64, device="cpu")
    small = pinst.InstancedScene.from_config(
        MeshConfig(obj_path="builtin:terrain:23"), 16, device="cpu")
    assert big.fb_real == 968 and big.base_faces.shape[0] == 1024
    sd = big.instantiate(pinst.grid_transforms(64, z=-6.0))
    assert sd.padded_faces == 65536 and sd.spack.shape[0] == 65536
    assert MK._should_stream(sd.padded_faces,
                             MK._natural_block_f(sd, sd.padded_faces))
    sd16 = small.instantiate(pinst.grid_transforms(16, z=-6.0))
    assert sd16.padded_faces == 16384 and sd16.spack.shape[0] == 0
    assert MK.fused_eligible(sd16, shadows=True, normal_mapping=False)
