"""PyTorch port: kernel K1 (closest hit, spheres fused) against the JAX
package's _make_closest_hit_kernel run in interpret mode.

Both sides get the same schedule, ray planes, face pack, origin terms
and sphere block (computed by JAX, carried across as NumPy); (t, face)
and the sphere planes must be EXACTLY equal. On the CPU the wrapper runs
the plain PyTorch version; the CUDA kernel is checked against it on the
card (marked gpu, skipped here).
"""

import numpy as np
import pytest
import torch

from rust_wgpu_raytracing_tpu_torch import config as pcfg
from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
from rust_wgpu_raytracing_tpu_torch.core.scene import Scene
from rust_wgpu_raytracing_tpu_torch.ops import megakernel as P
from rust_wgpu_raytracing_tpu_torch.ops import scenepacks as SP
from rust_wgpu_raytracing_tpu_torch.ops.kernels import (closest_hit,
                                                        closest_hit_plain,
                                                        launch_counts)
from rust_wgpu_raytracing_tpu_torch.ops.traverse import tile_ray_bounds
from test_torch_host import (cube_config, cuda_device,  # noqa: F401
                             jax_config, jax_reference, terrain_config)

CASES = {
    "terrain_cull": (lambda: terrain_config(pcfg), "cull", 96, 64),
    "terrain_brute": (lambda: terrain_config(pcfg), "brute", 96, 64),
    "cube_cull": (lambda: cube_config(pcfg), "cull", 64, 64),
    "terrain_random_rays": (lambda: terrain_config(pcfg), "cull", 0, 0),
}
INPUTS = ("tlb", "order", "dx", "dy", "dz", "texit", "fpack", "oterm", "sph")
SPH = ("st", "sid", "snx", "sny", "snz")


def random_dirs(n=2048, seed=11):
    """Wide-cone rays toward the scene (tiles far less coherent than
    screen tiles, so the cull admits many more blocks)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32) + \
        np.array([0.0, 1.6, -1.8], np.float32)
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).T.copy()


def jax_closest_hit(out):
    import jax
    import jax.numpy as jnp

    import rust_wgpu_raytracing_tpu.ops.megakernel as J
    from rust_wgpu_raytracing_tpu.core.camera import Camera as JCamera
    from rust_wgpu_raytracing_tpu.core.camera import CameraUniforms as JU
    from rust_wgpu_raytracing_tpu.core.scene import Scene as JScene

    res = {}
    for name, (make, accel, w, h) in CASES.items():
        cfg = jax_config(make())
        data = JScene.build(cfg).data
        uni = JCamera.from_config(cfg.camera, (w / h) if w else 1.0).uniforms()
        origin = jnp.asarray(uni.origin)
        if w:
            th, tw, rh = J._pick_tile_shape(w, h)
            rays = jax.jit(lambda u: J.raygen_planar_tiled(
                w, rh, JU.unflat(u), total_height=h, tile_h=th,
                tile_w=tw))(jnp.asarray(uni.flat()))
        else:
            rays = tuple(jnp.asarray(a) for a in random_dirs())
        f = data.tri_p0.shape[0]
        bf = J._natural_block_f(data, f)

        def inputs(d, o, x, y, z, accel=accel):
            x, y, z = (J._pad1(v, 1024) for v in (x, y, z))
            mask, nw = J._mask_words(d, accel, o[0], o[1], o[2], x, y, z,
                                     1024, bf, f)
            tlb, order, texit = J._vmem_sched(d, mask, nw, o[0], o[1], o[2],
                                              x, y, z, 1024, f, bf)
            sph = jnp.concatenate([o, jnp.concatenate(
                [d.sphere_center, d.sphere_radius[:, None]], 1).reshape(-1)])
            return (tlb[:, 0], order[:, 0], x, y, z, texit,
                    J.pack_face_columns(d), J.pack_origin_cols(d, o), sph)
        for k, v in zip(INPUTS, jax.jit(inputs)(data, origin, *rays)):
            res[f"{name}_{k}"] = v
        gb, sph = J.gbuffer_pallas(data, origin, *rays, with_spheres=True,
                                   interpret=True, accel=accel)
        res[f"{name}_t"], res[f"{name}_face"] = gb.t, gb.face
        for k, v in zip(SPH, sph):
            res[f"{name}_{k}"] = v
        res[f"{name}_block_f"] = np.int32(bf)
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return jax_reference("test_torch_closest_hit", "jax_closest_hit",
                         tmp_path_factory.mktemp("k1"))


def case_inputs(ref, name):
    args = [torch.from_numpy(ref[f"{name}_{k}"]) for k in INPUTS]
    return args, int(ref[f"{name}_block_f"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_closest_hit_matches_jax_kernel(ref, name):
    args, bf = case_inputs(ref, name)
    before = launch_counts()["closest_hit"]
    t, face, sph = closest_hit(*args, block_f=bf)
    # CPU tensors: plain version
    assert launch_counts()["closest_hit"] == before
    n = ref[f"{name}_t"].shape[0]
    hits = np.isfinite(ref[f"{name}_t"])
    assert hits.any() and not hits.all()
    np.testing.assert_array_equal(t[:n].numpy(), ref[f"{name}_t"])
    np.testing.assert_array_equal(face[:n].numpy(), ref[f"{name}_face"])
    for k, v in zip(SPH, sph):
        np.testing.assert_array_equal(v[:n].numpy(), ref[f"{name}_{k}"])


@pytest.mark.parametrize("name", ["terrain_cull", "cube_cull"])
def test_port_gbuffer_matches_jax_kernel(ref, name):
    """The port's own glue + K1 from the scene and camera alone."""
    make, accel, w, h = CASES[name]
    cfg = make()
    data = Scene.build(cfg).data
    uni = Camera.from_config(cfg.camera, w / h).uniforms()
    th, tw, rh = P._pick_tile_shape(w, h)
    rays = P.raygen_planar_tiled(w, rh, uni, device="cpu", total_height=h,
                                 tile_h=th, tile_w=tw)
    gb, sph = P.gbuffer(data, torch.from_numpy(uni.origin), *rays,
                        accel=accel)
    np.testing.assert_array_equal(gb.t.numpy(), ref[f"{name}_t"])
    np.testing.assert_array_equal(gb.face.numpy(), ref[f"{name}_face"])
    for k, v in zip(SPH, sph):
        np.testing.assert_array_equal(v.numpy(), ref[f"{name}_{k}"])


def test_closest_hit_rejects_bad_inputs(ref):
    args, bf = case_inputs(ref, "cube_cull")
    bad = list(args)
    bad[1] = bad[1].to(torch.int64)
    with pytest.raises(TypeError):
        closest_hit(*bad, block_f=bf)
    with pytest.raises(ValueError):
        closest_hit(*args, block_f=bf * 2)


def port_inputs(name, device):
    """K1's inputs for a case, built by the port's own glue on `device`."""
    make, accel, w, h = CASES[name]
    cfg = make()
    data = Scene.build(cfg).data.to(device)
    uni = Camera.from_config(cfg.camera, (w / h) if w else 1.0).uniforms()
    origin = torch.from_numpy(uni.origin).to(device)
    if w:
        th, tw, rh = P._pick_tile_shape(w, h)
        rays = P.raygen_planar_tiled(w, rh, uni, device=device,
                                     total_height=h, tile_h=th, tile_w=tw)
    else:
        rays = [torch.from_numpy(a).to(device) for a in random_dirs()]
    f = data.padded_faces
    bf = P._natural_block_f(data, f)
    x, y, z = (P._pad1(v, 1024) for v in rays)
    o = (origin[0], origin[1], origin[2])
    bounds = tile_ray_bounds(*o, x, y, z, 1024)
    mask, nw = P._mask_words(data, accel, bounds, bf)
    tlb, order, texit = P._vmem_sched(data, mask, nw, bounds, *o, x, y, z,
                                      bf)
    return ([tlb, order, x, y, z, texit, SP.pack_face_columns(data),
             P.pack_origin_cols(data, origin), P._sphere_pack(data, origin)],
            bf)


def test_port_inputs_match_jax_inputs(ref):
    """The card test below builds its inputs with the port's glue; on
    the CPU they equal the JAX-built ones."""
    for name in CASES:
        args, bf = port_inputs(name, "cpu")
        assert bf == int(ref[f"{name}_block_f"])
        for k, a in zip(INPUTS, args):
            np.testing.assert_array_equal(a.numpy(), ref[f"{name}_{k}"])


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_closest_hit_cuda_matches_plain(name, cuda_device):
    args, bf = port_inputs(name, cuda_device)
    before = launch_counts()["closest_hit"]
    t, face, sph = closest_hit(*args, block_f=bf)
    torch.cuda.synchronize()
    assert launch_counts()["closest_hit"] == before + 1
    pt_, pf, psph = closest_hit_plain(*args, block_f=bf)
    assert torch.isfinite(t).any()
    assert torch.equal(t, pt_) and torch.equal(face, pf)
    for a, b in zip(sph, psph):
        assert torch.equal(a, b)
