"""PyTorch port: kernel K7 (closest hit for per-ray origins) against the
JAX package's _make_closest_hit_perray_kernel run in interpret mode
(gbuffer_perray_pallas, VMEM branch).

The rays are a path tracer's bounce wavefront: seeded origins on and
around the surface with directions spread over the sphere, and some
rays parked as dead paths are (origin 1e9, zero direction). Both sides
get the same schedule, planes, face pack and plane constants (computed
by JAX, carried across as NumPy): t and face must be BITWISE equal,
with the face blocks' boxes (which the kernel's per-ray culled walk
reads and the plain version ignores; testing/raycull.py
sched_perray_culled models the walk) and without. The
port's own glue (gbuffer_perray: mask, schedule, K7, and
expand_tf_gbuffer with per-ray origin terms) must give every G-buffer
plane by value.
"""

import os
from unittest import mock

import numpy as np
import pytest
import torch

from rust_wgpu_raytracing_tpu_torch import config as pcfg
from rust_wgpu_raytracing_tpu_torch.core.scene import Scene
from rust_wgpu_raytracing_tpu_torch.ops import megakernel as P
from rust_wgpu_raytracing_tpu_torch.ops import scenepacks as SP
from rust_wgpu_raytracing_tpu_torch.ops.kernels import (
    closest_hit_perray, closest_hit_perray_plain, launch_counts)
from rust_wgpu_raytracing_tpu_torch.ops.traverse import tile_ray_bounds
from rust_wgpu_raytracing_tpu_torch.testing.raycull import \
    sched_perray_culled
from test_torch_host import (cuda_device, jax_config,  # noqa: F401
                             jax_reference, terrain_config,
                             textured_config, write_textured_assets)

INPUTS = ("tlb", "order", "dx", "dy", "dz", "ox", "oy", "oz", "texit",
          "fpack", "dc")
GB = ("t", "face", "u", "v", "nd", "uvx", "uvy", "nx", "ny", "nz", "mat")
# name: (scene, accel, seed)
CASES = {"terrain_cull": ("terrain", "cull", 31),
         "terrain_brute": ("terrain", "brute", 32),
         "box_cull": ("box", "cull", 33)}


def scene_config(kind):
    if kind == "terrain":
        return terrain_config(pcfg, shadows=False)
    return textured_config(pcfg, shadows=False)


def bounce_wavefront(kind, seed, n=3000):
    """(origins (3,n), directions (3,n)) f32: a bounce wavefront around
    the scene's surface, 20% of it parked."""
    rng = np.random.default_rng(seed)
    if kind == "terrain":
        lo, hi = (-1.0, -1.0, -3.3), (1.0, 1.0, -2.65)
    else:
        lo, hi = (-1.1, -1.1, -4.4), (1.1, 1.1, -2.6)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    dead = rng.uniform(size=n) < 0.2
    o[dead] = 1e9
    d[dead] = 0.0
    return o.T.copy(), d.T.copy()


def jax_perray(out, assets):
    import jax
    import jax.numpy as jnp

    import rust_wgpu_raytracing_tpu.ops.megakernel as J
    from rust_wgpu_raytracing_tpu.core.scene import Scene as JScene

    os.environ["RWRT_ASSETS"] = assets
    res = {}
    for name, (kind, accel, seed) in CASES.items():
        data = JScene.build(jax_config(scene_config(kind))).data
        f = data.tri_p0.shape[0]
        bf = J._natural_block_f(data, f)
        o, d = (tuple(jnp.asarray(a) for a in x)
                for x in bounce_wavefront(kind, seed))

        def inputs(dt, o, d, accel=accel):
            o = [J._pad1(v, 1024) for v in o]
            d = [J._pad1(v, 1024) for v in d]
            mask, nw = J._mask_words(dt, accel, *o, *d, 1024, bf, f)
            tlb, order, texit = J._vmem_sched(dt, mask, nw, *o, *d, 1024, f,
                                              bf)
            dc = jnp.concatenate([dt.tri_d[:, None], dt.tri_c,
                                  jnp.zeros((f, 4), jnp.float32)], axis=1)
            return (tlb[:, 0], order[:, 0], *d, *o, texit,
                    J.pack_face_columns(dt), dc)
        for k, v in zip(INPUTS, jax.jit(inputs)(data, o, d)):
            res[f"{name}_{k}"] = v
        gb = J.gbuffer_perray_pallas(data, *o, *d, interpret=True,
                                     accel=accel, stream=False)
        for k in GB:
            res[f"{name}_{k}"] = getattr(gb, k)
        res[f"{name}_block_f"] = np.int32(bf)
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("k7_assets")
    write_textured_assets(str(root))
    return str(root)


@pytest.fixture(scope="module")
def ref(tmp_path_factory, assets):
    return jax_reference("test_torch_perray", "jax_perray",
                         tmp_path_factory.mktemp("k7"), assets=assets)


def port_data(kind, assets, device="cpu"):
    with mock.patch.dict(os.environ, {"RWRT_ASSETS": assets}):
        return Scene.build(scene_config(kind)).data.to(device)


def case_inputs(ref, name):
    return ([torch.from_numpy(ref[f"{name}_{k}"]) for k in INPUTS],
            int(ref[f"{name}_block_f"]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_closest_hit_perray_matches_jax_kernel(ref, name):
    args, bf = case_inputs(ref, name)
    before = launch_counts()["closest_hit_perray"]
    t, face = closest_hit_perray(*args, block_f=bf)
    # CPU: plain version
    assert launch_counts()["closest_hit_perray"] == before
    n = ref[f"{name}_t"].shape[0]
    want_t, want_f = ref[f"{name}_t"], ref[f"{name}_face"]
    assert np.isfinite(want_t).sum() > 100  # the wavefront hits
    assert (want_t >= 1e-3).all()
    np.testing.assert_array_equal(t[:n].numpy().view(np.int32),
                                  want_t.view(np.int32))
    np.testing.assert_array_equal(face[:n].numpy(), want_f)


@pytest.mark.parametrize("name", sorted(CASES))
def test_closest_hit_perray_with_boxes_matches_jax_kernel(ref, assets, name):
    """With the port's block boxes (gbuffer_perray's block_boxes): the
    plain version and the culled walk's model, bitwise JAX's kernel."""
    args, bf = case_inputs(ref, name)
    data = port_data(CASES[name][0], assets)
    boxes = SP.block_boxes(data, bf)
    n = ref[f"{name}_t"].shape[0]
    for t, face in (closest_hit_perray(*args, *boxes, block_f=bf),
                    sched_perray_culled(*args, *boxes, block_f=bf)):
        np.testing.assert_array_equal(t[:n].numpy().view(np.int32),
                                      ref[f"{name}_t"].view(np.int32))
        np.testing.assert_array_equal(face[:n].numpy(),
                                      ref[f"{name}_face"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_gbuffer_perray_matches_jax(ref, assets, name):
    """The port's glue from the raw wavefront: mask, schedule, K7 and the
    G-buffer expanded with per-ray origin terms (expand_tf_gbuffer's
    oxyz branch)."""
    kind, accel, seed = CASES[name]
    data = port_data(kind, assets)
    o, d = bounce_wavefront(kind, seed)
    gb = P.gbuffer_perray(data, *map(torch.from_numpy, o),
                          *map(torch.from_numpy, d), accel=accel)
    for k in GB:
        np.testing.assert_array_equal(getattr(gb, k).numpy(),
                                      ref[f"{name}_{k}"], err_msg=k)


def test_parked_rays_never_hit(ref):
    args, bf = case_inputs(ref, "terrain_cull")
    t, face = closest_hit_perray(*args, block_f=bf)
    parked = (args[2] == 0) & (args[3] == 0) & (args[4] == 0)
    assert parked.sum() > 100
    assert torch.isinf(t[parked]).all() and (face[parked] == 0).all()
    assert (args[8][parked] == -1.0).all()  # root-exit cap pinned to -1


def test_closest_hit_perray_rejects_bad_inputs(ref):
    args, bf = case_inputs(ref, "terrain_cull")
    with pytest.raises(TypeError):
        closest_hit_perray(*args[:2], args[2].double(), *args[3:],
                           block_f=bf)
    with pytest.raises(ValueError):
        closest_hit_perray(*args[:8], args[8][:-1], *args[9:], block_f=bf)
    with pytest.raises(ValueError):
        closest_hit_perray(*args, block_f=64)


def port_inputs(name, assets, device):
    """K7's inputs for a case, built by the port's own glue on `device`."""
    kind, accel, seed = CASES[name]
    data = port_data(kind, assets, device)
    f = data.padded_faces
    bf = P._natural_block_f(data, f)
    o, d = bounce_wavefront(kind, seed)
    o = [P._pad1(torch.from_numpy(v).to(device), 1024) for v in o]
    d = [P._pad1(torch.from_numpy(v).to(device), 1024) for v in d]
    bounds = tile_ray_bounds(*o, *d, 1024)
    mask, nw = P._mask_words(data, accel, bounds, bf)
    tlb, order, texit = P._vmem_sched(data, mask, nw, bounds, *o, *d, bf)
    return [tlb, order, *d, *o, texit, SP.pack_face_columns(data),
            SP.pack_plane_consts(data)], bf


def test_port_inputs_match_jax_inputs(ref, assets):
    for name in CASES:
        args, bf = port_inputs(name, assets, "cpu")
        assert bf == int(ref[f"{name}_block_f"])
        for k, a in zip(INPUTS, args):
            np.testing.assert_array_equal(a.numpy(), ref[f"{name}_{k}"],
                                          err_msg=f"{name} {k}")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_closest_hit_perray_cuda_matches_plain(name, assets, cuda_device):
    args, bf = port_inputs(name, assets, cuda_device)
    data = port_data(CASES[name][0], assets, cuda_device)
    boxes = SP.block_boxes(data, bf)
    pt, pf = closest_hit_perray_plain(*args, block_f=bf)
    for a in (args, args + list(boxes)):
        before = launch_counts()["closest_hit_perray"]
        t, face = closest_hit_perray(*a, block_f=bf)
        torch.cuda.synchronize()
        assert launch_counts()["closest_hit_perray"] == before + 1
        assert torch.isfinite(t).any()
        assert torch.equal(t, pt) and torch.equal(face, pf)
