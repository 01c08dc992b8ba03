"""PyTorch port: kernel K8 (the path tracer's fused extend + shadow
sweep) against the JAX package's _make_fused_extend_shadow_kernel run
in interpret mode (extend_shadow_pallas, VMEM branch).

The rays are one bounce of a path tracer: extension rays from seeded
points on and around the surface with directions over the sphere (dead
paths parked: origin 1e9, zero direction) and shadow rays from the same
points toward the light; the dead lanes' shadow rays keep a real light
direction, half of them from the camera origin, and are inactive. Both
sides get the same act-aware mask words, planes, face pack and plane
constants (computed by JAX): t, face and occ must be BITWISE equal.
K8's plain version must equal K7's plain version (t, face) plus K3's
(occ) on the same rays, and the port's act-aware mask words must equal
JAX's.
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
    anyhit, anyhit_plain, closest_hit_perray, closest_hit_perray_plain,
    extend_shadow, extend_shadow_plain, launch_counts)
from rust_wgpu_raytracing_tpu_torch.ops.traverse import tile_ray_bounds
from test_torch_host import (cuda_device, jax_config,  # noqa: F401
                             jax_reference, terrain_config,
                             textured_config, write_textured_assets)

PLANES = ("dx", "dy", "dz", "ox", "oy", "oz",
          "sdx", "sdy", "sdz", "sox", "soy", "soz", "act")
INPUTS = ("words_a", "words_b") + PLANES + ("fpack", "dc")
GB = ("t", "face", "u", "v", "nd", "uvx", "uvy", "nx", "ny", "nz", "mat")
# name: (scene, accel, seed)
CASES = {"terrain_cull": ("terrain", "cull", 41),
         "terrain_brute": ("terrain", "brute", 42),
         "box_cull": ("box", "cull", 43)}


def scene_config(kind):
    if kind == "terrain":
        return terrain_config(pcfg, shadows=False)
    return textured_config(pcfg, shadows=False)


def bounce(kind, seed, n=3000):
    """(ext origins, ext dirs, shadow origins, shadow dirs, active): the
    planes (3, n) f32, active (n,) bool."""
    rng = np.random.default_rng(seed)
    if kind == "terrain":
        lo, hi = (-1.0, -1.0, -3.3), (1.0, 1.0, -2.65)
        light = np.array([6.0, -1.0, 1.0])
    else:
        lo, hi = (-1.1, -1.1, -4.4), (1.1, 1.1, -2.6)
        light = np.array([1.0, -2.0, -1.0])
    p = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    sd = -light / np.linalg.norm(light) + rng.normal(0, 0.05, (n, 3))
    sd = (sd / np.linalg.norm(sd, axis=1, keepdims=True)).astype(np.float32)
    act = rng.uniform(size=n) < 0.7
    o = p.copy()
    o[~act] = 1e9
    d[~act] = 0.0
    so = p.copy()
    so[~act & (rng.uniform(size=n) < 0.5)] = (0.0, -2.0, -1.0)
    return o.T.copy(), d.T.copy(), so.T.copy(), sd.T.copy(), act


def jax_extend_shadow(out, assets):
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
        o, d, so, sd, act = bounce(kind, seed)
        o, d, so, sd = (tuple(jnp.asarray(a) for a in x)
                        for x in (o, d, so, sd))
        act = jnp.asarray(act)

        def inputs(dt, o, d, so, sd, act, accel=accel):
            pad = [J._pad1(v, 1024) for v in (*d, *o, *sd, *so)]
            a = J._pad1(act.astype(jnp.float32), 1024)
            wa, _ = J._mask_words(dt, accel, *pad[3:6], *pad[0:3], 1024, bf,
                                  f, act=a > 0)
            wb, _ = J._mask_words(dt, accel, *pad[9:12], *pad[6:9], 1024,
                                  bf, f, act=a > 0)
            dc = jnp.concatenate([dt.tri_d[:, None], dt.tri_c,
                                  jnp.zeros((f, 4), jnp.float32)], axis=1)
            return (wa, wb, *pad, a, J.pack_face_columns(dt), dc)
        for k, v in zip(INPUTS, jax.jit(inputs)(data, o, d, so, sd, act)):
            res[f"{name}_{k}"] = v
        gb, occ = J.extend_shadow_pallas(data, *o, *d, *so, *sd, act,
                                         interpret=True, accel=accel)
        for k in GB:
            res[f"{name}_{k}"] = getattr(gb, k)
        res[f"{name}_occ"] = occ
        res[f"{name}_block_f"] = np.int32(bf)
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("k8_assets")
    write_textured_assets(str(root))
    return str(root)


@pytest.fixture(scope="module")
def ref(tmp_path_factory, assets):
    return jax_reference("test_torch_extend_shadow", "jax_extend_shadow",
                         tmp_path_factory.mktemp("k8"), assets=assets)


def port_data(kind, assets, device="cpu"):
    with mock.patch.dict(os.environ, {"RWRT_ASSETS": assets}):
        return Scene.build(scene_config(kind)).data.to(device)


def case_inputs(ref, name):
    return ([torch.from_numpy(ref[f"{name}_{k}"]) for k in INPUTS],
            int(ref[f"{name}_block_f"]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_extend_shadow_matches_jax_kernel(ref, name):
    args, bf = case_inputs(ref, name)
    before = launch_counts()["extend_shadow"]
    t, face, occ = extend_shadow(*args, block_f=bf)
    assert launch_counts()["extend_shadow"] == before  # CPU: plain version
    n = ref[f"{name}_t"].shape[0]
    want_t, want_occ = ref[f"{name}_t"], ref[f"{name}_occ"]
    assert np.isfinite(want_t).sum() > 100 and want_occ.sum() > 50
    np.testing.assert_array_equal(t[:n].numpy().view(np.int32),
                                  want_t.view(np.int32))
    np.testing.assert_array_equal(face[:n].numpy(), ref[f"{name}_face"])
    assert set(np.unique(occ.numpy())) <= {0.0, 1.0}
    np.testing.assert_array_equal(occ[:n].numpy() > 0, want_occ)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_extend_shadow_rays_matches_jax(ref, assets, name):
    """The port's glue from the raw bounce: both act-aware masks, K8 and
    the G-buffer with per-ray origin terms."""
    kind, accel, seed = CASES[name]
    data = port_data(kind, assets)
    o, d, so, sd, act = bounce(kind, seed)
    gb, occ = P.extend_shadow_rays(
        data, *map(torch.from_numpy, (*o, *d, *so, *sd)),
        torch.from_numpy(act), accel=accel)
    for k in GB:
        np.testing.assert_array_equal(getattr(gb, k).numpy(),
                                      ref[f"{name}_{k}"], err_msg=k)
    np.testing.assert_array_equal(occ.numpy(), ref[f"{name}_occ"])


def port_inputs(name, assets, device):
    """K8's inputs for a case, built by the port's own glue on `device`,
    and the data."""
    kind, accel, seed = CASES[name]
    data = port_data(kind, assets, device)
    f = data.padded_faces
    bf = P._natural_block_f(data, f)
    o, d, so, sd, act = bounce(kind, seed)
    pad = [P._pad1(torch.from_numpy(v).to(device), 1024)
           for v in (*d, *o, *sd, *so)]
    a = P._pad1(torch.from_numpy(act).to(device).float(), 1024)
    wa, _ = P._mask_words(data, accel, tile_ray_bounds(
        *pad[3:6], *pad[0:3], 1024, a > 0), bf)
    wb, _ = P._mask_words(data, accel, tile_ray_bounds(
        *pad[9:12], *pad[6:9], 1024, a > 0), bf)
    return [wa, wb, *pad, a, SP.pack_face_columns(data),
            SP.pack_plane_consts(data)], bf, data


def test_act_aware_mask_words_match_jax(ref, assets):
    for name in CASES:
        args, bf, _ = port_inputs(name, assets, "cpu")
        assert bf == int(ref[f"{name}_block_f"])
        for k, a in zip(INPUTS, args):
            np.testing.assert_array_equal(a.numpy(), ref[f"{name}_{k}"],
                                          err_msg=f"{name} {k}")


def split_kernels(args, bf, data, k7, k3):
    """K7 + K3 on K8's rays: K7 through its own schedule (act-blind mask,
    as gbuffer_perray builds it), K3 through anyhit_rays' schedule."""
    planes = args[2:15]
    d, o, sd, so, act = (planes[0:3], planes[3:6], planes[6:9],
                         planes[9:12], planes[12])
    bounds = tile_ray_bounds(*o, *d, 1024)
    mask, nw = P._mask_words(data, "cull", bounds, bf)
    tlb, order, texit = P._vmem_sched(data, mask, nw, bounds, *o, *d, bf)
    t, face = k7(tlb, order, *d, *o, texit, args[15], args[16], block_f=bf)
    mask, nw = P._mask_words(data, "cull", tile_ray_bounds(*so, *sd, 1024),
                             bf)
    tlb, order, texit = P._vmem_sched(
        data, mask, nw, tile_ray_bounds(*so, *sd, 1024, act > 0), *so, *sd,
        bf)
    occ = k3(tlb, order, *sd, *so, act, texit, args[15], args[16],
             block_f=bf)
    return t, face, occ


@pytest.mark.parametrize("name", ["terrain_cull", "box_cull"])
def test_plain_equals_k7_plus_k3(assets, name):
    args, bf, data = port_inputs(name, assets, "cpu")
    t, face, occ = extend_shadow_plain(*args, block_f=bf)
    t7, f7, o3 = split_kernels(args, bf, data, closest_hit_perray_plain,
                               anyhit_plain)
    assert torch.equal(t, t7) and torch.equal(face, f7)
    assert torch.equal(occ, o3)
    assert occ.sum() > 50 and torch.isfinite(t).sum() > 100


def test_extend_shadow_rejects_bad_inputs(ref):
    args, bf = case_inputs(ref, "terrain_cull")
    with pytest.raises(TypeError):
        extend_shadow(args[0].float(), *args[1:], block_f=bf)
    with pytest.raises(ValueError):
        extend_shadow(args[0][:-1], *args[1:], block_f=bf)
    with pytest.raises(ValueError):
        extend_shadow(*args, block_f=7)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_extend_shadow_cuda_matches_plain_and_split(name, assets,
                                                    cuda_device):
    args, bf, data = port_inputs(name, assets, cuda_device)
    before = launch_counts()["extend_shadow"]
    got = extend_shadow(*args, block_f=bf)
    torch.cuda.synchronize()
    assert launch_counts()["extend_shadow"] == before + 1
    want = extend_shadow_plain(*args, block_f=bf)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(got, split_kernels(args, bf, data, closest_hit_perray,
                                       anyhit)):
        assert torch.equal(g, w)
