"""PyTorch port: kernel K3 (shadow any-hit) against the JAX package's
_make_anyhit_kernel run in interpret mode.

Both sides get the same schedule, ray and origin planes, activity plane,
face pack and plane constants (computed by JAX, carried across as
NumPy); the occlusion must be EXACTLY equal. The shadow wavefront is
the frame's kind: origins on and above the terrain toward the light,
parked rays (origin 1e9, zero direction, inactive) mixed in.
"""

import numpy as np
import pytest
import torch

from rust_wgpu_raytracing_tpu_torch import config as pcfg
from rust_wgpu_raytracing_tpu_torch.core.scene import Scene
from rust_wgpu_raytracing_tpu_torch.ops import megakernel as P
from rust_wgpu_raytracing_tpu_torch.ops import scenepacks as SP
from rust_wgpu_raytracing_tpu_torch.ops.kernels import (anyhit, anyhit_plain,
                                                        launch_counts)
from rust_wgpu_raytracing_tpu_torch.ops.traverse import tile_ray_bounds
from test_torch_host import (cuda_device, jax_config,  # noqa: F401
                             jax_reference, terrain_config)

INPUTS = ("tlb", "order", "dx", "dy", "dz", "ox", "oy", "oz", "act",
          "texit", "fpack", "dc")
CASES = {"cull": ("cull", 0.05), "brute": ("brute", 0.05),
         "wide_cull": ("cull", 0.6)}


def shadow_wavefront(spread, n=3000, seed=21):
    """(origins (3,n), directions (3,n), active (n,)) f32/bool."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32)
    z = (-3.0 + rng.uniform(-0.3, 0.35, n)).astype(np.float32)
    o = np.concatenate([xy, z[:, None]], axis=1)
    ldir = -np.array([6.0, -1.0, 1.0], np.float32)
    d = ldir / np.linalg.norm(ldir) + rng.normal(0, spread, (n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    act = rng.uniform(size=n) < 0.75
    o[~act] = 1e9
    d[~act] = 0.0
    return o.T.copy(), d.T.copy(), act


def jax_anyhit(out):
    import jax
    import jax.numpy as jnp

    import rust_wgpu_raytracing_tpu.ops.megakernel as J
    from rust_wgpu_raytracing_tpu.core.scene import Scene as JScene

    data = JScene.build(jax_config(terrain_config(pcfg))).data
    f = data.tri_p0.shape[0]
    bf = J._natural_block_f(data, f)
    res = {}
    for name, (accel, spread) in CASES.items():
        o, d, act = (jnp.asarray(a) for a in shadow_wavefront(spread))

        def inputs(dt, o, d, act, accel=accel):
            o = [J._pad1(v, 1024) for v in o]
            d = [J._pad1(v, 1024) for v in d]
            a = J._pad1(act.astype(jnp.float32), 1024)
            mask, nw = J._mask_words(dt, accel, *o, *d, 1024, bf, f)
            tlb, order, texit = J._vmem_sched(dt, mask, nw, *o, *d, 1024, f,
                                              bf, act=(a > 0))
            dc = jnp.concatenate([dt.tri_d[:, None], dt.tri_c,
                                  jnp.zeros((f, 4), jnp.float32)], axis=1)
            return (tlb[:, 0], order[:, 0], *d, *o, a, texit,
                    J.pack_face_columns(dt), dc)
        for k, v in zip(INPUTS, jax.jit(inputs)(data, tuple(o), tuple(d),
                                                act)):
            res[f"{name}_{k}"] = v
        res[f"{name}_occ"] = J.anyhit_pallas(data, o[0], o[1], o[2], d[0],
                                             d[1], d[2], act, interpret=True,
                                             accel=accel)
    res["block_f"] = np.int32(bf)
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return jax_reference("test_torch_anyhit", "jax_anyhit",
                         tmp_path_factory.mktemp("k3"))


def case_inputs(ref, name):
    return [torch.from_numpy(ref[f"{name}_{k}"]) for k in INPUTS]


@pytest.mark.parametrize("name", sorted(CASES))
def test_anyhit_matches_jax_kernel(ref, name):
    before = launch_counts()["anyhit"]
    occ = anyhit(*case_inputs(ref, name), block_f=int(ref["block_f"]))
    assert launch_counts()["anyhit"] == before  # CPU tensors: plain version
    want = ref[f"{name}_occ"]
    assert want.any() and not want.all()
    assert set(np.unique(occ.numpy())) <= {0.0, 1.0}
    np.testing.assert_array_equal(occ[:want.shape[0]].numpy() > 0, want)


@pytest.mark.parametrize("accel", ["cull", "brute"])
def test_port_anyhit_rays_matches_jax_kernel(ref, accel):
    """The port's own glue + K3 from the raw shadow wavefront."""
    data = Scene.build(terrain_config(pcfg)).data
    o, d, act = shadow_wavefront(CASES[accel][1])
    occ = P.anyhit_rays(data, *map(torch.from_numpy, o),
                        *map(torch.from_numpy, d), torch.from_numpy(act),
                        accel=accel)
    np.testing.assert_array_equal(occ.numpy(), ref[f"{accel}_occ"])


def test_inactive_rays_never_occluded(ref):
    args = case_inputs(ref, "cull")
    occ = anyhit(*args, block_f=int(ref["block_f"]))
    assert not occ[args[8] == 0].any()


def port_inputs(name, device):
    """K3's inputs for a case, built by the port's own glue on `device`."""
    accel, spread = CASES[name]
    data = Scene.build(terrain_config(pcfg)).data.to(device)
    f = data.padded_faces
    bf = P._natural_block_f(data, f)
    o, d, act = shadow_wavefront(spread)
    o = [P._pad1(torch.from_numpy(v).to(device), 1024) for v in o]
    d = [P._pad1(torch.from_numpy(v).to(device), 1024) for v in d]
    a = P._pad1(torch.from_numpy(act).to(device).float(), 1024)
    mask, nw = P._mask_words(data, accel, tile_ray_bounds(*o, *d, 1024), bf)
    tlb, order, texit = P._vmem_sched(
        data, mask, nw, tile_ray_bounds(*o, *d, 1024, a > 0), *o, *d, bf)
    dc = torch.cat([data.tri_d[:, None], data.tri_c,
                    torch.zeros((f, 4), device=device)], dim=1)
    return [tlb, order, *d, *o, a, texit, SP.pack_face_columns(data), dc], bf


def test_port_inputs_match_jax_inputs(ref):
    """The card test below builds its inputs with the port's glue; on
    the CPU they equal the JAX-built ones."""
    for name in CASES:
        args, bf = port_inputs(name, "cpu")
        assert bf == int(ref["block_f"])
        for k, a in zip(INPUTS, args):
            np.testing.assert_array_equal(a.numpy(), ref[f"{name}_{k}"])


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_anyhit_cuda_matches_plain(name, cuda_device):
    args, bf = port_inputs(name, cuda_device)
    before = launch_counts()["anyhit"]
    occ = anyhit(*args, block_f=bf)
    torch.cuda.synchronize()
    assert launch_counts()["anyhit"] == before + 1
    assert occ.any()
    assert torch.equal(occ, anyhit_plain(*args, block_f=bf))
