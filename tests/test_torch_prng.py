"""PyTorch port: the path tracer's replica of jax.random (partitionable
threefry-2x32) against jax.random and the JAX package's uniform_at.

Keys (PRNGKey, fold_in, split) are u32 pairs computed on the host; the
draws (uniform, uniform_at) are device tensors. Every key word and
every drawn float must be BITWISE equal to JAX's.
"""

import numpy as np
import pytest
import torch

from rust_wgpu_raytracing_tpu_torch.ops import pathtrace as P
from test_torch_host import cuda_device, jax_reference  # noqa: F401

SEEDS = (0, 7, 123456, 2**31 - 1)
SIZES = (8, 129, 4096)
FOLDS = (0, 1, 5, 2**32 - 1)
PICK = (3, 3, 0, 5, 7, 2)


def jax_prng(out):
    import jax
    import jax.numpy as jnp

    from rust_wgpu_raytracing_tpu.ops.pathtrace import uniform_at

    res = {}
    for seed in SEEDS:
        key = jax.random.PRNGKey(seed)
        res[f"key_{seed}"] = key
        for d in FOLDS:
            res[f"fold_{seed}_{d}"] = jax.random.fold_in(key, d)
        res[f"split_{seed}"] = jax.random.split(key)
        res[f"split3_{seed}"] = jax.random.split(key, 3)
        sub = jax.random.fold_in(key, 5)
        for n in SIZES:
            res[f"uniform_{seed}_{n}"] = jax.random.uniform(sub, (n,))
            ids = jnp.asarray([i % n for i in PICK] + [n - 1], jnp.int32)
            res[f"at_{seed}_{n}"] = uniform_at(sub, ids)
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return jax_reference("test_torch_prng", "jax_prng",
                         tmp_path_factory.mktemp("prng"))


def bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_match_jax(ref, seed):
    key = P.PRNGKey(seed)
    assert key == tuple(int(v) for v in ref[f"key_{seed}"])
    for d in FOLDS:
        assert P.fold_in(key, d) == tuple(
            int(v) for v in ref[f"fold_{seed}_{d}"])
    assert P.split(key) == [tuple(int(v) for v in k)
                            for k in ref[f"split_{seed}"]]
    assert P.split(key, 3) == [tuple(int(v) for v in k)
                               for k in ref[f"split3_{seed}"]]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", SIZES)
def test_uniform_matches_jax(ref, seed, n):
    sub = P.fold_in(P.PRNGKey(seed), 5)
    got = P.uniform(sub, n, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(bits(got), bits(ref[f"uniform_{seed}_{n}"]))
    ids = torch.tensor([i % n for i in PICK] + [n - 1], dtype=torch.int32)
    np.testing.assert_array_equal(bits(P.uniform_at(sub, ids)),
                                  bits(ref[f"at_{seed}_{n}"]))


def test_uniform_range_and_lane_independence():
    key = P.fold_in(P.PRNGKey(3), 1)
    full = P.uniform(key, 5000, device="cpu")
    assert float(full.min()) >= 0.0 and float(full.max()) < 1.0
    ids = torch.tensor([4999, 0, 17, 17], dtype=torch.int64)
    assert torch.equal(P.uniform_at(key, ids), full[ids])


def test_threefry_host_equals_device():
    """The same round function on Python ints (keys) and on int64 lanes
    (draws)."""
    k = P.PRNGKey(99)
    lanes = torch.tensor([0, 1, 2**31, 2**32 - 1], dtype=torch.int64)
    x0, x1 = P._threefry2x32(k[0], k[1], 0, lanes)
    for i, lane in enumerate(lanes.tolist()):
        assert (int(x0[i]), int(x1[i])) == P._threefry2x32(k[0], k[1], 0,
                                                           lane)


@pytest.mark.gpu
def test_uniform_cuda_matches_cpu(cuda_device):
    key = P.fold_in(P.PRNGKey(7), 2)
    got = P.uniform(key, 100_000, device=cuda_device)
    assert torch.equal(got.cpu(), P.uniform(key, 100_000, device="cpu"))
