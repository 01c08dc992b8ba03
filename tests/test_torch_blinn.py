"""PyTorch port: the Blinn-Phong specular power, and the gap between the
two ways the frames compute it.

The split frame's blinn_phong_planar takes torch's pow, the fused
frame's pow32 the JAX fused kernel's five-squaring chain. On 1M seeded
inputs, against the JAX package under the reference rounding rules
(test_torch_host.jax_reference): blinn_phong_planar's lambert equals
JAX's bit for bit and its specular is at most 1 ulp from XLA's pow;
pow32 equals fusedframe._pow32 bit for bit. The chain and pow differ by
far more than 1 ulp, which is why the fused and split frames agree
only after quantization (in both packages). Both flush denormal
results to zero, as the JAX package's arithmetic does.
"""

import numpy as np
import pytest
import torch

from rust_wgpu_raytracing_tpu_torch.ops.kernels.frame import pow32
from rust_wgpu_raytracing_tpu_torch.ops.megakernel import blinn_phong_planar
from rust_wgpu_raytracing_tpu_torch.ops.rounding import ftz
from test_torch_host import jax_reference

N = 1_000_000


def blinn_inputs(n=N, seed=17):
    rng = np.random.default_rng(seed)

    def unit(v):
        return (v / np.linalg.norm(v, axis=0, keepdims=True)).astype(
            np.float32)

    nrm = unit(rng.normal(size=(3, n)))
    d = unit(rng.normal(size=(3, n)))
    light = rng.normal(size=(3, n)).astype(np.float32)
    x = rng.uniform(0, 1, n).astype(np.float32)
    return nrm, d, light, x


def jax_blinn(out):
    import jax

    from rust_wgpu_raytracing_tpu.ops.fusedframe import _pow32
    from rust_wgpu_raytracing_tpu.ops.megakernel import \
        blinn_phong_planar as jblinn

    nrm, d, light, x = blinn_inputs()
    lam, spec = jax.jit(lambda n, d, l: jblinn(*n, *d, tuple(l)))(
        nrm, d, light)
    np.savez(out, lam=np.asarray(lam), spec=np.asarray(spec),
             pow32=np.asarray(jax.jit(_pow32)(x)),
             pow=np.asarray(jax.jit(lambda v: v ** 32.0)(x)))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return jax_reference("test_torch_blinn", "jax_blinn",
                         tmp_path_factory.mktemp("blinn"))


def ulps(a, b):
    """Per-element distance in f32 ulps of two non-negative arrays."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_blinn_phong_planar_matches_jax(ref):
    nrm, d, light, _ = blinn_inputs()
    t = [torch.from_numpy(a) for a in (*nrm, *d)]
    lam, spec = blinn_phong_planar(*t, tuple(torch.from_numpy(light)))
    np.testing.assert_array_equal(lam.numpy(), ref["lam"])
    gap = ulps(spec.numpy(), ref["spec"])
    assert gap.max() <= 1, f"spec {gap.max()} ulp from XLA's pow"
    assert (ref["spec"] == 0).any() and (ref["spec"] > 0).any()


def test_pow32_matches_jax_chain(ref):
    x = torch.from_numpy(blinn_inputs()[3])
    np.testing.assert_array_equal(pow32(x).numpy(), ref["pow32"])
    # denormal results flush to zero, as in the JAX package
    assert (ref["pow32"] == 0).mean() > 0.05


def test_pow32_differs_from_pow(ref):
    """The gap that keeps the unquantized fused and split frames apart."""
    gap = ulps(ref["pow32"], ref["pow"])
    assert (gap > 1).mean() > 0.5
    assert gap.max() > 10
    x = torch.from_numpy(blinn_inputs()[3])
    port_gap = ulps(pow32(x).numpy(), ftz(x ** 32.0).numpy())
    assert port_gap.max() > 10
