"""PyTorch port: kernel K6 (bilinear texture mix, the bump-map sample)
against the JAX package's _texfilter_kernel run in interpret mode.

Random u16 taps from a seeded generator, including 0 and 65535, and
weights in [0, 1] with exact zeros (the clamp-to-edge rows). All three
output planes must be EXACTLY equal (0 ulp).
"""

import numpy as np
import pytest
import torch

from rust_wgpu_raytracing_tpu_torch.ops.kernels import (launch_counts,
                                                        texfilter,
                                                        texfilter_plain)
from test_torch_host import cuda_device, jax_reference  # noqa: F401

N = 5000


def texfilter_inputs(n=N, seed=13):
    rng = np.random.default_rng(seed)
    taps = rng.integers(0, 65536, (12, n), dtype=np.uint16)
    taps[:, :4] = [0, 65535, 1, 32768]
    fx = rng.uniform(0, 1, n).astype(np.float32)
    fy = rng.uniform(0, 1, n).astype(np.float32)
    fx[:8] = 0.0
    fy[4:12] = 0.0
    return taps, fx, fy


def jax_texfilter(out):
    import rust_wgpu_raytracing_tpu.ops.megakernel as J

    r, g, b = J._texfilter_pallas(*texfilter_inputs(), interpret=True)
    np.savez(out, r=np.asarray(r), g=np.asarray(g), b=np.asarray(b))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return jax_reference("test_torch_texfilter", "jax_texfilter",
                         tmp_path_factory.mktemp("k6"))


def port_inputs(device="cpu"):
    taps, fx, fy = texfilter_inputs()
    return [torch.from_numpy(taps.view(np.int16)).to(device),
            torch.from_numpy(fx).to(device), torch.from_numpy(fy).to(device)]


def test_texfilter_matches_jax_kernel(ref):
    before = launch_counts()["texfilter"]
    out = texfilter(*port_inputs())
    assert launch_counts()["texfilter"] == before  # CPU tensors: plain version
    for got, k in zip(out, "rgb"):
        np.testing.assert_array_equal(got.numpy(), ref[k])


def test_texfilter_taps_are_unsigned():
    """A tap of 65535 is full white, not -1."""
    taps = torch.full((12, 4), -1, dtype=torch.int16)  # u16 65535
    w = torch.tensor([0.0, 0.25, 0.5, 1.0])
    for plane in texfilter(taps, w, w.flip(0)):
        assert torch.equal(plane, torch.ones(4))


def test_texfilter_rejects_bad_inputs():
    taps, fx, fy = port_inputs()
    with pytest.raises(TypeError):
        texfilter(taps.to(torch.int32), fx, fy)
    with pytest.raises(ValueError):
        texfilter(taps[:, :10], fx, fy)
    with pytest.raises(ValueError):
        texfilter(taps, fx, fy[:-1])


@pytest.mark.gpu
def test_texfilter_cuda_matches_plain(cuda_device):
    args = port_inputs(cuda_device)
    before = launch_counts()["texfilter"]
    out = texfilter(*args)
    torch.cuda.synchronize()
    assert launch_counts()["texfilter"] == before + 1
    for a, b in zip(out, texfilter_plain(*args)):
        assert torch.equal(a, b)
