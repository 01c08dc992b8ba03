"""PyTorch port: kernel K2 (bilinear texture mix + Blinn-Phong combine)
against the JAX package's _texshade_kernel run in interpret mode.

The taps are random u16 from a seeded generator (a solid texture would
make the mix trivial), including 0 and 65535; weights in [0, 1), Blinn
factors and colours as the frame produces them. All three output planes
must be EXACTLY equal (0 ulp).
"""

import numpy as np
import pytest
import torch

from rust_wgpu_raytracing_tpu_torch.ops.kernels import (launch_counts,
                                                        texshade,
                                                        texshade_plain)
from test_torch_host import cuda_device, jax_reference  # noqa: F401

PLANES = ("fx", "fy", "lam", "spec", "ar", "ag", "ab", "sr", "sg", "sb")
N = 5000


def texshade_inputs(n=N, seed=9):
    rng = np.random.default_rng(seed)
    taps = rng.integers(0, 65536, (12, n), dtype=np.uint16)
    taps[:, :4] = [0, 65535, 1, 32768]
    planes = {
        "fx": rng.uniform(0, 1, n), "fy": rng.uniform(0, 1, n),
        "lam": rng.uniform(0, 1, n), "spec": rng.uniform(0, 1, n) ** 8,
        "ar": rng.uniform(0, 0.2, n), "ag": rng.uniform(0, 0.2, n),
        "ab": rng.uniform(0, 0.2, n), "sr": rng.uniform(0, 1, n),
        "sg": rng.uniform(0, 1, n), "sb": rng.uniform(0, 1, n),
    }
    planes["fx"][:8] = 0.0  # clamp-to-edge rows: weight exactly zero
    return taps, {k: v.astype(np.float32) for k, v in planes.items()}


def jax_texshade(out):
    import rust_wgpu_raytracing_tpu.ops.megakernel as J

    taps, planes = texshade_inputs()
    pr, pg, pb = J._texshade_pallas(taps, *(planes[k] for k in PLANES),
                                    interpret=True)
    np.savez(out, pr=np.asarray(pr), pg=np.asarray(pg), pb=np.asarray(pb))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return jax_reference("test_torch_texshade", "jax_texshade",
                         tmp_path_factory.mktemp("k2"))


def port_inputs(device="cpu"):
    taps, planes = texshade_inputs()
    return ([torch.from_numpy(taps.view(np.int16)).to(device)]
            + [torch.from_numpy(planes[k]).to(device) for k in PLANES])


def test_texshade_matches_jax_kernel(ref):
    before = launch_counts()["texshade"]
    out = texshade(*port_inputs())
    assert launch_counts()["texshade"] == before  # CPU tensors: plain version
    for got, k in zip(out, ("pr", "pg", "pb")):
        np.testing.assert_array_equal(got.numpy(), ref[k])


def test_texshade_taps_are_unsigned():
    """A tap of 65535 is full white, not -1: the int16 view is widened
    as unsigned."""
    taps = torch.full((12, 4), -1, dtype=torch.int16)  # u16 65535
    one, zero = torch.ones(4), torch.zeros(4)
    pr, _, _ = texshade(taps, zero, zero, one, zero, zero, zero, zero,
                        zero, zero, zero)
    assert torch.equal(pr, one)


def test_texshade_rejects_bad_inputs():
    args = port_inputs()
    with pytest.raises(TypeError):
        texshade(args[0].to(torch.int32), *args[1:])
    with pytest.raises(ValueError):
        texshade(args[0][:, :10], *args[1:])


@pytest.mark.gpu
def test_texshade_cuda_matches_plain(cuda_device):
    args = port_inputs(cuda_device)
    before = launch_counts()["texshade"]
    out = texshade(*args)
    torch.cuda.synchronize()
    assert launch_counts()["texshade"] == before + 1
    for a, b in zip(out, texshade_plain(*args)):
        assert torch.equal(a, b)


def shade_planes(n, device, seed=25):
    """Seeded Blinn factors and colours for texshade, on `device`."""
    rng = np.random.default_rng(seed)
    planes = [rng.uniform(0, 1, n), rng.uniform(0, 1, n) ** 8]
    planes += [rng.uniform(0, 0.2, n) for _ in range(3)]
    planes += [rng.uniform(0, 1, n) for _ in range(3)]
    return [torch.from_numpy(p.astype(np.float32)).to(device)
            for p in planes]


@pytest.mark.gpu
def test_texel_offsets_past_2_24_cuda(cuda_device):
    """Texels past 2^24 in a ~400 MB pool (odd base offsets no f32 holds):
    the glue's i32 addresses pick each ray's own taps, and K2 and K6 on
    them equal their plain versions."""
    from rust_wgpu_raytracing_tpu_torch.ops.kernels import (texfilter,
                                                            texfilter_plain)
    from rust_wgpu_raytracing_tpu_torch.testing.texels import (
        F32_EXACT, far_texel_case)
    from rust_wgpu_raytracing_tpu_torch.ops.megakernel import \
        gather_packed_taps

    pool, base, hh, ww, u, v, want = far_texel_case(cuda_device)
    assert bool((base > F32_EXACT).all()) and bool(
        (base.float().long() != base.long()).all())
    taps, fx, fy = gather_packed_taps(pool, base, hh, ww, u, v)
    assert torch.equal(taps.cpu(), want)
    before = launch_counts()
    got = texfilter(taps, fx, fy)
    shaded = texshade(taps, fx, fy, *shade_planes(fx.shape[0], cuda_device))
    torch.cuda.synchronize()
    after = launch_counts()
    assert (after["texfilter"], after["texshade"]) == (
        before["texfilter"] + 1, before["texshade"] + 1)
    for a, b in zip(got, texfilter_plain(taps, fx, fy)):
        assert torch.equal(a, b)
    for a, b in zip(shaded, texshade_plain(
            taps, fx, fy, *shade_planes(fx.shape[0], cuda_device))):
        assert torch.equal(a, b)
