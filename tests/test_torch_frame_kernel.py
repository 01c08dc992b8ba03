"""PyTorch port: kernel K4 (the fused frame kernel) against the JAX
package's _make_frame_kernel run in interpret mode.

The JAX side renders render_frame_fused (interpret=True) and records the
frame kernel's pallas_call arguments and outputs as the frame program
makes them; frame_plain then runs on exactly those arguments. Every
output plane must be equal BY VALUE (torch.equal semantics: the Pallas
kernel resolves the winner's attributes with a masked sum, which turns
-0.0 into +0.0; the port reads the winner face's row). Each branch runs:
no shadows, sched shadows, in-kernel shadows and normal mapping, on the
terrain (NaN padding faces) and on a textured, bump-mapped box. The
kernel's culled walks (testing/raycull.py frame_culled: per-ray boxes
in the sweep and the in-kernel shadow loop) are held to the same JAX
outputs. The CUDA kernel is checked against frame_plain on the card
(marked gpu), with the face blocks' boxes and without.
"""

import os

import numpy as np
import pytest
import torch

from rust_wgpu_raytracing_tpu_torch import config as pcfg
from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
from rust_wgpu_raytracing_tpu_torch.core.scene import Scene
from rust_wgpu_raytracing_tpu_torch.ops import megakernel as P
from rust_wgpu_raytracing_tpu_torch.ops import scenepacks as SP
from rust_wgpu_raytracing_tpu_torch.ops.kernels import (frame, frame_plain,
                                                        launch_counts)
from rust_wgpu_raytracing_tpu_torch.ops.kernels.frame import N_OUT
from rust_wgpu_raytracing_tpu_torch.ops.traverse import tile_ray_bounds
from rust_wgpu_raytracing_tpu_torch.testing.raycull import frame_culled
from test_torch_host import (cuda_device, jax_config,  # noqa: F401
                             jax_reference, terrain_config, textured_config,
                             write_textured_assets)

SCENES = {
    "terrain": lambda: terrain_config(pcfg, width=96, height=64),
    "bump_box": lambda: textured_config(pcfg, bump=True),
}
# mode -> (shadows, normal_mapping, shadow_mode)
MODES = {"none": (False, False, "auto"), "sched": (True, False, "sched"),
         "inkernel": (True, False, "inkernel"), "nm": (False, True, "auto")}
CASES = [(s, m) for s in sorted(SCENES) for m in sorted(MODES)]
ARGS = ("tlb", "order", "const", "dx", "dy", "dz", "texit", "fpack",
        "oterm", "dc")


def jax_frame_kernel(out, assets):
    """Each case's frame-kernel arguments and outputs, captured inside
    the jitted JAX frame program."""
    import jax
    import jax.numpy as jnp

    import rust_wgpu_raytracing_tpu.ops.fusedframe as FF
    from rust_wgpu_raytracing_tpu.core.camera import Camera as JCamera
    from rust_wgpu_raytracing_tpu.core.scene import Scene as JScene

    os.environ["RWRT_ASSETS"] = assets
    pallas_call = FF.pl.pallas_call
    res = {}
    for scene, mode in CASES:
        cfg = jax_config(SCENES[scene]())
        rc = cfg.render
        data = JScene.build(cfg).data
        uni = jnp.asarray(JCamera.from_config(
            cfg.camera, rc.width / rc.height).uniforms().flat())
        shadows, nm, shadow_mode = MODES[mode]
        cap = {}

        def spy(kernel, **kw):
            call = pallas_call(kernel, **kw)
            if "_make_frame_kernel" not in kernel.__qualname__:
                return call

            def run(*args):
                cap["args"], cap["outs"] = args, call(*args)
                return cap["outs"]
            return run

        def traced(d, u):
            FF.pl.pallas_call = spy
            try:
                FF.render_frame_fused.__wrapped__(
                    d, u, width=rc.width, height=rc.height, shadows=shadows,
                    normal_mapping=nm, shadow_mode=shadow_mode,
                    interpret=True)
            finally:
                FF.pl.pallas_call = pallas_call
            return cap["args"], cap["outs"]

        args, outs = jax.jit(traced)(data, uni)
        key = f"{scene}_{mode}"
        for k, v in zip(ARGS, args):
            res[f"{key}_{k}"] = v[:, 0] if k in ("tlb", "order") else v
        res[f"{key}_outs"] = jnp.stack(outs)
        res[f"{key}_meta"] = np.array(
            [data.num_spheres, data.mat_ambient.shape[0],
             data.tri_p0.shape[0] // data.blk_lo.shape[0]], np.int32)
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("assets")
    write_textured_assets(str(root), bump=True)
    return str(root)


@pytest.fixture(scope="module")
def ref(tmp_path_factory, assets):
    return jax_reference("test_torch_frame_kernel", "jax_frame_kernel",
                         tmp_path_factory.mktemp("k4"), assets=assets)


def case_args(ref, scene, mode):
    key = f"{scene}_{mode}"
    args = [torch.from_numpy(ref[f"{key}_{k}"]) for k in ARGS]
    ns, nmat, bf = (int(v) for v in ref[f"{key}_meta"])
    return args, dict(ns=ns, nmat=nmat, block_f=bf, mode=mode)


@pytest.mark.parametrize("scene,mode", CASES)
def test_frame_plain_matches_jax_kernel(ref, scene, mode):
    args, kw = case_args(ref, scene, mode)
    before = launch_counts()["frame"]
    outs = frame(*args, **kw)
    assert launch_counts()["frame"] == before  # CPU tensors: plain version
    want = ref[f"{scene}_{mode}_outs"]
    assert len(outs) == want.shape[0] == N_OUT[mode]
    kind = want[1]
    assert (kind > 0).any() and (kind == 0).any()  # hits and misses
    if mode in ("sched", "inkernel"):
        assert want[2 if mode == "inkernel" else 15].any()
    for i, (got, w) in enumerate(zip(outs, want)):
        assert torch.equal(got, torch.from_numpy(w)), f"plane {i}"


@pytest.mark.parametrize("scene,mode", CASES)
def test_frame_culled_matches_jax_kernel(ref, assets, monkeypatch, scene,
                                         mode):
    """K4's culled walks (raycull.frame_culled) on the JAX-built arguments
    with the port's face-block boxes: every plane equal to the JAX
    kernel's by value."""
    monkeypatch.setenv("RWRT_ASSETS", assets)
    args, kw = case_args(ref, scene, mode)
    data = Scene.build(SCENES[scene]()).data
    boxes = SP.block_boxes(data, kw["block_f"])
    outs = frame_culled(*args, *boxes, **kw)
    want = ref[f"{scene}_{mode}_outs"]
    assert len(outs) == want.shape[0]
    for i, (got, w) in enumerate(zip(outs, want)):
        assert torch.equal(got, torch.from_numpy(w)), f"plane {i}"


def test_frame_rejects_bad_inputs(ref):
    args, kw = case_args(ref, "terrain", "sched")
    with pytest.raises(ValueError):
        frame(*args, **dict(kw, mode="bogus"))
    bad = list(args)
    bad[2] = bad[2][:-1]
    with pytest.raises(ValueError):
        frame(*bad, **kw)
    bad = list(args)
    bad[0] = bad[0].double()
    with pytest.raises(TypeError):
        frame(*bad, **kw)


def port_args(scene, mode, device):
    """K4's arguments for a case, built by the port's own frame glue."""
    cfg = SCENES[scene]()
    rc = cfg.render
    data = Scene.build(cfg).data.to(device)
    uni = Camera.from_config(cfg.camera, rc.width / rc.height).uniforms()
    origin = torch.from_numpy(uni.origin).to(device)
    th, tw, rh = P._pick_tile_shape(rc.width, rc.height)
    rays = P.raygen_planar_tiled(rc.width, rh, uni, device=device,
                                 total_height=rc.height, tile_h=th,
                                 tile_w=tw)
    x, y, z = (P._pad1(v, 1024) for v in rays)
    f = data.padded_faces
    bf = f // data.blk_lo.shape[0]
    o = (origin[0], origin[1], origin[2])
    bounds = tile_ray_bounds(*o, x, y, z, 1024)
    mask, nw = P._mask_words(data, "cull", bounds, bf)
    tlb, order, texit = P._vmem_sched(data, mask, nw, bounds, *o, x, y, z,
                                      bf)
    dc = torch.cat([data.tri_d[:, None], data.tri_c,
                    torch.zeros((f, 4), device=device)], dim=1)
    args = [tlb, order, SP.frame_const(data, origin), x, y, z, texit,
            SP.pack_face_columns(data), P.pack_origin_cols(data, origin), dc,
            *SP.block_boxes(data, bf)]
    return args, dict(ns=data.num_spheres, nmat=data.mat_ambient.shape[0],
                      block_f=bf, mode=mode)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_port_args_match_jax_args(ref, assets, monkeypatch, scene):
    """The card test builds K4's arguments with the port's glue; on the
    CPU they equal the JAX-built ones (the cluster order entries only
    decide the in-kernel shadow loop's visit order, and may differ on
    ties of the float projection)."""
    monkeypatch.setenv("RWRT_ASSETS", assets)
    args, kw = port_args(scene, "sched", "cpu")
    want, wkw = case_args(ref, scene, "sched")
    assert kw == wkw
    for k, a, w in zip(ARGS, args, want):
        if k == "const":
            nb = args[0].shape[1]
            assert torch.equal(a[:-nb], w[:-nb])
            assert sorted(a[-nb:].tolist()) == list(range(nb))
        else:
            assert torch.equal(a, w), k


@pytest.mark.gpu
@pytest.mark.parametrize("scene,mode", CASES)
def test_frame_cuda_matches_plain(assets, monkeypatch, scene, mode,
                                  cuda_device):
    monkeypatch.setenv("RWRT_ASSETS", assets)
    args, kw = port_args(scene, mode, cuda_device)
    want = frame_plain(*args, **kw)
    for a in (args, args[:10]):  # with the blocks' boxes and without
        before = launch_counts()["frame"]
        outs = frame(*a, **kw)
        torch.cuda.synchronize()
        assert launch_counts()["frame"] == before + 1
        for i, (x, y) in enumerate(zip(outs, want)):
            assert torch.equal(x, y), f"plane {i}"
