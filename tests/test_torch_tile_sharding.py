"""PyTorch port: row-slab and sample sharding and the sharded train step
(parallel/tile_sharding.py) on gloo CPU ranks, against the JAX package.

The cases of the JAX package's TestRenderSharded, TestTrainStep,
TestShardedMegakernel, TestShardedPathtrace and TestShardedStreaming
(tests/test_sharding.py) on tests/test_sharding.py's small scene (a
sphere and builtin:cube at 64x32), four ranks in one launch
(parallel.launch.spawn), and dryrun_multichip on eight. The JAX side runs
its sharded functions on meshes of the same shape (make_render_mesh(4,
sp)), once, in a fresh interpreter with 8 virtual CPU devices and XLA
capped below FMA (test_torch_host.jax_reference), while the ranks run.

Bars against JAX's sharded results:
- render_sharded (2 samples a rank): bit for bit with sp = 1 and sp = 2
  (a sum of two is order-free); with sp = 4 within 2.4e-7, two ulps of
  1.0 (gloo's reduction order is not XLA's psum order; measured here:
  1.19e-7, on colours in [0, 1.2]); with
  one sample and sp = 1 (no jitter) it draws the oracle's frame;
- render_sharded_megakernel, split, fused and streamed: depth and the
  quantized frame bit for bit, unquantized colour within 1 ulp (the
  split frame's pow);
- render_pathtrace_sharded (bounces=1): within 1e-6, at most 1% of
  subpixels not bitwise (test_torch_pathtrace's bar: torch's cos/sin);
  and bit for bit the port's own per-slab single-device composition;
- the train step: the loss of each of 5 steps and the final parameters
  within rtol 1e-5 of the same steps taken with JAX's value_and_grad of
  each rank's loss, mean-reduced over the ranks (autograd and XLA sum
  the image's terms in other orders); the loss descends. JAX's own
  sharded step moves the parameters by n times that mean gradient:
  shard_map transposes the replicated parameters' broadcast into a sum
  over the mesh before the step's pmean, so its per-rank gradient is
  already the ranks' sum. Its first update is held at n times the
  port's.
"""

import concurrent.futures
import contextlib

import numpy as np
import pytest
import torch

from rust_wgpu_raytracing_tpu_torch import config as pcfg
from rust_wgpu_raytracing_tpu_torch.core import scene as pscene
from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
from rust_wgpu_raytracing_tpu_torch.core.scene import (Scene,
                                                       params_from_numpy,
                                                       params_to_numpy)
from rust_wgpu_raytracing_tpu_torch.ops import megakernel as pmk
from rust_wgpu_raytracing_tpu_torch.ops import pathtrace as ppt
from rust_wgpu_raytracing_tpu_torch.parallel import tile_sharding as T
from rust_wgpu_raytracing_tpu_torch.parallel.launch import spawn
from test_torch_host import jax_reference, sphere_cube_config, stream_faces

W, H = 64, 32
PT_KEY = 7
STEPS, LR = 5, 8.0
STREAM_LOW = 1024  # builtin:terrain:47 pads to 5,120 faces and streams
# name: (function, sp, options)
CASES = {
    "sharded_sp1": ("render_sharded", 1, dict(spp=2)),
    "sharded_sp2": ("render_sharded", 2, dict(spp=2, quantize=False)),
    "sharded_sp4": ("render_sharded", 4, dict(spp=2, quantize=False)),
    "mk_split": ("render_sharded_megakernel", 1,
                 dict(shadows=True, fused=False)),
    "mk_split_f32": ("render_sharded_megakernel", 1,
                     dict(shadows=True, quantize=False, fused=False)),
    "mk_fused": ("render_sharded_megakernel", 1,
                 dict(shadows=True, fused=True)),
    "mk_streamed": ("render_sharded_megakernel", 1, dict(quantize=False)),
    "pt": ("render_pathtrace_sharded", 2, dict(bounces=1)),
}


def small_scene(cfg_mod, streamed=False):
    if streamed:
        return cfg_mod.SceneConfig(
            meshes=(cfg_mod.MeshConfig(obj_path="builtin:terrain:47",
                                       translation=(0.0, 0.0, -3.0)),),
            camera=cfg_mod.CameraConfig(eye=(0.0, -2.0, -1.0),
                                        target=(0.0, 0.0, -3.2)),
            render=cfg_mod.RenderConfig(width=W, height=H))
    return sphere_cube_config(cfg_mod, W, H)


def low_stream(name, *modules):
    return (stream_faces(STREAM_LOW, *modules) if name == "mk_streamed"
            else contextlib.nullcontext())


def jax_tile_sharding(out):
    import jax
    import jax.numpy as jnp

    from rust_wgpu_raytracing_tpu import config as jcfg
    from rust_wgpu_raytracing_tpu.core import scene as jscene
    from rust_wgpu_raytracing_tpu.core.camera import Camera as JCamera
    from rust_wgpu_raytracing_tpu.core.scene import Scene as JScene
    from rust_wgpu_raytracing_tpu.ops import megakernel as jmk
    from rust_wgpu_raytracing_tpu.ops.oracle import render_oracle
    from rust_wgpu_raytracing_tpu.parallel import tile_sharding as JT

    res = {}
    for name, (fn, sp, opts) in CASES.items():
        with low_stream(name, jscene, jmk):
            cfg = small_scene(jcfg, streamed=name == "mk_streamed")
            data = JScene.build(cfg).data
            uni = JCamera.from_config(cfg.camera, W / H).uniforms().flat()
            mesh = JT.make_render_mesh(4, sp=sp)
            args = ((jax.random.PRNGKey(PT_KEY),) if fn.startswith(
                "render_pathtrace") else ())
            res[name] = getattr(JT, fn)(data, uni, *args, mesh, width=W,
                                        height=H, **opts)
            if name.startswith("mk_") and opts.get("quantize") is False:
                from rust_wgpu_raytracing_tpu.ops.shade import \
                    quantize_rgba8

                res[f"{name}.u8"] = quantize_rgba8(jnp.asarray(res[name]))
    cfg = small_scene(jcfg)
    data = JScene.build(cfg).data
    uni = JCamera.from_config(cfg.camera, W / H).uniforms().flat()
    target, _ = render_oracle(data, uni, width=W, height=H, quantize=False)
    params = {"sphere_color": data.sphere_color + 0.4,
              "mat_ambient": data.mat_ambient + 0.2}
    res["train.params0.sphere_color"] = params["sphere_color"]
    res["train.params0.mat_ambient"] = params["mat_ambient"]
    step = JT.make_train_step(data, JT.make_render_mesh(4, sp=2), width=W,
                              height=H, lr=LR)
    first, _ = step(params, data, uni, jnp.asarray(target), 0)
    for k, v in first.items():
        res[f"train.sharded_step1.{k}"] = v

    # the steps by hand: value_and_grad of each (dp, sp) rank's loss, the
    # loss and gradients mean-reduced over the 4 ranks
    dp, sp, rows = 2, 2, H // 2

    def loss_local(p, row0, key):
        jit_xy = (jax.random.uniform(key, (2,)) - 0.5) * jnp.asarray(
            [2.0 / W, 2.0 / H], jnp.float32)
        c, _ = JT._render_rows(JT._apply_params(data, p), uni, W, H, row0,
                               rows, jitter=jit_xy)
        t = jnp.asarray(target)[row0:row0 + rows]
        return jnp.mean((c - t) ** 2)

    vg = jax.jit(jax.value_and_grad(loss_local), static_argnums=1)
    losses = []
    for i in range(STEPS):
        parts = [vg(params, dpi * rows, jax.random.fold_in(
            jax.random.PRNGKey(0), i * 977 + spi))
            for dpi in range(dp) for spi in range(sp)]
        losses.append(float(sum(l for l, _ in parts) / len(parts)))
        params = {k: params[k] - LR * (sum(g[k] for _, g in parts)
                                       / len(parts)) for k in params}
    res["train.losses"] = np.asarray(losses, np.float32)
    for k, v in params.items():
        res[f"train.params.{k}"] = v
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})


def rank_cases():
    """On each of 4 ranks: every case, the port's single-device
    counterparts (rank 0 returns them) and 5 train steps."""
    res = {}
    for name, (fn, sp, opts) in CASES.items():
        with low_stream(name, pscene, pmk):
            cfg = small_scene(pcfg, streamed=name == "mk_streamed")
            data = Scene.build(cfg).data
            uni = Camera.from_config(cfg.camera, W / H).uniforms().flat()
            mesh = T.make_render_mesh(sp=sp, device="cpu")
            if fn == "render_pathtrace_sharded":
                key = ppt.PRNGKey(PT_KEY)
                res[name] = T.render_pathtrace_sharded(
                    data, uni, key, mesh, width=W, height=H, **opts)
                dp, rows = mesh.size("dp"), H // mesh.size("dp")
                slabs = []
                for dpi in range(dp):
                    acc = sum(ppt.render_pathtrace(
                        data, uni, ppt.fold_in(ppt.fold_in(key, spi), dpi),
                        width=W, height=rows, row0=dpi * rows,
                        total_height=H, **opts) for spi in range(sp))
                    slabs.append(acc * 0.5)
                res[f"{name}.single"] = torch.cat(slabs)
                continue
            res[name] = getattr(T, fn)(data, uni, mesh, width=W, height=H,
                                       **opts)
            if fn == "render_sharded_megakernel":
                kw = {k: v for k, v in opts.items() if k != "fused"}
                res[f"{name}.single"] = pmk.render_megakernel(
                    data, uni, width=W, height=H, fused=opts.get("fused"),
                    **kw)[0]
    cfg = small_scene(pcfg)
    data = Scene.build(cfg).data
    uni = Camera.from_config(cfg.camera, W / H).uniforms().flat()
    from rust_wgpu_raytracing_tpu_torch.ops.oracle import render_oracle

    res["oracle"] = render_oracle(data, uni, width=W, height=H)[0]
    res["sharded_nojitter"] = T.render_sharded(
        data, uni, T.make_render_mesh(device="cpu"), width=W, height=H)
    target, _ = render_oracle(data, uni, width=W, height=H, quantize=False)
    params = {"sphere_color": data.sphere_color + 0.4,
              "mat_ambient": data.mat_ambient + 0.2}
    res["train.params0"] = params_to_numpy(params)
    step = T.make_train_step(data, T.make_render_mesh(sp=2, device="cpu"),
                             width=W, height=H, lr=LR)
    losses = []
    for i in range(STEPS):
        params, loss = step(params, data, uni, target, i)
        losses.append(float(loss))
        if i == 0:
            res["train.step1"] = params_to_numpy(params)
    res["train.losses"] = np.asarray(losses, np.float32)
    res["train.params"] = params_to_numpy(params)
    return res


def rank_dryrun(n):
    T.dryrun_multichip(n, device="cpu")
    return n


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's results, the 4 ranks' results): the JAX interpreter runs in
    a thread while the ranks run."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(jax_reference, "test_torch_tile_sharding",
                              "jax_tile_sharding",
                              tmp_path_factory.mktemp("tile"),
                              host_devices=8)
        port = spawn(rank_cases, 4)
        return jax_run.result(), port


@pytest.fixture(scope="module")
def ref(runs):
    return runs[0]


@pytest.fixture(scope="module")
def port(runs):
    return runs[1]


def bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def ulps(a, b):
    return int(np.abs(bits(a).astype(np.int64) - bits(b)).max())


@pytest.mark.parametrize("name", ["sharded_sp1", "sharded_sp2",
                                  "sharded_sp4"])
def test_render_sharded_matches_jax(ref, port, name):
    got = port[name]
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    if name == "sharded_sp4":
        np.testing.assert_allclose(got, ref[name], rtol=0, atol=2.4e-7)
    else:
        np.testing.assert_array_equal(bits(got), bits(ref[name]))
    if name == "sharded_sp1":  # sp * spp == 1, no jitter: the oracle
        np.testing.assert_array_equal(bits(port["sharded_nojitter"]),
                                      bits(port["oracle"]))


@pytest.mark.parametrize("name", ["mk_split", "mk_split_f32", "mk_fused",
                                  "mk_streamed"])
def test_render_sharded_megakernel_matches_jax(ref, port, name):
    got = port[name]
    np.testing.assert_array_equal(bits(got), bits(port[f"{name}.single"]))
    if f"{name}.u8" in ref:
        from rust_wgpu_raytracing_tpu_torch.ops.shade import quantize_rgba8

        assert ulps(got, ref[name]) <= 1
        np.testing.assert_array_equal(
            bits(quantize_rgba8(torch.from_numpy(got))),
            bits(ref[f"{name}.u8"]))
    else:
        np.testing.assert_array_equal(bits(got), bits(ref[name]))
    if name == "mk_fused":  # the fused frame takes the same slab viewport
        np.testing.assert_array_equal(got, port["mk_split"])


def test_render_pathtrace_sharded_matches_jax(ref, port):
    got = port["pt"]
    assert got.sum() > 0 and np.isfinite(got).all()
    np.testing.assert_array_equal(bits(got), bits(port["pt.single"]))
    np.testing.assert_allclose(got, ref["pt"], rtol=0, atol=1e-6)
    assert (got != ref["pt"]).mean() <= 0.01


def test_train_step_matches_jax_value_and_grad(ref, port):
    """5 steps from the same perturbed parameters (carried across with
    the scene bridge's params_to_numpy): the losses and the parameters
    after them match JAX's value_and_grad steps, and the loss descends;
    JAX's sharded step moves the parameters 4 times as far (module
    docstring)."""
    for k in ("sphere_color", "mat_ambient"):
        np.testing.assert_array_equal(port["train.params0"][k],
                                      ref[f"train.params0.{k}"])
    losses = port["train.losses"]
    np.testing.assert_allclose(losses, ref["train.losses"], rtol=1e-5)
    assert losses[-1] < losses[0]
    for k in ("sphere_color", "mat_ambient"):
        np.testing.assert_allclose(port["train.params"][k],
                                   ref[f"train.params.{k}"], rtol=1e-5,
                                   atol=1e-6)
        p0 = ref[f"train.params0.{k}"]
        np.testing.assert_allclose(ref[f"train.sharded_step1.{k}"] - p0,
                                   4 * (port["train.step1"][k] - p0),
                                   rtol=1e-4, atol=1e-7)


def test_params_bridge_round_trip():
    p = params_from_numpy({"sphere_color": np.ones((2, 3)),
                           "mat_ambient": np.zeros((1, 3)), "x": 1})
    assert set(p) == {"sphere_color", "mat_ambient"}
    assert p["sphere_color"].dtype == torch.float32
    back = params_to_numpy(p)
    np.testing.assert_array_equal(back["sphere_color"], np.ones((2, 3)))


def test_dryrun_multichip_on_8_ranks():
    assert spawn(rank_dryrun, 8, 8) == 8
