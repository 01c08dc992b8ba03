"""PyTorch port: it runs where JAX cannot be imported (the frame, the CLI,
the path tracer, the oracle, mip sampling, instancing, also through the
Renderer, the raster pipeline, the runtime shells, row slabs, the
sharded functions on two gloo ranks and the geometry-parallel Renderer),
and no file of the port imports JAX or the JAX package."""

import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "rust_wgpu_raytracing_tpu_torch"

_RENDER_WITHOUT_JAX = r"""
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
sys.modules["rust_wgpu_raytracing_tpu"] = None
sys.path.insert(0, {repo!r})
import numpy as np
import rust_wgpu_raytracing_tpu_torch as pt
from rust_wgpu_raytracing_tpu_torch.__main__ import main
from rust_wgpu_raytracing_tpu_torch.io.image_out import read_png

cfg = pt.SceneConfig(
    spheres=pt.config.reference_scene().spheres,
    meshes=(pt.MeshConfig(obj_path="builtin:terrain:23",
                          translation=(0.0, 0.0, -3.0),
                          light_direction=(6.0, -1.0, 1.0)),),
    camera=pt.CameraConfig(eye=(0.0, -2.0, -1.0), target=(0.0, 0.0, -3.2)),
    render=pt.RenderConfig(width=32, height=32, shadows=True))
r = pt.Renderer(cfg, device="cpu")
color, depth = r.render(block=True)
assert tuple(color.shape) == (32, 32, 3) and bool((depth < 1).any())
with open({cfg_path!r}, "w") as fh:
    fh.write(cfg.to_json())
assert main(["--shell", "headless", "--scene", {cfg_path!r}, "--width", "32",
             "--height", "24",
             "--shadows", "--frames", "2", "--device", "cpu",
             "--out", {png!r}]) == 0
assert read_png({png!r}).shape == (24, 32, 3)
import dataclasses as dc
pt_cfg = dc.replace(cfg, render=dc.replace(cfg.render, pt_bounces=2,
                                           pt_spp=2))
r = pt.Renderer(pt_cfg, device="cpu")
for _ in range(3):
    color, _ = r.render(block=True)
assert r.spp_done == 2 and bool(np.isfinite(color.numpy()).all())
assert float(color.sum()) > 0
big = dc.replace(cfg, meshes=(dc.replace(cfg.meshes[0],
                                         obj_path="builtin:terrain:92"),),
                 render=dc.replace(cfg.render, accel="bvh"))
rb = pt.Renderer(big, device="cpu")
color, depth = rb.render(block=True)
assert rb.data.padded_faces > 16384 and bool((depth < 1).any())
ro = pt.Renderer(cfg, backend="oracle", device="cpu")
color, depth = ro.render(block=True)
assert tuple(color.shape) == (32, 32, 3) and bool((depth < 1).any())
rm = pt.Renderer(dc.replace(cfg, render=dc.replace(cfg.render, mip=True)),
                 device="cpu")
color, depth = rm.render(block=True)
assert rm.variant_chosen == "split" and bool((depth < 1).any())
from rust_wgpu_raytracing_tpu_torch.ops.traverse import bvh_walk_mask_words
from rust_wgpu_raytracing_tpu_torch.ops.instances import (InstancedScene,
                                                          grid_transforms)
from rust_wgpu_raytracing_tpu_torch.ops.megakernel import render_megakernel
inst = InstancedScene.from_config(pt.MeshConfig(obj_path="builtin:cube"), 4,
                                  device="cpu")
data = inst.instantiate(grid_transforms(4, z=-6.0, angle=0.3))
uni = pt.Camera.from_config(pt.CameraConfig(eye=(0.3, -0.5, -1.5),
                                            target=(0.0, 0.0, -6.0)),
                            1.0).uniforms().flat()
color, depth = render_megakernel(data, uni, width=32, height=32)
assert bool((depth < 1).any())
ri = pt.Renderer(pt.SceneConfig(
    meshes=(pt.MeshConfig(obj_path="builtin:cube"),),
    camera=pt.CameraConfig(eye=(0.3, -0.5, -1.5), target=(0.0, 0.0, -6.0)),
    render=pt.RenderConfig(width=32, height=32, accel="bvh"),
    instances=pt.InstancesConfig(count=4)), device="cpu")
ri.set_instance_transforms(grid_transforms(4, z=-6.0, angle=0.3))
assert bool((ri.render(block=True)[0] == color).all())
from rust_wgpu_raytracing_tpu_torch.ops import raster
enc = raster.RasterEncoder(24, 24, device="cpu")
mesh = raster.RasterMesh("tri", np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]],
                                         np.float32),
                         np.zeros((3, 2), np.float32),
                         np.zeros((3, 3), np.float32),
                         np.array([[0, 1, 2]], np.int32))
enc.draw_mesh(mesh, raster.RasterMaterial("m", np.ones((2, 2, 3),
                                                       np.float32)),
              np.eye(4, dtype=np.float32))
assert bool((enc.depth.data < 1).any())
from rust_wgpu_raytracing_tpu_torch.runtime.frame_loop import FrameLoop
from rust_wgpu_raytracing_tpu_torch.runtime.limits import default_limits
from rust_wgpu_raytracing_tpu_torch.runtime.server import RenderServer
from rust_wgpu_raytracing_tpu_torch.runtime.window import image_to_ppm
from rust_wgpu_raytracing_tpu_torch.io.checkpoint import (load_checkpoint,
                                                          save_checkpoint)
from rust_wgpu_raytracing_tpu_torch.utils.logging import log_frame_stats
loop = FrameLoop(pt.Renderer(cfg, device="cpu", limits=default_limits()))
srv = RenderServer(loop, port=0)
srv.serve_async()
loop.run(n_frames=2)
srv.shutdown()
save_checkpoint({ckpt!r}, loop.renderer)
assert load_checkpoint({ckpt!r}, device="cpu").frame_count == 2
uni = pt.Camera.from_config(cfg.camera, 1.0).uniforms().flat()
data = pt.Scene.build(cfg).data
whole = render_megakernel(data, uni, width=32, height=32, shadows=True)[0]
slabs = [render_megakernel(data, uni, width=32, height=16, shadows=True,
                           fused=fused, row0=r0, total_height=32)[0]
         for fused in (False, True) for r0 in (0, 16)]
import torch
assert torch.equal(torch.cat(slabs[:2]), whole)
assert torch.equal(torch.cat(slabs[2:]), whole)
from rust_wgpu_raytracing_tpu_torch.ops.pathtrace import (PRNGKey,
                                                          render_pathtrace)
assert bool(torch.isfinite(render_pathtrace(
    data, uni, PRNGKey(1), width=32, height=16, bounces=1, row0=16,
    total_height=32)).all())
from rust_wgpu_raytracing_tpu_torch.parallel.launch import spawn
from rust_wgpu_raytracing_tpu_torch.parallel.tile_sharding import \
    dryrun_multichip
spawn(dryrun_multichip, 2, 2, device="cpu")
rg = pt.Renderer(cfg, backend="megakernel_gp", device="cpu")
assert torch.equal(rg.render()[0], whole)
assert not [m for m, mod in sys.modules.items() if mod is not None and (
    m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
    or m.split(".")[0] == "rust_wgpu_raytracing_tpu")]
print("rendered without jax")
"""


def test_port_renders_without_jax(tmp_path):
    code = _RENDER_WITHOUT_JAX.format(repo=str(REPO),
                                      cfg_path=str(tmp_path / "scene.json"),
                                      png=str(tmp_path / "frame.png"),
                                      ckpt=str(tmp_path / "run.ckpt"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "rendered without jax" in res.stdout


def test_no_port_file_imports_jax():
    pattern = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+rust_wgpu_raytracing_tpu\b"
        r"(?!_torch)|from\s+rust_wgpu_raytracing_tpu(\.|\s)(?!.*_torch))",
        re.MULTILINE)
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    # the modules of the streamed path and of accel="bvh" are covered
    for mod in ("ops/hier_cull.py", "ops/kernels/hier_cull.py",
                "ops/kernels/stream_sweep.py", "ops/traverse.py",
                "ops/oracle.py", "ops/raygen.py", "ops/intersect.py",
                "ops/miptex.py", "ops/bvh.py", "models/triangle.py",
                "ops/instances.py", "ops/raster.py", "runtime/frame_loop.py",
                "runtime/renderer.py", "config.py",
                "runtime/limits.py", "runtime/server.py", "runtime/window.py",
                "io/checkpoint.py", "utils/logging.py",
                "parallel/__init__.py", "parallel/mesh.py",
                "parallel/launch.py", "parallel/tile_sharding.py",
                "parallel/geometry_sharding.py"):
        assert PORT / mod in files, mod
    offenders = [str(f.relative_to(REPO)) for f in files
                 if pattern.search(f.read_text())]
    assert offenders == []
