"""The instances scene kind (rtbench/scenes/instances.py) on the CPU: a
tiny instanced cell reads `correct` true against the reference, and
false where the program keeps its first pose; the kind's reference
geometry; the two readers of the refit span."""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from rtbench import harness, run, trace
from rtbench.obs import Obs
from rtbench.scenes import heightfield
from rtbench.tests import tiny
from rust_wgpu_raytracing_tpu_torch.runtime.renderer import Renderer

CELL = "tiny-instances.still"
REAL = "instances64-terrain23.still-4k"


def tiny_instances_config(count=4, grid=12):
    cfg = harness.load_json(os.path.join(
        harness.HERE, "configs", "instances64-terrain23.json"))
    cfg["name"] = "tiny-instances"
    cfg["scene"]["mesh"].update(grid=grid, texture_size=16, texture_cells=4)
    cfg["scene"]["instances"]["count"] = count
    cfg["faces"] = 2 * (grid - 1) ** 2
    return cfg


def make_root(tmp, limit=0.0):
    """The tiny benchmark root with a tiny instanced cell: 4 copies of a
    12x12 heightfield, still camera, 64x48."""
    root = tiny.make_root(tmp)
    bench = harness.load_benchmark(root)
    bench["configs"].append({"name": "tiny-instances", "source": "a test",
                             "file": "rtbench/configs/tiny-instances.json",
                             "reduced": [], "why": "a CPU test"})
    bench["workloads"].append({"name": CELL, "config": "tiny-instances",
                               "traffic": "tiny-still", "chips": 1,
                               "why": "a CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if REAL in m.get("workloads", ()):
            m["workloads"].append(CELL)
    mix = tiny.tiny_mix("tiny-still", script=[{"keys": [], "steps": 1}])
    del mix["start"]
    tiny.write(root, "BENCHMARK.json", bench)
    tiny.write(root, "rtbench/configs/tiny-instances.json",
               tiny_instances_config())
    tiny.write(root, "rtbench/workloads/tiny-still.json", mix)
    tiny.write(root, f"rtbench/limits/{CELL}.json", {"bad_px_share": limit})
    return root


def run_tiny(root, seed, trace_on=False):
    cell = harness.load_cell(CELL, root)
    res, _ = run.run_cell(cell, seed=seed, seconds=1.0, trace=trace_on,
                          device="cpu", t_start=time.perf_counter(),
                          root=root)
    return res


def test_tiny_instanced_cell_is_correct(tmp_path):
    root = make_root(tmp_path)
    res = run_tiny(root, 2**31 + 77)
    assert res["correct"], res["checks"]
    assert res["checks"]["bad_px_share"]["value"] == 0.0
    assert res["checks"]["frames_checked"]["value"] >= 1
    assert set(res["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
    traced = run_tiny(root, 12345, trace_on=True)
    assert traced["correct"], traced["checks"]
    # the CPU trace holds the refit span, not device operations
    assert traced["metrics"]["refit_enqueue_ms.frame"]["value"] > 0
    assert "refit_launches.frame" not in traced["metrics"]


@pytest.mark.parametrize("fault", ["first_pose", "no_refit"])
def test_a_program_that_keeps_its_first_pose_is_caught(tmp_path,
                                                      monkeypatch, fault):
    """The setter ignoring the transforms, or render() skipping the
    refit: the frames show the first pose, and `correct` reads false."""
    if fault == "first_pose":
        monkeypatch.setattr(Renderer, "set_instance_transforms",
                            lambda self, transforms: None)
    else:
        monkeypatch.setattr(Renderer, "_refit",
                            lambda self: setattr(self, "_stale", False))
    root = make_root(tmp_path)
    res = run_tiny(root, 2**31 + 77)
    assert not res["correct"]
    assert res["checks"]["bad_px_share"]["value"] > 0.01


def test_one_identity_instance_is_the_heightfield(monkeypatch):
    """One copy under the identity transform: the kind's reference scene
    equals the heightfield kind's of the same mesh, tensor for tensor."""
    cfg = tiny_instances_config(count=1)
    cfg["scene"]["mesh"]["translation"] = [0.1, 0.2, -3.0]
    kind = harness.scene_kind(cfg)
    inputs = kind.make_inputs(cfg, 31)
    ident = np.zeros((1, 3, 4), np.float32)
    ident[0, :, :3] = np.eye(3)
    monkeypatch.setattr(kind, "transforms", lambda inputs, step: ident)
    got = kind.reference_scene(inputs, 9, device="cpu")
    want = heightfield.reference_scene(heightfield.make_inputs(cfg, 31), 9,
                                       device="cpu")
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name


def test_transforms_follow_the_seed_and_step():
    """Turned floor tiles: rigid, height axis up, the grid's centres, a
    turn of `turn` a step about y, and the program's first transforms
    the kind's at step 0."""
    cfg = harness.load_json(os.path.join(
        harness.HERE, "configs", "instances64-terrain23.json"))
    kind = harness.scene_kind(cfg)
    seed = 2**33 + 5
    inputs = kind.make_inputs(cfg, seed)
    t0, t3 = kind.transforms(inputs, 0), kind.transforms(inputs, 3)
    assert t0.shape == (64, 3, 4) and t0.dtype == np.float32
    r = t0[:, :, :3].astype(np.float64)
    np.testing.assert_allclose(r @ r.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), r.shape),
                               atol=1e-6)
    np.testing.assert_allclose(np.linalg.det(r), 1.0, atol=1e-6)
    np.testing.assert_array_equal(t0[:, :, 2], np.tile([0, 1, 0], (64, 1)))
    np.testing.assert_allclose(t0[:, :, 3].mean(0), (0.0, 0.0, -6.0),
                               atol=1e-5)
    np.testing.assert_allclose(np.ptp(t0[:, 0, 3]), 7 * 2.5, atol=1e-5)
    ang0 = np.arctan2(-t0[:, 0, 1], t0[:, 0, 0])
    ang3 = np.arctan2(-t3[:, 0, 1], t3[:, 0, 0])
    np.testing.assert_allclose(np.angle(np.exp(1j * (ang3 - ang0))),
                               0.15, atol=1e-5)
    assert not np.array_equal(t0, kind.transforms(kind.make_inputs(cfg, 7),
                                                   0))
    sc = kind.program_config(cfg, harness.load_json(os.path.join(
        harness.HERE, "workloads", "still-4k.json")),
        _camera(cfg), "mesh.obj", seed)
    assert sc.instances.count == 64
    np.testing.assert_array_equal(np.asarray(sc.instances.transforms,
                                             np.float32), t0)
    assert sc.spheres == () and len(sc.meshes) == 1


def _camera(cfg):
    from rtbench.reference.camera import Camera

    cam = cfg["scene"]["camera"]
    return Camera(cam["eye"], cam["target"], cam["up"], aspect=16 / 9)


def _traced(host_ops, device_ops=(("k", 0.0, 1.0),), steps=2):
    return trace.Traced(device_ops=list(device_ops), host_ops=host_ops,
                        window_us=100.0, steps=steps)


def test_refit_readers():
    cell = harness.load_cell(REAL)
    enqueue = harness.metric_reader("refit_enqueue_ms.frame")
    launches = harness.metric_reader("refit_launches.frame")
    assert enqueue(Obs(cell=cell)) is None
    assert launches(Obs(cell=cell)) is None
    # a trace without the span (a plain scene, or an older program)
    bare = Obs(cell=cell, traced=_traced([("rtbench.render", 0.0, 50.0),
                                          ("cudaLaunchKernel", 1.0, 2.0)]))
    assert enqueue(bare) is None and launches(bare) is None
    host = [("rtbench.render", 0.0, 100.0), ("rt.render", 0.0, 100.0),
            ("rt.frame.refit", 10.0, 40.0),
            ("cudaLaunchKernel", 12.0, 13.0),
            ("cudaMemcpyAsync", 20.0, 26.0),  # a copy: may wait (WAITS)
            ("cudaLaunchKernel", 30.0, 31.0),
            ("rt.frame.gbuffer", 50.0, 90.0),
            ("cudaLaunchKernel", 60.0, 61.0),
            ("rt.frame.refit", 110.0, 130.0),
            ("cudaLaunchKernel", 115.0, 116.0)]
    obs = Obs(cell=cell, traced=_traced(host))
    # (30 - 6 + 20) us of refit over 2 steps
    assert enqueue(obs) == pytest.approx(0.022)
    # 4 launch calls start inside the refit spans: 2 a step
    assert launches(obs) == 2.0
    assert launches(Obs(cell=cell, traced=_traced(host, ()))) is None
