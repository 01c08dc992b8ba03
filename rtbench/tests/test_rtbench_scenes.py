"""Scene kinds: a new kind is new files, and the harness calls a kind's
hooks at the steps it should.

The new kind written here (two heightfields side by side, two meshes in
the program's SceneConfig, one material, texture and light) runs the
tiny lit and path-traced cells with `correct` true on the CPU; stubs
show the order of Driver's calls, the steps verify asks the kind for,
and the cells load_cell refuses. A kind with a lit-frame reference of
its own (OWN_KIND) decides `correct` in a run and in the control.
"""

from __future__ import annotations

import time
import types

import pytest

import torch

from rtbench import control, harness, run, traffic, verify
from rtbench.reference import frame as ref_frame
from rtbench.reference import pathtrace as ref_pt
from rtbench.tests import tiny

TWIN_KIND = '''
"""Two seeded heightfields side by side (the scene's "mesh", moved by
each of its "offsets"), with one material, texture and light: world-space
vertices in two OBJ files beside one MTL and one PNG."""

import dataclasses
import os

import numpy as np

from rtbench import scenegen, scenes

MOVES = False


def make_inputs(config, seed):
    scene = config["scene"]
    mesh = scene["mesh"]
    a, b = (scenegen.make_inputs(config, seed + i) for i in (0, 1))
    move = np.asarray(mesh["translation"], np.float32)
    pos = [p.positions * np.float32(mesh["scale"])
           + (move + np.asarray(off, np.float32))
           for p, off in zip((a, b), scene["offsets"])]
    return dataclasses.replace(
        a, positions=np.concatenate(pos),
        uvs=np.concatenate([a.uvs, b.uvs]),
        normals=np.concatenate([a.normals, b.normals]),
        faces=np.concatenate([a.faces, b.faces + len(a.positions)]),
        translation=(0.0, 0.0, 0.0), scale=1.0)


def write_assets(inputs, directory):
    v, f = len(inputs.positions) // 2, len(inputs.faces) // 2
    names = []
    for i in (0, 1):
        part = dataclasses.replace(
            inputs, positions=inputs.positions[i * v:(i + 1) * v],
            uvs=inputs.uvs[i * v:(i + 1) * v],
            normals=inputs.normals[i * v:(i + 1) * v],
            faces=inputs.faces[i * f:(i + 1) * f] - i * v)
        scenegen.write_assets(part, directory)
        names.append(f"half{i}.obj")
        os.replace(os.path.join(directory, "mesh.obj"),
                   os.path.join(directory, names[-1]))
    return names


def program_config(config, traffic, camera, assets, seed):
    light = tuple(config["scene"]["mesh"]["light_direction"])
    return scenes.program_scene(config, traffic, camera, seed, meshes=[
        dict(obj_path=name, light_direction=light) for name in assets])


def reference_scene(inputs, step, *, device, dtype):
    return scenes.built_once(inputs, device=device, dtype=dtype)
'''

MOVING_KIND = '''
MOVES = True
'''

OWN_KIND = '''
"""The heightfield kind with a lit-frame reference of its own:
reference_scene wraps the RefScene with the step and dtype it was built
for, and reference_lit records each call, unwraps the scene and adds
SHIFT to every value of reference.frame.lit_pixels."""

from rtbench.reference import frame
from rtbench.scenes import heightfield

MOVES = False
SHIFT = 0.0
CALLS = []

make_inputs = heightfield.make_inputs
write_assets = heightfield.write_assets
program_config = heightfield.program_config


class Own:
    def __init__(self, ref, step, dtype):
        self.ref, self.step, self.dtype = ref, step, dtype


def reference_scene(inputs, step, *, device, dtype):
    return Own(heightfield.reference_scene(inputs, step, device=device,
                                           dtype=dtype), step, dtype)


def reference_lit(scene, cam, xs, ys, *, width, height, render):
    CALLS.append((scene, cam, render))
    return frame.lit_pixels(scene.ref, cam, xs, ys, width=width,
                            height=height, shadows=render["shadows"]) + SHIFT
'''


def _add_config(root, name, scene_kind, **scene):
    """A tiny configuration of `scene_kind` with its cells under the tiny
    lit and path-traced mixes; returns the cells' names."""
    cfg = tiny.tiny_config(name)
    cfg["scene"].update(kind=scene_kind, **scene)
    tiny.write(root, f"rtbench/configs/{name}.json", cfg)
    bench = harness.load_benchmark(root)
    bench["configs"].append({"name": name, "source": "a test",
                             "file": f"rtbench/configs/{name}.json",
                             "reduced": [], "why": "a CPU test"})
    cells = []
    for mix in ("tiny-orbit", "tiny-pt"):
        cell = f"{name}.{mix[5:]}"
        bench["workloads"].append({"name": cell, "config": name,
                                   "traffic": mix, "chips": 1,
                                   "why": "a CPU test"})
        tiny.write(root, f"rtbench/limits/{cell}.json",
                   {"bad_px_share": 0.0})
        cells.append(cell)
    tiny.write(root, "BENCHMARK.json", bench)
    return cells


def test_new_kind_is_new_files(tmp_path):
    root = tiny.make_root(tmp_path)
    (tmp_path / "rtbench" / "scenes" / "twin.py").write_text(TWIN_KIND)
    mesh = dict(tiny.tiny_config()["scene"]["mesh"], size=1.0)
    cells = _add_config(root, "twin", "twin", mesh=mesh,
                        offsets=[[-0.6, 0.0, 0.0], [0.6, 0.0, 0.0]])
    for name in cells:
        cell = harness.load_cell(name, root)
        assert cell.scene.__file__.endswith("twin.py")
        sc = cell.scene.program_config(
            cell.config, cell.traffic,
            traffic.Replay(cell.traffic, cell.config, 5).start,
            ["half0.obj", "half1.obj"], 5)
        assert [m.obj_path for m in sc.meshes] == ["half0.obj", "half1.obj"]
        res, _ = run.run_cell(cell, seed=2**31 + 99, seconds=1.0,
                              trace=False, device="cpu",
                              t_start=time.perf_counter(), root=root)
        assert res["correct"], (name, res["checks"])
        assert res["checks"]["bad_px_share"]["value"] == 0.0
        assert res["checks"]["frames_checked"]["value"] >= 1


def test_unknown_kind_names_its_file(tmp_path):
    with pytest.raises(FileNotFoundError, match="rtbench/scenes/nosuch.py"):
        harness.scene_kind({"scene": {"kind": "nosuch"}}, str(tmp_path))
    root = tiny.make_root(tmp_path)
    orbit, _ = _add_config(root, "lost", "nosuch")
    with pytest.raises(FileNotFoundError, match="rtbench/scenes/nosuch.py"):
        harness.load_cell(orbit, root)


def test_moving_kind_takes_no_path_traced_mix(tmp_path):
    root = tiny.make_root(tmp_path)
    (tmp_path / "rtbench" / "scenes" / "moving.py").write_text(MOVING_KIND)
    orbit, pt = _add_config(root, "moving", "moving")
    assert harness.load_cell(orbit, root).scene.MOVES
    with pytest.raises(ValueError, match="fixed geometry"):
        harness.load_cell(pt, root)


class _Loop:
    def __init__(self, calls):
        self.calls = calls

    def push_key(self, key, down):
        self.calls.append(("key", key, down))

    def step(self):
        self.calls.append(("step",))
        return None


class _Replay:
    """Holds "right" for two steps, then nothing for one."""

    def keys_at(self, g):
        return frozenset({"right"}) if g % 3 < 2 else frozenset()


def test_driver_advances_after_the_keys_before_the_step():
    calls = []
    drv = run.Driver(_Loop(calls), _Replay(),
                     lambda g: calls.append(("advance", g)))
    drv.steps(2)
    drv.step()
    drv.steps(2)
    assert calls == [
        ("key", "right", True), ("advance", 0), ("step",),
        ("advance", 1), ("step",),
        ("key", "right", False), ("advance", 2), ("step",),
        ("key", "right", True), ("advance", 3), ("step",),
        ("advance", 4), ("step",)]
    calls.clear()
    run.Driver(_Loop(calls), _Replay()).step()
    assert calls == [("key", "right", True), ("step",)]


def test_bound_advance_passes_renderer_and_inputs():
    got = []
    kind = types.SimpleNamespace(
        advance=lambda renderer, inputs, step: got.append(
            (renderer, inputs, step)))
    run.bound_advance(kind, "renderer", "inputs")(7)
    assert got == [("renderer", "inputs", 7)]
    assert run.bound_advance(types.SimpleNamespace(), "r", "i") is None


class _Rendered:
    """Sample counts 1, 2, 3, 4 over every four steps: an accumulation
    starts at each step divisible by 4."""

    def rendered(self, step):
        return f"cam{step}", step % 4 + 1


def _stub_cell(bounces, asked):
    def reference_scene(inputs, step, *, device, dtype):
        asked.append(step)
        return f"scene{step}"
    return types.SimpleNamespace(
        traffic={"width": 8, "height": 4, "pt_bounces": bounces},
        config={"render": {"shadows": True}},
        scene=types.SimpleNamespace(reference_scene=reference_scene))


def test_verify_asks_for_the_step_that_rendered_each_lit_frame(monkeypatch):
    drawn = []
    monkeypatch.setattr(ref_frame, "lit_pixels",
                        lambda s, cam, *a, **k: drawn.append((s, cam)))
    asked = []
    verify.reference_values(_stub_cell(0, asked), None, _Rendered(),
                            [0], [0], [3, 9, 20], seed=1, device="cpu")
    assert asked == [2, 8, 19]
    assert drawn == [("scene2", "cam2"), ("scene8", "cam8"),
                     ("scene19", "cam19")]


def test_verify_asks_for_each_accumulations_first_step(monkeypatch):
    drawn = []

    def accumulate(s, cam, *a, means_at, **k):
        drawn.append((s, cam, sorted(means_at)))
        return {n: n for n in means_at}
    monkeypatch.setattr(ref_pt, "accumulate", accumulate)
    asked = []
    out = verify.reference_values(_stub_cell(2, asked), None, _Rendered(),
                                  [0], [0], [6, 7, 10, 13], seed=1,
                                  device="cpu")
    # steps 5, 6 render samples 2, 3 of the accumulation from step 4;
    # step 9 sample 2 of step 8's; step 12 sample 1 of its own
    assert asked == [4, 8, 12]
    assert drawn == [("scene4", "cam4", [2, 3]), ("scene8", "cam8", [2]),
                     ("scene12", "cam12", [1])]
    assert out == {6: 2, 7: 3, 10: 2, 13: 1}


def _own_cell(tmp_path, shift=0.0, accumulate=""):
    """The tiny lit and path-traced cells of OWN_KIND with `shift` (and
    `accumulate`, source appended to the kind); returns (root, cells)."""
    root = tiny.make_root(tmp_path)
    (tmp_path / "rtbench" / "scenes" / "own.py").write_text(
        OWN_KIND.replace("SHIFT = 0.0", f"SHIFT = {shift!r}") + accumulate)
    return root, _add_config(root, "own", "own")


@pytest.mark.parametrize("shift, correct", [(0.0, True), (2 / 255, False)])
def test_kind_reference_lit_decides_correct(tmp_path, shift, correct):
    root, (orbit, _) = _own_cell(tmp_path, shift)
    cell = harness.load_cell(orbit, root)
    seed = 2**31 + 41
    res, _ = run.run_cell(cell, seed=seed, seconds=1.0, trace=False,
                          device="cpu", t_start=time.perf_counter(),
                          root=root)
    assert res["correct"] is correct, res["checks"]
    calls = cell.scene.CALLS
    assert len(calls) == res["checks"]["frames_checked"]["value"] >= 1
    replay = traffic.Replay(cell.traffic, cell.config, seed)
    for scene, cam, render in calls:
        assert isinstance(scene, cell.scene.Own)
        assert scene.dtype == torch.float32
        assert (cam.eye == replay.rendered(scene.step)[0].eye).all()
        assert render is cell.config["render"]
    if not correct:  # every value two rgba8 levels off
        assert res["checks"]["bad_px_share"]["value"] == 1.0


def test_control_takes_the_kinds_reference(tmp_path):
    root, (orbit, _) = _own_cell(tmp_path)
    cell = harness.load_cell(orbit, root)
    seed = 2**31 + 43
    out = control.readings(cell, seed, "cpu")
    steps = [int(g) for g in out["frames"]]
    calls = cell.scene.CALLS
    assert all(r is cell.config["render"] for _, _, r in calls)
    assert [(s.dtype, s.step) for s, _, _ in calls] == (
        [(torch.float32, g - 1) for g in steps]
        + [(torch.bfloat16, g - 1) for g in steps])


def test_reference_lit_without_accumulate_takes_no_path_traced_mix(
        tmp_path):
    root, (orbit, pt) = _own_cell(tmp_path)
    assert hasattr(harness.load_cell(orbit, root).scene, "reference_lit")
    with pytest.raises(ValueError, match="'own' gives reference_lit but "
                                         "no reference_accumulate"):
        harness.load_cell(pt, root)


def test_reference_accumulate_lets_a_kind_path_trace(tmp_path):
    root, (_, pt) = _own_cell(tmp_path, accumulate='''

def reference_accumulate(scene, cam, xs, ys, *, render, **kwargs):
    from rtbench.reference import pathtrace
    CALLS.append((scene, cam, render))
    return pathtrace.accumulate(scene.ref, cam, xs, ys, **kwargs)
''')
    cell = harness.load_cell(pt, root)
    res, _ = run.run_cell(cell, seed=2**31 + 45, seconds=1.0, trace=False,
                          device="cpu", t_start=time.perf_counter(),
                          root=root)
    assert res["correct"], res["checks"]
    assert cell.scene.CALLS
    assert all(r is cell.config["render"] for _, _, r in cell.scene.CALLS)


def _own_stub(bounces, drawn):
    """A kind whose scene is the step's name and whose references record
    what they were given; the configuration's "render" has keys beyond
    "shadows"."""
    def reference_scene(inputs, step, *, device, dtype):
        return f"scene{step}"

    def reference_lit(s, cam, xs, ys, *, width, height, render):
        drawn.append((s, cam, width, height, render))
        return s

    def reference_accumulate(s, cam, xs, ys, *, width, height, bounces,
                             seed, samples, means_at, render):
        drawn.append((s, cam, width, height, render))
        return {n: (s, n) for n in means_at}
    return types.SimpleNamespace(
        traffic={"width": 8, "height": 4, "pt_bounces": bounces},
        config={"render": {"shadows": True, "normal_mapping": True,
                           "mip": True}},
        scene=types.SimpleNamespace(
            reference_scene=reference_scene, reference_lit=reference_lit,
            reference_accumulate=reference_accumulate))


def _no_default(*a, **k):
    raise AssertionError("the default reference was called")


def test_verify_hands_the_kind_its_scene_and_whole_render(monkeypatch):
    monkeypatch.setattr(ref_frame, "lit_pixels", _no_default)
    monkeypatch.setattr(ref_pt, "accumulate", _no_default)
    drawn = []
    cell = _own_stub(0, drawn)
    out = verify.reference_values(cell, None, _Rendered(), [0], [0],
                                  [3, 9, 20], seed=1, device="cpu")
    assert out == {3: "scene2", 9: "scene8", 20: "scene19"}
    assert drawn == [(f"scene{g}", f"cam{g}", 8, 4, cell.config["render"])
                     for g in (2, 8, 19)]
    assert all(d[4] is cell.config["render"] for d in drawn)
    drawn.clear()
    cell = _own_stub(2, drawn)
    out = verify.reference_values(cell, None, _Rendered(), [0], [0],
                                  [6, 7, 13], seed=1, device="cpu")
    assert out == {6: ("scene4", 2), 7: ("scene4", 3), 13: ("scene12", 1)}
    assert drawn == [("scene4", "cam4", 8, 4, cell.config["render"]),
                     ("scene12", "cam12", 8, 4, cell.config["render"])]
