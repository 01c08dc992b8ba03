"""PyTorch port: the span and counter recorder (runtime/profiler.py) —
nesting, self time, waits and their counters, the recorder off by
default, drain — and the spans a CPU Renderer records for each frame
program and the path tracer, with frames bitwise the same with the
recorder on and off."""

import time

import numpy as np
import pytest
import torch

from rust_wgpu_raytracing_tpu_torch import Renderer
from rust_wgpu_raytracing_tpu_torch.config import (CameraConfig, MeshConfig,
                                                   RenderConfig, SceneConfig,
                                                   SphereConfig)
from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
from rust_wgpu_raytracing_tpu_torch.core.scene import Scene
from rust_wgpu_raytracing_tpu_torch.ops import kernels as K
from rust_wgpu_raytracing_tpu_torch.ops import pathtrace as P
from rust_wgpu_raytracing_tpu_torch.runtime import profiler
from rust_wgpu_raytracing_tpu_torch.runtime.frame_loop import FrameLoop

W, H = 64, 48


@pytest.fixture(autouse=True)
def recorder():
    """Every test starts and ends with the recorder off and empty."""
    profiler.enable(False)
    profiler.drain()
    profiler.set_step(None)
    yield
    profiler.enable(False)
    profiler.drain()
    profiler.set_step(None)


def names(spans):
    return [s.name for s in spans]


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_nesting_parents_and_step_id():
    profiler.enable()
    profiler.set_step(7)
    with profiler.span("a", x=1):
        with profiler.span("b"):
            with profiler.span("c"):
                pass
        with profiler.span("d"):
            pass
    profiler.set_step(8)
    with profiler.span("e"):
        pass
    spans, _ = profiler.drain()
    assert names(spans) == ["a", "b", "c", "d", "e"]
    assert [s.parent for s in spans] == [-1, 0, 1, 0, -1]
    assert [s.step for s in spans] == [7, 7, 7, 7, 8]
    assert spans[0].attrs == {"x": 1} and spans[0].kind == "span"
    for s in spans:
        assert s.end_ns >= s.start_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


@pytest.mark.parametrize("children", [0, 1, 3])
def test_self_time_is_the_span_less_its_children(children):
    profiler.enable()
    with profiler.span("outer"):
        time.sleep(0.001)
        for i in range(children):
            with profiler.span(f"child{i}"):
                time.sleep(0.001)
                with profiler.span("grandchild"):
                    time.sleep(0.001)
    spans, _ = profiler.drain()
    own = profiler.self_ns(spans)
    kids = [s for s in spans if s.parent == 0]
    assert len(kids) == children
    assert own[0] == spans[0].ns - sum(s.ns for s in kids)
    for i, s in enumerate(spans):
        below = sum(c.ns for c in spans if c.parent == i)
        assert own[i] == s.ns - below and own[i] >= 0


@pytest.mark.parametrize("site", ["span", "wait"])
def test_off_records_nothing_and_returns_the_null_context(site):
    assert not profiler.enabled()
    ctx = (profiler.span("x") if site == "span"
           else profiler.wait("x"))
    assert ctx is profiler.NULL
    with ctx:
        pass
    spans, counts = profiler.drain()
    assert spans == []
    # a wait counts its sync with the recorder off too
    assert counts == ({"syncs.x": 1} if site == "wait" else {})


@pytest.mark.parametrize("sites", [("compact",), ("uniforms", "uniforms"),
                                   ("compact", "uniforms", "background",
                                    "compact")])
def test_wait_counts_by_site(sites):
    profiler.enable()
    with profiler.span("render"):
        for site in sites:
            with profiler.wait(site):
                pass
    spans, counts = profiler.drain()
    assert names(spans) == ["render"] + [s + ".wait" for s in sites]
    assert [s.kind for s in spans[1:]] == ["wait"] * len(sites)
    assert all(s.parent == 0 for s in spans[1:])
    assert counts == {f"syncs.{s}": sites.count(s) for s in set(sites)}


def test_drain_empties_the_recorder():
    profiler.enable()
    with profiler.span("a"):
        with pytest.raises(RuntimeError):
            profiler.drain()  # inside an open span
    profiler.count("n", 3)
    spans, counts = profiler.drain()
    assert names(spans) == ["a"] and counts == {"n": 3}
    assert profiler.drain() == ([], {})
    assert profiler.counters() == {}


def test_timed_counts_its_length_with_the_recorder_off():
    with profiler.timed("setup.x"):
        time.sleep(0.002)
    spans, counts = profiler.drain()
    assert spans == [] and counts["ns.setup.x"] >= 2_000_000


@pytest.mark.parametrize("on", [False, True])
def test_spans_annotate_a_running_profiler(on):
    """While torch.profiler runs, every span is a record_function "rt."
    + name, with the recorder on or off."""
    profiler.enable(on)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with profiler.span("frame.shade"):
            with profiler.wait("present"):
                torch.ones(4).add_(1)
    got = {e.name for e in prof.events()}
    assert {"rt.frame.shade", "rt.present.wait"} <= got
    spans, counts = profiler.drain()
    assert names(spans) == (["frame.shade", "present.wait"] if on else [])
    assert counts == {"syncs.present": 1}
    profiler.enable(False)
    assert profiler.span("x") is profiler.NULL  # the profiler has stopped


def test_launch_counts_keep_their_api():
    """launch_counts() names every wrapper, as the per-function counters
    did; the plain versions on CPU tensors launch nothing; the counters
    are the recorder's "launches.<wrapper>", and reset_launch_counts()
    drops those alone."""
    K.reset_launch_counts()
    want = {f.__name__: 0 for f in K.KERNELS}
    assert K.launch_counts() == want and len(want) == 13
    r = Renderer(scene("fused"), device="cpu")
    r.render()
    assert K.launch_counts() == want
    profiler.count("launches.frame")
    profiler.count("launches.stream_anyhit", 2)
    profiler.count("pt.full")
    assert K.launch_counts() == {**want, "frame": 1, "stream_anyhit": 2}
    K.reset_launch_counts()
    assert K.launch_counts() == want
    assert profiler.counters()["pt.full"] == 1


# ---------------------------------------------------------------------------
# the program's spans
# ---------------------------------------------------------------------------

def scene(program, **render_kw):
    return SceneConfig(
        spheres=(SphereConfig(center=(0.6, 0.5, -4.0), radius=0.4),),
        meshes=(MeshConfig(obj_path="builtin:terrain:23",
                           translation=(0.0, 0.0, -3.0),
                           light_direction=(6.0, -1.0, 1.0)),),
        camera=CameraConfig(eye=(0.0, -0.3, -2.2), target=(0.0, 0.0, -3.0)),
        render=RenderConfig(width=W, height=H, shadows=True,
                            variant=program, **render_kw))


STEP = ["step", "update", "present.encode", "render"]
FUSED = ["frame.raygen", "frame.gbuffer", "frame.shadow", "frame.shade",
         "frame.present"]
SPLIT = ["frame.raygen", "frame.gbuffer", "frame.shade", "frame.shadow",
         "frame.present"]
PT = ["uniforms.wait", "background.wait", "pt.raygen", "pt.primary",
      "pt.bounce", "pt.bounce", "pt.bounce", "pt.accumulate"]
CASES = {
    "fused": (dict(), FUSED),
    "split": (dict(), SPLIT),
    "pathtrace": (dict(pt_bounces=2, pt_spp=8), PT),
}


def drive(program, on, steps=3):
    """Images and spans of `steps` FrameLoop steps, orbit key held."""
    kw, _ = CASES[program]
    r = Renderer(scene("split" if program == "pathtrace" else program,
                       **kw), device="cpu")
    loop = FrameLoop(r)
    loop.push_key("d", True)
    profiler.enable(on)
    images = [loop.step() for _ in range(steps)]
    images.append(loop.flush())
    profiler.enable(False)
    spans, _ = profiler.drain()
    return images, spans


@pytest.mark.parametrize("program", sorted(CASES))
def test_renderer_records_its_phases_in_order(program):
    _, phases = CASES[program]
    images, spans = drive(program, on=True)
    assert {s.step for s in spans} == {0, 1, 2}
    for step in (1, 2):  # a step that presents the frame before it
        mine = [s for s in spans if s.step == step]
        assert names(mine) == STEP + phases + ["present.wait"]
        top = [s for s in mine if s.parent < 0]
        assert names(top) == ["step"]
        render = next(i for i, s in enumerate(spans)
                      if s.step == step and s.name == "render")
        inside = [s.name for s in spans if s.parent == render]
        assert inside == phases
    if program == "pathtrace":
        bounces = [s.attrs["bounce"] for s in spans
                   if s.step == 1 and s.name == "pt.bounce"]
        assert bounces == [0, 1, 2]


@pytest.mark.parametrize("program", sorted(CASES))
def test_frames_are_bitwise_the_same_with_the_recorder_on(program):
    off, none = drive(program, on=False)
    on, spans = drive(program, on=True)
    assert none == [] and spans
    assert len(off) == len(on) == 4 and off[0] is None and on[0] is None
    for a, b in zip(off[1:], on[1:]):
        assert a is not None and np.array_equal(a, b)


@pytest.mark.parametrize("cap,branch", [(None, None), (8 * 1024, "compacted"),
                                        (1024, "full")])
def test_pathtrace_compaction_spans_and_counters(cap, branch):
    """compact_cap=None never counts live tiles; a capacity that holds
    every live tile takes the compacted loop (its bounces inside
    pt.compact); one tile's room takes the full loop. Every sample counts
    its branch, and the frame is the same bits either way."""
    cfg = scene("split")
    data = Scene.build(cfg).data
    uni = Camera.from_config(cfg.camera, W / H).uniforms().flat()
    kw = dict(width=W, height=H, bounces=2, spp=2, background=(0.1, 0.2,
                                                                0.3))
    full = P.render_pathtrace(data, uni, P.PRNGKey(5), **kw)
    profiler.drain()
    profiler.enable()
    got = P.render_pathtrace(data, uni, P.PRNGKey(5), compact_cap=cap, **kw)
    profiler.enable(False)
    spans, counts = profiler.drain()
    assert torch.equal(got, full)
    sample = ["pt.raygen", "pt.primary"]
    if cap is not None:
        sample += ["pt.compact", "compact.wait"]
    sample += ["pt.bounce"] * 3
    assert names(spans) == (["uniforms.wait", "background.wait"]
                            + sample * 2 + ["pt.accumulate"])
    # a sample's sweep_inputs calls: the primary closest hit, K8's pair
    # at each of the two bounces and the last bounce's any-hit
    want = {"syncs.uniforms": 1, "syncs.background": 1,
            f"pt.{branch or 'full'}": 2, "sweep.inputs": 2 * 6}
    if cap is not None:
        want["syncs.compact"] = 2
    assert counts == want
    compact = [i for i, s in enumerate(spans) if s.name == "pt.compact"]
    for i in compact:
        inside = [s.name for s in spans if s.parent == i]
        assert inside == (["compact.wait", "pt.bounce", "pt.bounce",
                           "pt.bounce"] if branch == "compacted"
                          else ["compact.wait"])


def nm_scene(program):
    """The bump-mapped box of write_textured_assets (normal mapping on):
    "nm_split" with shadows (the split frame), "nm_fused" without."""
    import dataclasses as dc

    from rust_wgpu_raytracing_tpu_torch import config as pcfg
    from test_torch_host import textured_config

    shadows = program == "nm_split"
    cfg = textured_config(pcfg, width=W, height=H, shadows=shadows,
                          bump=True)
    return dc.replace(cfg, render=dc.replace(
        cfg.render, variant="split" if shadows else "fused"))


def drive_nm(program, on, tmp_path, monkeypatch, steps=3):
    """drive() over nm_scene(program), or over scene(program) for a
    program without normal mapping."""
    if not program.startswith("nm"):
        return drive(program, on, steps)
    from test_torch_host import write_textured_assets

    write_textured_assets(str(tmp_path), bump=True)
    monkeypatch.setenv("RWRT_ASSETS", str(tmp_path))
    loop = FrameLoop(Renderer(nm_scene(program), device="cpu"))
    loop.push_key("d", True)
    profiler.enable(on)
    images = [loop.step() for _ in range(steps)]
    images.append(loop.flush())
    profiler.enable(False)
    spans, _ = profiler.drain()
    return images, spans


@pytest.mark.parametrize("program", ["nm_split", "nm_fused", "split",
                                     "fused"])
def test_normal_map_span_opens_once_per_nm_frame(program, tmp_path,
                                                 monkeypatch):
    """frame.normal_map opens once in each frame with normal mapping,
    inside frame.shade, and never in a frame without it."""
    _, spans = drive_nm(program, True, tmp_path, monkeypatch)
    for step in (0, 1, 2):
        nm = [s for s in spans if s.step == step
              and s.name == "frame.normal_map"]
        if not program.startswith("nm"):
            assert nm == []
            continue
        assert len(nm) == 1
        assert spans[nm[0].parent].name == "frame.shade"
    if program.startswith("nm"):  # the other phases as before
        phases = [s.name for s in spans if s.step == 1
                  and s.name.startswith("frame.")]
        want = FUSED if program == "nm_fused" else SPLIT
        assert [p for p in phases if p != "frame.normal_map"] == [
            p for p in want if p != "frame.shadow" or program == "nm_split"]


@pytest.mark.parametrize("program", ["nm_split", "nm_fused"])
def test_nm_frames_are_bitwise_the_same_with_the_recorder_on(
        program, tmp_path, monkeypatch):
    off, none = drive_nm(program, False, tmp_path, monkeypatch)
    on, spans = drive_nm(program, True, tmp_path, monkeypatch)
    assert none == [] and "frame.normal_map" in names(spans)
    assert len(off) == len(on) == 4 and off[0] is None and on[0] is None
    for a, b in zip(off[1:], on[1:]):
        assert a is not None and np.array_equal(a, b)


def test_renderer_times_its_setup():
    before = profiler.counters()
    Renderer(scene("fused"), device="cpu")
    after = profiler.counters()
    for name in ("ns.setup.scene_build", "ns.setup.upload"):
        assert after[name] > before.get(name, 0)
    assert profiler.drain()[0] == []  # the recorder was off
