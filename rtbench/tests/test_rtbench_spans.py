"""The program's spans and counters as the benchmark reads them
(rtbench/spans.py and the readers syncs_per_sample.pt and scene_build_s):
synthetic spans and profiler events, and one CPU run of the tiny cells."""

from __future__ import annotations

import pytest

from rtbench import harness, spans, trace
from rtbench.obs import Obs
from rtbench.tests import tiny
from rust_wgpu_raytracing_tpu_torch.runtime import profiler
from rust_wgpu_raytracing_tpu_torch.runtime.profiler import Span

BENCH = harness.load_benchmark()
ORBITS = ["refscene-terrain91.orbit-1080p", "terrain512-bvh.orbit-1080p"]
PTS = ["refscene-terrain91.pt4-1080p", "terrain512-bvh.pt3-540p"]


@pytest.fixture(autouse=True)
def empty_recorder():
    profiler.enable(False)
    profiler.drain()
    yield
    profiler.enable(False)
    profiler.drain()


def on_the_card(cell):
    """An Obs of a traced run on the card: its trace holds a device
    operation."""
    return Obs(cell=harness.load_cell(cell),
               traced=trace.Traced(device_ops=[("k", 0.0, 1.0)], steps=1))


def span(name, start, end, parent=-1, kind="span", step=0):
    return Span(name, kind, start * 1000, end * 1000, parent, step, {})


def test_render_host_ms_less_the_waits_inside():
    recs = [span("step", 0, 100),                      # 0
            span("render", 10, 60, 0),                 # 1
            span("pt.compact", 20, 40, 1),             # 2
            span("compact.wait", 25, 35, 2, "wait"),   # 3: inside render
            span("uniforms.wait", 12, 14, 1, "wait"),  # 4
            span("present.wait", 70, 90, 0, "wait"),   # 5: outside render
            span("step", 100, 200, step=1),            # 6
            span("render", 110, 150, 6, step=1)]       # 7
    # (50 - 10 - 2) + 40 us over 2 samples
    assert spans.render_host_ms(recs, 2) == pytest.approx(0.039)
    assert spans.render_host_ms(recs, 0) is None
    assert spans.render_host_ms(recs[:1], 1) is None


def test_host_spans_self_waits_and_launches():
    recs = [span("render", 0, 100),
            span("frame.gbuffer", 10, 50, 0),
            span("uniforms.wait", 5, 8, 0, "wait")]
    host = [("rt.render", 0.0, 100.0), ("rt.frame.gbuffer", 10.0, 50.0),
            ("cudaLaunchKernel", 20.0, 21.0), ("cuLaunchKernel", 30.0, 31.0),
            ("cudaMemcpyAsync", 60.0, 61.0), ("cudaMemsetAsync", 150.0, 151),
            ("cudaStreamSynchronize", 70.0, 80.0)]
    t = trace.Traced(host_ops=host, window_us=200.0, steps=2)
    assert spans.launches_by_span(t) == {"frame.gbuffer": 1.0,
                                         "render": 0.5,
                                         spans.OUTSIDE: 0.5}
    rows = {r[0]: r[1:] for r in spans.host_spans(recs, 2, t)}
    # render: 100 us less its child's 40 and the wait's 3, a step of 2
    assert rows["render"] == pytest.approx([0.0285, 0.0015, 0.5])
    assert rows["frame.gbuffer"] == pytest.approx([0.02, 0.0, 1.0])
    assert rows["uniforms.wait"] == pytest.approx([0.0015, 0.0, 0.0])
    assert rows[spans.OUTSIDE] == [0.0, 0.0, 0.5]
    assert spans.host_spans(recs, 0, t) == []


def test_idle_by_span_puts_every_gap_somewhere():
    ops = [("k", 0.0, 10.0), ("k", 20.0, 30.0), ("k", 40.0, 50.0),
           ("k", 60.0, 70.0), ("k", 90.0, 100.0)]
    host = [("rt.step", 0.0, 75.0), ("rt.render", 5.0, 45.0),
            ("rt.frame.shade", 12.0, 18.0),
            ("Activity Buffer Request", 31.0, 39.0)]
    t = trace.Traced(device_ops=ops, host_ops=host, window_us=100.0,
                     steps=1)
    got = dict(spans.idle_by_span(t))
    assert got == pytest.approx({"frame.shade": 10e-6,
                                 "Activity Buffer Request": 10e-6,
                                 "step": 10e-6, spans.OUTSIDE: 20e-6})
    idle = t.window_us - t.busy_us()
    assert sum(got.values()) == pytest.approx(idle / 1e6)
    assert spans.idle_by_span(trace.Traced()) == []


@pytest.mark.parametrize("cell", ORBITS + PTS)
def test_syncs_per_sample_reads_the_program_counters(cell):
    read = harness.metric_reader("syncs_per_sample.pt")
    obs = on_the_card(cell)
    assert read(obs) is None  # no sample rendered
    profiler.count("pt.full", 3)
    profiler.count("pt.compacted", 1)
    profiler.count("syncs.compact", 1)
    profiler.count("syncs.uniforms", 4)
    profiler.count("syncs.present", 4)
    profiler.count("launches.frame", 9)
    assert read(obs) == (None if cell in ORBITS else 9 / 4)
    assert read(Obs(cell=obs.cell)) is None  # not on the card


@pytest.mark.parametrize("cell", ORBITS + PTS)
def test_scene_build_s_reads_the_setup_span(cell):
    read = harness.metric_reader("scene_build_s")
    obs = on_the_card(cell)
    assert read(obs) is None
    profiler.count("ns.setup.scene_build", 2_500_000_000)
    assert read(obs) == 2.5
    assert read(Obs(cell=obs.cell)) is None  # not on the card


def test_new_entries():
    """The two entries that came with the program's recorder keep their
    fields, their first cells and their place after the eleven metrics
    before them; cells and metrics added after them are free."""
    names = [m["name"] for m in BENCH["per_layer"]]
    assert set(names[:11]) == {
        "enqueue_ms.frame", "enqueue_ms.pt", "launches_per_frame.frame",
        "launches_per_sample.pt", "host_syncs_per_sample.pt",
        "K4_roofline", "K9_roofline", "K8_roofline", "K10_roofline",
        "device_idle.frame", "device_idle.pt"}
    assert names[11:13] == ["syncs_per_sample.pt", "scene_build_s"]
    per = {m["name"]: dict(m) for m in BENCH["per_layer"]}
    for name, fields, cells in (
            ("syncs_per_sample.pt",
             {"unit": "syncs", "source": "program_counter",
              "layer": "path tracer", "moves": "sample_ms"}, PTS),
            ("scene_build_s",
             {"unit": "s", "source": "program_span", "layer": "scene",
              "moves": "setup_s"}, ORBITS + PTS)):
        workloads = per[name].pop("workloads")
        assert per[name] == dict(fields, name=name, better="lower")
        assert workloads[:len(cells)] == cells


@pytest.mark.parametrize("cell", [tiny.TINY_ORBIT, tiny.TINY_PT])
def test_measure_a_tiny_cell_on_the_cpu(tmp_path, cell):
    root = tiny.make_root(tmp_path)
    c = harness.load_cell(cell, root)
    out = spans.measure(c, seed=2 ** 31 + 7, device="cpu")
    assert out["scene_build_s"] > 0
    assert set(out["setup_ms"]) == {"setup.scene_build", "setup.upload"}
    assert out["render_host_ms"] > 0 and out["bitwise_on_off"]
    assert out["after_profiler"]["render_host_ms"] > 0
    assert set(out["segment_ms_a_step"]) == {"on", "off"}
    ops = out["device_ops_a_step"]
    assert ops["rt_spans"] == ops["no_spans"] == 0  # no device on the CPU
    names = {r[0] for r in out["host_spans"]}
    assert {"step", "render", "present.wait"} <= names
    if cell == tiny.TINY_PT:
        assert out["pt_branch"] and out["syncs_per_sample"] > 0
        assert "pt.bounce" in names
    else:
        assert "frame.gbuffer" in names
