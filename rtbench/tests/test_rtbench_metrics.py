"""The benchmark's arithmetic on synthetic spans and profiler events."""

from __future__ import annotations

import math
import statistics

import pytest

from rtbench import harness, run, trace
from rtbench.obs import Obs

CELLS = {w["name"]: w for w in harness.load_benchmark()["workloads"]}
ORBIT = "refscene-terrain91.orbit-1080p"
PT = "refscene-terrain91.pt4-1080p"


def test_window_rate_and_tail():
    steps = [0.010] * 95 + [0.050] * 5
    e = run.end_to_end(steps, window_s=1.2, frames=100, samples=0,
                       setup_s=7.5)
    assert e["frame_ms"] == pytest.approx(12.0)
    # the tail of all 100 frames: the 95th percentile lies between the
    # 95th (10 ms) and 96th (50 ms) values
    assert e["frame_p95_ms"] == pytest.approx(
        statistics.quantiles([s * 1e3 for s in steps], n=20,
                             method="inclusive")[-1])
    assert 10.0 < e["frame_p95_ms"] <= 50.0
    assert math.isnan(e["sample_ms"]) and e["setup_s"] == 7.5
    e = run.end_to_end([0.1] * 8, window_s=0.8, frames=8, samples=5,
                       setup_s=1.0)
    assert e["sample_ms"] == pytest.approx(160.0)


def test_idle_share_from_overlapping_intervals():
    ops = [("a", 0.0, 10.0), ("b", 5.0, 15.0), ("c", 20.0, 30.0),
           ("d", 22.0, 25.0), ("e", 40.0, 41.0)]
    assert trace.union_us((s, e) for _, s, e in ops) == 26.0
    assert trace.gaps((s, e) for _, s, e in ops) == [(15.0, 20.0),
                                                      (30.0, 40.0)]
    t = trace.Traced(device_ops=ops, window_us=52.0, steps=2)
    # 13 us busy a traced step against the window's 52 us a frame
    obs = Obs(cell=harness.load_cell(ORBIT), traced=t, window_s=520e-6,
              window_frames=10)
    assert harness.metric_reader("device_idle.frame")(obs) == \
        pytest.approx(75.0)
    assert harness.metric_reader("device_idle.pt")(obs) is None
    obs.window_frames = 0
    assert harness.metric_reader("device_idle.frame")(obs) is None
    # path tracing: 26 us busy over 2 traced samples against 26 us a sample
    pt = Obs(cell=harness.load_cell(PT), traced=t, traced_samples=2,
             window_s=260e-6, window_samples=10)
    assert harness.metric_reader("device_idle.pt")(pt) == pytest.approx(50.0)
    assert harness.metric_reader("device_idle.frame")(pt) is None
    assert harness.metric_reader("launches_per_frame.frame")(obs) == 2.5
    assert t.by_name(1) == [["a", 10e-6]] and len(t.by_name()) == 5
    assert t.by_name()[-1] == ["e", 1e-6]


def test_idle_gaps_name_the_host():
    ops = [("k", 0.0, 10.0), ("k", 30.0, 31.0), ("k", 33.0, 34.0)]
    host = [("rtbench.step", -5.0, 40.0), ("rtbench.render", 11.0, 29.0),
            ("aten::nonzero", 12.0, 28.0), ("cudaMemcpyAsync", 31.0, 33.5)]
    t = trace.Traced(device_ops=ops, host_ops=host, window_us=50.0, steps=1)
    assert t.idle_gaps() == [["rtbench.render > aten::nonzero", 20e-6],
                             ["rtbench.step > cudaMemcpyAsync", 2e-6]]
    t.host_ops = host[:1]
    assert t.idle_gaps(1) == [["rtbench.step", 20e-6]]
    t.host_ops = []
    assert t.idle_gaps(1) == [["no host operation", 20e-6]]


def test_spans_and_counts():
    cell = harness.load_cell(PT)
    obs = Obs(cell=cell, render_ms=[100.0, 120.0, 110.0], window_samples=3,
              syncs=9, sync_samples=3)
    assert harness.metric_reader("host_syncs_per_sample.pt")(obs) == 3.0
    assert harness.metric_reader("enqueue_ms.pt")(obs) is None
    assert harness.metric_reader("enqueue_ms.frame")(obs) is None
    # two render spans of 5,000 and 7,000 us; 4,000 us of them waits on
    # the card (a sync inside an op, a copy straddling the span's end),
    # the launch and the wait outside the spans do not count
    host = [("rtbench.step", 0.0, 20000.0),
            ("rtbench.render", 0.0, 5000.0),
            ("aten::item", 1000.0, 3500.0),
            ("cudaStreamSynchronize", 1000.0, 3000.0),
            ("cudaLaunchKernel", 3000.0, 3010.0),
            ("rtbench.render", 10000.0, 17000.0),
            ("cudaMemcpyAsync", 15000.0, 19000.0),
            ("cudaEventSynchronize", 18000.0, 19500.0)]
    obs.traced = trace.Traced(device_ops=[("k", 0, 1)] * 12, host_ops=host,
                              window_us=9.0, steps=3)
    assert obs.traced.span_us("rtbench.render") == (12000.0, 4000.0)
    obs.traced_samples = 2
    assert harness.metric_reader("launches_per_sample.pt")(obs) == 6.0
    assert harness.metric_reader("enqueue_ms.pt")(obs) == 4.0
    orbit = Obs(cell=harness.load_cell(ORBIT), render_ms=[4.0, 6.0],
                traced=obs.traced)
    assert harness.metric_reader("enqueue_ms.frame")(orbit) == \
        pytest.approx(8.0 / 3)
    assert harness.metric_reader("enqueue_ms.pt")(orbit) is None


def test_kernel_time_by_name():
    ops = [("void frame_kernel<1>(float const*, int)", 0.0, 5.0),
           ("frame_kernel(float const*)", 10.0, 12.0),
           ("shared_culled_kernel(Sched, float const*)", 0.0, 7.0),
           ("void at::native::frame_kernel_other(int)", 0.0, 100.0)]
    obs = Obs(cell=harness.load_cell(ORBIT),
              traced=trace.Traced(device_ops=ops, window_us=1.0, steps=1))
    assert obs.device_us("frame_kernel") == 7.0
    assert obs.device_us("shared_culled_kernel") == 7.0
    assert obs.device_us("perray_culled_kernel") == 0.0


def test_readers_find_nothing_without_a_trace():
    for cell in CELLS:
        obs = Obs(cell=harness.load_cell(cell))
        for m in harness.load_cell(cell).per_layer:
            if m["name"].startswith(("device_idle", "launches", "K")):
                assert harness.metric_reader(m["name"])(obs) is None
