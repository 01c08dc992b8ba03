"""BENCHMARK.json, the configurations, the mixes and the limits load and
keep to their schemas; every name resolves to its file."""

from __future__ import annotations

import json
import os
import re

import pytest

from rtbench import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["rtbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert not any(a.startswith("/") or ".." in a for a in BENCH["command"])
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for cell in CELLS:
        reported = [m for m in e2e.values() if cell in m.get("workloads",
                                                               CELLS)]
        assert len(reported) >= 2


def test_per_layer_metrics_resolve():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= set(
            e2e[m["moves"]].get("workloads", CELLS))
        assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                           m["name"] + ".py"))
        if m["name"].endswith("_roofline"):
            kernel = m["name"][:-len("_roofline")]
            assert m["unit"] == "%"
            assert os.path.exists(os.path.join(harness.HERE, "roofline",
                                               kernel + ".py"))
        layers.setdefault(m["layer"], []).append(m["name"])
    for cell in CELLS:
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    c = harness.load_cell(cell)
    assert c.workload["chips"] == 1
    assert 1 <= len(c.workload["why"]) <= 200
    cfg, mix = c.config, c.traffic
    assert cfg["name"] == c.workload["config"]
    assert mix["name"] == c.workload["traffic"]
    mesh = cfg["scene"]["mesh"]
    assert cfg["faces"] == 2 * (mesh["grid"] - 1) ** 2
    assert cfg["render"]["accel"] in ("cull", "bvh", "brute")
    assert cfg["render"]["variant"] in ("fused", "split", "auto")
    for key in ("width", "height", "pt_bounces", "pt_spp", "script",
                "warmup", "check_frames", "check_pixels", "trace_steps",
                "sync_steps"):
        assert key in mix
    assert all(set(p) == {"keys", "steps"} for p in mix["script"])
    assert 0.0 <= c.limits["bad_px_share"] < 1.0


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entries(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert 1 <= len(conf["why"]) <= 200 and "\n" not in conf["why"]
    assert 1 <= len(conf["source"]) <= 200 and conf["source"].startswith(
        "https://")
    assert conf["file"].startswith("rtbench/configs/")
    cfg = harness.load_json(os.path.join(harness.ROOT, conf["file"]))
    assert cfg["source"] == conf["source"]
    assert cfg["reduced"] == conf["reduced"] and "assumed" in cfg
