"""The harness finds a configuration, a traffic mix and a metric reader
it has never seen, from new files and a new entry, by name alone."""

from __future__ import annotations

import time

from rtbench import harness, run
from rtbench.obs import Obs
from rtbench.tests import tiny


def test_new_cell_by_name_alone(tmp_path):
    root = tiny.make_root(tmp_path)
    bench = harness.load_benchmark(root)
    bench["configs"].append({"name": "brand-new", "source": "a test",
                             "file": "rtbench/configs/brand-new.json",
                             "reduced": [], "why": "never seen"})
    bench["workloads"].append({"name": "brand-new.fresh-mix",
                               "config": "brand-new",
                               "traffic": "fresh-mix", "chips": 1,
                               "why": "never seen"})
    bench["per_layer"].append({"name": "steps_seen.frame", "unit": "steps",
                               "better": "higher", "source": "program_span",
                               "layer": "runtime", "moves": "frame_ms",
                               "workloads": ["brand-new.fresh-mix"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("frame_ms", "frame_p95_ms"):
            m["workloads"].append("brand-new.fresh-mix")
    tiny.write(root, "BENCHMARK.json", bench)
    tiny.write(root, "rtbench/configs/brand-new.json",
               tiny.tiny_config("brand-new", grid=6))
    mix = tiny.tiny_mix("fresh-mix", script=[{"keys": ["left"],
                                              "steps": 1}])
    tiny.write(root, "rtbench/workloads/fresh-mix.json", mix)
    tiny.write(root, "rtbench/limits/brand-new.fresh-mix.json",
               {"bad_px_share": 0.0})
    (tmp_path / "rtbench" / "metrics" / "steps_seen.frame.py").write_text(
        "def read(obs):\n    return float(len(obs.render_ms))\n")

    cell = harness.load_cell("brand-new.fresh-mix", root)
    assert cell.config["scene"]["mesh"]["grid"] == 6
    assert cell.traffic["script"][0]["keys"] == ["left"]
    assert [m["name"] for m in cell.per_layer] == ["steps_seen.frame"]
    got = harness.read_per_layer(cell, Obs(cell=cell, render_ms=[1.0] * 3),
                                 root)
    assert got == {"steps_seen.frame": {"value": 3.0, "unit": "steps"}}
    res, _ = run.run_cell(cell, seed=9, seconds=0.4, trace=False,
                          device="cpu", t_start=time.perf_counter(),
                          root=root)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
