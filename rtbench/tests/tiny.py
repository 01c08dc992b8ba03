"""A tiny copy of the benchmark for CPU tests: the real cells' files and
readers under a temporary root, plus small cells that the CPU renders in
seconds (a 12x12 heightfield at 64x48, two spheres)."""

from __future__ import annotations

import copy
import json
import os
import shutil

from rtbench import harness

TINY_ORBIT = "tiny.orbit"
TINY_PT = "tiny.pt"


def tiny_config(name="tiny", grid=12):
    cfg = harness.load_json(os.path.join(
        harness.HERE, "configs", "refscene-terrain91.json"))
    cfg = copy.deepcopy(cfg)
    cfg["name"] = name
    cfg["scene"]["mesh"].update(grid=grid, texture_size=16,
                                texture_cells=4)
    cfg["faces"] = 2 * (grid - 1) ** 2
    return cfg


def tiny_mix(name, *, bounces=0, spp=0, script=None):
    mix = {"name": name, "width": 64, "height": 48, "pt_bounces": bounces,
           "pt_spp": spp,
           "script": script or [{"keys": ["right"], "steps": 1}],
           "warmup": 2, "start": "orbit", "check_frames": 2,
           "check_pixels": 512, "trace_steps": 2, "sync_steps": 2}
    return mix


def make_root(tmp, limit=0.0):
    """A benchmark root under `tmp` holding the real files and the tiny
    cells; returns its path."""
    root = str(tmp)
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(harness.HERE, os.path.join(root, "rtbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = harness.load_benchmark(root)
    bench["configs"].append({"name": "tiny", "source": "a test scene",
                             "file": "rtbench/configs/tiny.json",
                             "reduced": [], "why": "a CPU test"})
    pt_mix = tiny_mix("tiny-pt", bounces=2, spp=3,
                      script=[{"keys": ["right"], "steps": 1},
                              {"keys": [], "steps": 2}])
    for cell, mix in ((TINY_ORBIT, tiny_mix("tiny-orbit")),
                      (TINY_PT, pt_mix)):
        bench["workloads"].append({"name": cell, "config": "tiny",
                                   "traffic": mix["name"], "chips": 1,
                                   "why": "a CPU test"})
        write(root, f"rtbench/workloads/{mix['name']}.json", mix)
        write(root, f"rtbench/limits/{cell}.json", {"bad_px_share": limit})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            pt = any(".pt" in w for w in m["workloads"])
            m["workloads"].append(TINY_PT if pt else TINY_ORBIT)
    write(root, "BENCHMARK.json", bench)
    write(root, "rtbench/configs/tiny.json", tiny_config())
    return root


def write(root, rel, obj):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)
