"""Everything the benchmark finds by name.

BENCHMARK.json lists the metrics, configurations and cells; each
configuration is rtbench/configs/<name>.json, each traffic mix
rtbench/workloads/<name>.json, each per-layer metric's reader
rtbench/metrics/<name>.py (a `read(obs)` that returns a number or None),
each scene kind rtbench/scenes/<kind>.py (what makes a configuration's
scene for the program and for the reference: rtbench/scenes/__init__.py)
and each cell's correctness limits rtbench/limits/<cell>.json. A new
scene kind, scene, mix, metric or cell is new files and new entries:
nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    workload: dict  # the BENCHMARK.json entry
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    scene: object  # the configuration's scene kind (scene_kind)


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = os.path.join(root, "rtbench")
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(here, "workloads",
                                     w["traffic"] + ".json"))
    scene = scene_kind(config, root)
    pathtraced = int(traffic.get("pt_bounces", 0)) > 0
    if scene.MOVES and pathtraced:
        raise ValueError(
            f"workload {name!r}: the scene kind {_kind(config)!r} moves "
            "its geometry between steps, and the path tracer's reference "
            "accumulates its samples over fixed geometry")
    if (pathtraced and hasattr(scene, "reference_lit")
            and not hasattr(scene, "reference_accumulate")):
        raise ValueError(
            f"workload {name!r}: the scene kind {_kind(config)!r} gives "
            "reference_lit but no reference_accumulate, and the path "
            "tracer's reference (rtbench/reference/pathtrace.py) knows "
            "only a RefScene")
    return Cell(
        name=name, workload=w, config=config, traffic=traffic,
        limits=load_json(os.path.join(here, "limits", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        scene=scene)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kind(config: dict) -> str:
    return config["scene"].get("kind", "heightfield")


def scene_kind(config: dict, root: str = ROOT):
    """The module of the configuration's scene kind, rtbench/scenes/<kind>.py
    ("heightfield" where its scene names no "kind")."""
    kind = _kind(config)
    rel = f"rtbench/scenes/{kind}.py"
    path = os.path.join(root, rel)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no scene kind {kind!r}: {rel} is missing")
    return load_module(path, "rtbench_scene_" + kind.replace(".", "_"))


def metric_reader(name: str, root: str = ROOT) -> Callable:
    path = os.path.join(root, "rtbench", "metrics", name + ".py")
    return load_module(path, "rtbench_metric_" + name.replace(".", "_")).read


def read_per_layer(cell: Cell, obs, root: str = ROOT) -> Dict[str, dict]:
    """Each per-layer metric of the cell that its reader finds, by name;
    a reader that finds nothing to read returns None and is left out."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"], root)(obs)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
