"""The reference against the port's CPU path, the control, and runs with
the timed path broken underneath.

The tiny cells (tiny.py: a 12x12 heightfield and two spheres at 64x48,
lit frames and a 2-bounce path tracer) run through run_cell on the CPU,
where every kernel wrapper takes its plain PyTorch version; the limit is
0, so one bad pixel fails a run.
"""

from __future__ import annotations

import time

import pytest
import torch

from rtbench import check, control, harness, run
from rtbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"), limit=0.0)


def _run(root, cell, seed=5, seconds=0.6):
    c = harness.load_cell(cell, root)
    return run.run_cell(c, seed=seed, seconds=seconds, trace=False,
                        device="cpu", t_start=time.perf_counter(),
                        root=root)[0]


@pytest.mark.parametrize("cell", [tiny.TINY_ORBIT, tiny.TINY_PT])
def test_reference_matches_the_port(root, cell):
    res = _run(root, cell, seed=2**31 + 77, seconds=1.5)
    assert res["correct"], res["checks"]
    assert res["checks"]["bad_px_share"]["value"] == 0.0
    assert res["checks"]["frames_checked"]["value"] >= 1
    assert res["failed"] == 0 and res["attempted"] >= 1
    names = {m["name"] for m in harness.load_cell(cell, root).end_to_end}
    assert set(res["metrics"]) == names
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", [tiny.TINY_ORBIT, tiny.TINY_PT])
def test_control_reads_bad(root, cell):
    c = harness.load_cell(cell, root)
    for seed in (3, 4):
        assert control.readings(c, seed, "cpu")["bad_px_share"] > 0.02


def _broken(monkeypatch, fault):
    import rust_wgpu_raytracing_tpu_torch.runtime.renderer as rend

    render = rend.Renderer.render
    if fault == "stale_state":
        # a step that leaves the camera and its accumulation as they were
        monkeypatch.setattr(rend.Renderer, "update", lambda self: None)
        return
    if fault == "half_batch":
        def half(self, *args, **kwargs):
            color, depth = render(self, *args, **kwargs)
            color = color.clone()
            color[color.shape[0] // 2:] = 0.0
            return color, depth
        monkeypatch.setattr(rend.Renderer, "render", half)
        return
    if fault == "altered_answer":
        def altered(self, *args, **kwargs):
            color, depth = render(self, *args, **kwargs)
            color = color.clone()
            color[::4] = (color[::4] + 0.25).clamp(0.0, 1.0)
            return color, depth
        monkeypatch.setattr(rend.Renderer, "render", altered)


@pytest.mark.parametrize("fault", ["stale_state", "half_batch",
                                   "altered_answer"])
@pytest.mark.parametrize("cell", [tiny.TINY_ORBIT, tiny.TINY_PT])
def test_broken_path_is_not_correct(root, cell, fault, monkeypatch):
    _broken(monkeypatch, fault)
    res = _run(root, cell)
    assert not res["correct"]
    assert res["checks"]["bad_px_share"]["value"] > 0.0


def test_check_tolerances():
    ref = torch.tensor([[0.5, 0.2, 0.0]])
    codes = check.present_codes(ref)
    assert check.bad_share(codes, ref, quantized=True) == 0.0
    assert check.bad_share(codes, ref + 0.5 / 255, quantized=True) == 0.0
    assert check.bad_share(codes, ref + 3.0 / 255, quantized=True) == 1.0
    assert check.bad_share(codes, ref, quantized=False) == 0.0
    assert check.bad_share(codes + 2, ref, quantized=False) == 1.0
    nan = torch.tensor([[float("nan"), 0.2, 0.0]])
    assert check.bad_share(codes, nan, quantized=False) == 1.0


@pytest.mark.parametrize("cell", [tiny.TINY_ORBIT, tiny.TINY_PT])
def test_traced_run_spans_the_renderer(root, cell):
    c = harness.load_cell(cell, root)
    res, _ = run.run_cell(c, seed=21, seconds=0.8, trace=True, device="cpu",
                          t_start=time.perf_counter(), root=root)
    assert res["correct"], res["checks"]
    # without a card there is no trace: only the host span's reader reads
    name = "enqueue_ms.pt" if cell == tiny.TINY_PT else "enqueue_ms.frame"
    assert set(res["metrics"]) == {name}
    assert res["metrics"][name]["value"] > 0.0
