"""One short run of the main cell on the card (skipped without one)."""

from __future__ import annotations

import time

import pytest


@pytest.mark.gpu
def test_main_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rtbench import harness, run

    cell = harness.load_cell("refscene-terrain91.orbit-1080p")
    res, _ = run.run_cell(cell, seed=4242, seconds=1.0, trace=False,
                          device="cuda", t_start=time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
