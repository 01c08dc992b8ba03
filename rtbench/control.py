"""The comparison's control: the reference in bfloat16 put in the
program's place, at a cell's own size.

    python3 -m rtbench.control --workload <cell> --seeds 1 2 3

For each seed it makes the cell's inputs, takes frames at cameras and
sample counts the cell's window shows (drawn from the seed), computes
the reference at the cell's sampled pixels in float32 and in bfloat16,
presents the bfloat16 values with the program's encode and compares them
to the float32 values exactly as a run compares the program's images. It
prints one JSON line per seed: the bad pixel share of each frame and the
largest. The configuration's precision is float32, so bfloat16 is the
step below it; the control has to read above the cell's limit.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import check, harness, traffic, verify


def control_frames(cell, replay, seed: int):
    """Presenting steps a window could check: for lit frames four steps
    in the first 300 after the warm-up; for the path tracer one frame of
    the first accumulation after the warm-up with 16 to 64 samples."""
    rng = traffic.seeded_rng(seed, 4)
    w = replay.warmup
    if int(cell.traffic.get("pt_bounces", 0)) == 0:
        return sorted(w + 1 + int(k) for k in
                      rng.choice(300, size=4, replace=False))
    g = w
    while replay.rendered(g)[1] != 1:
        g += 1
    return [g + int(rng.integers(16, 65))]


def readings(cell, seed: int, device: str, dtype=torch.bfloat16) -> dict:
    tr = cell.traffic
    replay = traffic.Replay(tr, cell.config, seed)
    inputs = cell.scene.make_inputs(cell.config, seed)
    xs, ys = traffic.pixel_sample(tr, seed, int(tr["check_pixels"]))
    steps = control_frames(cell, replay, seed)
    ref = verify.reference_values(cell, inputs, replay, xs, ys, steps,
                                  seed=seed, device=device)
    low = verify.reference_values(cell, inputs, replay, xs, ys, steps,
                                  seed=seed, device=device, dtype=dtype)
    presented = {g: check.present_codes(low[g]) for g in steps}
    share = verify.shares(presented, ref,
                          quantized=int(tr.get("pt_bounces", 0)) == 0)
    return {"cell": cell.name, "seed": seed, "dtype": str(dtype),
            "frames": {str(g): share[g] for g in steps},
            "bad_px_share": max(share.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
