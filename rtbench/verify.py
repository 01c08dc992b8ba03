"""Hold the presented frames to the reference.

A checked frame is (the global step that presented it, the presented
codes at the sampled pixels). The step before it rendered the frame, so
its camera and, for the path tracer, its sample count come from the
mix's replay, and its geometry from the cell's scene kind at that step.
Path-traced frames of one accumulation share one pass of the reference,
over the geometry of the accumulation's first step, which keeps the mean
at each count it needs.

The reference is rtbench/reference's frame.lit_pixels and
pathtrace.accumulate over the kind's RefScene, or the kind's own
reference_lit and reference_accumulate where it gives them
(rtbench/scenes/__init__.py): those take whatever the kind's
reference_scene returns and the configuration's whole "render".
"""

from __future__ import annotations

import torch

from . import check
from .reference import frame as ref_frame
from .reference import pathtrace as ref_pt

SEED_MASK = 0xFFFFFFFF


def _lit_pixels(scene, cam, xs, ys, *, width, height, render):
    return ref_frame.lit_pixels(scene, cam, xs, ys, width=width,
                                height=height, shadows=render["shadows"])


def _accumulate(scene, cam, xs, ys, *, render, **kwargs):
    return ref_pt.accumulate(scene, cam, xs, ys, **kwargs)


def reference_values(cell, inputs, replay, xs, ys, steps, *, seed, device,
                     dtype=torch.float32):
    """{presenting step: (P, 3) reference linear values} for the frames
    presented at `steps`."""
    tr = cell.traffic
    render = cell.config["render"]
    lit = getattr(cell.scene, "reference_lit", _lit_pixels)
    accumulate = getattr(cell.scene, "reference_accumulate", _accumulate)

    def scene(step):
        return cell.scene.reference_scene(inputs, step, device=device,
                                          dtype=dtype)

    xs_t = torch.as_tensor(xs, device=device)
    ys_t = torch.as_tensor(ys, device=device)
    out = {}
    bounces = int(tr.get("pt_bounces", 0))
    if bounces == 0:
        for g in steps:
            cam, _ = replay.rendered(g - 1)
            out[g] = lit(scene(g - 1), cam, xs_t, ys_t, width=tr["width"],
                         height=tr["height"], render=render)
        return out
    groups = {}
    for g in steps:
        cam, spp = replay.rendered(g - 1)
        first = g - 1  # walk back to the step that rendered sample 1
        while replay.rendered(first)[1] > 1:
            first -= 1
        groups.setdefault(first, []).append((g, spp))
    for first, members in groups.items():
        cam, _ = replay.rendered(first)
        counts = [spp for _, spp in members]
        means = accumulate(
            scene(first), cam, xs_t, ys_t, width=tr["width"],
            height=tr["height"], bounces=bounces, seed=seed & SEED_MASK,
            samples=max(counts), means_at=counts, render=render)
        for g, spp in members:
            out[g] = means[spp]
    return out


def shares(presented: dict, reference: dict, quantized: bool) -> dict:
    """{step: bad pixel share} of presented codes against the reference;
    `quantized`: lit frames (rgba8 before the present)."""
    return {g: check.bad_share(presented[g], reference[g], quantized)
            for g in presented}
