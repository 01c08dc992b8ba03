"""Each kernel's least work, one file a kernel (rtbench/roofline/<K>.py).

A file names the kernel's CUDA function (KERNEL) and gives work(shape)
-> (operations, bytes) for the kernel's share of one frame or one
path-tracing sample at the cell's sizes (traced Obs.shape()). Bytes:
every input of the work read once and every output written once, at
the least width that holds it. Operations: a floor every correct
implementation must do; where none is defensible it is 0 and the share
is bound by bytes alone. The count comes from the cell's sizes, never
from the walk a kernel does, so a kernel that culls better or is fused
into another cannot move it.
"""

from __future__ import annotations

import json
import os

F32 = 4
I32 = 4
# the smallest record a triangle needs: three f32 corners
TRIANGLE = 9 * F32


def peaks() -> dict:
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "peaks.json")) as fh:
        return json.load(fh)


def share(obs, kernel_module) -> float | None:
    """Percent of the kernel's roofline: the least time its work takes at
    the published peaks over its device time, per frame or per sample.
    None where the trace holds no launch of the kernel."""
    if obs.traced is None:
        return None
    per = obs.traced_samples if obs.pathtrace else obs.traced.steps
    us = obs.device_us(kernel_module.KERNEL)
    if us <= 0 or per <= 0:
        return None
    flops, nbytes = kernel_module.work(obs.shape())
    pk = peaks()
    least_s = max(flops / pk["flops_per_s"], nbytes / pk["bytes_per_s"])
    return 100.0 * least_s / (us * 1e-6 / per)
