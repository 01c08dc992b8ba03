"""Where a frame's time goes on the card (torch.profiler).

profile_frames drives a Renderer for a few frames under torch.profiler
and returns what PERF.md's section 5 reads: device kernels launched per
frame, device kernel time per frame, the device's busy share of the
host wall time, and the top operators by device time. The numbers come
from the card's own trace (CUPTI), so the function raises on a Renderer
that is not on a CUDA device.

    python3 chip_smoke.py --profile   # the smoke scene, fused and split
"""

from __future__ import annotations

import time

import torch


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profile_frames(renderer, frames: int = 5, warmup: int = 3,
                   top: int = 10) -> dict:
    """Profile `frames` renders (after `warmup` unprofiled ones), each
    with update() first and render(block=True)."""
    if renderer.device.type != "cuda":
        raise ValueError("profile_frames measures the card: the Renderer "
                         f"is on {renderer.device}")
    for _ in range(warmup):
        renderer.update()
        renderer.render(block=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            renderer.update()
            renderer.render(block=True)
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events() if e.device_type == cuda]
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    rows = sorted(prof.key_averages(),
                  key=lambda a: a.self_device_time_total, reverse=True)
    return {
        "frames": frames,
        "device_kernels_per_frame": len(kernels) / frames,
        "device_ms_per_frame": sum(e.time_range.elapsed_us()
                                   for e in kernels) / frames / 1e3,
        "busy_share": busy / wall_us,
        "wall_ms_per_frame": wall_us / frames / 1e3,
        "top": [(a.key, a.count, a.self_device_time_total / 1e3)
                for a in rows[:top] if a.self_device_time_total > 0],
    }
