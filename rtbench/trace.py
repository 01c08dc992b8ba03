"""Reading the card's trace: torch.profiler events reduced to what the
per-layer readers take, and the breakdown of the traced window.

The arithmetic follows the port's runtime/profiler.py, written out
here so that the yardstick stays as it is when the program changes:
device busy time is the union of the device operations' intervals, the
busy share is that over the traced window's wall time, and host syncs
are the operations torch's sync debug mode reports as synchronizing.
"""

from __future__ import annotations

import contextlib
import re
import time
import warnings
from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Tuple

Interval = Tuple[str, float, float]  # (name, start us, end us)
SPAN_PREFIX = "rtbench."  # the harness's own spans (run.instrument)
# CUDA runtime calls in which the host thread may wait for the device: the
# synchronizations, and the copies (a copy to or from pageable memory
# returns only once the stream has reached it)
WAITS = re.compile(r"^cuda(StreamSynchronize|DeviceSynchronize|"
                   r"EventSynchronize|Memcpy)")


def union_us(intervals) -> float:
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


def gaps(intervals) -> List[Tuple[float, float]]:
    """The idle stretches (start, end) between the union's pieces."""
    out, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


def short_name(name: str, limit: int = 160) -> str:
    """A device operation's name without its argument list and leading
    return type, at most `limit` characters."""
    if name.startswith("void "):
        name = name[5:]
    if "::" in name and name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:limit]


@dataclass
class Traced:
    device_ops: List[Interval] = field(default_factory=list)
    host_ops: List[Interval] = field(default_factory=list)
    window_us: float = 0.0
    steps: int = 0

    def busy_us(self) -> float:
        return union_us((s, e) for _, s, e in self.device_ops)

    def span_us(self, span: str) -> Tuple[float, float]:
        """(length, waiting) of the host spans named `span`, summed:
        their length, and the time inside them in CUDA runtime calls
        that may wait for the device (WAITS)."""
        spans = [(s, e) for name, s, e in self.host_ops if name == span]
        waits = [(s, e) for name, s, e in self.host_ops if WAITS.match(name)]
        length = sum(e - s for s, e in spans)
        waiting = sum(max(0.0, min(e, we) - max(s, ws))
                      for s, e in spans for ws, we in waits)
        return length, waiting

    def by_name(self, top: int = 10):
        """[[name, seconds]] of the device operations, most time first."""
        total = defaultdict(float)
        for name, s, e in self.device_ops:
            total[short_name(name)] += e - s
        rows = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[name, us / 1e6] for name, us in rows]

    def idle_gaps(self, top: int = 10):
        """[[what the host was doing, seconds]] of the longest idle
        stretches between device operations: the innermost host operation
        that spans the stretch's middle, under the innermost of the
        harness's spans around it."""
        longest = sorted(gaps((s, e) for _, s, e in self.device_ops),
                         key=lambda g: g[0] - g[1])[:top]
        out = []
        for s, e in longest:
            mid = 0.5 * (s + e)
            over = sorted((h for h in self.host_ops if h[1] <= mid <= h[2]),
                          key=lambda h: h[2] - h[1])
            spans = [h for h in over if h[0].startswith(SPAN_PREFIX)]
            if not over:
                name = "no host operation"
            elif spans and spans[0] is not over[0]:
                name = f"{spans[0][0]} > {over[0][0]}"
            else:
                name = over[0][0]
            out.append([name, (e - s) / 1e6])
        return out


def profile(run_steps, steps: int, cuda: bool = True) -> Traced:
    """Run `run_steps(steps)` under torch.profiler (host and, with
    `cuda`, device activities) and keep every operation's interval."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_steps(steps)
        if cuda:
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    traced = Traced(window_us=wall_us, steps=steps)
    for e in prof.events():
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type != cuda:
            traced.host_ops.append(row)
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name.startswith(SPAN_PREFIX)):
            # the device copy of a host span is no device operation
            traced.device_ops.append(row)
    return traced


@contextlib.contextmanager
def host_syncs():
    """Count the synchronizing CUDA operations run inside the block
    (torch.cuda.set_sync_debug_mode("warn")); yields a list whose len()
    is the count when the block ends."""
    import torch

    seen = []
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield seen
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    seen.extend(w for w in caught if "synchronizing" in str(w.message))
