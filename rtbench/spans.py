"""The program's own spans and counters (the port's runtime/profiler.py),
as the per-layer readers and the breakdown take them.

The port records spans only when its recorder is switched on, and its
counters always; while torch.profiler runs, each program span is also a
record_function named "rt." + its name, on the device operations'
clock. Here:

- program_counters(): the program's counters, or None where the program
  has none (an older checkout): a reader then finds nothing to read.
- render_host_ms(spans, n): the host time of the program's "render"
  spans less the waits inside them, over n frames or samples.
- host_spans(spans, steps, traced): each program span's self time, its
  waits and, from a torch.profiler trace, its CUDA launch calls, a step.
- idle_by_span(traced): a trace's idle device time by the innermost
  "rt." span around each gap's middle.

    python3 -m rtbench.spans --workload <cell> --seed <n>

runs one cell as rtbench/run.py sets it up (no window, no check against
the reference) and prints one JSON line: the set-up spans; after the
warm-up, the readings above from trace_steps steps with the recorder on
and no profiler, and the time of as many steps with it off; as many
profiled steps with the program's spans and without them; the recorder's
steps again, after the profiler has run; the host syncs of sync_steps
steps by site (torch's sync debug mode beside the program's wait
counters); and whether the frames of a fresh Renderer are bitwise the
same with the recorder on and off.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import re
import sys
import time
import warnings

RT = "rt."  # the program's spans in a torch.profiler trace
# the profiler's own buffer handling, which a gap may fall in
PROFILER_OWN = ("Activity Buffer Request", "Buffer Flush")
OUTSIDE = "outside render"
# CUDA runtime calls that queue one device operation
LAUNCHES = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel|cudaMemcpyAsync|"
                      r"cudaMemsetAsync)")


def program_counters():
    """The port's counters (runtime/profiler.counters()), or None where
    the program has no recorder."""
    try:
        from rust_wgpu_raytracing_tpu_torch.runtime import profiler
    except ImportError:
        return None
    read = getattr(profiler, "counters", None)
    return read() if callable(read) else None


def _waits_below(spans, i: int) -> int:
    """ns of the wait spans inside span i (drained spans, in open order:
    a span's descendants follow it)."""
    total, end = 0, spans[i].end_ns
    for s in spans[i + 1:]:
        if s.start_ns >= end:
            break
        if s.kind == "wait" and _inside(spans, s, i):
            total += s.end_ns - s.start_ns
    return total


def _inside(spans, s, i: int) -> bool:
    p = s.parent
    while p > i:
        p = spans[p].parent
    return p == i


def render_host_ms(spans, n: int):
    """ms a frame or sample of the "render" spans less the waits inside
    them; None without render spans or with n <= 0."""
    idx = [i for i, s in enumerate(spans) if s.name == "render"]
    if not idx or n <= 0:
        return None
    ns = sum(spans[i].end_ns - spans[i].start_ns - _waits_below(spans, i)
             for i in idx)
    return ns / 1e6 / n


def _label(intervals, points):
    """For each point (sorted), the name of the shortest interval
    (name, start, end) that holds it, or None."""
    out = [None] * len(points)
    for name, s, e in sorted(intervals, key=lambda h: h[1] - h[2]):
        lo = bisect.bisect_left(points, s)
        hi = bisect.bisect_right(points, e)
        for k in range(lo, hi):
            out[k] = name  # the longest first: the innermost wins
    return out


def _rt_spans(traced):
    return [(name[len(RT):], s, e) for name, s, e in traced.host_ops
            if name.startswith(RT)]


def idle_by_span(traced):
    """[[span, idle seconds a step]] of a torch.profiler trace (Traced),
    most first: each gap between device operations goes to the innermost
    program span around its middle, to the profiler's own buffer
    handling where that holds the middle, or to OUTSIDE."""
    from .trace import gaps

    if traced is None or traced.steps <= 0:
        return []
    holes = sorted(gaps((s, e) for _, s, e in traced.device_ops))
    mids = [0.5 * (s + e) for s, e in holes]
    names = _label(_rt_spans(traced), mids)
    own = _label([h for h in traced.host_ops if h[0] in PROFILER_OWN], mids)
    total = collections.defaultdict(float)
    for (s, e), name, prof in zip(holes, names, own):
        total[prof or name or OUTSIDE] += (e - s) / 1e6 / traced.steps
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])]


def launches_by_span(traced):
    """{span: CUDA launch calls a step} of a torch.profiler trace, each
    call under the innermost program span whose host interval holds its
    start (OUTSIDE where none does)."""
    if traced is None or traced.steps <= 0:
        return {}
    starts = sorted(s for name, s, _ in traced.host_ops
                    if LAUNCHES.match(name))
    names = _label(_rt_spans(traced), starts)
    counts = collections.Counter(n or OUTSIDE for n in names)
    return {k: v / traced.steps for k, v in counts.items()}


def host_spans(spans, steps: int, traced=None):
    """[[span, self ms, wait ms, launches]] a step: self and wait time
    from the recorder's spans over `steps` steps (a wait's own time is
    its span's; the waits directly inside a span are its wait time), the
    launches from `traced` (launches_by_span)."""
    from rust_wgpu_raytracing_tpu_torch.runtime.profiler import self_ns

    if steps <= 0:
        return []
    own = self_ns(spans)
    self_ms = collections.defaultdict(float)
    wait_ms = collections.defaultdict(float)
    for s, ns in zip(spans, own):
        self_ms[s.name] += ns / 1e6 / steps
        if s.kind == "wait" and s.parent >= 0:
            wait_ms[spans[s.parent].name] += s.ns / 1e6 / steps
    launches = launches_by_span(traced)
    names = sorted(set(self_ms) | set(launches),
                   key=lambda n: -self_ms.get(n, 0.0))
    return [[n, self_ms.get(n, 0.0), wait_ms.get(n, 0.0),
             launches.get(n, 0.0)] for n in names]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync_sites(run_steps, steps: int):
    """(count, {site: count}) of the synchronizing CUDA operations in
    run_steps(steps), as torch's sync debug mode reports them; a site is
    the innermost Python frames of the call that synchronized."""
    import traceback

    import torch

    where = collections.Counter()

    def seen(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if not f.filename.endswith("warnings.py")]
        where[" < ".join(f"{'/'.join(f.filename.split('/')[-2:])}:"
                         f"{f.lineno} {f.name}"
                         for f in reversed(frames[-4:]))] += 1

    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run_steps(steps)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return sum(where.values()), dict(where)


def _images(cell, seed, inputs, assets, steps: int, on: bool,
            device: str):
    """The images of `steps` FrameLoop steps of a fresh Renderer, with
    the recorder on or off."""
    import torch

    from rust_wgpu_raytracing_tpu_torch import Renderer
    from rust_wgpu_raytracing_tpu_torch.runtime import profiler
    from rust_wgpu_raytracing_tpu_torch.runtime.frame_loop import FrameLoop

    from . import run, traffic

    replay = traffic.Replay(cell.traffic, cell.config, seed)
    renderer = Renderer(cell.scene.program_config(
        cell.config, cell.traffic, replay.start, assets, seed),
        backend="auto", device=device)
    drv = run.Driver(FrameLoop(renderer), replay,
                     run.bound_advance(cell.scene, renderer, inputs))
    profiler.enable(on)
    images = [drv.step() for _ in range(steps)]
    profiler.enable(False)
    profiler.drain()
    del drv, renderer
    if device == "cuda":
        torch.cuda.empty_cache()
    return images


def measure(cell, seed: int, device: str = "cuda") -> dict:
    """The readings of the module docstring for one cell and seed."""
    import os
    import shutil
    import tempfile

    import torch

    from rust_wgpu_raytracing_tpu_torch import Renderer
    from rust_wgpu_raytracing_tpu_torch.runtime import profiler
    from rust_wgpu_raytracing_tpu_torch.runtime.frame_loop import FrameLoop

    from . import run, trace, traffic

    tr = cell.traffic
    kind = cell.scene
    cuda = device == "cuda"
    replay = traffic.Replay(tr, cell.config, seed)
    inputs = kind.make_inputs(cell.config, seed)
    asset_dir = tempfile.mkdtemp(prefix="rtbench-assets-")
    assets = kind.write_assets(inputs, asset_dir)
    os.environ["RWRT_ASSETS"] = asset_dir
    out = {"cell": cell.name, "seed": seed}

    profiler.drain()
    profiler.enable()
    renderer = Renderer(kind.program_config(cell.config, tr, replay.start,
                                            assets, seed),
                        backend="auto", device=device)
    profiler.enable(False)
    setup, counts = profiler.drain()
    out["setup_ms"] = {s.name: s.ns / 1e6 for s in setup}
    out["scene_build_s"] = counts.get("ns.setup.scene_build", 0) / 1e9
    loop = FrameLoop(renderer)
    drv = run.Driver(loop, replay, run.bound_advance(kind, renderer, inputs))
    run.instrument(renderer, [])
    drv.steps(replay.warmup)
    if cuda:
        torch.cuda.synchronize()
    n = int(tr["trace_steps"])
    pt = int(tr.get("pt_bounces", 0)) > 0

    def added(g0):
        return sum(replay.added_sample(g) for g in range(g0, drv.g))

    def segment(on: bool):
        """n steps without the profiler: (spans, counters, ms a step,
        frames or samples)."""
        g0 = drv.g
        profiler.drain()
        profiler.enable(on)
        t0 = time.perf_counter()
        drv.steps(n)
        if cuda:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n
        profiler.enable(False)
        spans, counts = profiler.drain()
        return spans, counts, ms, added(g0) if pt else n

    # the recorder's segment (on, no profiler), then as many steps off
    spans, counts, ms, per = segment(True)
    out["segment_ms_a_step"] = {"on": ms, "off": segment(False)[2]}
    out["render_host_ms"] = render_host_ms(spans, per)
    out["waits"] = {k: v for k, v in counts.items() if k.startswith("syncs.")}
    out["pt_branch"] = {k: v for k, v in counts.items()
                        if k.startswith("pt.")}
    out["syncs_per_sample"] = (sum(out["waits"].values()) / per
                               if pt and per else None)

    # the profiled steps, with the program's spans and without them
    g0 = drv.g
    traced = trace.profile(drv.steps, n, cuda)
    traced_samples = added(g0)
    real = profiler._autograd_profiler
    profiler._autograd_profiler = type("Off", (), {
        "_is_profiler_enabled": False})
    try:
        bare = trace.profile(drv.steps, n, cuda)
    finally:
        profiler._autograd_profiler = real
    per_traced = traced_samples if pt else n
    length, waiting = traced.span_us("rtbench.render")
    out["enqueue_ms"] = ((length - waiting) / 1e3 / per_traced
                         if per_traced else None)
    out["device_ops_a_step"] = {"rt_spans": len(traced.device_ops) / n,
                                "no_spans": len(bare.device_ops) / n}
    out["launch_calls_a_step"] = sum(launches_by_span(traced).values())
    out["idle_by_span"] = idle_by_span(traced)
    out["idle_s_a_step"] = (traced.window_us - traced.busy_us()) / 1e6 / n
    out["host_spans"] = host_spans(spans, n, traced)

    # the recorder's segment again, after the profiler has run
    after, _, ms, per = segment(True)
    out["after_profiler"] = {"segment_ms_a_step": ms,
                             "render_host_ms": render_host_ms(after, per)}

    # the host syncs by site
    g0 = drv.g
    if cuda:
        found, where = sync_sites(drv.steps, int(tr["sync_steps"]))
        samples = added(g0)
        out["host_syncs_per_sample"] = found / samples if samples else None
        out["sync_sites"] = where
    waits = profiler.drain()[1]
    out["sync_steps_waits"] = {k: v for k, v in waits.items()
                               if k.startswith("syncs.")}
    del loop, drv, renderer
    if cuda:
        torch.cuda.empty_cache()

    steps = max(4, n // 4)
    off = _images(cell, seed, inputs, assets, steps, False, device)
    on = _images(cell, seed, inputs, assets, steps, True, device)
    out["bitwise_on_off"] = all(
        (a is None and b is None) or (a is not None and b is not None
                                      and (a == b).all())
        for a, b in zip(off, on))
    shutil.rmtree(asset_dir, ignore_errors=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)

    import torch

    from . import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        log("needs a CUDA device")
        return 2
    out = measure(cell, args.seed)
    out["card"] = torch.cuda.get_device_name(0)
    for row in out["idle_by_span"]:
        log(f"idle {row[0]}: {row[1] * 1e3:.3f} ms a step")
    for row in out["host_spans"]:
        log(f"span {row[0]}: self {row[1]:.3f} ms, waits {row[2]:.3f} ms, "
            f"{row[3]:.1f} launches a step")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
