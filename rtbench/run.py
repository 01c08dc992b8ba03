"""Run one cell of the port's benchmark once.

    python3 -m rtbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository's root, on a machine with the cell's cards. The
configuration's scene kind (rtbench/scenes/<kind>.py) makes the scene's
inputs from the seed, writes its asset files under $TMPDIR and gives
the program's SceneConfig; the run builds a Renderer(backend="auto",
device="cuda") over them with a FrameLoop, warms up, and then, for
`--seconds`, drives FrameLoop.step() in a closed loop with the mix's
keys, each step after the kind's change to the scene where it makes
one: a step begins when the previous one returned, and a frame counts
once its image is on the host. After the window it holds a seeded
sample of the presented images, and the last, to the reference
(rtbench/reference, over the kind's scene at the step that rendered
each) at seeded pixels, and prints one JSON line last on standard
output.

--trace 0 reports the cell's end-to-end metrics: frame_ms (window over
frames presented), frame_p95_ms (95th percentile of every step's time,
entry to image on the host) or sample_ms (window over path-tracing
samples added), and setup_s (process start to the first timed step, less
the making of the inputs). --trace 1 reports its per-layer metrics,
read by rtbench/metrics/<name>.py from a window of spans around
Renderer.render(), a torch.profiler trace of a few more steps and a
count of host syncs over a few more, with device.busy_s, window_s and
the breakdown.

It exits non-zero without a result where CUDA is missing or has fewer
cards than the cell asks for, where the program or its inputs are not
there, and where the process holds jax, jaxlib, flax or the JAX package
once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import functools  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "rust_wgpu_raytracing_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def p95(values):
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


def end_to_end(step_s, window_s, frames, samples, setup_s) -> dict:
    """The end-to-end metrics of one window: `step_s` every step's time
    (entry to image on the host), `window_s` the window's wall time,
    `frames` presented and `samples` added in it."""
    return {"frame_ms": window_s * 1e3 / frames if frames else math.nan,
            "frame_p95_ms": p95([s * 1e3 for s in step_s])
            if len(step_s) >= 2 else math.nan,
            "sample_ms": window_s * 1e3 / samples if samples else math.nan,
            "setup_s": setup_s}


class Driver:
    """Pushes the mix's key changes, calls `advance(g)` where the scene
    kind changes the scene, then steps the FrameLoop; `g` is the global
    step index (warm-up included)."""

    def __init__(self, loop, replay, advance=None):
        self.loop, self.replay, self.advance = loop, replay, advance
        self.g = 0
        self.held = frozenset()

    def step(self):
        keys = self.replay.keys_at(self.g)
        for k in sorted(self.held - keys):
            self.loop.push_key(k, False)
        for k in sorted(keys - self.held):
            self.loop.push_key(k, True)
        self.held = keys
        if self.advance is not None:
            self.advance(self.g)
        img = self.loop.step()
        self.g += 1
        return img

    def steps(self, n: int):
        import torch

        for _ in range(n):
            with torch.profiler.record_function("rtbench.step"):
                self.step()


def bound_advance(kind, renderer, inputs):
    """The scene kind's change to the program's scene before each step,
    as Driver calls it (`advance(g)`); None where the kind makes none."""
    advance = getattr(kind, "advance", None)
    if advance is None:
        return None
    return functools.partial(advance, renderer, inputs)


def instrument(renderer, render_ms: list) -> None:
    """The harness's spans around the calls FrameLoop.step() makes into
    the Renderer (update, render, the present's encode and its wait),
    as instance attributes: each is a torch.profiler record_function,
    and render's host time a step is appended to `render_ms`."""
    import torch

    def span(name, fn, timed=None):
        def call(*args, **kwargs):
            with torch.profiler.record_function(name):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                if timed is not None:
                    timed.append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    fetch = renderer.fetch_image

    def fetch_image(*args, **kwargs):
        with torch.profiler.record_function("rtbench.present_encode"):
            wait = fetch(*args, **kwargs)
        return span("rtbench.present_wait", wait)
    renderer.update = span("rtbench.update", renderer.update)
    renderer.render = span("rtbench.render", renderer.render, render_ms)
    renderer.fetch_image = fetch_image


def run_cell(cell, *, seed: int, seconds: float, trace: bool, device: str,
             t_start: float = None, root: str = None):
    """One run of `cell`; returns (result dict, check lines). The caller
    has checked the device."""
    import torch

    from . import harness, trace as tracing, traffic, verify
    from .obs import Obs

    t_start = T_START if t_start is None else t_start
    root = root or harness.ROOT
    tr = cell.traffic
    kind = cell.scene
    cuda = torch.device(device).type == "cuda"

    # ---- the inputs, made from the seed (timed apart from set-up) ----
    t_in = time.perf_counter()
    replay = traffic.Replay(tr, cell.config, seed)
    inputs = kind.make_inputs(cell.config, seed)
    asset_dir = tempfile.mkdtemp(prefix="rtbench-assets-")
    assets = kind.write_assets(inputs, asset_dir)
    xs, ys = traffic.pixel_sample(tr, seed, int(tr["check_pixels"]))
    inputs_s = time.perf_counter() - t_in
    log(f"inputs: made in {inputs_s:.3f} s (not in setup_s)")

    # ---- set-up: the program loads the scene, then warms up ----
    os.environ["RWRT_ASSETS"] = asset_dir
    from rust_wgpu_raytracing_tpu_torch import Renderer
    from rust_wgpu_raytracing_tpu_torch.runtime.frame_loop import FrameLoop

    renderer = Renderer(
        kind.program_config(cell.config, tr, replay.start, assets, seed),
        backend="auto", device=device)
    shutil.rmtree(asset_dir, ignore_errors=True)
    loop = FrameLoop(renderer)
    advance = bound_advance(kind, renderer, inputs)
    drv = Driver(loop, replay, advance)
    render_ms = []
    if trace:
        instrument(renderer, render_ms)
    drv.steps(replay.warmup)
    if cuda:
        torch.cuda.synchronize()
    render_ms.clear()

    # ---- the window: a closed loop of FrameLoop.step() ----
    h = tr["height"]
    rows, cols = h - 1 - ys, xs  # presented images are top-down
    kept = traffic.Reservoir(int(tr["check_frames"]), seed)
    step_s, failed, last = [], 0, None
    t0 = time.perf_counter()
    setup_s = t0 - t_start - inputs_s
    first_step = drv.g
    while True:
        ts = time.perf_counter()
        g = drv.g
        try:
            img = drv.step()
        except Exception as err:  # noqa: BLE001 - a failed step is counted
            log(f"step {g} failed: {type(err).__name__}: {err}")
            img = None
        te = time.perf_counter()
        step_s.append(te - ts)
        if img is None:
            failed += 1
        else:
            last = (g, img)
            kept.offer(lambda g=g, img=img: (g, img[rows, cols].copy()))
        if te - t0 >= seconds:
            break
    window_s = te - t0
    steps = drv.g - first_step
    samples = sum(replay.added_sample(g) for g in range(first_step, drv.g))
    frames = steps - failed
    presented = dict(kept.items)
    if last is not None:
        presented[last[0]] = last[1][rows, cols].copy()
    last = None

    result = {"correct": False, "attempted": steps, "failed": failed,
              "metrics": {}, "device": {}}
    e2e = end_to_end(step_s, window_s, frames, samples, setup_s)
    log(f"window: {window_s:.3f} s, {steps} steps, {frames} frames "
        f"presented, {samples} samples added, setup {setup_s:.3f} s")
    if len(step_s) >= 4:
        q = len(step_s) // 4
        log("step ms by quarter of the window: " + ", ".join(
            f"{1e3 * statistics.mean(step_s[i * q:(i + 1) * q]):.3f}"
            for i in range(4)))

    obs = Obs(cell=cell, render_ms=list(render_ms), window_s=window_s,
              window_frames=frames, window_samples=samples)
    if trace:
        g0 = drv.g
        obs.traced = tracing.profile(drv.steps, int(tr["trace_steps"]),
                                     cuda)
        obs.traced_samples = sum(replay.added_sample(g)
                                 for g in range(g0, drv.g))
        length, waiting = obs.traced.span_us("rtbench.render")
        if render_ms:
            log(f"render span a step: {statistics.mean(render_ms):.3f} ms "
                f"in the window; {length / 1e3 / obs.traced.steps:.3f} ms "
                f"under the profiler, {waiting / 1e3 / obs.traced.steps:.3f}"
                " of it waiting on the card")
    if trace and cuda:
        g0 = drv.g
        with tracing.host_syncs() as syncs:
            drv.steps(int(tr["sync_steps"]))
        obs.syncs = len(syncs)
        obs.sync_samples = sum(replay.added_sample(g)
                               for g in range(g0, drv.g))

    if cuda:
        torch.cuda.synchronize()
        result["device"] = {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(cell.workload["chips"]),
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}
    if trace:
        result["metrics"] = harness.read_per_layer(cell, obs, root)
        if cuda and obs.traced is not None:
            result["device"]["busy_s"] = obs.traced.busy_us() / 1e6
            result["device"]["window_s"] = obs.traced.window_us / 1e6
            result["breakdown"] = {"device_ops": obs.traced.by_name(),
                                   "idle_gaps": obs.traced.idle_gaps()}
    else:
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}

    # ---- free the program, then hold its images to the reference ----
    del loop, drv, renderer, img, advance
    render_ms = obs = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = verify.reference_values(cell, inputs, replay, xs, ys,
                                  sorted(presented), seed=seed, device=device)
    share = verify.shares(presented, ref,
                          quantized=int(tr.get("pt_bounces", 0)) == 0)
    worst = max(share.values()) if share else 1.0
    limit = float(cell.limits["bad_px_share"])
    for g in sorted(share):
        log(f"frame at step {g}: bad pixel share {share[g]:.6f}")
    checks = {"bad_px_share": {"value": worst, "limit": limit},
              "frames_checked": {"value": len(share), "limit": 1},
              "failed_steps": {"value": failed, "limit": 0}}
    result["correct"] = bool(share) and worst <= limit and failed == 0
    result["checks"] = checks
    lines = [f"check {k}: {v['value']} (limit {v['limit']})"
             for k, v in checks.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import harness

    cell = harness.load_cell(args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result, lines = run_cell(cell, seed=args.seed, seconds=args.seconds,
                             trace=bool(args.trace), device="cuda")
    found = forbidden_modules()
    if found:
        log(f"the process holds {', '.join(found)}: no result")
        return 3
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
