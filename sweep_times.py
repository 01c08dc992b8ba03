#!/usr/bin/env python3
"""Time the port's all-on-chip sweeps K1 (closest_hit), K3 (anyhit), K4
(frame), K7 (closest_hit_perray) and K8 (extend_shadow), the LBVH-cut
cull K5 (hier_cull) and the streamed path tracer's superblock admission
(super_any), on one NVIDIA GPU, against another checkout of the port if
asked.

    python3 sweep_times.py [--against DIR]

Each kernel runs at the arguments the port's own glue gives it in
chip_smoke.py's scenes at 1920x1080: the split frame at the smoke view
and at the dense view (K1's primary sweep, K3's shadow rays), the fused
frame at both views and at the Renderer's orbit frames 4-8 (the frames
chip_smoke.py --profile profiles; K4 in each of its four modes on the
same arguments), the path tracer's first sample (K1's primary sweep,
K3's last-bounce shadow rays, K8's bounce-1 wavefront and K7 on its
extension rays, K7's arguments from the checkout's own gbuffer_perray)
and the streamed terrain:512 frame under
accel="bvh" (K5's primary and shadow-wavefront culls), and the 960x540
3-bounce path tracer of terrain:512 (super_any at its bounce-1
wavefront; a checkout without the kernel times the plain function
traverse.perray_super_any, which its glue runs). A time is the
mean of 20 launches after one, by CUDA events (K5's by its kernels'
device time in torch.profiler's trace: its wrapper's host work takes
longer than the kernel); at the orbit frames the mean of the five
frames' times.

With --against DIR (another checkout of the port, e.g. an earlier
commit unpacked with `git archive`), both checkouts run, each in its own
process that builds its own kernels and records its own arguments, in
turns: this one, the other, the other, this one. Each line gives a
kernel and an argument set with each checkout's two times; the card's
name and power limit come before the last line. Exits 2 without CUDA.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def child(root: str) -> None:
    """Record and time the sweeps of the checkout at `root`; one JSON
    line per (kernel, argument set)."""
    sys.path.insert(0, root)
    import torch

    from rust_wgpu_raytracing_tpu_torch import Renderer
    from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
    from rust_wgpu_raytracing_tpu_torch.config import CameraConfig
    from rust_wgpu_raytracing_tpu_torch.ops import kernels as K
    from rust_wgpu_raytracing_tpu_torch.ops import megakernel as MK
    from rust_wgpu_raytracing_tpu_torch.ops.kernels import build
    from rust_wgpu_raytracing_tpu_torch.ops.megakernel import \
        render_megakernel
    from rust_wgpu_raytracing_tpu_torch.ops.kernels.frame import MODES
    from rust_wgpu_raytracing_tpu_torch.ops.pathtrace import (
        PRNGKey, fold_in, render_pathtrace)
    from rust_wgpu_raytracing_tpu_torch.ops.traverse import perray_super_any

    # chip_smoke.py's scenes and timer, from this script's checkout
    spec = importlib.util.spec_from_file_location(
        "smoke_scenes", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    build.build()

    def record(run):
        calls = {}

        def recorder(fn):
            def call(*args, **kwargs):
                calls.setdefault(fn.__name__, []).append((args, kwargs))
                return fn(*args, **kwargs)
            return call
        run(K.KernelSet(*(recorder(f) for f in K.KERNELS)))
        torch.cuda.synchronize()
        return calls

    cfg = cs.smoke_config("split")
    rc = cfg.render
    data = Renderer(cfg, device="cuda").data
    cases = []
    for view, eye, target in (("smoke view", cs.SMOKE_EYE, cs.SMOKE_TARGET),
                              ("dense view", cs.DENSE_EYE, cs.DENSE_TARGET)):
        uni = Camera.from_config(CameraConfig(eye=eye, target=target),
                                 cs.WIDTH / cs.HEIGHT).uniforms().flat()
        calls = record(lambda ks: render_megakernel(
            data, uni, width=cs.WIDTH, height=cs.HEIGHT,
            near=rc.kernel_near, far=rc.kernel_far,
            background=tuple(cfg.background), shadows=True,
            quantize=rc.quantize_rgba8, accel=rc.accel, fused=False,
            kernels=ks))
        cases += [("closest_hit", view, calls["closest_hit"][0]),
                  ("anyhit", view, calls["anyhit"][0])]
        calls = record(lambda ks: render_megakernel(
            data, uni, width=cs.WIDTH, height=cs.HEIGHT,
            near=rc.kernel_near, far=rc.kernel_far,
            background=tuple(cfg.background), shadows=True,
            quantize=rc.quantize_rgba8, accel=rc.accel, fused=True,
            kernels=ks))
        args, kw = calls["frame"][0]
        cases += [("frame", f"{view} (mode {m})", (args, dict(kw, mode=m)))
                  for m in MODES]
    # the orbit frames, each after update() with the orbit key held
    orbit = Renderer(cs.smoke_config("fused"), device="cuda")
    orbit.controller.process_key("d", True)
    frames = []
    for i in range(cs.WARMUP + 5):
        orbit.update()
        if i >= cs.WARMUP:
            uni = orbit.camera.uniforms().flat()
            frames.append(record(lambda ks: render_megakernel(
                data, uni, width=cs.WIDTH, height=cs.HEIGHT,
                near=rc.kernel_near, far=rc.kernel_far,
                background=tuple(cfg.background), shadows=True,
                quantize=rc.quantize_rgba8, accel=rc.accel, fused=True,
                kernels=ks))["frame"][0])
    orbits = [("frame", f"the orbit frames {cs.WARMUP + 1}-{cs.WARMUP + 5} "
               f"(mode {m})", [(a, dict(k, mode=m)) for a, k in frames])
              for m in MODES]
    assets = tempfile.mkdtemp(prefix="rt_sweeps_")
    os.environ["RWRT_ASSETS"] = assets
    cs.write_nm_assets(assets)
    pt_cfg = cs.pt_config()
    pt = Renderer(pt_cfg, device="cuda")
    key = fold_in(PRNGKey(cs.PT_SEED), 0)  # the Renderer's first sample
    calls = record(lambda ks: render_pathtrace(
        pt.data, pt.camera.uniforms().flat(), key,
        width=cs.WIDTH, height=cs.HEIGHT, bounces=cs.PT_BOUNCES, spp=1,
        background=tuple(pt_cfg.background), compact_cap="auto",
        kernels=ks))
    es_args = calls["extend_shadow"][0][0]  # the bounce-1 wavefront
    d, o = es_args[2:5], es_args[5:8]
    k7 = record(lambda ks: MK.gbuffer_perray(pt.data, *o, *d, kernels=ks))
    cases += [("closest_hit", "the path tracer's primary sweep",
               calls["closest_hit"][0]),
              ("anyhit", "the path tracer's last bounce",
               calls["anyhit"][-1]),
              ("extend_shadow", "the path tracer's bounce 1",
               calls["extend_shadow"][0]),
              ("closest_hit_perray", "the path tracer's bounce 1 (its "
               "extension rays)", k7["closest_hit_perray"][0])]
    del pt
    scfg = cs.stream_config("bvh")
    sdata = Renderer(scfg, device="cuda").data
    suni = Camera.from_config(scfg.camera, cs.WIDTH / cs.HEIGHT).uniforms(
        ).flat()
    calls = record(lambda ks: render_megakernel(
        sdata, suni, width=cs.WIDTH, height=cs.HEIGHT, shadows=True,
        accel="bvh", fused=False, kernels=ks))
    cases += [("hier_cull", "the bvh frame's primary cull",
               calls["hier_cull"][0]),
              ("hier_cull", "the bvh frame's shadow cull",
               calls["hier_cull"][1])]
    del sdata
    # the streamed path tracer's admission at its bounce-1 wavefront,
    # rebuilt from K10's arguments (a checkout before the kernel has no
    # wrapper to record: there the plain function is what the glue runs)
    pcfg = cs.pt_stream_config()
    pdata = Renderer(pcfg, device="cuda").data
    calls = record(lambda ks: render_pathtrace(
        pdata, Camera.from_config(pcfg.camera, cs.PTS_W / cs.PTS_H).uniforms(
            ).flat(), fold_in(PRNGKey(cs.PT_SEED), 0), width=cs.PTS_W,
        height=cs.PTS_H, bounces=cs.PTS_BOUNCES, spp=1, compact_cap="auto",
        kernels=ks))
    dx, dy, dz, ox, oy, oz = calls["stream_closest_hit_perray"][0][0][3:9]
    try:
        from rust_wgpu_raytracing_tpu_torch.ops.scenepacks import super_boxes
        slo, shi = super_boxes(pdata)
    except ImportError:  # a checkout before the scene's packs had an owner
        _, _, slo, shi = MK._super_aabbs(pdata, pdata.padded_faces // 1024)
    live = (dx != 0.0) | (dy != 0.0) | (dz != 0.0)
    cases.append(("super_any", "the 540p streamed path tracer's bounce 1",
                  ((slo, shi, ox, oy, oz, dx, dy, dz, 1024),
                   {"act": live})))
    wrapper = {f.__name__: f for f in K.KERNELS}
    wrapper.setdefault("super_any", perray_super_any)
    for name, at, sets in cases + orbits:
        sets = sets if isinstance(sets, list) else [sets]
        if name == "hier_cull":  # shorter than its wrapper's host work
            ms = float(np.mean([cs.device_ms(
                lambda: wrapper[name](*args, **kw), 20,
                "hier_cull_kernel")[0] for args, kw in sets]))
        else:
            ms = float(np.mean([
                cs.time_ms(lambda: wrapper[name](*args, **kw), 20)
                for args, kw in sets]))
        print(json.dumps({"kernel": name, "at": at, "ms": ms}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_times: torch.cuda.is_available() is false; this needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    other = None
    if args[:1] == ["--against"] and len(args) == 2:
        other = os.path.abspath(args[1])
    elif args:
        print(__doc__, file=sys.stderr)
        return 2
    label = {HERE: "this checkout", other: f"against {other}"}
    turns = [HERE] if other is None else [HERE, other, other, HERE]
    times = {}
    for root in turns:
        res = subprocess.run([sys.executable, __file__, "--child", root],
                             capture_output=True, text=True, timeout=1200)
        if res.returncode:
            print(f"sweep_times: {root} failed:\n{res.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        for line in res.stdout.splitlines():
            if line.startswith("{"):
                rec = json.loads(line)
                times.setdefault((rec["kernel"], rec["at"]), {}).setdefault(
                    root, []).append(rec["ms"])
    import chip_smoke

    for (name, at), by_root in times.items():
        how = ("device time by torch.profiler" if name == "hier_cull"
               else "CUDA events")
        frames = ", the mean of the five frames" if "orbit" in at else ""
        print(f"[sweeps] {name} at {at}'s arguments, ms ({how}, mean of 20 "
              f"launches{frames}): " + "; ".join(
                  f"{label[root]} " + ", ".join(f"{ms:.4f}" for ms in v)
                  for root, v in by_root.items()), flush=True)
    print(chip_smoke.card_line())
    print(json.dumps({"ok": True, "turns": len(turns)}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
