#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — Renderer(cfg, device="cuda") rendering the
shadowed split frame at 1920x1080 — and checks it:

1. environment: the card (nvidia-smi name and power limit), torch and
   CUDA versions, nvcc, whether triton imports;
2. build: the CUDA kernels from rust_wgpu_raytracing_tpu_torch/csrc
   (nvcc, one shared library, into the git-ignored build/kernels/);
3. each kernel (closest hit, texshade, any-hit) against its plain
   PyTorch version on the card, on the very arguments the 1080p frame
   gives it (texshade also on seeded random u16 taps, since the smoke
   mesh's texture is solid white): (t, face), the sphere planes and the
   occlusion exactly equal, texshade within 0 ulp;
4. the frame: 3 warm-up + 12 frames through the Renderer with the orbit
   key held, every kernel's launch counter above zero over that run,
   the last frame against the same frame composed from the plain
   versions (at most 1 linear u8 level, >= 99.9% exact; bit-exact is
   expected), and a 160x160 terrain frame against the committed golden
   tests/goldens/terrain_shadows.png at the same bar;
5. timing with CUDA events: median ms per frame and Mrays/s
   (Renderer.mrays_per_s), each kernel's time beside its plain version's
   at the frame's shapes.

The scene: the reference's two spheres and the procedural terrain
builtin:terrain:91 (16,200 faces, the largest mesh the all-on-chip path
takes) under the terrain golden's camera and low sun. Any failure raises
and the script exits non-zero; without CUDA it exits 2 before printing a
result. The last line is the result JSON.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

WIDTH, HEIGHT = 1920, 1080
WARMUP, FRAMES = 3, 12


def say(msg: str) -> None:
    print(msg, flush=True)


def smoke_config():
    from rust_wgpu_raytracing_tpu_torch.config import (
        CameraConfig, MeshConfig, RenderConfig, SceneConfig, reference_scene)

    return SceneConfig(
        spheres=reference_scene().spheres,
        meshes=(MeshConfig(obj_path="builtin:terrain:91",
                           translation=(0.0, 0.0, -3.0),
                           light_direction=(6.0, -1.0, 1.0)),),
        camera=CameraConfig(eye=(0.0, -2.0, -1.0), target=(0.0, 0.0, -3.2)),
        render=RenderConfig(width=WIDTH, height=HEIGHT, shadows=True,
                            accel="cull"))


def card_line() -> str:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        raise RuntimeError("nvidia-smi not found")
    out = subprocess.run([smi, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def u8(color):
    import torch

    return torch.round(color.clamp(0, 1) * 255).to(torch.int32)


def frame_bar(a, b):
    """(max linear u8 delta, exact fraction, bitwise equal)."""
    d = (u8(a) - u8(b)).abs()
    return int(d.max()), float((d == 0).float().mean()), bool(
        (a == b).all())


def ulp_gap(a, b) -> int:
    """Largest distance in f32 ulps between two finite f32 tensors."""
    import torch

    def key(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((key(a) - key(b)).abs().max())


def max_abs_err(a, b) -> float:
    """max |a - b| over elements; equal values (inf included) count 0."""
    import torch

    a, b = a.double(), b.double()
    same = a == b
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(d.max())


def time_ms(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    # --- 1. environment ---------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr, flush=True)
        return 2
    card = card_line()
    say(f"[env] card: {card}")
    say(f"[env] torch {torch.__version__}, torch.version.cuda "
        f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    from rust_wgpu_raytracing_tpu_torch.ops.kernels import build

    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    say(f"[env] nvcc --version: {' | '.join(nvcc)}")
    try:
        import triton
        say(f"[env] triton imports: yes ({triton.__version__})")
    except ImportError:
        say("[env] triton imports: no")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build(verbose=True)
    build.library()
    say(f"[build] {os.path.relpath(lib_path)} in "
        f"{time.perf_counter() - t0:.1f} s (flags: {' '.join(build.NVCC_FLAGS)})")

    from rust_wgpu_raytracing_tpu_torch import Renderer
    from rust_wgpu_raytracing_tpu_torch.ops import kernels as K
    from rust_wgpu_raytracing_tpu_torch.ops.megakernel import \
        render_megakernel

    cfg = smoke_config()
    rc = cfg.render
    t0 = time.perf_counter()
    r = Renderer(cfg, device="cuda")
    say(f"[scene] {r.data.num_faces} faces (padded {r.data.padded_faces}), "
        f"{r.data.num_spheres} spheres, {r.data.blk_lo.shape[0]} face "
        f"blocks; built in {time.perf_counter() - t0:.1f} s")

    def frame(uni, kernels):
        return render_megakernel(
            r.data, uni, width=r.width, height=r.height, near=rc.kernel_near,
            far=rc.kernel_far, background=tuple(cfg.background),
            shadows=rc.shadows, quantize=rc.quantize_rgba8, accel=rc.accel,
            kernels=kernels)

    # --- 3. each kernel against its plain version at the frame's shapes ----
    plain = dict(zip((f.__name__ for f in K.KERNELS), K.PLAIN))
    wrapper = {f.__name__: f for f in K.KERNELS}

    def capture(uni):
        """Render one frame, recording every kernel call's arguments."""
        captured = {}

        def recorder(fn):
            def call(*args, **kw):
                captured[fn.__name__] = (args, kw)
                return fn(*args, **kw)
            return call

        frame(uni, K.KernelSet(*(recorder(f) for f in K.KERNELS)))
        torch.cuda.synchronize()
        # the smoke mesh is textured solid white (every tap 65535), which
        # makes texshade's mix trivial: check it on seeded random u16
        # taps at the frame's shapes too
        args, kw = captured["texshade"]
        rng = np.random.default_rng(20261016)
        taps = rng.integers(0, 65536, tuple(args[0].shape), dtype=np.uint16)
        captured["texshade"] = (args, kw, (torch.from_numpy(
            taps.view(np.int16)).cuda(),) + tuple(args[1:]))
        return captured

    def check_against_plain(view, captured):
        """Each kernel bitwise against its plain version on the captured
        arguments; returns {kernel: max_abs_err}."""
        errs = {}
        for name in ("closest_hit", "texshade", "anyhit"):
            args, kw = captured[name][:2]
            runs = [("", args)]
            if name == "texshade":
                runs.append((" (random taps)", captured[name][2]))
            for tag, a in runs:
                got = wrapper[name](*a, **kw)
                want = plain[name](*a, **kw)
                torch.cuda.synchronize()
                if name == "closest_hit":
                    got, want = (got[0], got[1], *got[2]), \
                        (want[0], want[1], *want[2])
                    planes = "t, face, st, sid, snx, sny, snz"
                elif name == "texshade":
                    planes = "pr, pg, pb"
                else:
                    got, want, planes = (got,), (want,), "occ"
                err = max(max_abs_err(x, y) for x, y in zip(got, want))
                exact = all(torch.equal(x, y) for x, y in zip(got, want))
                if name == "texshade":
                    gap = max(ulp_gap(x, y) for x, y in zip(got, want))
                    ok, bar = gap <= 0, f"max gap {gap} ulp (bound 0 ulp)"
                else:
                    ok, bar = exact, "exact equality required"
                shape = "x".join(map(str, a[0].shape))
                say(f"[kernel] {view}: {name}{tag} {'OK' if ok else 'MISMATCH'}"
                    f" vs plain on ({planes}), first arg {shape}; "
                    f"max_abs_err {err!r}; bitwise {exact}; {bar}")
                if not ok:
                    raise AssertionError(
                        f"{name}{tag} disagrees with its plain version")
                errs[name] = max(errs.get(name, 0.0), err)
            if name == "closest_hit":
                hits = int(torch.isfinite(got[0]).sum())
                say(f"[kernel] {view}: {hits} of {got[0].numel()} rays hit "
                    f"the mesh, {int(torch.isfinite(got[2]).sum())} a "
                    f"sphere; {float(torch.isfinite(a[0]).sum(1).float().mean()):.1f}"
                    f" of {a[0].shape[1]} face blocks admitted per tile")
            if name == "anyhit":
                say(f"[kernel] {view}: {int(a[8].sum())} active shadow rays,"
                    f" {int((got[0] > 0).sum())} occluded")
        return errs

    from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
    from rust_wgpu_raytracing_tpu_torch.config import CameraConfig

    captured = capture(r.camera.uniforms().flat())
    errs = check_against_plain("smoke view", captured)
    # a dense view of the same scene (the terrain fills ~60% of the
    # frame): many more hits, visited blocks and shadow rays per tile
    dense_uni = Camera.from_config(CameraConfig(
        eye=(0.0, -0.3, -2.2), target=(0.0, 0.0, -3.0)),
        WIDTH / HEIGHT).uniforms().flat()
    dense = capture(dense_uni)
    for k, v in check_against_plain("dense view", dense).items():
        errs[k] = max(errs[k], v)

    # --- 4. the frame through the Renderer (the user's entry point) -------
    K.reset_launch_counts()
    r.controller.process_key("d", True)  # hold the orbit key
    times = []
    for i in range(WARMUP + FRAMES):
        r.update()
        color, depth = r.render(block=True)
        if i >= WARMUP:
            times.append(r.last_frame_ms)
    launches = K.launch_counts()
    say(f"[frame] launches over {WARMUP + FRAMES} frames: {launches}")
    if not all(launches[f.__name__] > 0 for f in K.KERNELS):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if tuple(color.shape) != (HEIGHT, WIDTH, 3) or \
            not bool(torch.isfinite(color).all()):
        raise AssertionError(f"bad frame: shape {tuple(color.shape)}")
    ref_color, _ = frame(r.camera.uniforms().flat(), K.PLAIN)
    dmax, exact_frac, bitwise = frame_bar(color, ref_color)
    say(f"[frame] 1080p frame vs plain-composed frame: max linear u8 delta "
        f"{dmax}, exact {exact_frac:.6f}, bitwise {bitwise}; mean colour "
        f"{float(color.mean()):.5f}, "
        f"{float((depth < 1).float().mean()):.4f} of pixels hit")
    if dmax > 1 or exact_frac < 0.999:
        raise AssertionError("frame disagrees with the plain-composed frame")

    from rust_wgpu_raytracing_tpu_torch.config import (MeshConfig,
                                                       RenderConfig,
                                                       SceneConfig)
    from rust_wgpu_raytracing_tpu_torch.io.image_out import (
        framebuffer_to_image, read_png)

    golden_cfg = SceneConfig(
        meshes=(MeshConfig(obj_path="builtin:terrain:23",
                           translation=(0.0, 0.0, -3.0),
                           light_direction=(6.0, -1.0, 1.0)),),
        camera=CameraConfig(eye=(0.0, -2.0, -1.0), target=(0.0, 0.0, -3.2)),
        render=RenderConfig(width=160, height=160, shadows=True))
    g, _ = Renderer(golden_cfg, device="cuda").render(block=True)
    golden = read_png(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests", "goldens", "terrain_shadows.png"))
    # golden holds the sRGB encode of linear u8 levels: compare levels
    # through the same encode (a level off is a neighbour's code)
    levels = u8(g).cpu()
    enc = {k: framebuffer_to_image(levels.new_full((1, 1, 3), k).numpy()
                                   / 255.0)[0, 0, 0] for k in range(256)}
    lut = torch.tensor([int(enc[k]) for k in range(256)])
    img = torch.from_numpy(golden[::-1].copy()).to(torch.int64)
    levels = levels.long()
    exact_g = lut[levels] == img
    near_g = exact_g | (lut[(levels - 1).clamp(0, 255)] == img) | \
        (lut[(levels + 1).clamp(0, 255)] == img)
    say(f"[frame] 160x160 terrain frame vs committed golden: exact "
        f"{float(exact_g.float().mean()):.6f}, within 1 level "
        f"{bool(near_g.all())}")
    if not bool(near_g.all()) or float(exact_g.float().mean()) < 0.999:
        raise AssertionError("terrain frame disagrees with its golden")

    # --- 5. timing --------------------------------------------------------
    times.sort()
    med = times[len(times) // 2]
    mrays = WIDTH * HEIGHT / (med * 1e-3) / 1e6
    say(f"[timing] {card}: {WIDTH}x{HEIGHT} shadowed split frame, median "
        f"{med:.3f} ms/frame over {FRAMES} frames (CUDA events; min "
        f"{times[0]:.3f}, max {times[-1]:.3f}), {mrays:.1f} Mrays/s")
    dense_ms = time_ms(lambda: frame(dense_uni, K.KERNELS), 10)
    say(f"[timing] {card}: dense view {WIDTH}x{HEIGHT} shadowed split "
        f"frame {dense_ms:.3f} ms/frame (mean of 10, CUDA events)")
    results = {}
    for name in ("closest_hit", "texshade", "anyhit"):
        # texshade on the random taps: the solid-white ones are trivial
        args = captured[name][2 if name == "texshade" else 0]
        kw = captured[name][1]

        def run_kernel():
            return wrapper[name](*args, **kw)

        def run_plain():
            return plain[name](*args, **kw)
        # turns: plain, kernel, kernel, plain
        p1 = time_ms(run_plain, 2)
        k1 = time_ms(run_kernel, 20)
        k2 = time_ms(run_kernel, 20)
        p2 = time_ms(run_plain, 2)
        results[name] = dict(max_abs_err=errs[name], ms=(k1 + k2) / 2,
                             plain_ms=(p1 + p2) / 2)
        dargs = dense[name][2 if name == "texshade" else 0]
        dms = time_ms(lambda: wrapper[name](*dargs, **kw), 20)
        say(f"[timing] {card}: {name} {results[name]['ms']:.4f} ms "
            f"(kernel) vs {results[name]['plain_ms']:.4f} ms (plain "
            f"PyTorch) at the smoke frame's arguments; kernel {dms:.4f} ms "
            f"at the dense view's")

    base = "rust_wgpu_raytracing_tpu_torch/csrc/"
    replaces = {
        "closest_hit": "rust_wgpu_raytracing_tpu/ops/megakernel.py:382",
        "texshade": "rust_wgpu_raytracing_tpu/ops/megakernel.py:2540",
        "anyhit": "rust_wgpu_raytracing_tpu/ops/megakernel.py:612",
    }
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"{base}{name}.cu",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"]}
        for name in ("closest_hit", "texshade", "anyhit")]}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
