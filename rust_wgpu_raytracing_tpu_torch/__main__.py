"""CLI entry point — the reference binary's analogue.

The reference's whole main is `pollster::block_on(run())`
(src/main.rs:3-5): it opens a 600x600 window on the default scene (two
spheres + suzanne, src/lib.rs:1244-1251,532-566) and runs the orbit-
controlled frame loop. Here, on the card unless --device cpu:

    python -m rust_wgpu_raytracing_tpu_torch                 # window shell
    python -m rust_wgpu_raytracing_tpu_torch --shell server  # browser view
    python -m rust_wgpu_raytracing_tpu_torch --shell headless \
        --frames 10 --out frame.png                          # render + save

Scene selection: --scene reference|cube|<config.json> (the JSON schema
is SceneConfig.to_json; render.pt_bounces > 0 in it path-traces, one
sample per frame up to render.pt_spp; render.mip samples the texture
pyramid). --backend oracle draws through the brute-force oracle. Every
shell drives a runtime.frame_loop.FrameLoop; the keyboard of the window
and the browser page is the reference's map (WASD/arrows/Space/LShift,
src/circle_camera_control.rs:32-74). The window shell needs a display
(RuntimeError without one: use --shell server).
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m rust_wgpu_raytracing_tpu_torch",
        description="ray tracer on PyTorch/CUDA (reference: "
                    "clejacquet/rust-wgpu-raytracing)")
    p.add_argument("--scene", default="reference",
                   help="'reference' | 'cube' | path to a SceneConfig "
                        "JSON (default: the reference's live scene)")
    p.add_argument("--width", type=int, default=600,
                   help="framebuffer width (reference default 600)")
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--shadows", action="store_true",
                   help="hard shadows (extension over the reference)")
    p.add_argument("--shell", choices=("window", "server", "headless"),
                   default="window",
                   help="window = tkinter desktop (winit analogue); "
                        "server = HTTP page with the live view (wasm "
                        "analogue); headless = render --frames then exit")
    p.add_argument("--port", type=int, default=8080,
                   help="server shell port")
    p.add_argument("--frames", type=int, default=None,
                   help="stop after N frames (all shells; headless "
                        "renders 1 by default)")
    p.add_argument("--out", default=None,
                   help="PNG path for the final frame")
    p.add_argument("--backend", default="megakernel",
                   choices=("megakernel", "oracle"),
                   help="frame backend: the kernels' frame programs "
                        "(default) or the brute-force oracle")
    p.add_argument("--accel", default=None, choices=("brute", "cull", "bvh"))
    p.add_argument("--variant", default=None,
                   choices=("split", "fused", "auto"),
                   help="frame program (RenderConfig.variant)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on: 'cuda' (default) or "
                        "'cpu'")
    return p


def load_scene_config(args):
    from .config import SceneConfig, cube_scene, reference_scene

    if args.scene == "reference":
        cfg = reference_scene(args.width, args.height, shadows=args.shadows)
    elif args.scene == "cube":
        cfg = cube_scene(args.width, args.height, shadows=args.shadows)
    else:
        with open(args.scene) as fh:
            cfg = SceneConfig.from_json(fh.read())
        rc = dc.replace(cfg.render, width=args.width, height=args.height,
                        shadows=args.shadows or cfg.render.shadows)
        cfg = dc.replace(cfg, render=rc)
    overrides = {k: getattr(args, k) for k in ("accel", "variant")
                 if getattr(args, k) is not None}
    if overrides:
        cfg = dc.replace(cfg, render=dc.replace(cfg.render, **overrides))
    return cfg


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = load_scene_config(args)

    from .runtime.frame_loop import FrameLoop
    from .runtime.renderer import Renderer

    renderer = Renderer(cfg, backend=args.backend, device=args.device)
    if args.shell == "headless":
        loop = FrameLoop(renderer)
        frames = args.frames or 1
        for _ in range(frames):
            loop.step()
        loop.flush()
        print(f"{frames} frames at {renderer.width}x{renderer.height} on "
              f"{args.device}: last frame {renderer.last_frame_ms:.3f} ms",
              flush=True)
    elif args.shell == "server":
        from .runtime.server import RenderServer

        srv = RenderServer(FrameLoop(renderer), port=args.port)
        srv.serve_async()
        print(f"serving http://127.0.0.1:{srv.port}", flush=True)
        try:
            srv.loop.run(n_frames=args.frames)
        finally:
            srv.shutdown()
    else:
        from .runtime.window import Window

        Window(renderer).run(n_frames=args.frames)

    if args.out:
        renderer.save_png(args.out)
        print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
