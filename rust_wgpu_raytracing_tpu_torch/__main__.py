"""CLI entry point — the reference binary's analogue, headless shell only.

    python -m rust_wgpu_raytracing_tpu_torch --shell headless \
        --device cuda --frames 10 --out frame.png

Scene selection: --scene reference|cube|<config.json> (the JSON schema
is SceneConfig.to_json; render.pt_bounces > 0 in it path-traces, one
sample per frame up to render.pt_spp; render.mip samples the texture
pyramid). --backend oracle draws through the brute-force oracle. The loop is a plain update(); render() per
frame; the window and server shells are later slices (ROADMAP.md).
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
    p.add_argument("--shell", choices=("headless",), default="headless",
                   help="headless = render --frames then exit")
    p.add_argument("--frames", type=int, default=1,
                   help="number of frames to render")
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

    from .runtime.renderer import Renderer

    renderer = Renderer(cfg, backend=args.backend, device=args.device)
    for i in range(args.frames):
        renderer.update()
        renderer.render(block=i == args.frames - 1)
    print(f"{args.frames} frames at {renderer.width}x{renderer.height} on "
          f"{args.device}: last frame {renderer.last_frame_ms:.3f} ms",
          flush=True)
    if args.out:
        renderer.save_png(args.out)
        print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
