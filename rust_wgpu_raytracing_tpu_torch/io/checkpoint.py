"""Checkpoint / resume: the JAX package's io/checkpoint.py, with the same
file format, so that a checkpoint written by either package resumes in
the other (the reference has none: its state is rebuilt from constants
at each launch, lib.rs:352-361).

A checkpoint is one .npz file written at the exact path given: `state`,
a JSON string with the scene config, the camera (eye, target, up,
aspect), the controller's key flags, the frame count and the path
tracer's accumulated samples per pixel (spp_done), and, once the path
tracer has accumulated, `accum`: its (H, W, 3) f32 running sum. Resuming
and rendering to the target gives the image of an uninterrupted run.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..config import SceneConfig


def save_checkpoint(path: str, renderer) -> None:
    cam = renderer.camera
    state = {
        "config": json.loads(renderer.config.to_json()),
        "camera": {
            "eye": cam.eye.tolist(),
            "target": cam.target.tolist(),
            "up": cam.up.tolist(),
            "aspect": cam.aspect,
        },
        "keys": vars(renderer.controller.keys),
        "frame_count": renderer.frame_count,
        "spp_done": renderer.spp_done,
    }
    arrays = {}
    if renderer._accum is not None:
        arrays["accum"] = renderer._accum.detach().cpu().numpy()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # np.savez appends '.npz' to a path with another suffix: write to the
    # exact path so that load_checkpoint(path) always finds it
    with open(path, "wb") as fh:
        np.savez(fh, state=json.dumps(state), **arrays)


def load_checkpoint(path: str, backend: str = "auto", *, device="cuda"):
    """A Renderer on `device` in the checkpoint's state."""
    from ..runtime.renderer import Renderer

    with np.load(path, allow_pickle=False) as z:
        state = json.loads(str(z["state"]))
        accum = z["accum"] if "accum" in z.files else None

    cfg = SceneConfig.from_json(json.dumps(state["config"]))
    r = Renderer(cfg, backend=backend, device=device)
    r.camera.eye = np.asarray(state["camera"]["eye"], np.float64)
    r.camera.target = np.asarray(state["camera"]["target"], np.float64)
    r.camera.up = np.asarray(state["camera"]["up"], np.float64)
    r.camera.aspect = float(state["camera"]["aspect"])
    for k, v in state["keys"].items():
        setattr(r.controller.keys, k, bool(v))
    r.frame_count = int(state["frame_count"])
    if accum is not None:
        r._accum = torch.from_numpy(np.asarray(accum, np.float32)).to(
            r.device)
        r._spp_done = int(state["spp_done"])
    return r
