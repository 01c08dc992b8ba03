"""Scene kinds: what a configuration's scene is made of.

A configuration's "scene" may name its kind ("kind"; "heightfield"
where it names none). Each kind is a file of its own,
rtbench/scenes/<kind>.py, which harness.scene_kind loads by that name,
and gives:

- make_inputs(config, seed): the host arrays, made from the seed alone;
- write_assets(inputs, directory): writes the asset files the program
  loads (the directory is the program's $RWRT_ASSETS) and returns what
  program_config needs to find them;
- program_config(config, traffic, camera, assets, seed): the port's
  SceneConfig, with the camera at `camera` (the mix's start);
- reference_scene(inputs, step, *, device, dtype): the reference's
  RefScene (rtbench/reference/scene.py) of the geometry the program drew
  at global step `step`; triangles from several meshes or transforms
  reach reference.scene.build as world-space arrays (scale 1,
  translation 0);
- MOVES: true where the geometry changes between steps. Such a kind
  takes no path-traced mix: the reference accumulates over fixed
  geometry;
- optionally advance(renderer, inputs, step): the kind's change to the
  program's scene, made before FrameLoop.step() of global step `step`.

This package holds what kinds share: the program's SceneConfig around a
kind's meshes, and a static kind's reference scene.
"""

from __future__ import annotations

import torch

from rtbench.reference import scene as ref_scene

SEED_MASK = 0xFFFFFFFF  # the program's seed: the low 32 bits of --seed


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def program_scene(config: dict, traffic: dict, camera, seed: int, meshes):
    """The port's SceneConfig: `meshes` (MeshConfig keywords, in pass
    order) after the configuration's spheres, the camera at `camera`, and
    every key of the configuration's "render" with the frame size and the
    path tracer's bounces and samples from the mix and the seed's low
    32 bits."""
    import rust_wgpu_raytracing_tpu_torch as rt

    render = dict(config["render"], width=traffic["width"],
                  height=traffic["height"],
                  pt_bounces=int(traffic.get("pt_bounces", 0)),
                  pt_spp=int(traffic.get("pt_spp", 64)),
                  seed=seed & SEED_MASK)
    return rt.SceneConfig(
        spheres=tuple(rt.SphereConfig(**_tuples(s))
                      for s in config["scene"].get("spheres", ())),
        meshes=tuple(rt.MeshConfig(**m) for m in meshes),
        camera=rt.CameraConfig(eye=tuple(float(v) for v in camera.eye),
                               target=tuple(float(v) for v in camera.target),
                               up=tuple(float(v) for v in camera.up)),
        render=rt.RenderConfig(**_tuples(render)))


def built_once(inputs, *, device, dtype=torch.float32):
    """A static kind's reference scene: reference.scene.build(inputs),
    built on the first call for a device and dtype and kept on `inputs`,
    so that every step gets the same scene."""
    memo = vars(inputs).setdefault("_reference_scenes", {})
    key = (torch.device(device), dtype)
    if key not in memo:
        memo[key] = ref_scene.build(inputs, device=device, dtype=dtype)
    return memo[key]
