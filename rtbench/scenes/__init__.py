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
  scene of the geometry the program drew at global step `step`, built
  in `dtype` (float32, or the control's bfloat16): a RefScene
  (rtbench/reference/scene.py), or for a kind that gives reference_lit
  whatever that function takes; triangles from several meshes or
  transforms reach reference.scene.build as world-space arrays (scale 1,
  translation 0);
- MOVES: true where the geometry changes between steps. Such a kind
  takes no path-traced mix: the reference accumulates over fixed
  geometry;
- optionally advance(renderer, inputs, step): the kind's change to the
  program's scene, made before FrameLoop.step() of global step `step`;
- optionally reference_lit(scene, cam, xs, ys, *, width, height,
  render): the reference's lit frame at pixels (xs, ys) of a
  width x height frame seen from `cam`, over `scene` as the kind's
  reference_scene returned it, with the configuration's whole "render";
  (P, 3) linear values quantized to rgba8 levels, as
  reference.frame.lit_pixels gives them. verify takes it in place of
  lit_pixels (which sees only "render"'s "shadows"), so a kind whose
  frame needs more (a normal map, a mip pyramid) brings its own
  reference as new files;
- optionally reference_accumulate(scene, cam, xs, ys, *, width, height,
  bounces, seed, samples, means_at, render): the same for the path
  tracer, in place of reference.pathtrace.accumulate. A kind that gives
  reference_lit takes a path-traced mix only if it gives this too
  (harness.load_cell refuses it otherwise): the path tracer's reference
  knows only a RefScene.

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
