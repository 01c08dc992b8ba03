"""The heightfield kind: the configuration's spheres and one seeded
heightfield mesh (its scene's "mesh": grid, size, amplitude, texture,
transform, light and material), made by rtbench/scenegen.py and loaded by
the program as an OBJ/MTL/PNG triple. The geometry never moves."""

from __future__ import annotations

import torch

from rtbench import scenegen, scenes

MOVES = False

make_inputs = scenegen.make_inputs
write_assets = scenegen.write_assets


def program_config(config, traffic, camera, assets, seed):
    mesh = config["scene"]["mesh"]
    return scenes.program_scene(config, traffic, camera, seed, meshes=[dict(
        obj_path=assets, translation=tuple(mesh["translation"]),
        scale=float(mesh["scale"]),
        light_direction=tuple(mesh["light_direction"]),
        normal_mapping=bool(mesh.get("normal_mapping", False)))])


def reference_scene(inputs, step, *, device, dtype=torch.float32):
    return scenes.built_once(inputs, device=device, dtype=dtype)
