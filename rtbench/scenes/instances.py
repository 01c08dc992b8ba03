"""The instances kind: the configuration's one seeded heightfield mesh
(its scene's "mesh", as the heightfield kind makes it) drawn "count"
times, and moved every step (BASELINE config 5).

The scene's "instances" lays the copies out: a side x side grid
(side = ceil(sqrt(count)), as ops/instances.grid_transforms) at
"spacing" in the world's XZ plane, centred on "center". Each copy's
height axis (+z of the mesh) is turned to +y, so the tiles lie as a
floor, and the copy then turns about the world y axis by
phase_i + "turn" * step radians, with phase_i drawn from the seed. The
transforms depend on the seed and the step alone: computed in float64
and given to the program in float32 (Renderer.set_instance_transforms
before each step; the first in the SceneConfig).

The reference's geometry is its own: each copy's world-space vertices
from the same float32 transforms and mesh vertices, transformed in
float64 NumPy and then cast to the reference's dtype, handed to
reference.scene.build as one mesh (scale 1, translation 0). Nothing of
the program's refit is used; the program transforms in float32, so the
two vertex sets differ by float32 rounding (~1e-7 relative), which the
cell's limit absorbs.
"""

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from rtbench import scenegen
from rtbench.reference import scene as ref_scene
from rtbench.scenes import heightfield
from rtbench.traffic import seeded_rng

MOVES = True
PHASE_STREAM = 5  # the seed's random stream of the copies' phases


# a dataclass here takes real annotations (no `from __future__ import
# annotations`): the harness loads this file as a module that
# sys.modules does not hold, where string annotations cannot be resolved
@dataclass
class InstancedInputs(scenegen.SceneInputs):
    phases: np.ndarray  # (N,) f64, each copy's turn at step 0
    spacing: float
    center: tuple
    turn: float  # radians a step


def make_inputs(config, seed):
    lay = config["scene"]["instances"]
    return InstancedInputs(
        **vars(scenegen.make_inputs(config, seed)),
        phases=seeded_rng(seed, PHASE_STREAM).uniform(
            0.0, 2.0 * np.pi, size=int(lay["count"])),
        spacing=float(lay["spacing"]),
        center=tuple(float(v) for v in lay["center"]),
        turn=float(lay["turn"]))


write_assets = scenegen.write_assets


def transforms(inputs: InstancedInputs, step: int) -> np.ndarray:
    """(N, 3, 4) float32 [R | t] of the copies at `step` (module
    docstring), computed in float64."""
    n = len(inputs.phases)
    side = int(np.ceil(np.sqrt(n)))
    i = np.arange(n)
    gx = (i % side) - (side - 1) / 2.0
    gz = (i // side) - (side - 1) / 2.0
    a = inputs.phases + inputs.turn * float(step)
    c, s = np.cos(a), np.sin(a)
    # R_y(a) @ F, F: (x, y, z) -> (x, z, -y) turns the height to +y
    r = np.zeros((n, 3, 3))
    r[:, 0, 0], r[:, 0, 1] = c, -s
    r[:, 1, 2] = 1.0
    r[:, 2, 0], r[:, 2, 1] = -s, -c
    cx, cy, cz = inputs.center
    t = np.stack([cx + gx * inputs.spacing, np.full(n, cy),
                  cz + gz * inputs.spacing], axis=1)
    return np.concatenate([r, t[:, :, None]], axis=2).astype(np.float32)


def program_config(config, traffic, camera, assets, seed):
    import rust_wgpu_raytracing_tpu_torch as rt

    sc = heightfield.program_config(config, traffic, camera, assets, seed)
    first = transforms(make_inputs(config, seed), 0)
    return dataclasses.replace(sc, instances=rt.InstancesConfig(
        count=len(first), transforms=first))


def advance(renderer, inputs, step):
    renderer.set_instance_transforms(transforms(inputs, step))


def reference_scene(inputs, step, *, device, dtype=torch.float32):
    """Every copy's world-space triangles at `step` as one mesh: the
    mesh's own scale and translation, then each copy's transform, in
    float64 (module docstring)."""
    n, v = len(inputs.phases), len(inputs.positions)
    tf = transforms(inputs, step).astype(np.float64)
    obj = (inputs.positions.astype(np.float64) * np.float32(inputs.scale)
           + np.asarray(inputs.translation, np.float32))
    world = np.einsum("nij,vj->nvi", tf[:, :, :3], obj) + tf[:, None, :, 3]
    soup = dataclasses.replace(
        inputs, positions=world.reshape(-1, 3),
        uvs=np.tile(inputs.uvs, (n, 1)),
        normals=np.tile(inputs.normals, (n, 1)),
        faces=np.concatenate([inputs.faces + k * v for k in range(n)]),
        translation=(0.0, 0.0, 0.0), scale=1.0)
    return ref_scene.build(soup, device=device, dtype=dtype)
