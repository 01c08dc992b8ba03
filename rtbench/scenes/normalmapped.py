"""The normal-mapped kind: the heightfield kind's scene (the
configuration's spheres and one seeded heightfield mesh, made by
rtbench/scenegen.py) with a seeded tangent-space normal map as the
mesh's map_Bump, drawn with normal mapping on (MeshConfig.normal_mapping).
The geometry never moves.

The normal map is bump_size x bump_size texels of a height
h(u, v) = sum_k sin(2 pi f_k . (u, v) + phase_k) / (2 pi |f_k|) over the
frequencies FREQS, with the phases drawn from the seed's stream
BUMP_STREAM: each texel holds round((n + 1) / 2 * 255) of
n = normalize(-s dh/du, -s dh/dv, 1), s = BUMP_STRENGTH, at the texel's
own (u, v) (row 0 at v = 1, as the program samples at (u, 1 - v)). At
that strength about 80% of the texels tilt 10-35 degrees from the
surface normal.

The program loads the OBJ/MTL/PNG triple of the heightfield kind, the
MTL written here with map_Bump bump.png beside map_Kd albedo.png. The
reference draws the same arrays with its own normal mapping
(rtbench/scenes/normalmapped_ref.py), since reference.frame.lit_pixels
shades the flat geometric normal.
"""

import dataclasses
import os
from dataclasses import dataclass

import numpy as np
import torch

from rtbench import scenegen
from rtbench.scenes import heightfield, normalmapped_ref
from rtbench.traffic import seeded_rng

MOVES = False
BUMP_STREAM = 6  # the seed's random stream of the normal map's phases
FREQS = ((3, 2), (-5, 9), (17, 11), (-29, 37))  # cycles across (u, v)
BUMP_STRENGTH = 0.3


# a dataclass here takes real annotations (no `from __future__ import
# annotations`): the harness loads this file as a module that
# sys.modules does not hold, where string annotations cannot be resolved
@dataclass
class NormalMappedInputs(scenegen.SceneInputs):
    bump_u8: np.ndarray  # (B, B, 3) u8 tangent-space normals, top-down


def normal_map(size: int, rng: np.random.Generator) -> np.ndarray:
    """(size, size, 3) u8: the encoded normals of the module docstring."""
    x = (np.arange(size) + 0.5) / size
    u, v = np.meshgrid(x, 1.0 - x, indexing="xy")
    du = np.zeros_like(u)
    dv = np.zeros_like(u)
    for (fu, fv), phase in zip(FREQS, rng.uniform(0.0, 2.0 * np.pi,
                                                  len(FREQS))):
        c = np.cos(2.0 * np.pi * (fu * u + fv * v) + phase) / np.hypot(fu,
                                                                       fv)
        du += c * fu
        dv += c * fv
    n = np.stack([-BUMP_STRENGTH * du, -BUMP_STRENGTH * dv,
                  np.ones_like(u)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return np.round((n + 1.0) / 2.0 * 255.0).astype(np.uint8)


def make_inputs(config, seed):
    mesh = config["scene"]["mesh"]
    return NormalMappedInputs(
        **vars(scenegen.make_inputs(config, seed)),
        bump_u8=normal_map(int(mesh["bump_size"]),
                           seeded_rng(seed, BUMP_STREAM)))


def write_assets(inputs, directory):
    """The heightfield kind's mesh.obj and albedo.png, bump.png, and a
    mesh.mtl that names both maps; returns the OBJ's file name."""
    name = scenegen.write_assets(inputs, directory)
    with open(os.path.join(directory, "bump.png"), "wb") as fh:
        fh.write(scenegen.encode_png(inputs.bump_u8))
    with open(os.path.join(directory, "mesh.mtl"), "w") as fh:
        fh.write("newmtl surface\n"
                 "Ka %.9g %.9g %.9g\n" % inputs.ambient
                 + "Kd %.9g %.9g %.9g\n" % inputs.diffuse
                 + "Ks %.9g %.9g %.9g\n" % inputs.specular
                 + "map_Kd albedo.png\n"
                 + "map_Bump bump.png\n")
    return name


def program_config(config, traffic, camera, assets, seed):
    sc = heightfield.program_config(config, traffic, camera, assets, seed)
    return dataclasses.replace(sc, meshes=tuple(
        dataclasses.replace(m, normal_mapping=True) for m in sc.meshes))


def reference_scene(inputs, step, *, device, dtype=torch.float32):
    """The reference's normal-mapped scene, built on the first call for a
    device and dtype and kept on `inputs`."""
    memo = vars(inputs).setdefault("_nm_reference_scenes", {})
    key = (torch.device(device), dtype)
    if key not in memo:
        memo[key] = normalmapped_ref.build(inputs, device=device, dtype=dtype)
    return memo[key]


reference_lit = normalmapped_ref.lit_pixels
