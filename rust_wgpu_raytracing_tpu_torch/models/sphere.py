"""Analytic sphere model (reference src/models/sphere/sphere.rs).

The reference Sphere owns a {center, radius} uniform (sphere.rs:10-15);
here a Sphere owns its SphereConfig and packs it into the scene's
sphere block. Intersection and shading live in the frame
(ops/megakernel.py: the closest-hit kernel's sphere tail and
sphere_pass_planar).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

from ..config import SphereConfig


@dataclass(frozen=True)
class Sphere:
    config: SphereConfig

    @staticmethod
    def soa(spheres: Sequence[SphereConfig]) -> Tuple[np.ndarray, ...]:
        """Configs -> the sphere block of the scene SoA: the analogue of
        Sphere::new packing {center, radius} + shading coefficients into
        its uniform buffer (sphere.rs:18-96, compute.wgsl's SphereData).
        Returns float32 (center (S,3), radius (S,), color (S,3),
        [ambient,diffuse,specular] (S,3), light_dir (S,3))."""
        center = np.array([s.center for s in spheres],
                          np.float32).reshape(-1, 3)
        radius = np.array([s.radius for s in spheres], np.float32)
        color = np.array([s.color for s in spheres],
                         np.float32).reshape(-1, 3)
        coeff = np.array([[s.ambient, s.diffuse, s.specular]
                          for s in spheres], np.float32).reshape(-1, 3)
        light = np.array([s.light_direction for s in spheres],
                         np.float32).reshape(-1, 3)
        return center, radius, color, coeff, light
