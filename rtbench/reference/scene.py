"""The reference's scene: triangles, planes and texture from the raw inputs.

Built from the same arrays the benchmark writes to the OBJ, MTL and PNG
files the program loads: vertex positions, uvs and faces, the material,
the texture's sRGB bytes, the spheres and the lights. Nothing here comes
from the program. The edge-plane precompute is the derivation of the
reference rust project's triangle kernel (triangle_list/compute.wgsl:
82-148): N = e0 x (p2 - p0), t = -(N.O + d) / N.D and the three
inside-outside values O.g_i + t D.g_i - c_i with g_i = N x edge_i.

Every tensor is made in `dtype` on `device`, so the same code is the
f32 reference and, in bfloat16, its control.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    c = np.asarray(c, np.float64)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


@dataclass
class RefScene:
    sph_center: torch.Tensor  # (S, 3)
    sph_radius: torch.Tensor  # (S,)
    sph_color: torch.Tensor  # (S, 3)
    sph_coeff: torch.Tensor  # (S, 3) ambient, diffuse, specular
    sph_light: torch.Tensor  # (S, 3)
    n: torch.Tensor  # (F, 3) unnormalized geometric normal
    d: torch.Tensor  # (F,) -N.p0
    g: torch.Tensor  # (F, 3, 3) g_i = N x edge_i
    c: torch.Tensor  # (F, 3) c_i = p_i.g_i
    inv_denom: torch.Tensor  # (F,) 1 / N.N
    uv3: torch.Tensor  # (F, 3, 2)
    ambient: torch.Tensor  # (3,)
    specular: torch.Tensor  # (3,)
    light: torch.Tensor  # (3,) the mesh's light direction
    tex: torch.Tensor  # (TH, TW, 3) linear light
    dtype: torch.dtype

    @property
    def num_faces(self) -> int:
        return self.n.shape[0]

    @property
    def num_spheres(self) -> int:
        return self.sph_radius.shape[0]


def build(inputs, *, device, dtype=torch.float32) -> RefScene:
    """`inputs`: the benchmark's scene inputs (scenegen.SceneInputs)."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32),
                               device=device).to(dtype)

    pos = t(inputs.positions) * float(inputs.scale) + t(inputs.translation)
    faces = torch.as_tensor(inputs.faces, device=device).long()
    p0, p1, p2 = pos[faces[:, 0]], pos[faces[:, 1]], pos[faces[:, 2]]
    n = torch.linalg.cross(p1 - p0, p2 - p0)
    g = torch.stack([torch.linalg.cross(n, p1 - p0),
                     torch.linalg.cross(n, p2 - p1),
                     torch.linalg.cross(n, p0 - p2)], dim=1)
    c = torch.stack([(p0 * g[:, 0]).sum(-1), (p1 * g[:, 1]).sum(-1),
                     (p2 * g[:, 2]).sum(-1)], dim=1)
    denom = (n * n).sum(-1)
    inv_denom = torch.where(denom > 0, 1.0 / denom.clamp_min(1e-30),
                            torch.zeros_like(denom))
    uv = t(inputs.uvs)
    sph = inputs.spheres
    tex = srgb_to_linear(np.asarray(inputs.texture_u8, np.float64) / 255.0)
    return RefScene(
        sph_center=t([s["center"] for s in sph]).reshape(-1, 3),
        sph_radius=t([s["radius"] for s in sph]).reshape(-1),
        sph_color=t([s.get("color", (1.0, 0.0, 0.0)) for s in sph]
                    ).reshape(-1, 3),
        sph_coeff=t([(s.get("ambient", 0.1), s.get("diffuse", 1.0),
                      s.get("specular", 0.5)) for s in sph]).reshape(-1, 3),
        sph_light=t([s.get("light_direction", (1.0, -5.0, 1.0))
                     for s in sph]).reshape(-1, 3),
        n=n, d=-(n * p0).sum(-1), g=g, c=c, inv_denom=inv_denom,
        uv3=uv[faces], ambient=t(inputs.ambient), specular=t(inputs.specular),
        light=t(inputs.light_direction), tex=t(tex), dtype=dtype)
