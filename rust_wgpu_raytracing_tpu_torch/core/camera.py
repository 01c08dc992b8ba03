"""Camera state and GPU-uniform equivalents.

Mirrors reference src/camera.rs (Camera struct + matrix functions) and the
CameraInvUniform packing in src/lib.rs:86-112, including its load-bearing
quirk: the uniform's `proj_inv` is `OPENGL_TO_WGPU @ perspective^-1`
(src/lib.rs:109) while `viewmodel_inv` is the raw view inverse
(src/lib.rs:107). Because ray generation multiplies this premultiplied
inverse by (x_ndc, y_ndc, 1, 1) and then zeroes w
(sphere/compute.wgsl:87-101), the view-space ray vector becomes
(aspect*x/focal, y/focal, -0.5 + 0.5/zfar) instead of (..., -1): with the
defaults (fovy 60, zfar 100) the effective vertical FOV is ~99 degrees,
not 60. We reproduce this exactly; parity with the reference's rendered
output depends on it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import CameraConfig
from . import math3d


@dataclass
class Camera:
    """Pinhole camera (reference src/camera.rs:3-11). Mutable host state —
    controllers mutate `eye`/`target` between frames, exactly like the
    reference's `update_camera` (circle_camera_control.rs:76-105)."""

    eye: np.ndarray
    target: np.ndarray
    up: np.ndarray
    aspect: float
    fovy_deg: float = 60.0
    znear: float = 0.1
    zfar: float = 100.0

    @staticmethod
    def from_config(cfg: CameraConfig, aspect: float) -> "Camera":
        return Camera(
            eye=np.array(cfg.eye, dtype=np.float64),
            target=np.array(cfg.target, dtype=np.float64),
            up=np.array(cfg.up, dtype=np.float64),
            aspect=float(aspect),
            fovy_deg=cfg.fovy_deg,
            znear=cfg.znear,
            zfar=cfg.zfar,
        )

    # --- matrices (camera.rs:14-30) ---

    def view_matrix(self) -> np.ndarray:
        return math3d.look_at_rh(self.eye, self.target, self.up)

    def proj_matrix(self) -> np.ndarray:
        return math3d.perspective_gl(self.fovy_deg, self.aspect, self.znear, self.zfar)

    def view_proj_matrix(self) -> np.ndarray:
        return self.proj_matrix() @ self.view_matrix()

    def view_inv_matrix(self) -> np.ndarray:
        return np.linalg.inv(self.view_matrix())

    def proj_inv_matrix(self) -> np.ndarray:
        return np.linalg.inv(self.proj_matrix())

    def uniforms(self) -> "CameraUniforms":
        return CameraUniforms.from_camera(self)


@dataclass(frozen=True)
class CameraUniforms:
    """Device-side camera parameters, f32.

    The analogue of CameraInvUniform (src/lib.rs:86-112): `view_inv` is the
    raw view inverse, `proj_inv_wgpu` is OPENGL_TO_WGPU @ proj^-1 (the
    quirk), `origin` is the eye. These flow into the jitted frame function
    every frame — the analogue of queue.write_buffer (src/lib.rs:999-1009).
    """

    view_inv: np.ndarray  # (4,4) f32
    proj_inv_wgpu: np.ndarray  # (4,4) f32
    origin: np.ndarray  # (3,) f32

    @staticmethod
    def from_camera(cam: Camera) -> "CameraUniforms":
        return CameraUniforms(
            view_inv=cam.view_inv_matrix().astype(np.float32),
            proj_inv_wgpu=(math3d.OPENGL_TO_WGPU @ cam.proj_inv_matrix()).astype(np.float32),
            origin=np.asarray(cam.eye, dtype=np.float32),
        )

    def flat(self) -> np.ndarray:
        """Pack into a single (35,) f32 vector (two 4x4 row-major matrices +
        origin) for cheap host->device transfer of per-frame state."""
        return np.concatenate(
            [self.view_inv.reshape(-1), self.proj_inv_wgpu.reshape(-1), self.origin]
        ).astype(np.float32)

    @staticmethod
    def unflat(v) -> "CameraUniforms":
        """Inverse of flat() — works on numpy or jnp arrays (traced-safe)."""
        return CameraUniforms(
            view_inv=v[0:16].reshape(4, 4),
            proj_inv_wgpu=v[16:32].reshape(4, 4),
            origin=v[32:35],
        )
