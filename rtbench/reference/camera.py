"""The camera and the orbit controller, written out again for the reference.

The reference rust project builds its matrices with cgmath in f32; the
port computes them in f64 and rounds at the device boundary. This copy
does the same in NumPy: `look_at_rh`, the OpenGL perspective, the
OPENGL_TO_WGPU premultiply of the inverse projection (src/lib.rs:109),
and the circle controller's step (src/circle_camera_control.rs:76-105).
"""

from __future__ import annotations

import numpy as np

OPENGL_TO_WGPU = np.array([[1.0, 0.0, 0.0, 0.0],
                           [0.0, 1.0, 0.0, 0.0],
                           [0.0, 0.0, 0.5, 0.5],
                           [0.0, 0.0, 0.0, 1.0]])

KEYS = ("forward", "backward", "left", "right")


def look_at_rh(eye, target, up) -> np.ndarray:
    f = target - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3], m[1, 3], m[2, 3] = -s @ eye, -u @ eye, f @ eye
    return m


def perspective_gl(fovy_deg, aspect, near, far) -> np.ndarray:
    f = 1.0 / np.tan(np.deg2rad(fovy_deg) / 2.0)
    m = np.zeros((4, 4))
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = (2.0 * far * near) / (near - far)
    m[3, 2] = -1.0
    return m


class Camera:
    """Eye, target and up in f64, the projection constants of the scene."""

    def __init__(self, eye, target, up=(0.0, 1.0, 0.0), *, aspect,
                 fovy_deg=60.0, znear=0.1, zfar=100.0):
        self.eye = np.asarray(eye, np.float64)
        self.target = np.asarray(target, np.float64)
        self.up = np.asarray(up, np.float64)
        self.aspect = float(aspect)
        self.fovy_deg, self.znear, self.zfar = fovy_deg, znear, zfar

    def copy(self) -> "Camera":
        return Camera(self.eye.copy(), self.target.copy(), self.up.copy(),
                      aspect=self.aspect, fovy_deg=self.fovy_deg,
                      znear=self.znear, zfar=self.zfar)

    def uniforms(self):
        """(view_inv (4, 4), proj_inv_wgpu (4, 4), origin (3,)), f32."""
        view_inv = np.linalg.inv(look_at_rh(self.eye, self.target, self.up))
        proj_inv = np.linalg.inv(perspective_gl(
            self.fovy_deg, self.aspect, self.znear, self.zfar))
        return (view_inv.astype(np.float32),
                (OPENGL_TO_WGPU @ proj_inv).astype(np.float32),
                self.eye.astype(np.float32))

    def ray_matrix(self):
        """M = V^-1[:3,:3] (GL2WGPU P^-1)[:3,:] in f32, summed in index
        order, and its constant column M[:, 2] + M[:, 3]."""
        view_inv, proj_inv, _ = self.uniforms()
        v, p = view_inv[:3, :3], proj_inv[:3, :]
        m = v[:, 0:1] * p[0:1] + v[:, 1:2] * p[1:2] + v[:, 2:3] * p[2:3]
        return m, m[:, 2] + m[:, 3]


def orbit_step(cam: Camera, keys, speed: float = 0.2) -> None:
    """One update of the circle controller with the held keys (a set of
    names from KEYS), in place."""
    forward = cam.target - cam.eye
    mag = np.linalg.norm(forward)
    fn = forward / mag
    if "forward" in keys and mag > speed:
        cam.eye = cam.eye + fn * speed
    if "backward" in keys:
        cam.eye = cam.eye - fn * speed
    right = np.cross(fn, cam.up)
    forward = cam.target - cam.eye
    mag = np.linalg.norm(forward)
    if "right" in keys:
        d = forward + right * speed
        cam.eye = cam.target - d / np.linalg.norm(d) * mag
    if "left" in keys:
        d = forward - right * speed
        cam.eye = cam.target - d / np.linalg.norm(d) * mag


def orbit_period(cam: Camera, speed: float = 0.2, limit: int = 10000) -> int:
    """Steps of the held right key until the eye has gone once round the
    target (the swept angle about the up axis reaches 2 pi)."""
    c = cam.copy()
    up = c.up / np.linalg.norm(c.up)

    def flat(v):
        v = v - (v @ up) * up
        return v / np.linalg.norm(v)

    prev = flat(c.eye - c.target)
    swept = 0.0
    for step in range(1, limit + 1):
        orbit_step(c, {"right"}, speed)
        cur = flat(c.eye - c.target)
        swept += np.arccos(np.clip(prev @ cur, -1.0, 1.0))
        prev = cur
        if swept >= 2.0 * np.pi:
            return step
    raise ValueError("the orbit does not close")
