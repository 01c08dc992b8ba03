"""Host-side 3D math matching cgmath semantics used by the reference.

The reference builds camera matrices with cgmath (`look_at_rh`,
`perspective(Deg(fovy), ...)`, `Matrix4::invert` — reference
src/camera.rs:14-30) in f32. We compute in f64 and cast to f32 at the
device boundary: the result agrees with cgmath's f32 cofactor inverse to
within a few ULP, inside the parity tolerance.

All matrices here are NumPy (4,4) arrays in MATH convention: `M @ v`
applies M to column vector v (same as cgmath's `Matrix4 * Vector4`).
"""

from __future__ import annotations

import numpy as np

# Maps OpenGL clip z in [-1,1] to WebGPU clip z in [0,1]
# (reference src/lib.rs:31-37; cgmath Matrix4::new is column-major, so the
# matrix has m[2][2]=0.5, m[2][3]=0.5 in row,col math indexing).
OPENGL_TO_WGPU = np.array(
    [
        [1.0, 0.0, 0.0, 0.0],
        [0.0, 1.0, 0.0, 0.0],
        [0.0, 0.0, 0.5, 0.5],
        [0.0, 0.0, 0.0, 1.0],
    ],
    dtype=np.float64,
)


def normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return v / n


def look_at_rh(eye, target, up) -> np.ndarray:
    """Right-handed look-at view matrix, cgmath semantics (camera.rs:15).

    Rows are (s, u, -f) with translation (-s.eye, -u.eye, f.eye) where
    f = normalize(target - eye), s = normalize(f x up), u = s x f.
    """
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)

    f = normalize(target - eye)
    s = normalize(np.cross(f, up))
    u = np.cross(s, f)

    m = np.eye(4, dtype=np.float64)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective_gl(fovy_deg: float, aspect: float, near: float, far: float) -> np.ndarray:
    """OpenGL-convention perspective projection, cgmath semantics
    (camera.rs:16): clip z in [-1, 1], right-handed view space (-z forward).
    """
    f = 1.0 / np.tan(np.deg2rad(fovy_deg) / 2.0)
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = (2.0 * far * near) / (near - far)
    m[3, 2] = -1.0
    return m


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    """sRGB EOTF. The reference uploads textures as Rgba8UnormSrgb
    (texture.rs:122) so shader samples are linearized; we do the same at
    import time."""
    c = np.asarray(c, dtype=np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4).astype(np.float32)


def linear_to_srgb(c: np.ndarray) -> np.ndarray:
    """sRGB OETF — applied at present time (the reference's swapchain surface
    is an sRGB format, src/lib.rs:310-315, so its raster pass performs this
    encode on write)."""
    c = np.clip(np.asarray(c, dtype=np.float32), 0.0, 1.0)
    return np.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055).astype(np.float32)
