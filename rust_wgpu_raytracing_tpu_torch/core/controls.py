"""Camera controllers.

`CircleCameraController` reproduces the reference's orbit controller
semantics (src/circle_camera_control.rs:76-105): forward/backward translate
the eye along the normalized view direction (forward only if the distance
exceeds `speed`); left/right re-project the eye onto the orbit circle of the
current radius. Input is six boolean key flags, the analogue of the winit
key handling at circle_camera_control.rs:32-74.

`OrbitAnimator` is the scripted animation used for benchmarks
(BASELINE config 2: "circle-orbit camera animation") — it simply holds the
'right' key down for N frames.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .camera import Camera


@dataclass
class KeyState:
    up: bool = False  # Space
    down: bool = False  # LShift
    forward: bool = False  # W / Up
    backward: bool = False  # S / Down
    left: bool = False  # A / Left
    right: bool = False  # D / Right


@dataclass
class CircleCameraController:
    speed: float = 0.2  # reference instantiates with 0.2 (src/lib.rs:361)
    keys: KeyState = field(default_factory=KeyState)

    def process_key(self, key: str, pressed: bool) -> bool:
        """Key mapping of circle_camera_control.rs:44-69. Returns True if
        the key was consumed."""
        mapping = {
            "space": "up", "lshift": "down",
            "w": "forward", "up": "forward",
            "s": "backward", "down": "backward",
            "a": "left", "left": "left",
            "d": "right", "right": "right",
        }
        attr = mapping.get(key.lower())
        if attr is None:
            return False
        setattr(self.keys, attr, pressed)
        return True

    def update_camera(self, cam: Camera) -> None:
        """Orbit-step semantics of circle_camera_control.rs:76-105 (including
        the glitch guard on forward and the radius-preserving left/right)."""
        k = self.keys
        forward = cam.target - cam.eye
        forward_mag = np.linalg.norm(forward)
        forward_norm = forward / forward_mag

        if k.forward and forward_mag > self.speed:
            cam.eye = cam.eye + forward_norm * self.speed
        if k.backward:
            cam.eye = cam.eye - forward_norm * self.speed

        right = np.cross(forward_norm, cam.up)

        forward = cam.target - cam.eye
        forward_mag = np.linalg.norm(forward)

        if k.right:
            d = forward + right * self.speed
            cam.eye = cam.target - d / np.linalg.norm(d) * forward_mag
        if k.left:
            d = forward - right * self.speed
            cam.eye = cam.target - d / np.linalg.norm(d) * forward_mag


@dataclass
class OrbitAnimator:
    """Deterministic scripted orbit for benchmark replays: applies the
    controller with the 'right' key held every frame."""

    controller: CircleCameraController = field(default_factory=CircleCameraController)

    def __post_init__(self):
        self.controller.keys.right = True

    def step(self, cam: Camera) -> Camera:
        self.controller.update_camera(cam)
        return cam
