"""The general traffic generator: a traffic mix is data.

A mix (rtbench/workloads/<name>.json) gives the frame size, the path
tracer's bounces and samples (0 bounces: lit frames) and a key script:
phases of held keys, each for a number of FrameLoop steps, cycled for
the whole run. One step is one
FrameLoop.step(): the keys that changed are pushed first, then the
loop updates the camera, renders and presents the previous frame.

"start": "orbit" turns the configuration's camera round its target by a
number of steps drawn from the seed before the first step; "warmup" is
a step count or "orbit" (one whole orbit of the held right key, so the
window shows no camera the warm-up did not). Everything the program is
shown, and every frame's camera and sample count that the reference
needs, follows from the mix and the seed alone (`Replay`).
"""

from __future__ import annotations

from typing import List

import numpy as np

from .reference.camera import Camera, orbit_period, orbit_step

# the Renderer's orbit controller steps this far a frame (src/lib.rs:361)
SPEED = 0.2
# the program's key names (its controller's mapping) -> the motions
KEY_MOTION = {"right": "right", "d": "right", "left": "left", "a": "left",
              "w": "forward", "up": "forward", "s": "backward",
              "down": "backward"}


def seeded_rng(seed: int, stream: int) -> np.random.Generator:
    seed %= 1 << 64
    return np.random.default_rng(np.random.SeedSequence(
        [seed & 0xFFFFFFFF, seed >> 32, stream]))


class Replay:
    """The mix's key script over global step indices, the cameras it
    gives and the path tracer's sample counts."""

    def __init__(self, mix: dict, config: dict, seed: int):
        self.mix = mix
        cam = config["scene"]["camera"]
        self.base = Camera(cam["eye"], cam["target"], cam.get("up", (0, 1, 0)),
                           aspect=mix["width"] / mix["height"])
        self.script: List[tuple] = [(frozenset(p["keys"]), int(p["steps"]))
                                    for p in mix["script"]]
        self.cycle = sum(n for _, n in self.script)
        self.period = orbit_period(self.base, SPEED)
        rng = seeded_rng(seed, 1)
        self.start_steps = (int(rng.integers(0, self.period))
                            if mix.get("start") == "orbit" else 0)
        self.start = self.base.copy()
        for _ in range(self.start_steps):
            orbit_step(self.start, {"right"}, SPEED)
        w = mix.get("warmup", 1)
        self.warmup = self.period if w == "orbit" else int(w)
        self._cams = [self.start.copy()]
        self._spp = [0]

    def keys_at(self, step: int) -> frozenset:
        i = step % self.cycle
        for keys, n in self.script:
            if i < n:
                return keys
            i -= n
        raise AssertionError("unreachable")

    def _extend(self, steps: int):
        spp_cap = int(self.mix.get("pt_spp", 0))
        while len(self._cams) <= steps:
            g = len(self._cams) - 1
            cam = self._cams[-1].copy()
            before = cam.eye.copy()
            motions = {KEY_MOTION[k] for k in self.keys_at(g)}
            orbit_step(cam, motions, SPEED)
            spp = self._spp[-1]
            if not np.array_equal(before, cam.eye):
                spp = 0
            if spp_cap <= 0 or spp < spp_cap:
                spp += 1
            self._cams.append(cam)
            self._spp.append(spp)

    def rendered(self, step: int):
        """(camera, samples in its mean) of the frame rendered at global
        step `step` (0-based): after step + 1 updates."""
        self._extend(step + 1)
        return self._cams[step + 1], self._spp[step + 1]

    def added_sample(self, step: int) -> bool:
        """Whether the render at `step` added a path-tracing sample."""
        self._extend(step + 1)
        s = self._spp[step + 1]
        return s == 1 or s > self._spp[step]


def pixel_sample(mix: dict, seed: int, count: int):
    """`count` distinct pixels (xs, ys) of the frame, drawn from the
    seed; y is the framebuffer row (row 0 at the bottom)."""
    w, h = mix["width"], mix["height"]
    flat = seeded_rng(seed, 2).choice(w * h, size=min(count, w * h),
                                      replace=False)
    return flat % w, flat // w


class Reservoir:
    """A uniform sample of `k` items from a stream of unknown length
    (Algorithm R), its choices drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = seeded_rng(seed, 3)
        self.items = []
        self.seen = 0

    def offer(self, make):
        """`make()` builds the item only if it is kept."""
        j = self.seen
        self.seen += 1
        if j < self.k:
            self.items.append(make())
        else:
            r = int(self.rng.integers(0, j + 1))
            if r < self.k:
                self.items[r] = make()
