"""Renderer: the analogue of the reference's `State` (src/lib.rs:223-257).

The Renderer owns the SceneData on one device and the frame function;
per frame the host sends only the (35,) camera vector, and the
framebuffer stays on the device until presented. update()/render()/
resize() mirror State::update/render/resize (src/lib.rs:994,1012,772),
with the reference's resize aspect-lag bug fixed (the new size sets the
aspect), as in the JAX package.

The Renderer renders on the card by default (device="cuda", which
raises when there is none); device="cpu" runs the same frame through
the kernels' plain PyTorch versions. limits= validates the scene against
a runtime.limits.DeviceLimits first, as in the JAX package.

RenderConfig.pt_bounces > 0 switches to progressive path tracing
(ops/pathtrace.py), as in the JAX package: each render() adds one
sample per pixel to a running sum and presents the mean, up to
RenderConfig.pt_spp samples (<= 0: unbounded); once the target is
reached render() re-presents the finished mean; update() restarts the
accumulation when the camera moved, and so does resize(). The key of
sample n is fold_in(PRNGKey(RenderConfig.seed), n). RenderConfig.accel
and mip do not apply to it: its sweeps always cull, as in the JAX
package.

RenderConfig.variant picks the frame program as in the JAX package:
"split" and "fused" are fixed choices ("fused" raises ValueError on a
scene the fused frame cannot draw, and with mip); "auto" renders split
where the fused frame is not eligible (mip included) and otherwise
times both at the first render() (1 warm-up, then 8 frames each; CUDA
events on the card, the host clock on the CPU) and keeps the faster.
variant_chosen and variant_ms record the outcome.

backend="oracle" draws every frame through ops/oracle.render_oracle,
the brute-force executable spec (every ray against every face), on the
same device; variant_chosen stays None, as in the JAX package. "auto"
and "megakernel" take the frame programs above. backend="megakernel_gp"
draws through parallel/geometry_sharding.render_sharded_gp with the face
soup sharded over the ranks of the initialized process group (every
rank builds the Renderer, each on its own device: cuda:(rank % cards)
for device="cuda"); without a process group it renders one shard on
this process's device, as the JAX package does on one device. Its
variant_chosen is "gp". The path tracer takes precedence over every
backend, as in the JAX package.

SceneConfig.instances with count N > 0 makes an instanced scene
(BASELINE config 5): the scene's one mesh drawn N times as one soup, each
copy placed by an affine (3, 4) transform. Set-up builds an
ops/instances.InstancedScene in place of a Scene and refits it once at
the configured transforms (ops/instances.grid_transforms(N) where none
are given); set_instance_transforms() stages the next (N, 3, 4)
transforms on the device from pinned memory, without waiting for the
card, and the next render() refits the soup on the
device (span "frame.refit", counter "refits") before it draws, once for
any number of calls in between. The frame programs, their variant and
accel checks and backend="oracle" take the refit SceneData as they take
a built one; path tracing and backend="megakernel_gp" raise ValueError on
an instanced scene. reset_device() rebuilds the instanced scene and
refits it at the last transforms.

The lit frame (backend "megakernel", no path tracing) reads its camera
from the device: render() copies the frame's camera vector
(ops/megakernel.camera_vector) from pinned memory, without blocking,
into one device tensor, which the frame program reads. Nothing else in
the lit frame waits for the card, so on the card the Renderer launches
a plain scene's lit frame as one CUDA graph: the first frame of a key
(the size and the variant) runs eagerly, which also fills every lazy
cache, the next frame with that key captures the frame program into a
torch.cuda.CUDAGraph (counter "frame.graph_captures") and every later
one replays it (counter "frame.graph_replays", span "frame.replay").
An instanced scene is never captured: its refit makes a new SceneData.
The replayed outputs are copied out of the graph's memory, so every
frame returned stays as it was. resize() and reset_device() drop the
graph; the CPU never captures.

The set-up is timed by two spans (runtime/profiler.timed):
"setup.scene_build" (Scene.build: the OBJ import, the packing and the
LBVH; or the InstancedScene's base mesh) and "setup.upload" (the
SceneData to the device; or the first refit); their lengths stay in the
counters "ns.setup.scene_build" and "ns.setup.upload".
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..config import SceneConfig
from ..core.camera import Camera
from ..core.controls import CircleCameraController
from ..core.scene import Scene
from ..io.image_out import encode_u8_device, write_png
from ..ops.instances import InstancedScene, grid_transforms
from ..ops.megakernel import (CAMERA_LEN, camera_vector, check_supported,
                              fused_eligible, render_megakernel)
from ..ops.oracle import render_oracle
from ..ops.pathtrace import PRNGKey, fold_in, render_pathtrace
from . import profiler


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def check_instances(config: SceneConfig, backend: str) -> None:
    """ValueError, naming the reason, where SceneConfig.instances asks for
    what the instanced scene does not draw."""
    inst = config.instances
    if inst.count < 0:
        raise ValueError(f"instances.count {inst.count} < 0")
    if inst.count == 0:
        if inst.transforms is not None:
            raise ValueError("instances.transforms given with "
                             "instances.count 0")
        return
    if len(config.meshes) != 1 or config.spheres:
        raise ValueError("an instanced scene draws exactly one mesh and no "
                         f"spheres; got {len(config.meshes)} mesh(es) and "
                         f"{len(config.spheres)} sphere(s)")
    if config.render.pt_bounces > 0:
        raise ValueError("an instanced scene is not path-traced: the path "
                         "tracer accumulates over fixed geometry")
    if backend == "megakernel_gp":
        raise ValueError("an instanced scene is not geometry-sharded: "
                         "backend 'megakernel_gp' shards a built scene")


@dataclasses.dataclass
class _FrameGraph:
    """A captured lit frame: its key (width, height, variant) and the
    frame's outputs in the graph's memory."""

    key: tuple
    graph: "torch.cuda.CUDAGraph"
    outs: tuple


class Renderer:
    def __init__(self, config: SceneConfig, backend: str = "auto", *,
                 device="cuda", limits=None):
        """limits: an optional runtime.limits.DeviceLimits, validated as
        wgpu validates pipelines at creation (the reference's wasm build
        requests crippled limits, src/lib.rs:136-170,287-297); raises
        ValueError listing every violation, as the JAX package does."""
        if limits is not None:
            from .limits import validate_limits

            bad = validate_limits(config, limits)
            if bad:
                raise ValueError(
                    "scene does not validate under device limits:\n  "
                    + "\n  ".join(bad))
        self.backend = self._pick_backend(backend)
        check_instances(config, self.backend)
        self._gp_mesh = None
        if self.backend == "megakernel_gp":
            from ..parallel.mesh import make_gp_mesh

            self._gp_mesh = make_gp_mesh(device=device)
            self.device = self._gp_mesh.device
        else:
            self.device = resolve_device(device)
        rc = config.render
        self.config = config
        self.pathtrace = rc.pt_bounces > 0
        self._accum = None
        self._spp_done = 0
        if not self.pathtrace and self.backend == "megakernel":
            if rc.variant not in ("split", "fused", "auto"):
                raise ValueError(f"unknown frame variant {rc.variant!r}")
            if rc.variant == "fused" and (
                    rc.mip or (self._normal_mapping and rc.shadows)):
                raise ValueError("variant='fused' needs a frame without "
                                 "mip and without normal mapping with "
                                 "shadows; use 'split' or 'auto'")
        # the lit frame: its camera comes from the device (module docstring)
        self._lit = not self.pathtrace and self.backend == "megakernel"
        self._graph: Optional[_FrameGraph] = None
        self._drawn = None  # the key of the last frame drawn eagerly
        self._make_camera()
        inst = config.instances
        self._instanced = None  # the InstancedScene of an instanced scene
        self._stale = False  # staged transforms not yet refit
        with profiler.timed("setup.scene_build"):
            if inst.count:
                self.scene = None
                self._instanced = InstancedScene.from_config(
                    config.meshes[0], inst.count, device=self.device)
            else:
                self.scene = Scene.build(config)
        with profiler.timed("setup.upload"):
            if self._instanced is not None:
                self._upload_instances(grid_transforms(inst.count)
                                       if inst.transforms is None
                                       else inst.transforms)
            else:
                self.data = self.scene.data.to(self.device)
        self.variant_ms = {}
        self.variant_chosen = None  # decided at the first render for auto
        if self.pathtrace:
            check_supported(self.data)  # PT always culls, as in JAX
        elif self.backend == "megakernel":
            check_supported(self.data, accel=rc.accel)
            eligible = self._fused_eligible()
            if rc.variant == "fused" and not eligible:
                raise ValueError("variant='fused' needs a mesh of at most "
                                 "STREAM_FACES faces; use 'split' or "
                                 "'auto'")
            if rc.variant != "auto" or not eligible:
                self.variant_chosen = ("fused" if rc.variant == "fused"
                                       else "split")
        elif self.backend == "megakernel_gp":
            check_supported(self.data, accel=rc.accel)
            self.variant_chosen = "gp"
        self.camera = Camera.from_config(
            config.camera, aspect=rc.width / rc.height)
        self.controller = CircleCameraController(speed=0.2)
        self.width = rc.width
        self.height = rc.height
        self.frame_count = 0
        self._last = None
        self._events = None
        self._last_frame_ms = float("nan")

    # --- instancing ---
    def set_instance_transforms(self, transforms) -> None:
        """The instances' (N, 3, 4) affine transforms [R | t] (a host
        array) for the next render(), which refits the soup before it
        draws. ValueError on a plain scene or on another shape."""
        if self._instanced is None:
            raise ValueError("set_instance_transforms needs an instanced "
                             "scene (SceneConfig.instances.count > 0)")
        self._stage(transforms)
        self._stale = True

    def _upload_instances(self, transforms) -> None:
        """Stage `transforms` and refit the soup at them: the set-up's and
        reset_device's."""
        self._stage(transforms)
        self.data = self._instanced.instantiate(self._staged)
        self._stale = False

    def _stage(self, transforms) -> None:
        """Check the shape, keep a host copy and put the transforms on the
        device: on the card from pinned memory, without blocking (the
        caching host allocator keeps the pinned block until its copy has
        run)."""
        t = np.array(transforms, dtype=np.float32)
        want = (self._instanced.n_instances, 3, 4)
        if t.shape != want:
            raise ValueError(f"transforms: shape {t.shape}, expected {want}")
        self._transforms = t
        host = torch.from_numpy(t)
        if self.device.type == "cuda":
            host = host.pin_memory()
        self._staged = host.to(self.device, non_blocking=True)

    def _make_camera(self) -> None:
        """The device tensor a captured lit frame reads its camera from."""
        self._camera = None
        if self._lit and self.device.type == "cuda":
            self._camera = torch.zeros(CAMERA_LEN, dtype=torch.float32,
                                       device=self.device)

    def _stage_camera(self, uni) -> torch.Tensor:
        """The frame's camera vector on the device (module docstring)."""
        vec = torch.from_numpy(camera_vector(uni))
        if self._camera is None:
            return vec
        return self._camera.copy_(vec.pin_memory(), non_blocking=True)

    def _refit(self) -> None:
        with profiler.span("frame.refit"):
            self.data = self._instanced.instantiate(self._staged)
        profiler.count("refits")
        self._stale = False

    @property
    def _normal_mapping(self) -> bool:
        return any(m.normal_mapping for m in self.config.meshes)

    def _fused_eligible(self) -> bool:
        rc = self.config.render
        return fused_eligible(self.data, shadows=rc.shadows,
                              normal_mapping=self._normal_mapping,
                              mip=rc.mip)

    @staticmethod
    def _pick_backend(backend: str) -> str:
        if backend in ("auto", "megakernel"):
            return "megakernel"
        if backend in ("oracle", "megakernel_gp"):
            return backend
        raise ValueError(f"unknown backend {backend!r}")

    def _frame(self, uni, variant=None, camera=None):
        rc = self.config.render
        if self.pathtrace:
            return self._pathtrace_frame(uni)
        if self.backend == "oracle":
            return render_oracle(
                self.data, uni, width=self.width, height=self.height,
                near=rc.kernel_near, far=rc.kernel_far,
                background=tuple(self.config.background),
                shadows=rc.shadows, quantize=rc.quantize_rgba8,
                normal_mapping=self._normal_mapping)
        if self.backend == "megakernel_gp":
            from ..parallel.geometry_sharding import render_sharded_gp

            return render_sharded_gp(
                self.data, uni, self._gp_mesh, width=self.width,
                height=self.height, near=rc.kernel_near, far=rc.kernel_far,
                background=tuple(self.config.background),
                shadows=rc.shadows, quantize=rc.quantize_rgba8,
                normal_mapping=self._normal_mapping, accel=rc.accel,
                mip=rc.mip)
        return render_megakernel(
            self.data, uni, width=self.width, height=self.height,
            near=rc.kernel_near, far=rc.kernel_far,
            background=tuple(self.config.background), shadows=rc.shadows,
            quantize=rc.quantize_rgba8,
            normal_mapping=self._normal_mapping,
            accel=rc.accel, fused=(variant or self.variant_chosen) == "fused",
            mip=rc.mip, camera=camera)

    def _draw(self, uni, camera):
        """The frame: on the card a plain scene's lit frame runs eagerly,
        is captured or is replayed (module docstring); the rest runs
        eagerly."""
        if not self._lit or self._instanced is not None \
                or self.device.type != "cuda":
            return self._frame(uni, camera=camera)
        key = (self.width, self.height, self.variant_chosen)
        g = self._graph
        if g is None or g.key != key:
            drawn, self._drawn = self._drawn, key
            if drawn != key:
                self._graph = None
                return self._frame(uni, camera=camera)
            g = self._graph = self._capture(key, uni, camera)
        profiler.count("frame.graph_replays")
        with profiler.span("frame.replay"):
            g.graph.replay()
            return tuple(t.clone() for t in g.outs)

    def _capture(self, key, uni, camera) -> _FrameGraph:
        """Capture the frame program, reading `camera`, in a CUDA graph
        on a stream of its own (nothing runs until the replay)."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), torch.cuda.graph(
                graph, stream=torch.cuda.Stream(self.device)):
            outs = self._frame(uni, camera=camera)
        profiler.count("frame.graph_captures")
        return _FrameGraph(key, graph, tuple(outs))

    def _drop_graph(self) -> None:
        self._graph = None
        self._drawn = None

    def _pathtrace_frame(self, uni):
        """One progressive sample (JAX runtime/renderer.py PT frame):
        returns (mean radiance (H, W, 3), depth of ones)."""
        rc = self.config.render
        depth = torch.ones((self.height, self.width), dtype=torch.float32,
                           device=self.device)
        target = rc.pt_spp if rc.pt_spp > 0 else None
        if self._accum is not None and target is not None \
                and self._spp_done >= target:
            return self._accum / self._spp_done, depth
        key = fold_in(PRNGKey(rc.seed), self._spp_done)
        spp = 1 if target is None else min(target - self._spp_done, 1)
        self._accum = render_pathtrace(
            self.data, uni, key, width=self.width, height=self.height,
            bounces=rc.pt_bounces, spp=spp,
            background=tuple(self.config.background), accum=self._accum,
            compact_cap="auto")
        self._spp_done += spp
        return self._accum / self._spp_done, depth

    def _time_frames(self, fn, n: int = 8, warmup: int = 1) -> float:
        """Mean ms per frame of fn over n frames after warmup frames:
        CUDA events on the card, the host clock on the CPU."""
        for _ in range(warmup):
            fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / n
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) * 1e3 / n

    def _autotune(self, uni, camera) -> None:
        """variant="auto": time split and fused on this frame, keep the
        faster."""
        self.variant_ms = {
            name: self._time_frames(
                lambda name=name: self._frame(uni, name, camera))
            for name in ("split", "fused")}
        self.variant_chosen = min(self.variant_ms, key=self.variant_ms.get)

    # --- State::update (src/lib.rs:994-1010) ---
    def update(self):
        before = self.camera.eye.copy()
        self.controller.update_camera(self.camera)
        if self._accum is not None and not np.array_equal(
                before, self.camera.eye):
            self._reset_accumulation()  # camera moved

    def _reset_accumulation(self):
        self._accum = None
        self._spp_done = 0

    # --- State::render (src/lib.rs:1012-1230) ---
    def render(self, block: bool = False):
        """Returns the device-resident (color, depth) tensors.
        block=True waits for the frame (torch.cuda.synchronize). An
        instanced scene with new transforms is refit first."""
        if self._stale:
            self._refit()
        cam = self.camera.uniforms()
        uni = cam.flat()
        camera = self._stage_camera(cam) if self._lit else None
        if self.variant_chosen is None and self._lit:
            self._autotune(uni, camera)
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            color, depth = self._draw(uni, camera)
            end.record()
            self._events = (start, end)
            if block:
                torch.cuda.synchronize(self.device)
        else:
            t0 = time.perf_counter()
            color, depth = self._draw(uni, camera)
            self._events = None
            self._last_frame_ms = (time.perf_counter() - t0) * 1e3
        self.frame_count += 1
        self._last = (color, depth)
        return color, depth

    @property
    def last_frame_ms(self) -> float:
        """Time of the latest frame: CUDA events around it on the card
        (waits for the frame to finish), the host clock on the CPU."""
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self._last_frame_ms = start.elapsed_time(end)
            self._events = None
        return self._last_frame_ms

    # --- State::resize (src/lib.rs:772-989) ---
    def resize(self, width: int, height: int):
        if width <= 0 or height <= 0:
            return  # the reference also ignores degenerate sizes
        self.width, self.height = width, height
        self.camera.aspect = width / height
        self.config = dataclasses.replace(
            self.config, render=dataclasses.replace(
                self.config.render, width=width, height=height))
        self._reset_accumulation()
        self._drop_graph()
        rc = self.config.render
        if self._lit and rc.variant == "auto" and self._fused_eligible():
            # as JAX's _build_frame_fn: the next render re-times both
            # programs at the new size
            self.variant_chosen = None
            self.variant_ms = {}

    # --- presentation (screenquad.wgsl analogue) ---
    def _latest_color(self):
        if self._last is None:
            self.render()
        return self._last[0]

    def present_image(self, srgb: bool = True, color=None) -> np.ndarray:
        """(H,W,3) u8 top-down image of the latest frame, or of `color`
        (an older frame: the pipelined FrameLoop presents frame k-1 while
        frame k renders), encoded on the device so only the u8 image
        crosses to the host."""
        return self.fetch_image(srgb=srgb, color=color)()

    def fetch_image(self, srgb: bool = True, color=None):
        """Queue present_image's encode and its copy to the host; returns
        a function that waits for the copy and returns the image. On the
        card the copy goes to pinned memory without blocking the host, so
        work queued after it (the next frame) is enqueued while the copy
        runs, and the wait covers the copy alone."""
        if color is None:
            color = self._latest_color()
        img = encode_u8_device(color, srgb=srgb)
        if img.device.type != "cuda":
            return lambda: img.numpy()[::-1]
        host = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
        host.copy_(img, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()

        def wait() -> np.ndarray:
            copied.synchronize()
            return host.numpy()[::-1]
        return wait

    def reset_device(self):
        """Rebuild the Renderer's device state: wait for the card, free
        its cached blocks and upload the scene anew, or rebuild an
        instanced scene and refit it at the last transforms (FrameLoop's
        recovery from a lost device, followed by a resize); drop the
        frame's graph and make its camera tensor anew. Raises where the
        card is still unusable."""
        self._drop_graph()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
        self._make_camera()
        if self._instanced is not None:
            self._instanced = InstancedScene.from_config(
                self.config.meshes[0], self._instanced.n_instances,
                device=self.device)
            self._upload_instances(self._transforms)
        else:
            self.data = self.scene.data.to(self.device)
        self._last = None
        self._events = None

    def save_png(self, path: str, srgb: bool = True):
        write_png(path, self._latest_color(), srgb=srgb)

    # --- metrics ---
    @property
    def spp_done(self) -> int:
        """Accumulated path-tracing samples per pixel (0 outside PT)."""
        return self._spp_done

    @property
    def pt_converged(self) -> bool:
        """True once the accumulation reached RenderConfig.pt_spp (as in
        the JAX package, also for an unbounded accumulation, pt_spp <= 0)."""
        rc = self.config.render
        return self.pathtrace and self.spp_done >= rc.pt_spp

    @property
    def mrays_per_s(self) -> float:
        ms = self.last_frame_ms
        if not np.isfinite(ms):
            return float("nan")
        return (self.width * self.height) / (ms * 1e-3) / 1e6
