"""Config system for scenes, cameras, and render settings.

The reference hardcodes every constant (window 600x600 at src/lib.rs:1248,
fovy 60 / znear .1 / zfar 100 at src/lib.rs:352-360, kernel near/far .01/100
at src/models/sphere/compute.wgsl:38-39, controller speed 0.2 at
src/lib.rs:361, sphere placements at src/lib.rs:532-534, per-kernel light
directions at sphere/compute.wgsl:41 vs triangle_list/compute.wgsl:55).
This module is the config subsystem the reference lacks; the defaults below
reproduce the reference's live scene exactly.

Deliberately-preserved reference quirks (documented, configurable):
- kernel depth-mapping near/far (.01/100) differs from camera znear (.1);
- the sphere kernel and the triangle kernel use DIFFERENT light directions;
- proj_inv uniform is premultiplied by OPENGL_TO_WGPU (src/lib.rs:109),
  which widens the effective ray-gen FOV far beyond `fovy` — see
  core/camera.py.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

Vec3 = Tuple[float, float, float]


@dataclass(frozen=True)
class CameraConfig:
    """Mirrors the reference Camera struct (src/camera.rs:3-11)."""

    eye: Vec3 = (0.0, 0.0, 0.0)
    target: Vec3 = (0.0, 0.0, -1.0)
    up: Vec3 = (0.0, 1.0, 0.0)
    fovy_deg: float = 60.0
    znear: float = 0.1
    zfar: float = 100.0
    # aspect is derived from the render size at build time (the reference
    # derives it from the surface config, src/lib.rs:356).


@dataclass(frozen=True)
class LightConfig:
    """Directional light + Blinn-Phong constants.

    The reference hardcodes light dirs per kernel: (1,-5,1) for spheres
    (sphere/compute.wgsl:41), (1,-1,-5) for meshes
    (triangle_list/compute.wgsl:55). `None` in a primitive config falls back
    to these defaults to preserve parity.
    """

    direction: Vec3 = (1.0, -1.0, -5.0)
    shininess: float = 32.0


@dataclass(frozen=True)
class SphereConfig:
    """An analytic sphere (reference SphereBufferData, sphere.rs:10-15).

    The reference hardcodes red + (ambient .1, diffuse 1, specular .5)
    (sphere/compute.wgsl:138-147); those are the defaults here.
    """

    center: Vec3
    radius: float
    color: Vec3 = (1.0, 0.0, 0.0)
    ambient: float = 0.1
    diffuse: float = 1.0
    specular: float = 0.5
    light_direction: Vec3 = (1.0, -5.0, 1.0)


@dataclass(frozen=True)
class MeshConfig:
    """A triangle mesh loaded from an OBJ file (reference resources.rs:163)."""

    obj_path: str
    light_direction: Vec3 = (1.0, -1.0, -5.0)
    # Object-to-world transform (for instancing / combined scenes; the
    # reference renders meshes untransformed).
    translation: Vec3 = (0.0, 0.0, 0.0)
    scale: float = 1.0
    # Use the normal map (map_Bump) if the MTL provides one. The reference
    # ships cube-normal.png but never samples it; normal mapping is a
    # BASELINE-added capability (off by default for parity).
    normal_mapping: bool = False


@dataclass(frozen=True)
class RenderConfig:
    """Framebuffer + kernel settings."""

    width: int = 600  # reference default window size, src/lib.rs:1248
    height: int = 600
    # Depth-mapping constants used by toNonLinearDepth
    # (sphere/compute.wgsl:38-39). NOTE: differs from camera znear on
    # purpose — reference quirk preserved.
    kernel_near: float = 0.01
    kernel_far: float = 100.0
    # Shadows: cast a hard shadow ray per primary hit (BASELINE config 3
    # capability; the reference has no shadow rays).
    shadows: bool = False
    # Acceleration strategy (bit-identical output across all three):
    # "brute" = no culling (reference-parity brute force,
    #           triangle_list/compute.wgsl:186-202),
    # "cull"  = flat tile-interval Morton-cluster mask,
    # "bvh"   = LBVH build + stackless skip-pointer traversal
    #           (ops/traverse.py; BASELINE north star).
    accel: str = "cull"
    # Quantize the framebuffer to rgba8 like the reference's rgba8unorm
    # storage texture (sphere/compute.wgsl:2); tests compare at u8.
    quantize_rgba8: bool = True
    # Trilinear mip-chain minification (EXTENSION; megakernel backend
    # only). Off by default: the reference forces mip level 0 via
    # textureSampleGrad(..., 0, 0) (triangle_list/compute.wgsl:225), so
    # parity rendering must too. See ops/miptex.py.
    mip: bool = False
    # Frame-program variant (megakernel backend): "split" = the
    # closest-hit sweep (K1, or K9 streamed), the PyTorch shade with the
    # texture kernel (K2) and the shadow any-hit sweep (K3 or K11);
    # "fused" = the sweep, the spheres, the shading factors and the
    # composite in one frame kernel (K4, ops/fusedframe.py; needs a mesh
    # of at most STREAM_FACES faces, not normal mapping with shadows, no
    # mip). Both draw the same quantized frame (tested). "auto" (the
    # default) takes split where the fused frame is not eligible and
    # otherwise times both at the first render, eagerly (1 warm-up, then
    # 8 frames each), and keeps the faster, though later frames replay
    # as a CUDA graph on the card (runtime/renderer.py).
    variant: str = "auto"
    # Path tracing (BASELINE config 4): 0 = off (Blinn-Phong primary rays).
    pt_bounces: int = 0
    pt_spp: int = 64
    seed: int = 0


@dataclass(frozen=True)
class InstancesConfig:
    """Instancing (BASELINE config 5): the scene's one mesh drawn `count`
    times, each copy placed by an affine (3, 4) transform [R | t] that
    the Renderer may change every frame (Renderer.set_instance_transforms;
    ops/instances.py refits the soup on the device). count 0 is a plain
    scene. `transforms` holds the first (count, 3, 4) placement (any
    nested sequence or array, kept as nested float tuples); None places
    the copies by ops/instances.grid_transforms(count).
    An instanced scene has exactly one mesh and no spheres, and is drawn
    by the frame programs and the oracle only: no path tracing, no
    geometry sharding."""

    count: int = 0
    transforms: Optional[Tuple[Tuple[Tuple[float, ...], ...], ...]] = None

    def __post_init__(self):
        if self.transforms is not None:
            object.__setattr__(self, "transforms", tuple(
                tuple(tuple(float(v) for v in row) for row in t)
                for t in self.transforms))


@dataclass(frozen=True)
class SceneConfig:
    """A full scene: primitives in PASS ORDER.

    Pass order matters: the reference composites passes sequentially with a
    strict `<` depth test (sphere/compute.wgsl:133), so earlier passes win
    depth ties. The reference's live scene is sphere(back), sphere(front),
    suzanne (src/lib.rs:1106-1184).
    """

    spheres: Tuple[SphereConfig, ...] = ()
    meshes: Tuple[MeshConfig, ...] = ()
    background: Vec3 = (0.0, 0.0, 0.0)  # cleared framebuffer color
    camera: CameraConfig = field(default_factory=CameraConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    instances: InstancesConfig = field(default_factory=InstancesConfig)

    def __repr__(self) -> str:
        # a plain scene leaves the instancing field out, as to_json does,
        # so it reads as the JAX package's SceneConfig
        fields = [f.name for f in dataclasses.fields(self)
                  if f.name != "instances" or self.instances.count]
        return f"{type(self).__qualname__}(" + ", ".join(
            f"{name}={getattr(self, name)!r}" for name in fields) + ")"

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        if not self.instances.count:
            del d["instances"]  # a plain scene writes the JAX package's JSON
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(text: str) -> "SceneConfig":
        raw = json.loads(text)

        def tup(d, k):
            # tuple-ify list fields ONLY when present — hand-written
            # configs may omit any field with a dataclass default
            return {k: tuple(d[k])} if k in d else {}

        cam = raw.get("camera", {})
        return SceneConfig(
            spheres=tuple(
                SphereConfig(**{**s, **tup(s, "center"), **tup(s, "color"),
                                **tup(s, "light_direction")})
                for s in raw.get("spheres", ())),
            meshes=tuple(
                MeshConfig(**{**m, **tup(m, "light_direction"),
                              **tup(m, "translation")})
                for m in raw.get("meshes", ())),
            background=tuple(raw.get("background", (0.0, 0.0, 0.0))),
            camera=CameraConfig(**{**cam, **tup(cam, "eye"),
                                   **tup(cam, "target"), **tup(cam, "up")}),
            render=RenderConfig(**raw.get("render", {})),
            instances=InstancesConfig(**raw.get("instances", {})),
        )


# ---------------------------------------------------------------------------
# Asset resolution
# ---------------------------------------------------------------------------

def _asset_search_paths():
    # read $RWRT_ASSETS per call: setting it after import must work
    return (
        os.environ.get("RWRT_ASSETS", ""),
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "assets"),
    )


def resolve_asset(name: str) -> str:
    """Find an asset file (OBJ/MTL/texture) on the search path.

    Mirrors the reference's asset resolution (build.rs OUT_DIR copy for
    native, HTTP origin fetch for wasm — src/resources.rs:9-37) with a
    search-path scheme: $RWRT_ASSETS, then ./assets. The reference's own
    res/ directory is reached by pointing $RWRT_ASSETS at it.
    """
    if os.path.isabs(name) and os.path.exists(name):
        return name
    paths = _asset_search_paths()
    for root in paths:
        if not root:
            continue
        cand = os.path.join(root, name)
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(
        f"asset {name!r} not found on search path {paths}")


def reference_scene(width: int = 600, height: int = 600, **render_overrides) -> SceneConfig:
    """The reference's live scene: two red spheres + textured suzanne.

    Placements from src/lib.rs:532-534 (back sphere r=.4 @ (.6,.5,-4),
    front sphere r=.4 @ (.4,.4,-3)) and src/lib.rs:559-566 (suzanne_lowpoly).
    """
    return SceneConfig(
        spheres=(
            SphereConfig(center=(0.6, 0.5, -4.0), radius=0.4),
            SphereConfig(center=(0.4, 0.4, -3.0), radius=0.4),
        ),
        meshes=(MeshConfig(obj_path="suzanne_lowpoly.obj"),),
        render=RenderConfig(width=width, height=height, **render_overrides),
    )


def cube_scene(width: int = 256, height: int = 256, **render_overrides) -> SceneConfig:
    """BASELINE config 1: cube.obj, fixed camera, 256x256, primary rays."""
    return SceneConfig(
        meshes=(MeshConfig(obj_path="cube.obj", translation=(0.0, 0.0, -3.0), scale=0.75),),
        render=RenderConfig(width=width, height=height, **render_overrides),
    )
