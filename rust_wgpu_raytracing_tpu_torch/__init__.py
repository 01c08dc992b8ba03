"""rust_wgpu_raytracing_tpu_torch — the ray tracer on PyTorch and CUDA.

A port of the JAX/Pallas package `rust_wgpu_raytracing_tpu` (which stays
in the repository as the reference) to PyTorch, with the frame's kernels
hand-written in CUDA C++ for Hopper (csrc/). It renders spheres plus
one triangle soup: the fused and the split frame (Blinn-Phong shading
with textures, normal mapping, mip sampling, hard shadows, accel
"brute", "cull" or "bvh") and the progressive path tracer
(RenderConfig.pt_bounces > 0); meshes above STREAM_FACES faces take the
streamed sweeps. Renderer(backend="oracle") draws through the
brute-force oracle (ops/oracle.py), the executable spec. Instancing
with the per-frame refit (ops/instances.py), the forward raster
pipeline (ops/raster.py) and the runtime shells (runtime/frame_loop.py,
server.py, window.py, limits.py; io/checkpoint.py) are here too, and so
is multi-device rendering on torch.distributed (parallel/: row slabs and
samples, face shards with Renderer(backend="megakernel_gp"), the
sharded inverse-rendering train step).

The host modules (config, camera, controllers, OBJ/MTL import, scene
assembly, the native C++ host library of native/) are copies of the JAX
package's, because importing any module of that package imports JAX.
This package never imports JAX. Left out as TPU-only: utils/
compile_cache.py (XLA's persistent compilation cache), the profiler's
tunnel-sync calibration (runtime/profiler.py), the one-hot matrix-unit
winner fetch (ops/megakernel.py), RT_STREAM_BATCH (the Pallas grid's
batch; ops/megakernel.STREAM_BATCH is its default), the opt-in mask and
gather switches RT_AH_PERRAY, RT_PT_KREFINE and RT_TEX_ROW_GATHER (none
faster than the default on the H100; PERF.md) and the TPU tools
(tools/prof_*.py, tools/tpu_*.sh, tools/lower_smoke.py).

    from rust_wgpu_raytracing_tpu_torch import Renderer
    r = Renderer(cfg, device="cuda")   # or device="cpu"
    color, depth = r.render(block=True)
"""

from .config import (
    CameraConfig,
    InstancesConfig,
    LightConfig,
    MeshConfig,
    RenderConfig,
    SceneConfig,
    SphereConfig,
)
from .core.camera import Camera, CameraUniforms
from .core.controls import CircleCameraController, OrbitAnimator
from .core.scene import Scene, SceneData
from .runtime.renderer import Renderer

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "CameraUniforms",
    "CameraConfig",
    "CircleCameraController",
    "InstancesConfig",
    "LightConfig",
    "MeshConfig",
    "OrbitAnimator",
    "RenderConfig",
    "Renderer",
    "Scene",
    "SceneData",
    "SceneConfig",
    "SphereConfig",
]
