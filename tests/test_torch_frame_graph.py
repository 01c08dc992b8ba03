"""PyTorch port: the lit frame's camera from the device, and the Renderer's
CUDA graph of the lit frame (runtime/renderer.py).

CPU: the raygen from a camera vector (ops/megakernel.frame_camera) is
bitwise the raygen from the host's floats, tiled and scanline, with a row
slab, over several cameras (an axis-aligned view among them); a
Renderer's lit frames are bitwise render_megakernel's from the host
uniforms, fused and split, with shadows, normal mapping, mip sampling,
brute, cull and bvh, with and without a mesh; no lit frame waits at
"uniforms"; a CPU Renderer never captures.

Card (marked gpu): over 60 orbit steps of a fused scene and of a split
bvh scene past STREAM_FACES, and over 5 of each lit program above, every
replayed frame is bitwise the eager frame; one capture for each scene and shape, one more after a resize,
none until the second frame after reset_device; an instanced scene never
captures, whether it is refit every frame or every other frame, and
stays bitwise; a frame returned earlier is unchanged after
later renders; a replayed frame makes no host sync; a scene constant
(ops/scenepacks.py) first requested inside a capture raises.
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

import rust_wgpu_raytracing_tpu_torch as rt
from rust_wgpu_raytracing_tpu_torch import config as pcfg
from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
from rust_wgpu_raytracing_tpu_torch.core.scene import Scene
from rust_wgpu_raytracing_tpu_torch.ops import instances as pinst
from rust_wgpu_raytracing_tpu_torch.ops import megakernel as MK
from rust_wgpu_raytracing_tpu_torch.ops import scenepacks as SP
from rust_wgpu_raytracing_tpu_torch.runtime import profiler
from test_torch_host import (cuda_device, terrain_config,  # noqa: F401
                             textured_config, write_textured_assets)

CAMERAS = {
    "terrain": ((0.0, -2.0, -1.0), (0.0, 0.0, -3.2)),
    "axis": ((0.0, 0.0, 0.0), (0.0, 0.0, -3.0)),  # straight down -z
    "above": ((0.3, 2.5, -2.0), (0.0, 0.0, -3.0)),
    "grazing": ((-4.0, -0.05, -3.1), (0.0, 0.0, -3.0)),
}


def uniforms(eye, target, width, height):
    cam = Camera.from_config(pcfg.CameraConfig(eye=eye, target=target),
                             aspect=width / height)
    return cam.uniforms()


def bits(planes):
    return [p.view(torch.int32) for p in planes]


@pytest.mark.parametrize("camera", sorted(CAMERAS))
@pytest.mark.parametrize("order,width,height,row0,total", [
    ("tiled", 256, 64, None, None),
    ("tiled", 256, 32, 16, 96),
    ("scanline", 40, 24, None, None),
    ("scanline", 40, 12, 6, 30),
])
def test_device_camera_raygen_is_bitwise_the_host_raygen(
        camera, order, width, height, row0, total):
    uni = uniforms(*CAMERAS[camera], width, total or height)
    vec = MK.frame_camera(uni.flat(), "cpu")
    assert vec.shape == (MK.CAMERA_LEN,) and vec.dtype == torch.float32
    assert np.array_equal(vec[:3].numpy(), uni.origin)
    kw = dict(device="cpu", row0=row0, total_height=total)
    if order == "tiled":
        kw.update(tile_h=8, tile_w=128)
        host = MK.raygen_planar_tiled(width, height, uni, **kw)
        dev = MK.raygen_planar_tiled(width, height, vec, **kw)
    else:
        host = MK.raygen_planar(width, height, uni, **kw)
        dev = MK.raygen_planar(width, height, vec, **kw)
    for a, b in zip(bits(host), bits(dev)):
        assert torch.equal(a, b)


def lit_config(kind, width=64, height=48):
    """A small lit scene of each program the Renderer draws."""
    if kind.startswith("nm"):  # the bump-mapped box of write_textured_assets
        shadows = kind == "nm_split"
        cfg = textured_config(pcfg, width=width, height=height,
                              shadows=shadows, bump=True)
        return dc.replace(cfg, render=dc.replace(
            cfg.render, variant="split" if shadows else "fused"))
    grid, accel, variant = {"fused": (23, "cull", "fused"),
                            "split": (23, "cull", "split"),
                            "split_bvh": (23, "bvh", "split"),
                            "stream_bvh": (92, "bvh", "auto"),
                            "auto": (23, "cull", "auto"),
                            "brute": (23, "brute", "split"),
                            "mip": (23, "cull", "auto"),
                            "spheres": (23, "cull", "auto")}[kind]
    cfg = terrain_config(pcfg, grid=grid, width=width, height=height,
                         accel=accel)
    if kind == "spheres":
        cfg = dc.replace(cfg, meshes=())
    return dc.replace(cfg, render=dc.replace(cfg.render, variant=variant,
                                             mip=kind == "mip"))


LIT_KINDS = ["fused", "split", "auto", "split_bvh", "stream_bvh", "brute",
             "mip", "spheres", "nm_fused", "nm_split"]


def lit_renderer(kind, device, tmp_path, monkeypatch, **size):
    if kind.startswith("nm"):
        write_textured_assets(tmp_path, bump=True)
        monkeypatch.setenv("RWRT_ASSETS", str(tmp_path))
    return rt.Renderer(lit_config(kind, **size), device=device)


def eager_frame(r, uni_flat):
    """render_megakernel from the host uniforms with the Renderer's
    settings."""
    rc = r.config.render
    return MK.render_megakernel(
        r.data, uni_flat, width=r.width, height=r.height,
        near=rc.kernel_near, far=rc.kernel_far,
        background=tuple(r.config.background), shadows=rc.shadows,
        quantize=rc.quantize_rgba8,
        normal_mapping=any(m.normal_mapping for m in r.config.meshes),
        accel=rc.accel, fused=r.variant_chosen == "fused", mip=rc.mip)


def same_frame(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


@pytest.mark.parametrize("kind", LIT_KINDS)
def test_lit_frames_are_the_host_uniforms_frames(kind, tmp_path,
                                                 monkeypatch):
    """A Renderer's lit frame (its camera vector on the device) is bitwise
    render_megakernel's from the host uniforms, and no frame waits at
    any site; the CPU never captures."""
    r = lit_renderer(kind, "cpu", tmp_path, monkeypatch)
    before = profiler.counters()
    r.controller.process_key("d", True)
    for _ in range(3):
        r.update()
        got = r.render()
        assert same_frame(got, eager_frame(r, r.camera.uniforms().flat()))
    after = profiler.counters()
    moved = {k for k in set(before) | set(after)
             if k.startswith(("syncs.", "frame.graph_"))
             and after.get(k, 0) != before.get(k, 0)}
    assert moved == set()
    assert r._graph is None


def test_no_uniforms_wait_in_either_lit_program():
    """render_megakernel from host uniforms, fused and split: the frame
    reads its camera from a tensor and counts no wait."""
    data = Scene.build(lit_config("fused")).data
    uni = uniforms(*CAMERAS["terrain"], 64, 48).flat()
    before = profiler.counters()
    for fused in (True, False):
        MK.render_megakernel(data, uni, width=64, height=48, shadows=True,
                             fused=fused)
    after = profiler.counters()
    assert {k: v for k, v in after.items() if k.startswith("syncs.")} == \
        {k: v for k, v in before.items() if k.startswith("syncs.")}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def graph_counts():
    c = profiler.counters()
    return (c.get("frame.graph_captures", 0),
            c.get("frame.graph_replays", 0))


def orbit(r, steps, check=None):
    """`steps` orbit steps (key "d" held) through r.render(); check(r,
    frame) after each."""
    r.controller.process_key("d", True)
    frames = []
    for _ in range(steps):
        r.update()
        frame = r.render()
        if check is not None:
            check(r, frame)
        frames.append(frame)
    return frames


GRAPH_SCENES = {
    # the reference's spheres and terrain:91 (16,200 faces), fused
    "fused_terrain91": (91, "cull", "fused"),
    # terrain:128 (32,768 padded faces), the streamed split frame with bvh
    "split_bvh_terrain128": (128, "bvh", "split"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("scene", sorted(GRAPH_SCENES))
def test_replayed_frames_are_bitwise_the_eager_frames(cuda_device, scene):
    grid, accel, variant = GRAPH_SCENES[scene]
    cfg = terrain_config(pcfg, grid=grid, width=1920, height=1080,
                         accel=accel)
    cfg = dc.replace(cfg, render=dc.replace(cfg.render, variant=variant))
    r = rt.Renderer(cfg, device="cuda")
    if accel == "bvh":
        assert r.data.padded_faces > MK.STREAM_FACES
    c0, p0 = graph_counts()
    bad = []

    def check(r, frame):
        if not same_frame(frame, eager_frame(r, r.camera.uniforms().flat())):
            bad.append(r.frame_count)

    orbit(r, 60, check)
    assert bad == []
    assert graph_counts() == (c0 + 1, p0 + 59)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", LIT_KINDS)
def test_every_lit_program_replays_bitwise(cuda_device, kind, tmp_path,
                                           monkeypatch):
    """Each program and option the Renderer draws a lit frame with
    captures once and replays frames bitwise the eager ones."""
    r = lit_renderer(kind, "cuda", tmp_path, monkeypatch, width=256,
                     height=128)
    c0, p0 = graph_counts()
    bad = []

    def check(r, frame):
        if not same_frame(frame, eager_frame(r, r.camera.uniforms().flat())):
            bad.append(r.frame_count)

    orbit(r, 5, check)
    assert bad == [] and graph_counts() == (c0 + 1, p0 + 4)


@pytest.mark.gpu
def test_one_capture_per_scene_and_shape(cuda_device):
    cfg = terrain_config(pcfg, grid=23, width=256, height=128)
    cfg = dc.replace(cfg, render=dc.replace(cfg.render, variant="fused"))
    r = rt.Renderer(cfg, device="cuda")
    c0, p0 = graph_counts()
    orbit(r, 4)
    assert graph_counts() == (c0 + 1, p0 + 3)
    r.resize(320, 160)
    orbit(r, 4)
    assert graph_counts() == (c0 + 2, p0 + 6)
    r.reset_device()
    r.render()  # eager: the graph went with the device state
    assert graph_counts() == (c0 + 2, p0 + 6)
    orbit(r, 2)
    assert graph_counts() == (c0 + 3, p0 + 8)
    r.update()
    assert same_frame(r.render(), eager_frame(r, r.camera.uniforms().flat()))


@pytest.mark.gpu
def test_instanced_scene_never_captures(cuda_device):
    n = 64
    cfg = rt.SceneConfig(
        meshes=(rt.MeshConfig(obj_path="builtin:terrain:23"),),
        camera=rt.CameraConfig(eye=(0.0, 0.0, 18.0), target=(0.0, 0.0, -6.0)),
        render=rt.RenderConfig(width=320, height=180, accel="bvh",
                               variant="split"),
        instances=rt.InstancesConfig(
            count=n, transforms=pinst.grid_transforms(n, z=-6.0)))
    r = rt.Renderer(cfg, device="cuda")
    c0, p0 = graph_counts()
    for k in range(10):  # refit every frame, then every other frame
        if k < 4 or k % 2 == 0:
            r.set_instance_transforms(pinst.grid_transforms(
                n, z=-6.0, angle=0.05 * k))
        frame = r.render()
        assert same_frame(frame, eager_frame(r, r.camera.uniforms().flat()))
    assert graph_counts() == (c0, p0)


@pytest.mark.gpu
def test_a_returned_frame_survives_later_renders(cuda_device):
    cfg = terrain_config(pcfg, grid=23, width=256, height=128)
    r = rt.Renderer(dc.replace(cfg, render=dc.replace(cfg.render,
                                                      variant="split")),
                    device="cuda")
    held = orbit(r, 3)  # eager, capture, replay
    kept = [tuple(t.clone() for t in f) for f in held]
    orbit(r, 2)
    torch.cuda.synchronize()
    for f, k in zip(held, kept):
        assert same_frame(f, k)
    assert not same_frame(held[1], held[2])  # the camera moved


@pytest.mark.gpu
def test_a_replayed_frame_makes_no_host_sync(cuda_device):
    cfg = terrain_config(pcfg, grid=91, width=640, height=360)
    r = rt.Renderer(dc.replace(cfg, render=dc.replace(cfg.render,
                                                      variant="fused")),
                    device="cuda")
    orbit(r, 3)
    torch.cuda.synchronize()
    c0, p0 = graph_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        frames = orbit(r, 3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert graph_counts() == (c0, p0 + 3)
    assert same_frame(frames[-1], eager_frame(r, r.camera.uniforms().flat()))


@pytest.mark.gpu
def test_a_scene_constant_first_requested_in_a_capture_raises(cuda_device):
    """Capture records kernels without running them, so a scene constant
    first built there would hold nothing: the request raises. One built
    before the capture is handed out inside it."""
    data = Scene.build(terrain_config(pcfg)).data.to(cuda_device)
    x = torch.ones(4, device=cuda_device)
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            x.mul_(2.0)
            SP.pack_face_columns(data)
    built = SP.pack_face_columns(data)
    with torch.cuda.graph(torch.cuda.CUDAGraph()):
        x.mul_(2.0)
        assert SP.pack_face_columns(data) is built
