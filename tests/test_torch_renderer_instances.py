"""PyTorch port: instanced scenes on Renderer's path (SceneConfig.instances,
Renderer.set_instance_transforms, the refit in render()).

The Renderer's frame is held bit for bit to the side path it replaces,
render_megakernel over InstancedScene.instantiate at the same transforms:
a fused-eligible soup (4 cubes) and a streamed one (4 heightfields with
STREAM_FACES lowered to 512 in ops/instances.py and ops/megakernel.py,
so that the soup pads to superblocks and takes the split frame's
streamed sweep). New transforms refit once before the next frame; the
configured first transforms, accel="bvh", the oracle, reset_device and
FrameLoop keep to the same frames; the configurations an instanced scene
does not draw raise ValueError. On the card (-m gpu), config 5's soup
through FrameLoop, each image bit for bit the side path's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import rust_wgpu_raytracing_tpu_torch as rt
from rust_wgpu_raytracing_tpu_torch.ops import instances as pinst
from rust_wgpu_raytracing_tpu_torch.ops import megakernel as MK
from rust_wgpu_raytracing_tpu_torch.ops.oracle import render_oracle
from rust_wgpu_raytracing_tpu_torch.runtime import profiler
from rust_wgpu_raytracing_tpu_torch.runtime.frame_loop import FrameLoop
from test_torch_host import cuda_device  # noqa: F401

W, H = 64, 48
N = 4
EYE, TARGET = (0.3, -0.5, -1.5), (0.0, 0.0, -6.0)
T1 = pinst.grid_transforms(N, z=-6.0, angle=0.3)
T2 = pinst.grid_transforms(N, z=-6.0, angle=0.9)
# soup: (mesh, variant, STREAM_FACES in both modules or None)
SOUPS = {"fused": ("builtin:cube", "fused", None),
         "streamed": ("builtin:terrain:12", "split", 512)}


@pytest.fixture(params=list(SOUPS))
def soup(request, monkeypatch):
    mesh, variant, sf = SOUPS[request.param]
    if sf is not None:
        monkeypatch.setattr(pinst, "STREAM_FACES", sf)
        monkeypatch.setattr(MK, "STREAM_FACES", sf)
    return request.param, mesh, variant


def scene_config(mesh, variant="split", transforms=T1, accel="cull",
                 **render):
    return rt.SceneConfig(
        meshes=(rt.MeshConfig(obj_path=mesh),),
        camera=rt.CameraConfig(eye=EYE, target=TARGET),
        render=rt.RenderConfig(width=W, height=H, variant=variant,
                               accel=accel, **render),
        instances=rt.InstancesConfig(count=N, transforms=transforms))


def side_frame(mesh, t, **kw):
    """The side path: render_megakernel over a fresh refit at `t`."""
    inst = pinst.InstancedScene.from_config(rt.MeshConfig(obj_path=mesh), N,
                                            device="cpu")
    uni = rt.Camera.from_config(rt.CameraConfig(eye=EYE, target=TARGET),
                                W / H).uniforms().flat()
    return MK.render_megakernel(inst.instantiate(t), uni, width=W, height=H,
                                **kw)


def refits():
    return profiler.counters().get("refits", 0)


def test_renderer_draws_the_side_paths_frames(soup):
    name, mesh, variant = soup
    r = rt.Renderer(scene_config(mesh, variant), device="cpu")
    assert r.variant_chosen == variant
    assert MK._should_stream(r.data.padded_faces, 32) == (name == "streamed")
    fused = variant == "fused"
    c1, d1 = r.render()
    w1 = side_frame(mesh, T1, fused=fused)
    assert float((d1 < 1).float().mean()) > 0.01  # the soup is seen
    assert torch.equal(c1, w1[0]) and torch.equal(d1, w1[1])
    r.set_instance_transforms(T2)
    c2, d2 = r.render()
    w2 = side_frame(mesh, T2, fused=fused)
    assert torch.equal(c2, w2[0]) and torch.equal(d2, w2[1])
    assert not torch.equal(c2, c1)


def test_one_refit_per_change_of_transforms():
    r = rt.Renderer(scene_config("builtin:cube"), device="cpu")
    n0 = refits()  # the set-up's own refit is no frame's
    r.render()
    assert refits() == n0
    r.set_instance_transforms(T2)
    r.render()
    assert refits() == n0 + 1
    r.render()
    r.render()
    assert refits() == n0 + 1
    r.set_instance_transforms(T1)
    r.set_instance_transforms(T2)
    c, _ = r.render()
    assert refits() == n0 + 2
    assert torch.equal(c, side_frame("builtin:cube", T2)[0])


def test_configured_transforms_and_the_default_grid():
    default = rt.Renderer(scene_config("builtin:cube", transforms=None),
                          device="cpu")
    grid = pinst.grid_transforms(N)
    assert torch.equal(default.render()[0],
                       rt.Renderer(scene_config("builtin:cube",
                                                transforms=grid),
                                   device="cpu").render()[0])
    assert not torch.equal(default.render()[0],
                           side_frame("builtin:cube", T1)[0])


def test_bvh_draws_the_cull_frame(monkeypatch):
    monkeypatch.setattr(pinst, "STREAM_FACES", 512)
    monkeypatch.setattr(MK, "STREAM_FACES", 512)
    frames = {}
    for accel in ("cull", "bvh"):
        r = rt.Renderer(scene_config("builtin:terrain:12", accel=accel),
                        device="cpu")
        r.set_instance_transforms(T2)
        frames[accel] = r.render()
    assert torch.equal(frames["cull"][0], frames["bvh"][0])
    assert torch.equal(frames["cull"][1], frames["bvh"][1])


def test_oracle_draws_the_refit_scene():
    r = rt.Renderer(scene_config("builtin:cube"), backend="oracle",
                    device="cpu")
    r.set_instance_transforms(T2)
    c, d = r.render()
    inst = pinst.InstancedScene.from_config(
        rt.MeshConfig(obj_path="builtin:cube"), N, device="cpu")
    wc, wd = render_oracle(inst.instantiate(T2), r.camera.uniforms().flat(),
                           width=W, height=H)
    assert torch.equal(c, wc) and torch.equal(d, wd)
    assert bool((d < 1).any())


def test_reset_device_keeps_the_pose():
    r = rt.Renderer(scene_config("builtin:cube"), device="cpu")
    r.set_instance_transforms(T2)
    want, _ = r.render()
    r.reset_device()
    got, _ = r.render()
    assert torch.equal(got, want)
    assert not torch.equal(got, side_frame("builtin:cube", T1)[0])


def test_frame_loop_presents_each_pose():
    """FrameLoop presents frame k-1 at step k: the images of the frames
    rendered at T1 and then at T2."""
    r = rt.Renderer(scene_config("builtin:cube"), device="cpu")
    loop = FrameLoop(r)
    assert loop.step() is None
    r.set_instance_transforms(T2)
    img1 = loop.step()
    img2 = loop.step()
    for img, t in ((img1, T1), (img2, T2)):
        want = r.present_image(color=side_frame("builtin:cube", t)[0])
        np.testing.assert_array_equal(img, want)
    assert not np.array_equal(img1, img2)


def test_what_an_instanced_scene_does_not_draw_raises():
    cfg = scene_config("builtin:cube")
    sphere = rt.SphereConfig(center=(0.0, 0.0, -4.0), radius=0.5)
    bad = {
        "path": (dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, pt_bounces=2)), "auto", "path-traced"),
        "gp": (cfg, "megakernel_gp", "geometry-sharded"),
        "two meshes": (dataclasses.replace(cfg, meshes=cfg.meshes * 2),
                       "auto", "exactly one mesh"),
        "spheres": (dataclasses.replace(cfg, spheres=(sphere,)), "auto",
                    "no spheres"),
        "transforms alone": (dataclasses.replace(
            cfg, instances=rt.InstancesConfig(transforms=(((1.0,),),))),
            "auto", "count 0")}
    for name, (c, backend, reason) in bad.items():
        with pytest.raises(ValueError, match=reason):
            rt.Renderer(c, backend=backend, device="cpu")
    r = rt.Renderer(cfg, device="cpu")
    with pytest.raises(ValueError, match="transforms"):
        r.set_instance_transforms(pinst.grid_transforms(N + 1))
    plain = rt.Renderer(dataclasses.replace(
        cfg, instances=rt.InstancesConfig()), device="cpu")
    with pytest.raises(ValueError, match="instanced scene"):
        plain.set_instance_transforms(T1)


def test_instances_round_trip_through_json():
    cfg = scene_config("builtin:cube")
    back = rt.SceneConfig.from_json(cfg.to_json())
    assert back == cfg
    np.testing.assert_array_equal(np.asarray(back.instances.transforms,
                                             np.float32), T1)
    plain = rt.SceneConfig.from_json('{"meshes": [{"obj_path": "x.obj"}]}')
    assert plain.instances == rt.InstancesConfig(count=0, transforms=None)
    # a plain scene's JSON is the JAX package's: no "instances" key
    assert '"instances"' not in plain.to_json()
    assert rt.SceneConfig.from_json(plain.to_json()) == plain


def test_repr_names_instances_only_when_there_are_some():
    plain = rt.SceneConfig(meshes=(rt.MeshConfig(obj_path="x.obj"),))
    # the dataclass's own repr of the fields a plain scene has
    fields = ("spheres", "meshes", "background", "camera", "render")
    assert repr(plain) == "SceneConfig(" + ", ".join(
        f"{f}={getattr(plain, f)!r}" for f in fields) + ")"
    cfg = scene_config("builtin:cube")
    unset = dataclasses.replace(cfg, instances=rt.InstancesConfig())
    assert repr(cfg) == (repr(unset)[:-1]
                         + f", instances={cfg.instances!r})")


@pytest.mark.gpu
def test_renderer_refits_on_the_card(cuda_device):
    """BASELINE config 5's soup on the card: 64 builtin:terrain:23 copies
    (65,536 padded faces, the streamed split frame with accel="bvh") at
    320x180 through FrameLoop, new transforms every step. Each presented
    image is bit for bit the side path's at that step's transforms on the
    card, and the pinned staging never makes the host wait."""
    n = 64
    cfg = rt.SceneConfig(
        meshes=(rt.MeshConfig(obj_path="builtin:terrain:23"),),
        camera=rt.CameraConfig(eye=(0.0, 0.0, 18.0), target=TARGET),
        render=rt.RenderConfig(width=320, height=180, accel="bvh",
                               variant="split"),
        instances=rt.InstancesConfig(
            count=n, transforms=pinst.grid_transforms(n, z=-6.0)))
    r = rt.Renderer(cfg, device="cuda")
    assert r.data.padded_faces == 65536
    inst = pinst.InstancedScene.from_config(cfg.meshes[0], n, device="cuda")
    uni = r.camera.uniforms().flat()
    loop = FrameLoop(r)
    waits = profiler.counters().get("syncs.transforms", 0)
    poses = [pinst.grid_transforms(n, z=-6.0, angle=0.05 * k)
             for k in range(6)]
    images = []
    for t in poses:
        r.set_instance_transforms(t)
        images.append(loop.step())
    images.append(loop.flush())
    for k, t in enumerate(poses):
        color, _ = MK.render_megakernel(inst.instantiate(t), uni, width=320,
                                        height=180, accel="bvh", fused=False)
        np.testing.assert_array_equal(images[k + 1],
                                      r.present_image(color=color))
    assert profiler.counters().get("syncs.transforms", 0) == waits
