"""PyTorch port: kernels.super_any (csrc/super_any.cu), the per-ray union
superblock admission of the streamed bounce sweep, against its plain
twin ops/traverse.perray_super_any BITWISE.

Inputs: the terrain bounce wavefront of test_torch_stream (terrain:92,
its superblock boxes, the cluster boxes with padding turned empty, and
the raw cluster boxes with their +inf padding), the seeded adversarial
ray sets of testing/raycull.py on its grid meshes, and a hand case:
parked rays (zero direction, some inside a box), padding boxes (+inf /
-inf), half-open boxes, act-false lanes and a tile with none live,
direction components below the smallest normal f32 and infinite ones
(NaN slab times), and a superblock count that is a multiple neither of a
warp nor of the kernel's 128-superblock groups. The CPU tests hold the
wrapper's plain path and the glue's calls; the card tests (marked gpu)
hold the kernel to the plain function on the same tensors, and a whole
streamed path-traced sample through KERNELS to the same sample with the
plain admission.
"""

import dataclasses as dc
import os
from unittest import mock

import numpy as np
import pytest
import torch

from rust_wgpu_raytracing_tpu_torch import config as pcfg
from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
from rust_wgpu_raytracing_tpu_torch.core.scene import Scene
from rust_wgpu_raytracing_tpu_torch.ops import kernels as K
from rust_wgpu_raytracing_tpu_torch.ops import megakernel as P
from rust_wgpu_raytracing_tpu_torch.ops import scenepacks as SP
from rust_wgpu_raytracing_tpu_torch.ops.pathtrace import (PRNGKey, fold_in,
                                                          render_pathtrace)
from rust_wgpu_raytracing_tpu_torch.ops.traverse import perray_super_any
from rust_wgpu_raytracing_tpu_torch.testing.raycull import (
    ADVERSARIAL_KINDS, CAMERA_KINDS, adversarial_camera, adversarial_rays,
    write_grid_mesh)
from test_torch_host import cuda_device, terrain_config  # noqa: F401
from test_torch_stream import bounce_tensors, scene_config

# raycull.write_grid_mesh cells: 928 faces in 8-face clusters, 5,024 in 32
GRIDS = {"bf8": 16, "bf32": 48}
TILE = 1024
HAND_SUPER = 131
PT_W = 32


def hand_case(seed=5):
    """(slo, shi (S, 3), planes [ox, oy, oz, dx, dy, dz] (R,), act (R,))
    CPU tensors, S = HAND_SUPER, R = 3 tiles of TILE."""
    rng = np.random.default_rng(seed)
    s, r = HAND_SUPER, 3 * TILE
    c = rng.uniform(-2.0, 2.0, (s, 3))
    h = rng.uniform(0.0, 0.6, (s, 3))
    h[rng.uniform(size=(s, 3)) < 0.1] = 0.0  # flat slabs
    lo, hi = c - h, c + h
    pad = rng.uniform(size=s) < 0.1
    lo[pad], hi[pad] = np.inf, -np.inf
    half = rng.integers(0, s, 6)  # half-open: d = inf gives NaN slab times
    hi[half, rng.integers(0, 3, 6)] = np.inf
    lo[half[:3], rng.integers(0, 3, 3)] = -np.inf
    o = rng.uniform(-2.5, 2.5, (r, 3))
    d = rng.normal(size=(r, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    kind = rng.integers(0, 8, r)
    d[kind == 0, rng.integers(0, 3, int((kind == 0).sum()))] = 0.0
    d[kind == 1] = 0.0  # zero direction: inside a box or not
    inside = np.flatnonzero(kind == 1)[: r // 32]
    o[inside] = c[rng.integers(0, s, inside.size)]
    d[kind == 2, 0] = rng.choice([1e-40, -1e-39, 1e-45, -1e-38],
                                 int((kind == 2).sum()))
    d[kind == 3, 1] = rng.choice([np.inf, -np.inf], int((kind == 3).sum()))
    o[kind == 4] = 1e9  # parked
    d[kind == 4] = 0.0
    d[kind == 5, 2] = -0.0
    act = rng.uniform(size=r) < 0.7
    act[TILE:2 * TILE] = False  # a tile with no live ray
    # the last tile: 8 random live rays, and one from the centre of each
    # box open to +inf in y, along +inf in y. Its y slab time is (hi - o)
    # / inf = NaN, so the box is not admitted by it: min and max must
    # propagate NaN (fmin and fmax would admit it at t = 0)
    act[2 * TILE + 8:] = False
    yopen = rng.choice(np.flatnonzero(~pad), 6, replace=False)
    hi[yopen, 1] = np.inf
    rays = 2 * TILE + 8 + np.arange(6)
    o[rays] = c[yopen]
    d[rays] = (0.3, np.inf, 0.2)
    act[rays] = True
    f32 = [torch.from_numpy(np.ascontiguousarray(v, np.float32))
           for v in (lo, hi)]
    planes = [torch.from_numpy(np.ascontiguousarray(v, np.float32))
              for v in (*o.T, *d.T)]
    return f32[0], f32[1], planes, torch.from_numpy(act)


def terrain_case():
    """(box sets {name: (lo, hi)}, padded planes, live) of the bounce
    wavefront on terrain:92."""
    data = Scene.build(scene_config(92)).data
    o, d, _, _ = bounce_tensors()
    planes = [P._pad1(v, TILE) for v in (*o, *d)]
    live = (planes[3] != 0) | (planes[4] != 0) | (planes[5] != 0)
    return box_sets(data), planes, live


def box_sets(data):
    """The superblock boxes the glue hands the kernel, and the cluster
    boxes with padding turned empty (-> +inf / -inf) and as stored
    (+inf padding on both sides)."""
    return {"superblocks": SP.super_boxes(data),
            "clusters": SP.cluster_boxes(data)[:2],
            "raw clusters": (data.blk_lo, data.blk_hi)}


@pytest.fixture(scope="module")
def grid_meshes(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("super_any"))
    for name, cells in GRIDS.items():
        write_grid_mesh(os.path.join(root, f"{name}.obj"), cells)
    cfgs = {name: pcfg.SceneConfig(
        meshes=(pcfg.MeshConfig(obj_path=f"{name}.obj",
                                light_direction=(0.0, 0.0, -1.0)),),
        render=pcfg.RenderConfig(width=64, height=32)) for name in GRIDS}
    with mock.patch.dict(os.environ, {"RWRT_ASSETS": root}):
        return {name: Scene.build(cfg).data for name, cfg in cfgs.items()}


def adversarial_cases(data, cells, seed):
    """(what, planes, act) for each ray set and camera of raycull."""
    out = []
    for i, kind in enumerate(ADVERSARIAL_KINDS):
        o, d, so, sd, act = adversarial_rays(kind, cells, data.blk_lo,
                                             data.blk_hi, seed + i)
        live = torch.from_numpy((d != 0).any(axis=0))
        out.append((f"{kind} rays", [torch.from_numpy(v)
                                     for v in (*o, *d)], live))
        out.append((f"{kind} shadow rays", [torch.from_numpy(v)
                                            for v in (*so, *sd)],
                    torch.from_numpy(act)))
    for i, kind in enumerate(CAMERA_KINDS):
        origin, d = adversarial_camera(kind, cells, data.blk_lo,
                                       data.blk_hi, seed + 20 + i)
        n = d.shape[1]
        o = [torch.full((n,), float(v)) for v in origin]
        out.append((f"{kind} camera", o + [torch.from_numpy(v) for v in d],
                    None))
    return out


def test_super_any_on_cpu_is_perray_super_any():
    """On CPU tensors the wrapper runs the plain function and launches
    nothing; the plain version is traverse.perray_super_any itself."""
    assert K.PLAIN.super_any is perray_super_any
    assert K.super_any_plain is perray_super_any
    slo, shi, planes, act = hand_case()
    before = K.launch_counts()["super_any"]
    for a in (act, None):
        got = K.super_any(slo, shi, *planes, TILE, act=a)
        want = perray_super_any(slo, shi, *planes, TILE, act=a)
        assert got.dtype == torch.bool and got.shape == (3, HAND_SUPER)
        assert torch.equal(got, want)
    assert K.launch_counts()["super_any"] == before
    # the hand case can tell: a tile with no live ray admits nothing, the
    # others some superblocks and not all
    want = perray_super_any(slo, shi, *planes, TILE, act=act)
    assert not bool(want[1].any())
    assert 0 < int(want[0].sum()) < HAND_SUPER


def test_kernel_set_has_super_any():
    assert "super_any" in K.KernelSet._fields
    assert K.KERNELS.super_any is K.super_any
    assert "super_any" in K.launch_counts()


@pytest.mark.parametrize("bad", ["act dtype", "box dtype", "box shape",
                                 "plane length", "tile"])
def test_super_any_rejects_bad_arguments(bad):
    """The wrapper raises on what the kernel does not take, on the CPU
    too (it checks before it picks a path)."""
    slo, shi, planes, act = hand_case()
    tile = TILE
    if bad == "act dtype":
        act = act.to(torch.uint8)
    elif bad == "box dtype":
        slo = slo.double()
    elif bad == "box shape":
        shi = shi[:-1]
    elif bad == "plane length":
        planes[4] = planes[4][:-1]
    else:
        tile = 1000
    with pytest.raises((TypeError, ValueError)):
        K.super_any(slo, shi, *planes, tile, act=act)


def counting_kernels(calls):
    def wrap(name, fn):
        def call(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return call
    return K.KernelSet(*(wrap(f.__name__, p)
                         for f, p in zip(K.KERNELS, K.PLAIN)))


@pytest.mark.parametrize("grid,want", [(92, 3), (23, 0)])
def test_streamed_sample_admits_once_a_bounce(grid, want):
    """A 3-bounce sample calls super_any once a bounce past STREAM_FACES
    (terrain:92, gbuffer_perray's streamed branch) and never below it
    (terrain:23, the all-on-chip sweeps)."""
    cfg = terrain_config(pcfg, grid=grid, width=PT_W, height=PT_W,
                         shadows=False)
    cfg = dc.replace(cfg, camera=pcfg.CameraConfig(eye=(0.0, -0.4, -1.2),
                                                   target=(0.0, 0.0, -3.0)))
    data = Scene.build(cfg).data
    uni = Camera.from_config(cfg.camera, 1.0).uniforms().flat()
    calls = {}
    render_pathtrace(data, uni, fold_in(PRNGKey(3), 0), width=PT_W,
                     height=PT_W, bounces=3, kernels=counting_kernels(calls))
    assert calls.get("super_any", 0) == want
    assert calls.get("stream_closest_hit_perray", 0) == want


def test_super_any_plain_on_the_terrain_wavefront():
    """The plain function on the test's inputs admits some superblocks
    and clears others, so the card tests below can tell."""
    boxes, planes, live = terrain_case()
    got = K.super_any(*boxes["clusters"], *planes, TILE, act=live)
    assert 0 < int(got.sum()) < got.numel()


def cuda_equal(slo, shi, planes, tile, act, device, what):
    args = [x.to(device) for x in (slo, shi, *planes)]
    a = act.to(device) if act is not None else None
    before = K.launch_counts()["super_any"]
    got = K.super_any(*args, tile, act=a)
    torch.cuda.synchronize()
    assert K.launch_counts()["super_any"] == before + 1
    want = perray_super_any(*args, tile, act=a)
    assert got.dtype == torch.bool and got.shape == want.shape, what
    assert torch.equal(got, want), what
    assert torch.equal(got.cpu(), perray_super_any(slo, shi, *planes, tile,
                                                   act=act)), what
    return got


@pytest.mark.gpu
def test_super_any_cuda_terrain_wavefront(cuda_device):
    boxes, planes, live = terrain_case()
    for name, (lo, hi) in boxes.items():
        for tile in (TILE, 512, 3 * TILE):
            cuda_equal(lo, hi, planes, tile, live, cuda_device,
                       f"{name}, tile {tile}")
        cuda_equal(lo, hi, planes, TILE, None, cuda_device, f"{name}, all")


@pytest.mark.gpu
@pytest.mark.parametrize("mesh", sorted(GRIDS))
def test_super_any_cuda_adversarial(grid_meshes, mesh, cuda_device):
    data = grid_meshes[mesh]
    seed = 500 + 50 * sorted(GRIDS).index(mesh)
    for what, planes, act in adversarial_cases(data, GRIDS[mesh], seed):
        for name, (lo, hi) in box_sets(data).items():
            cuda_equal(lo, hi, planes, TILE, act, cuda_device,
                       f"{mesh} {what}, {name}")


@pytest.mark.gpu
def test_super_any_cuda_hand_case(cuda_device):
    slo, shi, planes, act = hand_case()
    got = cuda_equal(slo, shi, planes, TILE, act, cuda_device, "hand")
    assert not bool(got[1].any()) and 0 < int(got[0].sum()) < HAND_SUPER
    cuda_equal(slo, shi, planes, TILE, None, cuda_device, "hand, all live")
    cuda_equal(slo, shi, planes, 64, act, cuda_device, "hand, tile 64")
    for s in (1, 31, 129):
        cuda_equal(slo[:s].contiguous(), shi[:s].contiguous(), planes, TILE,
                   act, cuda_device, f"hand, {s} superblocks")


@pytest.mark.gpu
def test_streamed_sample_cuda_equals_plain_admission(cuda_device):
    """One 3-bounce path-traced sample of terrain:92 at 128x96 through
    KERNELS, bitwise the same sample with the plain admission."""
    cfg = scene_config(92)
    data = Scene.build(cfg).data.to(cuda_device)
    uni = Camera.from_config(cfg.camera, 128 / 96).uniforms().flat()
    before = K.launch_counts()["super_any"]

    def sample(kernels):
        return render_pathtrace(data, uni, fold_in(PRNGKey(11), 0),
                                width=128, height=96, bounces=3,
                                kernels=kernels)
    got = sample(K.KERNELS)
    torch.cuda.synchronize()
    assert K.launch_counts()["super_any"] == before + 3
    want = sample(K.KERNELS._replace(super_any=K.PLAIN.super_any))
    assert float(got.sum()) > 0
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
