"""PyTorch port: the per-ray cluster culling of kernels K8 (the path
tracer's fused extend + shadow sweep) and K10 (the streamed per-ray
closest hit).

Both kernels test a face block only for the rays whose own line enters
the block's box (ops/traverse.ray_box_enter, the plain twin of
csrc/rt_common.cuh ray_box_enter), a closest-hit ray only where that
entry lies at or below its best t so far. ops/kernels/raycull.py models
that walk in plain PyTorch; here the model is held against the unculled
plain versions (extend_shadow_plain, stream_closest_hit_perray_plain,
the TPU kernels' function) BITWISE: t, face and occ.

Inputs, from numpy seeds, on two meshes built at run time (an 8-face
cluster mesh and a 32-face one): flat axis-aligned grids (faces lie in
their boxes' planes, grid lines are edges shared by blocks) and a wall,
padded with NaN faces and +inf padding boxes. Ray sets: directions with
zero components, origins on box faces, origins inside boxes, rays in a
face plane, rays aimed at shared edges and vertices (t ties the lower
face id must win), each with parked rays (origin 1e9, zero direction).
Then the bounce-1 wavefronts of 64x64 path traces of a heightfield (K8)
and of a streamed one (K10). The arguments come from the port's own
glue (extend_shadow_rays, gbuffer_perray), which hands the kernels the
boxes. The card tests (marked gpu) hold the CUDA kernels to the plain
versions on the same inputs.
"""

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
from rust_wgpu_raytracing_tpu_torch.ops.kernels.raycull import (
    ADVERSARIAL_KINDS, adversarial_rays, extend_shadow_culled, mask_pairs,
    stream_pairs, stream_perray_culled, walk_counts, write_grid_mesh)
from rust_wgpu_raytracing_tpu_torch.ops.pathtrace import (PRNGKey, fold_in,
                                                          render_pathtrace)
from rust_wgpu_raytracing_tpu_torch.ops.traverse import ray_box_enter
from test_torch_host import cuda_device, heightfield_config  # noqa: F401

# mesh name: cells of raycull.write_grid_mesh's z = -3 grid (928 and
# 5,024 faces, padded to 1,024 and 5,120: whole superblocks, so K10 can be
# forced onto them)
MESHES = {"bf8": 16, "bf32": 48}
KINDS = ADVERSARIAL_KINDS
F32_INF = float("inf")


def mesh_config(name):
    return pcfg.SceneConfig(
        meshes=(pcfg.MeshConfig(obj_path=f"{name}.obj",
                                light_direction=(0.0, 0.0, -1.0)),),
        render=pcfg.RenderConfig(width=64, height=32))


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("raycull")
    for name, cells in MESHES.items():
        write_grid_mesh(os.path.join(root, f"{name}.obj"), cells)
    return str(root)


def write_bowl(root, n):
    """field.obj: a rippled bowl heightfield of n x n vertices over
    [-1, 1]^2, so most bounce rays hit it again."""
    u = np.linspace(-1.0, 1.0, n)
    x, y = np.meshgrid(u, u, indexing="xy")
    z = 0.7 * (x * x + y * y) + 0.05 * np.sin(9.0 * x) * np.cos(7.0 * y)
    verts = np.stack([x, y, z], -1).reshape(-1, 3)
    lines = [f"v {a:.7f} {b:.7f} {c:.7f}" for a, b, c in verts]
    for j in range(n - 1):
        for i in range(n - 1):
            a = j * n + i + 1
            lines += [f"f {a} {a + 1} {a + n + 1}", f"f {a} {a + n + 1} {a + n}"]
    with open(os.path.join(root, "field.obj"), "w") as fh:
        fh.write("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def fields(tmp_path_factory):
    """grid: a directory holding the bowl with grid vertices a side (49:
    4,608 faces in 32-face clusters; 92: 16,562, streamed)."""
    out = {}
    for grid in (49, 92):
        out[grid] = str(tmp_path_factory.mktemp(f"field{grid}"))
        write_bowl(out[grid], grid)
    return out


@pytest.fixture(scope="module")
def meshes(assets):
    with mock.patch.dict(os.environ, {"RWRT_ASSETS": assets}):
        return {name: Scene.build(mesh_config(name)).data
                for name in MESHES}


def rays(kind, mesh, data, seed):
    return adversarial_rays(kind, MESHES[mesh], data.blk_lo, data.blk_hi,
                            seed)


def recorder(calls):
    """A KernelSet of the plain versions that records each call."""
    def wrap(name, fn):
        def call(*a, **kw):
            calls.setdefault(name, []).append((a, kw))
            return fn(*a, **kw)
        return call
    return K.KernelSet(*(wrap(f.__name__, p)
                         for f, p in zip(K.KERNELS, K.PLAIN)))


def tens(planes):
    return [torch.from_numpy(v) for v in planes]


def k8_args(data, o, d, so, sd, act):
    """extend_shadow's arguments from the port's glue."""
    calls = {}
    P.extend_shadow_rays(data, *tens(o), *tens(d), *tens(so), *tens(sd),
                         torch.from_numpy(act), kernels=recorder(calls))
    return calls["extend_shadow"][0]


def k10_args(data, o, d):
    """stream_closest_hit_perray's arguments from the port's glue."""
    calls = {}
    P.gbuffer_perray(data, *tens(o), *tens(d), stream=True,
                     kernels=recorder(calls))
    return calls["stream_closest_hit_perray"][0]


def assert_bits(got, want, what):
    for name, g, w in zip(what, got, want):
        g, w = g.numpy(), w.numpy()
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=name)


def winner_entered(t, face, blo, bhi, dx, dy, dz, ox, oy, oz, block_f):
    """True where a ray that hits enters its winning face's block with an
    entry at or below its t: then every visit order keeps the winner."""
    hit = torch.isfinite(t)
    b = face[hit].long() // block_f
    ok, entry = ray_box_enter(blo[b], bhi[b], ox[hit], oy[hit], oz[hit],
                              dx[hit], dy[hit], dz[hit])
    return bool((ok & (entry <= t[hit])).all())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_culled_k8_equals_plain(meshes, mesh, kind):
    data = meshes[mesh]
    seed = 100 + KINDS.index(kind) + 10 * sorted(MESHES).index(mesh)
    args, kw = k8_args(data, *rays(kind, mesh, data, seed))
    bf = kw["block_f"]
    assert bf == (8 if mesh == "bf8" else 32)
    blo, bhi = args[17], args[18]
    assert torch.equal(blo, data.blk_lo) and torch.equal(bhi, data.blk_hi)
    assert bool(torch.isinf(blo).all(1).any())  # padding boxes
    want = K.extend_shadow_plain(*args, **kw)
    got = extend_shadow_culled(*args, **kw)
    assert_bits(got, want, ("t", "face", "occ"))
    assert winner_entered(want[0], want[1], blo, bhi, *args[2:8], bf)
    assert int(torch.isfinite(want[0]).sum()) > 50
    if kind != "in_plane":
        assert int((want[2] > 0).sum()) > 50


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_culled_k10_equals_plain(meshes, mesh, kind):
    data = meshes[mesh]
    seed = 200 + KINDS.index(kind) + 10 * sorted(MESHES).index(mesh)
    o, d, _, _, _ = rays(kind, mesh, data, seed)
    args, kw = k10_args(data, o, d)
    blo, bhi = args[11], args[12]
    assert blo.shape == (data.padded_faces // 32, 3)
    want = K.stream_closest_hit_perray_plain(*args, **kw)
    got = stream_perray_culled(*args, **kw)
    assert_bits(got, want, ("t", "face"))
    assert winner_entered(want[0], want[1], blo, bhi, *args[3:9], 32)
    assert int(torch.isfinite(want[0]).sum()) > 50


def pt_wavefront(root, name):
    """The first call of `name` in one 64x64 path-traced sample (2
    bounces) of the bowl in `root`."""
    cfg = heightfield_config(pcfg, width=64, height=64)
    with mock.patch.dict(os.environ, {"RWRT_ASSETS": root}):
        data = Scene.build(cfg).data
    uni = Camera.from_config(cfg.camera, 1.0).uniforms().flat()
    calls = {}
    render_pathtrace(data, uni, fold_in(PRNGKey(3), 0), width=64, height=64,
                     bounces=2, kernels=recorder(calls))
    return data, calls[name][0]


def test_pt_bounce1_k8_culled_equals_plain(fields):
    data, (args, kw) = pt_wavefront(fields[49], "extend_shadow")
    assert kw["block_f"] == 32 and data.num_faces == 4608
    want = K.extend_shadow_plain(*args, **kw)
    got = extend_shadow_culled(*args, **kw)
    assert_bits(got, want, ("t", "face", "occ"))
    assert int(torch.isfinite(want[0]).sum()) > 150
    assert int((want[2] > 0).sum()) > 50
    n_tiles = args[2].shape[0] // 1024
    nb = args[15].shape[0] // 32
    aimed = (args[2] != 0) | (args[3] != 0) | (args[4] != 0)
    n = walk_counts(mask_pairs(args[0], n_tiles, nb), args[17], args[18],
                    *args[2:8], aimed, t_final=want[0])
    # the culled walk tests a small share of the mask walk's pairs
    assert n["face_pairs"] <= n["entered"] < n["admitted"] / 4
    assert n["box_tests"] == n["admitted"] and n["blocks"] <= nb
    s = walk_counts(mask_pairs(args[1], n_tiles, nb), args[17], args[18],
                    *args[8:14], args[14] > 0, occ=want[2])
    assert s["face_pairs"] <= s["box_tests"] <= s["admitted"] + int(
        (want[2] > 0).sum())
    assert s["entered"] < s["admitted"]


def test_pt_bounce1_k10_culled_equals_plain(fields):
    data, (args, kw) = pt_wavefront(fields[92], "stream_closest_hit_perray")
    assert data.num_faces > 16384  # streamed on its own
    want = K.stream_closest_hit_perray_plain(*args, **kw)
    got = stream_perray_culled(*args, **kw)
    assert_bits(got, want, ("t", "face"))
    assert int(torch.isfinite(want[0]).sum()) > 150
    assert winner_entered(want[0], want[1], args[11], args[12],
                          *args[3:9], 32)
    aimed = (args[3] != 0) | (args[4] != 0) | (args[5] != 0)
    n = walk_counts(stream_pairs(args[0], args[2]), args[11], args[12],
                    *args[3:9], aimed, t_final=want[0])
    assert n["face_pairs"] <= n["entered"] < n["admitted"] / 4


@pytest.mark.parametrize("case", ["zero_inside", "zero_on_face",
                                  "zero_outside", "padding", "behind",
                                  "ahead"])
def test_ray_box_enter_cases(case):
    """Hand cases of the slab test against the box [0, 1]^3."""
    lo = torch.tensor([0.0, 0.0, 0.0])
    hi = torch.tensor([1.0, 1.0, 1.0])
    o, d, want_ok, want_entry = {
        "zero_inside": ((0.5, 0.5, -1.0), (0.0, 0.0, 1.0), True, 1.0),
        "zero_on_face": ((1.0, 0.0, -2.0), (0.0, 0.0, 1.0), True, 2.0),
        "zero_outside": ((1.001, 0.5, -1.0), (0.0, 0.0, 1.0), False,
                         None),
        "padding": ((0.5, 0.5, 0.5), (0.0, 0.0, 1.0), False, None),
        "behind": ((0.5, 0.5, 2.0), (0.0, 0.0, 1.0), False, None),
        "ahead": ((0.5, 0.5, 0.5), (0.6, 0.0, 0.8), True, 0.0),
    }[case]
    if case == "padding":
        lo, hi = torch.full((3,), F32_INF), torch.full((3,), -F32_INF)
    o = [torch.tensor(v, dtype=torch.float32) for v in o]
    d = [torch.tensor(v, dtype=torch.float32) for v in d]
    ok, entry = ray_box_enter(lo, hi, *o, *d)
    assert bool(ok) == want_ok
    if want_ok:
        # deflated: at most the true entry, within the margins of it
        assert float(entry) <= want_entry
        assert float(entry) >= want_entry - 1e-4 * (1.0 + want_entry)


def test_ray_box_enter_is_conservative():
    """Seeded rays and boxes, half the rays aimed at a point of the box
    or just beside it: wherever the line meets the box in exact
    (float64) arithmetic, the test admits it, with an entry at most the
    exact one."""
    rng = np.random.default_rng(7)
    n = 200_000
    lo = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    hi = (lo + rng.uniform(0, 0.3, (n, 3)) * (rng.uniform(size=(n, 3))
                                               > 0.1)).astype(np.float32)
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    aim = rng.uniform(lo - 1e-4, hi + 1e-4)
    d = np.where(rng.uniform(size=(n, 1)) < 0.5, aim - o,
                 rng.normal(size=(n, 3)))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[rng.uniform(size=(n, 3)) < 0.1] = 0.0
    lo64, hi64, o64, d64 = (x.astype(np.float64) for x in (lo, hi, o, d))
    with np.errstate(divide="ignore", invalid="ignore"):
        ta = (lo64 - o64) / d64
        tb = (hi64 - o64) / d64
    inside = (o64 >= lo64) & (o64 <= hi64)
    tn = np.where(d64 == 0, np.where(inside, 0, np.inf), np.minimum(ta, tb))
    tf = np.where(d64 == 0, np.where(inside, np.inf, -np.inf),
                  np.maximum(ta, tb))
    t_in = np.maximum(tn.max(1), 0.0)
    meets = t_in <= tf.min(1)
    ok, entry = ray_box_enter(torch.from_numpy(lo), torch.from_numpy(hi),
                              *(torch.from_numpy(o[:, a].copy())
                                for a in range(3)),
                              *(torch.from_numpy(d[:, a].copy())
                                for a in range(3)))
    ok, entry = ok.numpy(), entry.numpy().astype(np.float64)
    assert meets.sum() > 20_000 and (~meets).sum() > 20_000
    assert ok[meets].all()
    assert (entry[meets] <= t_in[meets]).all()
    # the margins stay small: few far misses are admitted
    assert ok[~meets].mean() < 0.05


def test_wrappers_take_and_ignore_boxes(meshes):
    """On the CPU the wrappers run the unculled plain versions, with or
    without boxes; mismatched boxes raise."""
    data = meshes["bf8"]
    args, kw = k8_args(data, *rays("inside", "bf8", data, 5))
    with_boxes = K.extend_shadow(*args, **kw)
    without = K.extend_shadow(*args[:17], **kw)
    assert_bits(with_boxes, without, ("t", "face", "occ"))
    with pytest.raises(ValueError):
        K.extend_shadow(*args[:17], args[17][:-1], args[18][:-1], **kw)
    with pytest.raises(ValueError):
        K.extend_shadow(*args[:18], None, **kw)
    o, d, _, _, _ = rays("inside", "bf8", data, 6)
    args, kw = k10_args(data, o, d)
    assert_bits(K.stream_closest_hit_perray(*args),
                K.stream_closest_hit_perray(*args[:11]), ("t", "face"))
    with pytest.raises(TypeError):
        K.stream_closest_hit_perray(*args[:11], args[11].double(),
                                    args[12])


def test_block_boxes_follow_the_blocks(meshes):
    """_block_boxes: a block of 32 faces over 8-face clusters takes the
    union of its four boxes (padding stays +inf / -inf)."""
    data = meshes["bf8"]
    f = data.padded_faces
    lo, hi = P._block_boxes(data, f, 8)
    assert lo is data.blk_lo and hi is data.blk_hi
    lo, hi = P._block_boxes(data, f, 32)
    assert torch.equal(lo, data.blk_lo.view(-1, 4, 3).amin(1))
    assert torch.equal(hi, data.blk_hi.view(-1, 4, 3).amax(1))
    assert bool(torch.isinf(lo[-1]).all()) and bool((lo[-1] > 0).all())


def gpu_inputs(meshes, mesh, kind, device):
    data = meshes[mesh]
    r = rays(kind, mesh, data, 300 + KINDS.index(kind))
    a8, kw8 = k8_args(data, *r)
    a10, kw10 = k10_args(data, r[0], r[1])
    move = (lambda a: a.to(device) if isinstance(a, torch.Tensor) else a)
    return [move(a) for a in a8], kw8, [move(a) for a in a10], kw10


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_culling_kernels_cuda_match_plain(meshes, mesh, kind, cuda_device):
    """K8 and K10 on the card, with the boxes and without, against their
    plain versions on the adversarial sets: every output equal."""
    a8, kw8, a10, kw10 = gpu_inputs(meshes, mesh, kind, cuda_device)
    for fn, plain, args, kw in (
            (K.extend_shadow, K.extend_shadow_plain, a8, kw8),
            (K.stream_closest_hit_perray, K.stream_closest_hit_perray_plain,
             a10, kw10)):
        want = plain(*args, **kw)
        for a in (args, args[:-2]):
            before = fn.launches
            got = fn(*a, **kw)
            torch.cuda.synchronize()
            assert fn.launches == before + 1
            for x, y in zip(got, want):
                assert torch.equal(x, y), fn.__name__
