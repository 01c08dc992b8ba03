"""PyTorch port: the per-ray cluster culling of kernels K1 (the
shared-origin closest hit), K3 (the shadow any-hit), K4 (the fused frame
kernel: its sweep and its in-kernel shadow loop), K7 (the per-ray-origin
closest hit), K8 (the path tracer's
fused extend + shadow sweep), K9 (the streamed shared-origin closest
hit), K10 (the streamed per-ray closest hit) and K11 (the streamed
shadow any-hit).

The kernels test a face block only for the rays whose own line enters
the block's box (ops/traverse.ray_box_enter, the plain twin of
csrc/rt_common.cuh ray_box_enter), a closest-hit ray only where that
entry lies at or below its best t so far. testing/raycull.py models
that walk in plain PyTorch (K1's, K3's and K7's models follow the
kernels' chunks of the front-to-back schedule, K4's the same sweep and K3's walk
over the static cluster order, K9's and K11's their word walk, split
into work items); here the model is held against the unculled plain
versions (closest_hit_plain, anyhit_plain, frame_plain,
closest_hit_perray_plain, extend_shadow_plain,
stream_closest_hit_plain, stream_closest_hit_perray_plain,
stream_anyhit_plain, the TPU kernels' function) BITWISE: t, face and
occ, K1's and K9's zero t with its sign (a camera on a face's plane
draws the face or not by that sign; the split frame there is held
against the JAX package's).

Inputs, from numpy seeds, on two meshes built at run time (an 8-face
cluster mesh and a 32-face one): flat axis-aligned grids (faces lie in
their boxes' planes, grid lines are edges shared by blocks) and a wall,
padded with NaN faces and +inf padding boxes. Ray sets: directions with
zero components, origins on box faces, origins inside boxes, rays in a
face plane, rays aimed at shared edges and vertices (t ties the lower
face id must win), each with parked rays (origin 1e9, zero direction);
for K1, K4 and K9 one camera of each kind and a camera on a face's
plane (zero t); K4's scene adds the reference's spheres and a light a
few degrees above the grids' plane (grazing shadow rays, whose origins
lie inside the clusters' boxes). Then the wavefronts of 64x64 path
traces of a heightfield (K1 primary, K7 and K8 bounce 1, K3 last bounce) and of
a streamed one (K9, K10, K11). The arguments come from the port's own
glue (extend_shadow_rays, gbuffer, gbuffer_perray, anyhit_rays,
fusedframe.frame_args), which hands the kernels the boxes. The card tests
(marked gpu) hold the CUDA kernels to the plain versions on the same
inputs.
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
from rust_wgpu_raytracing_tpu_torch.ops import scenepacks as SP
from rust_wgpu_raytracing_tpu_torch.ops.fusedframe import (frame_args,
                                                          render_frame_fused)
from rust_wgpu_raytracing_tpu_torch.testing.raycull import (
    ADVERSARIAL_KINDS, CAMERA_KINDS, adversarial_camera, adversarial_rays,
    extend_shadow_culled, frame_culled, item_walks, mask_pairs,
    plane_camera_config, sched_anyhit_culled, sched_closest_culled,
    sched_perray_culled,
    sched_pairs, stream_anyhit_culled, stream_pairs, stream_perray_culled,
    stream_shared_culled, walk_counts, write_grid_mesh)
from rust_wgpu_raytracing_tpu_torch.ops.kernels import common, stream_sweep
from rust_wgpu_raytracing_tpu_torch.ops.kernels.stream_sweep import (
    walk_items)
from rust_wgpu_raytracing_tpu_torch.ops.pathtrace import (PRNGKey, fold_in,
                                                          render_pathtrace)
from rust_wgpu_raytracing_tpu_torch.ops.kernels.anyhit import \
    perray_plane_test
from rust_wgpu_raytracing_tpu_torch.ops.traverse import (perray_super_any,
                                                         ray_box_enter)
from test_torch_host import (cuda_device, heightfield_config,  # noqa: F401
                             jax_reference, u8_levels)

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


@pytest.fixture(scope="module")
def frame_meshes(assets):
    """The meshes with the reference's spheres and a light a few degrees
    above the grids' plane: K4's scenes."""
    cfgs = {name: pcfg.SceneConfig(
        spheres=pcfg.reference_scene().spheres,
        meshes=(pcfg.MeshConfig(obj_path=f"{name}.obj",
                                light_direction=(-1.0, -0.2, -0.05)),),
        render=pcfg.RenderConfig(width=64, height=32)) for name in MESHES}
    with mock.patch.dict(os.environ, {"RWRT_ASSETS": assets}):
        return {name: Scene.build(cfg).data for name, cfg in cfgs.items()}


def k4_args(data, mesh, kind, seed, mode):
    """frame's arguments for the camera `kind`, from the port's glue."""
    origin, d = adversarial_camera(kind, MESHES[mesh], data.blk_lo,
                                   data.blk_hi, seed)
    dev = data.blk_lo.device
    args, kw = frame_args(data, torch.from_numpy(origin).to(dev),
                          *(v.to(dev) for v in tens(d)))
    return args, dict(kw, mode=mode)


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


def k7_args(data, o, d):
    """closest_hit_perray's arguments from the port's glue (gbuffer_perray
    on the all-on-chip sweep)."""
    calls = {}
    P.gbuffer_perray(data, *tens(o), *tens(d), stream=False,
                     kernels=recorder(calls))
    return calls["closest_hit_perray"][0]


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
def test_culled_k7_equals_plain(meshes, mesh, kind):
    """K7's walk (chunks of the front-to-back schedule, per-ray boxes from
    each ray's own origin) against the unculled plain version, bitwise."""
    data = meshes[mesh]
    seed = 1400 + KINDS.index(kind) + 10 * sorted(MESHES).index(mesh)
    o, d, _, _, _ = rays(kind, mesh, data, seed)
    args, kw = k7_args(data, o, d)
    bf = kw["block_f"]
    assert len(args) == 13 and bf == (8 if mesh == "bf8" else 32)
    assert args[11] is data.blk_lo and args[12] is data.blk_hi
    want = K.closest_hit_perray_plain(*args, **kw)
    assert_bits(K.closest_hit_perray_plain(*args[:11], **kw), want,
                ("t", "face"))
    assert_bits(sched_perray_culled(*args, **kw), want, ("t", "face"))
    assert winner_entered(want[0], want[1], args[11], args[12], *args[2:8],
                          bf)
    assert int(torch.isfinite(want[0]).sum()) > 50


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


def k9_args(data, origin, d):
    """stream_closest_hit's arguments from the port's glue (gbuffer
    forced onto the streamed sweep)."""
    calls = {}
    P.gbuffer(data, torch.from_numpy(origin), *tens(d), stream=True,
              kernels=recorder(calls))
    return calls["stream_closest_hit"][0]


def k11_args(data, so, sd, act):
    """stream_anyhit's arguments from the port's glue."""
    calls = {}
    P.anyhit_rays(data, *tens(so), *tens(sd), torch.from_numpy(act),
                  stream=True, kernels=recorder(calls))
    return calls["stream_anyhit"][0]


# K9's and K11's items: one word's 32 blocks, and the default
SEGS = (32, stream_sweep.SEG)


def segs(monkeypatch):
    """Set stream_sweep.SEG to each of SEGS in turn."""
    for seg in SEGS:
        monkeypatch.setattr(stream_sweep, "SEG", seg)
        yield seg


@pytest.mark.parametrize("kind", CAMERA_KINDS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_culled_k9_equals_plain(meshes, mesh, kind, monkeypatch):
    """K9's walk (shared origin, items of 32 blocks and of the default)
    against the unculled plain version: faces and t bitwise, a zero t
    with its sign (-0.0 where t_num / N.d is one)."""
    data = meshes[mesh]
    seed = 600 + CAMERA_KINDS.index(kind) + 10 * sorted(MESHES).index(mesh)
    origin, d = adversarial_camera(kind, MESHES[mesh], data.blk_lo,
                                   data.blk_hi, seed)
    args, kw = k9_args(data, origin, d)
    assert len(args) == 12 and torch.equal(args[9], torch.from_numpy(origin))
    assert torch.equal(args[10], SP.block_boxes(data, 32)[0])
    want = K.stream_closest_hit_plain(*args, **kw)
    for _ in segs(monkeypatch):
        got = stream_shared_culled(*args)
        assert_bits(got, want, ("t", "face"))
    assert int(torch.isfinite(want[0]).sum()) > 100
    if kind == "on_face_plane":
        # the hazard: a camera on a face's plane hits at t = -0.0 too
        zero = want[0] == 0.0
        assert int(zero.sum()) > 1000
        assert bool((want[0][zero].view(torch.int32) != 0).any())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_culled_k11_equals_plain(meshes, mesh, kind, monkeypatch):
    """K11's walk over live rays only (items of 32 blocks and of the
    default) against the unculled plain version, bitwise."""
    data = meshes[mesh]
    seed = 700 + KINDS.index(kind) + 10 * sorted(MESHES).index(mesh)
    _, _, so, sd, act = rays(kind, mesh, data, seed)
    args, kw = k11_args(data, so, sd, act)
    assert len(args) == 14
    want = K.stream_anyhit_plain(*args, **kw)
    for _ in segs(monkeypatch):
        assert_bits((stream_anyhit_culled(*args),), (want,),
                    ("occ",))
    assert int((want > 0).sum()) > 50


def k1_args(data, origin, d):
    """closest_hit's arguments from the port's glue (gbuffer on the
    all-on-chip sweep)."""
    calls = {}
    P.gbuffer(data, torch.from_numpy(origin), *tens(d), stream=False,
              kernels=recorder(calls))
    return calls["closest_hit"][0]


def k3_args(data, so, sd, act):
    """anyhit's arguments from the port's glue (all on chip)."""
    calls = {}
    P.anyhit_rays(data, *tens(so), *tens(sd), torch.from_numpy(act),
                  stream=False, kernels=recorder(calls))
    return calls["anyhit"][0]


@pytest.mark.parametrize("kind", CAMERA_KINDS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_culled_k1_equals_plain(meshes, mesh, kind):
    """K1's walk (chunks of the front-to-back schedule, per-ray boxes
    from the camera) against the unculled plain version: t (a zero t
    with its sign) and face bitwise."""
    data = meshes[mesh]
    seed = 1000 + CAMERA_KINDS.index(kind) + 10 * sorted(MESHES).index(mesh)
    origin, d = adversarial_camera(kind, MESHES[mesh], data.blk_lo,
                                   data.blk_hi, seed)
    args, kw = k1_args(data, origin, d)
    assert len(args) == 11 and kw["block_f"] == (8 if mesh == "bf8" else 32)
    assert torch.equal(args[8], torch.from_numpy(origin))
    assert args[9] is data.blk_lo and args[10] is data.blk_hi
    want = K.closest_hit_plain(*args, **kw)
    got = sched_closest_culled(*args, **kw)
    assert_bits(got[:2], want[:2], ("t", "face"))
    assert got[2] is None and want[2] is None
    assert int(torch.isfinite(want[0]).sum()) > 100
    if kind == "on_face_plane":
        zero = want[0] == 0.0
        assert int(zero.sum()) > 1000
        assert bool((want[0][zero].view(torch.int32) != 0).any())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_culled_k3_equals_plain(meshes, mesh, kind):
    """K3's walk over live rays only (chunks of the front-to-back
    schedule) against the unculled plain version, bitwise."""
    data = meshes[mesh]
    seed = 1100 + KINDS.index(kind) + 10 * sorted(MESHES).index(mesh)
    _, _, so, sd, act = rays(kind, mesh, data, seed)
    args, kw = k3_args(data, so, sd, act)
    assert len(args) == 14 and args[12] is data.blk_lo
    want = K.anyhit_plain(*args, **kw)
    assert_bits((sched_anyhit_culled(*args, **kw),), (want,), ("occ",))
    assert int((want > 0).sum()) > 50


@pytest.mark.parametrize("kind", CAMERA_KINDS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_culled_k4_equals_plain(frame_meshes, mesh, kind):
    """K4's walks (the sweep over chunks of the front-to-back schedule
    with per-ray boxes from the camera; the in-kernel shadow loop over the
    live rays, the static cluster order and the wavefront's admission)
    against frame_plain in the in-kernel shadow mode: every plane
    bitwise (depth, kind, occ, uv, material, lambert, specular)."""
    data = frame_meshes[mesh]
    seed = 1200 + CAMERA_KINDS.index(kind) + 10 * sorted(MESHES).index(mesh)
    args, kw = k4_args(data, mesh, kind, seed, "inkernel")
    assert len(args) == 12 and args[10] is data.blk_lo
    want = K.frame_plain(*args, **kw)
    got = frame_culled(*args, **kw)
    assert_bits(got, want, [f"plane {i}" for i in range(len(want))])
    assert int((want[1] == data.num_spheres + 1).sum()) > 100  # mesh hits
    assert int((want[2] > 0).sum()) > 0  # occluded


def test_walk_items_cover_each_walk_once(meshes):
    """walk_items: each subtile's items hold consecutive words of its
    visit order, every admitted word once, at most seg + 31 admitted
    blocks an item, none empty."""
    data = meshes["bf32"]
    origin, d = adversarial_camera("inside", 48, data.blk_lo, data.blk_hi,
                                   5)
    args, _ = k9_args(data, origin, d)
    mask3, order2, tlb3 = args[:3]
    nsub, n_super = mask3.shape[1] - 1, mask3.shape[2]
    for seg in (32, 64, 256):
        pre, off = walk_items(mask3, order2, tlb3, seg)
        items = item_walks(mask3, order2, tlb3, seg)
        assert len(items) == int(off[-1])
        assert len(items) > mask3.shape[0] * nsub or seg == 256
        for u in range(mask3.shape[0] * nsub):
            batch, sub = divmod(u, nsub)
            ordered = order2[batch].long()
            words = mask3[batch, sub][ordered].long() & 0xFFFFFFFF
            ok = torch.isfinite(tlb3[batch, sub][ordered])
            cnt = torch.tensor([bin(int(w)).count("1") for w in words]) * ok
            assert torch.equal(pre[u].long(), torch.cumsum(cnt, 0) - cnt)
            mine = [(j0, j1) for v, j0, j1 in items if v == u]
            assert len(mine) == int(off[u + 1] - off[u]) >= 1
            assert mine[0][0] == 0 and all(
                a[1] == b[0] for a, b in zip(mine, mine[1:]))
            assert all(int(cnt[j0:j1].sum()) <= seg + 31 for j0, j1 in mine)
            assert all(int(cnt[j0:j1].sum()) > 0 for j0, j1 in mine) \
                or int(cnt.sum()) == 0
            assert int(cnt[mine[-1][1]:].sum()) == 0


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


def test_pt_bounce1_k7_culled_equals_plain(fields):
    """K7 on K8's bounce-1 extension rays (the bowl's 4,608 faces), its
    arguments from gbuffer_perray: the culled walk bitwise the plain
    version and K8's closest-hit half."""
    data, (es_args, es_kw) = pt_wavefront(fields[49], "extend_shadow")
    d, o = es_args[2:5], es_args[5:8]
    calls = {}
    P.gbuffer_perray(data, *o, *d, kernels=recorder(calls))
    args, kw = calls["closest_hit_perray"][0]
    assert kw["block_f"] == 32 and len(args) == 13
    want = K.closest_hit_perray_plain(*args, **kw)
    assert_bits(sched_perray_culled(*args, **kw), want, ("t", "face"))
    assert_bits(K.extend_shadow_plain(*es_args, **es_kw)[:2], want,
                ("t", "face"))
    assert int(torch.isfinite(want[0]).sum()) > 150
    aimed = (args[2] != 0) | (args[3] != 0) | (args[4] != 0)
    reach = torch.minimum(want[0], args[8]).view(-1, 1024).amax(1)
    n = walk_counts(sched_pairs(args[0], reach), args[11], args[12],
                    *args[2:8], aimed, t_final=want[0])
    # the culled walk tests a small share of the mask walk's pairs
    assert n["face_pairs"] <= n["entered"] < n["admitted"] / 4


def test_pt_primary_k1_culled_equals_plain(fields):
    """K1 on the primary rays of a 64x64 path trace of the bowl (4,608
    faces, 32-face clusters, all on chip)."""
    data, (args, kw) = pt_wavefront(fields[49], "closest_hit")
    assert kw["block_f"] == 32 and len(args) == 11
    want = K.closest_hit_plain(*args, **kw)
    got = sched_closest_culled(*args, **kw)
    assert_bits(got[:2], want[:2], ("t", "face"))
    assert int(torch.isfinite(want[0]).sum()) > 500
    aimed = (args[2] != 0) | (args[3] != 0) | (args[4] != 0)
    o = [args[8][a].expand_as(args[2]) for a in range(3)]
    reach = torch.minimum(want[0], args[5]).view(-1, 1024).amax(1)
    n = walk_counts(sched_pairs(args[0], reach), args[9], args[10],
                    *args[2:5], *o, aimed, t_final=want[0])
    assert n["face_pairs"] <= n["entered"] < n["admitted"] / 2
    assert n["box_tests"] == n["admitted"]


def test_pt_last_bounce_k3_culled_equals_plain(fields):
    """K3 on the last bounce's shadow rays of the same path trace (the
    act-aware schedule: most lanes dead)."""
    data, (args, kw) = pt_wavefront(fields[49], "anyhit")
    assert kw["block_f"] == 32 and len(args) == 14
    want = K.anyhit_plain(*args, **kw)
    assert_bits((sched_anyhit_culled(*args, **kw),), (want,), ("occ",))
    assert int((want > 0).sum()) > 20
    act, occ = args[8] > 0, want
    reach = torch.where(act & (occ == 0), args[9], -1.0).view(
        -1, 1024).amax(1)
    n = walk_counts(sched_pairs(args[0], reach), args[12], args[13],
                    *args[2:8], act, occ=occ)
    shut = int((occ > 0).sum())
    assert shut <= n["face_pairs"] <= n["box_tests"] <= n["admitted"] + shut


def jax_frames(out, configs):
    """The JAX package's split and fused frames (interpret mode) of
    SceneConfig JSONs, saved as frame0, frame1, ... and fused0, fused1,
    ... (run through jax_reference)."""
    import jax.numpy as jnp

    from rust_wgpu_raytracing_tpu import config as jcfg
    from rust_wgpu_raytracing_tpu.core.camera import Camera as JCamera
    from rust_wgpu_raytracing_tpu.core.scene import Scene as JScene
    from rust_wgpu_raytracing_tpu.ops.megakernel import render_megakernel

    frames = {}
    for k, text in enumerate(configs):
        cfg = jcfg.SceneConfig.from_json(text)
        rc = cfg.render
        uni = jnp.asarray(JCamera.from_config(
            cfg.camera, rc.width / rc.height).uniforms().flat())
        data = JScene.build(cfg).data
        for key, fused in (("frame", False), ("fused", True)):
            color, _ = render_megakernel(data, uni, width=rc.width,
                                         height=rc.height,
                                         shadows=rc.shadows, interpret=True,
                                         fused=fused)
            frames[f"{key}{k}"] = np.asarray(color)
    np.savez(out, **frames)


@pytest.fixture(scope="module")
def plane_frames(assets, tmp_path_factory):
    """mesh: (port config, the JAX package's split frame, its fused
    frame) of plane_camera_config."""
    cfgs = {mesh: plane_camera_config(f"{mesh}.obj", MESHES[mesh], 600)
            for mesh in sorted(MESHES)}
    with mock.patch.dict(os.environ, {"RWRT_ASSETS": assets}):
        ref = jax_reference("test_torch_raycull", "jax_frames",
                            tmp_path_factory.mktemp("plane_jax"),
                            configs=[c.to_json() for c in cfgs.values()])
    return {mesh: (cfg, ref[f"frame{k}"], ref[f"fused{k}"])
            for k, (mesh, cfg) in enumerate(cfgs.items())}


# the kernels' culled walks, as the frame's KernelSet
MODELS = K.PLAIN._replace(closest_hit=sched_closest_culled,
                          anyhit=sched_anyhit_culled, frame=frame_culled,
                          stream_closest_hit=stream_shared_culled,
                          stream_anyhit=stream_anyhit_culled)


@pytest.mark.parametrize("mesh,stream", [("bf8", False), ("bf32", False),
                                         ("bf32", True)])
def test_plane_camera_frame_keeps_zero_sign(assets, plane_frames, mesh,
                                            stream):
    """The hazard of a zero t: the split frame from a camera on a face's
    plane (raycull.plane_camera_config), composed from the culled walks'
    models (K1 and K3, or forced onto the streamed sweeps K9 and K11),
    equals the plain-composed frame bitwise and the JAX package's frame
    at the frame bar. Packing every zero t as +0.0 draws the faces the
    reference leaves out."""
    cfg, want, _ = plane_frames[mesh]
    with mock.patch.dict(os.environ, {"RWRT_ASSETS": assets}):
        data = Scene.build(cfg).data
    uni = Camera.from_config(cfg.camera, 48 / 32).uniforms().flat()
    frames, calls = [], {}
    with mock.patch.object(P, "_should_stream", lambda f, bf: stream):
        for ks in (recorder(calls), MODELS):
            color, _ = P.render_megakernel(data, uni, width=48, height=32,
                                           shadows=True, fused=False,
                                           kernels=ks)
            frames.append(color)
    name = "stream_closest_hit" if stream else "closest_hit"
    assert len(calls[name]) == 1
    t = K.PLAIN._asdict()[name](*calls[name][0][0], **calls[name][0][1])[0]
    zero = t == 0.0
    negative = zero & (t.view(torch.int32) != 0)
    assert int(negative.sum()) > 100 and int((zero & ~negative).sum()) > 100
    assert torch.equal(frames[1], frames[0])
    diff = np.abs(u8_levels(frames[0]) - u8_levels(want))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    lit = (u8_levels(frames[0]) > 0).any(-1)
    assert 0.1 < lit.mean() < 0.9  # the faces drawn on one side only


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shadow_mode", ["sched", "inkernel"])
def test_plane_camera_fused_frame_keeps_zero_sign(assets, plane_frames,
                                                  mesh, shadow_mode):
    """The same hazard through the fused frame: render_frame_fused from a
    camera on a face's plane, composed from the culled walks' models (K4,
    with K3 for the sched shadows or K4's own in-kernel shadow loop),
    equals the plain-composed fused frame bitwise and the JAX package's
    fused frame at the frame bar."""
    cfg, _, want = plane_frames[mesh]
    with mock.patch.dict(os.environ, {"RWRT_ASSETS": assets}):
        data = Scene.build(cfg).data
    uni = Camera.from_config(cfg.camera, 48 / 32).uniforms().flat()
    frames, calls = [], {}
    for ks in (recorder(calls), MODELS):
        color, _ = render_frame_fused(data, uni, width=48, height=32,
                                      shadows=True, shadow_mode=shadow_mode,
                                      kernels=ks)
        frames.append(color)
    args, kw = calls["frame"][0]
    assert kw["mode"] == shadow_mode and len(args) == 12
    t = K.closest_hit_plain(args[0], args[1], *args[3:9],
                            args[2][:3].contiguous(),
                            block_f=kw["block_f"])[0]
    zero = t == 0.0
    negative = zero & (t.view(torch.int32) != 0)
    assert int(negative.sum()) > 100 and int((zero & ~negative).sum()) > 100
    assert torch.equal(frames[1], frames[0])
    diff = np.abs(u8_levels(frames[0]) - u8_levels(want))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    lit = (u8_levels(frames[0]) > 0).any(-1)
    assert 0.1 < lit.mean() < 0.9  # the faces drawn on one side only


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


def test_pt_bounce1_k11_culled_equals_plain(fields, monkeypatch):
    """K11 on the shadow rays of a 64x64 streamed path trace (the
    bowl's 16,562 faces), items of 32 blocks and of the default."""
    data, (args, kw) = pt_wavefront(fields[92], "stream_anyhit")
    assert data.num_faces > 16384 and len(args) == 14
    want = K.stream_anyhit_plain(*args, **kw)
    for _ in segs(monkeypatch):
        assert_bits((stream_anyhit_culled(*args),), (want,),
                    ("occ",))
    assert int((want > 0).sum()) > 50
    act, occ = args[9] > 0, want
    reach = torch.where(act & (occ == 0), args[10], -1.0).view(
        -1, 1024).amax(1)
    n = walk_counts(stream_pairs(args[0], args[2], reach), args[12],
                    args[13], *args[3:9], act, occ=occ)
    assert n["face_pairs"] <= n["box_tests"] <= n["admitted"] + int(
        (occ > 0).sum())
    assert n["entered"] < n["admitted"] / 4


def test_pt_primary_k9_culled_equals_plain(fields, monkeypatch):
    """K9 on the primary rays of the same path trace (its camera)."""
    data, (args, kw) = pt_wavefront(fields[92], "stream_closest_hit")
    want = K.stream_closest_hit_plain(*args, **kw)
    for _ in segs(monkeypatch):
        assert_bits(stream_shared_culled(*args), want, ("t", "face"))
    assert int(torch.isfinite(want[0]).sum()) > 500
    o = [args[9][a].expand_as(args[3]) for a in range(3)]
    aimed = (args[3] != 0) | (args[4] != 0) | (args[5] != 0)
    reach = torch.minimum(want[0], args[6]).view(-1, 1024).amax(1)
    n = walk_counts(stream_pairs(args[0], args[2], reach), args[10],
                    args[11], *args[3:6], *o, aimed, t_final=want[0])
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


def line_meets_boxes_f64(lo, hi, o, d):
    """(R, S) bool: the forward line of each ray (o, d (3, R)) meets box
    [lo, hi] (S, 3), in float64 arithmetic on the f32 values (a zero
    component takes the inside rule; empty boxes meet nothing)."""
    lo, hi = lo.double().numpy()[None], hi.double().numpy()[None]
    o, d = o.T.astype(np.float64)[:, None], d.T.astype(np.float64)[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        ta, tb = (lo - o) / d, (hi - o) / d
    inside = (o >= lo) & (o <= hi)
    tn = np.where(d == 0, np.where(inside, 0.0, np.inf), np.minimum(ta, tb))
    tf = np.where(d == 0, np.where(inside, np.inf, -np.inf),
                  np.maximum(ta, tb))
    return (np.maximum(tn.max(2), 0.0) <= tf.min(2)) & (lo <= hi).all(2)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_perray_super_any_margins(meshes, mesh, kind):
    """perray_super_any at the superblock level (K10's glue clears the
    words of superblocks no live ray's line meets, by JAX's margins in
    t): on the adversarial rays, each tile admits every superblock that a
    live ray's forward line meets in float64, and every face a live ray
    hits (t >= 1e-3, the per-ray face test) lies in a superblock its
    tile admits."""
    data = meshes[mesh]
    seed = 400 + KINDS.index(kind) + 10 * sorted(MESHES).index(mesh)
    o, d, _, _, _ = rays(kind, mesh, data, seed)
    n_super = data.padded_faces // 1024
    slo, shi = SP.super_boxes(data)
    ox, oy, oz, dx, dy, dz = (torch.from_numpy(v) for v in (*o, *d))
    live = (dx != 0) | (dy != 0) | (dz != 0)
    sup_ok = perray_super_any(slo, shi, ox, oy, oz, dx, dy, dz, 1024,
                              act=live)
    tile = torch.arange(dx.shape[0]) // 1024
    admitted = sup_ok[tile]  # (R, S)
    meets = torch.from_numpy(line_meets_boxes_f64(slo, shi, o, d))
    need = meets & live[:, None]
    assert int(need.sum()) > 100
    assert bool(admitted[need].all())
    fpack, dc = SP.pack_face_columns(data), SP.pack_plane_consts(data)
    hits = 0
    for s in range(n_super):
        rows = slice(s * 1024, (s + 1) * 1024)
        _, hit = perray_plane_test(fpack[rows], dc[rows], dx, dy, dz,
                                   ox, oy, oz)
        ray_hits = hit.any(dim=0) & live
        hits += int(ray_hits.sum())
        assert bool(admitted[ray_hits, s].all())
    assert hits > 50


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
    origin, d = adversarial_camera("inside", 16, data.blk_lo, data.blk_hi,
                                   7)
    args, _ = k9_args(data, origin, d)
    assert_bits(K.stream_closest_hit(*args), K.stream_closest_hit(*args[:9]),
                ("t", "face"))
    with pytest.raises(ValueError):  # boxes need the origin
        K.stream_closest_hit(*args[:9], None, *args[10:])
    _, _, so, sd, act = rays("inside", "bf8", data, 8)
    args, _ = k11_args(data, so, sd, act)
    assert_bits((K.stream_anyhit(*args),), (K.stream_anyhit(*args[:12]),),
                ("occ",))
    with pytest.raises(ValueError):
        K.stream_anyhit(*args[:12], args[12][:-1], args[13][:-1])
    args, kw = k1_args(data, origin, d)
    assert_bits(K.closest_hit(*args, **kw)[:2],
                K.closest_hit(*args[:9], **kw)[:2], ("t", "face"))
    with pytest.raises(ValueError):
        K.closest_hit(*args[:10], None, **kw)
    args, kw = k3_args(data, so, sd, act)
    assert_bits((K.anyhit(*args, **kw),), (K.anyhit(*args[:12], **kw),),
                ("occ",))
    with pytest.raises(ValueError):
        K.anyhit(*args[:12], args[12][:-1], args[13][:-1], **kw)
    with pytest.raises(TypeError):
        K.anyhit(*args[:12], args[12].double(), args[13], **kw)
    for mode in ("sched", "inkernel"):
        args, kw = frame_args(data, torch.from_numpy(origin), *tens(d))
        kw["mode"] = mode
        assert_bits(K.frame(*args, **kw), K.frame(*args[:10], **kw),
                    [f"plane {i}" for i in range(16)])
    with pytest.raises(ValueError):
        K.frame(*args[:10], args[10][:-1], args[11][:-1], **kw)
    with pytest.raises(ValueError):
        K.frame(*args[:11], None, **kw)


def test_block_boxes_follow_the_blocks(meshes):
    """block_boxes: a block of 32 faces over 8-face clusters takes the
    union of its four boxes (padding stays +inf / -inf)."""
    data = meshes["bf8"]
    lo, hi = SP.block_boxes(data, 8)
    assert lo is data.blk_lo and hi is data.blk_hi
    lo, hi = SP.block_boxes(data, 32)
    assert torch.equal(lo, data.blk_lo.view(-1, 4, 3).amin(1))
    assert torch.equal(hi, data.blk_hi.view(-1, 4, 3).amax(1))
    assert bool(torch.isinf(lo[-1]).all()) and bool((lo[-1] > 0).all())


def gpu_inputs(meshes, mesh, kind, device):
    """(kernel, plain version, arguments on the card, keywords) of K1
    (camera `kind`) and, for a ray set `kind`, K8, K10, K3 and K7."""
    data = meshes[mesh]
    origin, d = adversarial_camera(kind, MESHES[mesh], data.blk_lo,
                                   data.blk_hi, 350 + CAMERA_KINDS.index(kind))
    cases = [(K.closest_hit, K.closest_hit_plain, k1_args(data, origin, d))]
    if kind in KINDS:
        r = rays(kind, mesh, data, 300 + KINDS.index(kind))
        cases += [(K.extend_shadow, K.extend_shadow_plain, k8_args(data, *r)),
                  (K.stream_closest_hit_perray,
                   K.stream_closest_hit_perray_plain,
                   k10_args(data, r[0], r[1])),
                  (K.anyhit, K.anyhit_plain, k3_args(data, *r[2:])),
                  (K.closest_hit_perray, K.closest_hit_perray_plain,
                   k7_args(data, r[0], r[1]))]
    move = (lambda a: a.to(device) if isinstance(a, torch.Tensor) else a)
    return [(fn, plain, [move(a) for a in args], kw)
            for fn, plain, (args, kw) in cases]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", CAMERA_KINDS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_culling_kernels_cuda_match_plain(meshes, mesh, kind, cuda_device,
                                          monkeypatch):
    """K8, K10, K3, K7 and K1 on the card, with the boxes and without (K1 and
    K3 also with every chunk ray-major and every chunk by pairs), against
    their plain versions on the adversarial sets: every output equal, K1's
    t bitwise (a zero t with its sign)."""
    for fn, plain, args, kw in gpu_inputs(meshes, mesh, kind, cuda_device):
        want = plain(*args, **kw)
        want = want if isinstance(want, tuple) else (want,)
        modes = (None, 0, 65) if fn in (K.closest_hit, K.anyhit) else (None,)
        for mode in modes:
            if mode is not None:
                monkeypatch.setitem(common.RAY_MAJOR, fn.__name__, mode)
            for a in (args, args[:-2]):
                before = K.launch_counts()[fn.__name__]
                got = fn(*a, **kw)
                torch.cuda.synchronize()
                assert K.launch_counts()[fn.__name__] == before + 1
                got = got if isinstance(got, tuple) else (got,)
                for x, y in zip(got, want):  # K1's sphere planes: None
                    assert (x is None and y is None) or torch.equal(x, y), \
                        fn.__name__
                if fn is K.closest_hit:  # a zero t with its sign
                    assert torch.equal(got[0].view(torch.int32),
                                       want[0].view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", CAMERA_KINDS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_streamed_culling_kernels_cuda_match_plain(meshes, mesh, kind,
                                                   cuda_device, monkeypatch):
    """K9 (each camera) and K11 (each ray set) on the card, with the boxes
    and without, with items of 32 blocks and of the default, against their
    plain versions: every output equal, K9's t bitwise (a zero t with its
    sign)."""
    data = meshes[mesh]
    move = (lambda a: a.to(cuda_device) if isinstance(a, torch.Tensor)
            else a)
    origin, d = adversarial_camera(kind, MESHES[mesh], data.blk_lo,
                                   data.blk_hi, 800 + CAMERA_KINDS.index(kind))
    cases = [(K.stream_closest_hit, K.stream_closest_hit_plain,
              k9_args(data, origin, d)[0], 10)]
    if kind in KINDS:
        _, _, so, sd, act = rays(kind, mesh, data, 900 + KINDS.index(kind))
        cases.append((K.stream_anyhit, K.stream_anyhit_plain,
                      k11_args(data, so, sd, act)[0], 12))
    for fn, plain, args, n in cases:
        args = [move(a) for a in args]
        want = plain(*args)
        want = want if isinstance(want, tuple) else (want,)
        for a in (args, args[:n]):
            for _ in segs(monkeypatch):
                before = K.launch_counts()[fn.__name__]
                got = fn(*a)
                torch.cuda.synchronize()
                assert K.launch_counts()[fn.__name__] == before + 1
                got = got if isinstance(got, tuple) else (got,)
                for x, y in zip(got, want):
                    assert torch.equal(x, y), fn.__name__
                if fn is K.stream_closest_hit:  # a zero t with its sign
                    assert torch.equal(got[0].view(torch.int32),
                                       want[0].view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", CAMERA_KINDS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_frame_cuda_matches_plain_adversarial(frame_meshes, mesh, kind,
                                              cuda_device, monkeypatch):
    """K4 on the card in all four modes, with the boxes and without (every
    ray enters every box), the in-kernel shadow loop also with every
    chunk ray-major and every chunk by pairs, against frame_plain on the
    adversarial cameras: every plane bitwise."""
    data = frame_meshes[mesh].to(cuda_device)
    seed = 1300 + CAMERA_KINDS.index(kind) + 10 * sorted(MESHES).index(mesh)
    for mode in ("none", "sched", "nm", "inkernel"):
        args, kw = k4_args(data, mesh, kind, seed, mode)
        want = K.frame_plain(*args, **kw)
        for ray_major in ((None, 0, 65) if mode == "inkernel" else (None,)):
            if ray_major is not None:
                monkeypatch.setitem(common.RAY_MAJOR, "anyhit", ray_major)
            for a in (args, args[:10]):
                before = K.launch_counts()["frame"]
                got = K.frame(*a, **kw)
                torch.cuda.synchronize()
                assert K.launch_counts()["frame"] == before + 1
                for i, (x, y) in enumerate(zip(got, want)):
                    assert torch.equal(x.view(torch.int32),
                                       y.view(torch.int32)), (mode, i)
