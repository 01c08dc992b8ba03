"""PyTorch port: accel="bvh", the two-level LBVH-cut cull (kernel K5),
against the JAX package's traverse_pallas (Pallas in interpret mode), and
the streamed frame under both culls against the JAX frame.

Scenes: builtin:terrain:23 (128 8-face clusters, the last ones pure
padding) and terrain:92 (544 32-face clusters, 17 superblocks, past
STREAM_FACES). Cones: the tiles of a 128x128 camera frame (shared
origin) and of a seeded shadow wavefront with a third of its rays
inactive (act-aware bounds, some tiles empty). Edge cases of the
card's layout (EDGES: ragged groups of 32 superblocks and blocks of 8
tiles, zero, mixed-sign and tiny direction axes, NaN bounds, empty cones
and empty padding boxes), from numpy seeds, go through the JAX kernel
too. The JAX side runs as tests/test_torch_host.jax_reference runs it,
every operation rounding on its own; the words, the widened tables and
the frames are held bitwise. The card tests (marked gpu) hold K5 to its
plain version on the same inputs.
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

from rust_wgpu_raytracing_tpu_torch import config as pcfg
from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
from rust_wgpu_raytracing_tpu_torch.core.scene import Scene
from rust_wgpu_raytracing_tpu_torch.ops import hier_cull as HC
from rust_wgpu_raytracing_tpu_torch.ops import kernels as K
from rust_wgpu_raytracing_tpu_torch.ops import megakernel as P
from rust_wgpu_raytracing_tpu_torch.ops.megakernel import render_megakernel
from rust_wgpu_raytracing_tpu_torch.ops.traverse import tile_ray_bounds
from test_torch_host import (cuda_device, jax_config,  # noqa: F401
                             jax_reference, terrain_config)

GRIDS = {"t23": 23, "t92": 92}
W = H = 128
FRAME = 64  # the streamed frames, terrain:92 with shadows


def scene_config(grid, size=W, accel="cull"):
    cfg = terrain_config(pcfg, grid=grid, width=size, height=size,
                         shadows=True, accel=accel)
    return dc.replace(cfg, camera=pcfg.CameraConfig(eye=(0.0, -0.4, -1.2),
                                                    target=(0.0, 0.0, -3.0)))


def shadow_wavefront(n=4 * 1024, seed=17):
    """(origins (3,n), dirs (3,n), act (n,)): rays toward the light from
    points over the terrain; a third inactive, and the last tile wholly
    inactive (an empty cone)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform((-1.0, -1.0, -3.3), (1.0, 1.0, -2.65),
                    (n, 3)).astype(np.float32)
    ld = -np.array([6.0, -1.0, 1.0])
    d = ld / np.linalg.norm(ld) + rng.normal(0.0, 0.1, (n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    act = rng.uniform(size=n) < 0.67
    act[-1024:] = False
    return o.T.copy(), d.T.copy(), act


# edge cases of K5's layout (a warp per tile, lanes over 32 superblocks):
# name -> (superblocks S, tiles T); ragged superblock groups (S = 1, 31,
# 33, 511) and tiles that fill no whole block of 8 warps
EDGES = {"s1_t13": (1, 13), "s31_t200": (31, 200), "s32_t1030": (32, 1030),
         "s33_t37": (33, 37), "s511_t2045": (511, 2045)}


def edge_case(name):
    """(lo, hi (32 S, 3), omin, omax, dmin, dmax (T, 3)) f32 numpy of an
    EDGES case, from a numpy seed: cluster boxes with 15% empty padding
    boxes (+inf / -inf; for S > 2 superblock 1 wholly empty), and tile
    cones cycling through six kinds: plain, a zero direction axis
    (dmin = dmax = 0), a mixed-sign axis, one NaN bound, an axis below
    1e-30 (the reciprocals' clamp) and an empty cone (a tile without a
    live ray: +inf / -inf)."""
    n_super, n_tiles = EDGES[name]
    rng = np.random.default_rng(n_super * 7 + n_tiles)
    nb = 32 * n_super
    c = rng.uniform(-2.0, 2.0, (nb, 3))
    h = rng.uniform(0.01, 0.5, (nb, 3))
    lo, hi = (c - h).astype(np.float32), (c + h).astype(np.float32)
    empty = rng.uniform(size=nb) < 0.15
    if n_super > 2:
        empty[32:64] = True
    lo[empty], hi[empty] = np.inf, -np.inf
    o = rng.uniform(-3.0, 3.0, (n_tiles, 3))
    e = rng.uniform(0.0, 0.5, (n_tiles, 3))
    omin, omax = (o - e).astype(np.float32), (o + e).astype(np.float32)
    d = rng.normal(size=(n_tiles, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    s = rng.uniform(0.0, 0.3, (n_tiles, 3))
    dmin, dmax = (d - s).astype(np.float32), (d + s).astype(np.float32)
    kind = np.arange(n_tiles) % 6
    ax = rng.integers(0, 3, n_tiles)
    which = rng.integers(0, 12, n_tiles)
    planes = [omin, omax, dmin, dmax]
    for t_ in range(n_tiles):
        a = ax[t_]
        if kind[t_] == 1:
            dmin[t_, a] = dmax[t_, a] = 0.0
        elif kind[t_] == 2:
            dmin[t_, a] = -abs(dmin[t_, a]) - 0.1
            dmax[t_, a] = abs(dmax[t_, a]) + 0.1
        elif kind[t_] == 3:
            planes[which[t_] // 3][t_, which[t_] % 3] = np.nan
        elif kind[t_] == 4:
            dmin[t_, a], dmax[t_, a] = 1e-35, 3e-31
        elif kind[t_] == 5:
            omin[t_], dmin[t_] = np.inf, np.inf
            omax[t_], dmax[t_] = -np.inf, -np.inf
    return lo, hi, omin, omax, dmin, dmax


def edge_args(name):
    """K5's (sup, clus, bounds) tensors of an EDGES case: the union boxes
    of each superblock's 32 clusters, the cluster boxes, the 12 cone
    planes."""
    lo, hi, omin, omax, dmin, dmax = edge_case(name)
    n_super = EDGES[name][0]
    sup = np.concatenate([lo.reshape(n_super, 32, 3).min(1),
                          hi.reshape(n_super, 32, 3).max(1)], 1)
    return (t(sup), t(np.concatenate([lo, hi], 1)),
            t(np.concatenate([omin.T, omax.T, dmin.T, dmax.T])))


def jax_edge_words(out):
    """The JAX kernel's words (traverse_pallas._smem_cull_words, interpret
    mode) of every EDGES case."""
    import jax.numpy as jnp

    import rust_wgpu_raytracing_tpu.ops.traverse_pallas as TP

    res = {name: TP._smem_cull_words(
        *(jnp.asarray(v) for v in edge_case(name)), EDGES[name][0], True)
        for name in EDGES}
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})


def jax_hiercull(out, part):
    """part "words": the tables and words of every cone; part "frames":
    the streamed frames."""
    import jax.numpy as jnp

    import rust_wgpu_raytracing_tpu.ops.megakernel as J
    import rust_wgpu_raytracing_tpu.ops.traverse_pallas as TP
    from rust_wgpu_raytracing_tpu.core.camera import Camera as JCamera
    from rust_wgpu_raytracing_tpu.core.camera import CameraUniforms
    from rust_wgpu_raytracing_tpu.core.scene import Scene as JScene
    from rust_wgpu_raytracing_tpu.ops.traverse import tile_ray_bounds as jtb

    res = {}
    o, d, act = shadow_wavefront()
    for name, grid in (GRIDS.items() if part == "words" else ()):
        cfg = jax_config(scene_config(grid))
        data = JScene.build(cfg).data
        f = data.tri_p0.shape[0]
        nb = data.blk_lo.shape[0]
        nw = -(-nb // 32)
        uni = CameraUniforms.unflat(jnp.asarray(JCamera.from_config(
            cfg.camera, 1.0).uniforms().flat()))
        dx, dy, dz = J.raygen_planar(W, H, uni)
        org = uni.origin
        res[f"{name}_rays"] = np.stack([np.asarray(v) for v in (dx, dy, dz)])
        res[f"{name}_origin"] = np.asarray(org)
        oj, dj = [jnp.asarray(v) for v in o], [jnp.asarray(v) for v in d]
        actj = jnp.asarray(act)
        for cone, bounds in (
                ("cam", jtb(org[0], org[1], org[2], dx, dy, dz, 1024)),
                ("shadow", jtb(*oj, *dj, 1024, act=actj))):
            key = f"{name}_{cone}"
            res[f"{key}_words"] = TP.hier_cull_words(
                data.blk_lo, data.blk_hi, *bounds, nwords=nw, interpret=True)
            # the kernel's tables, as _smem_cull_words builds them
            fin = [jnp.where(jnp.isfinite(b), jnp.abs(b), 0.0)
                   for b in bounds[:2]]
            omag = jnp.maximum(jnp.max(fin[0]), jnp.max(fin[1]))
            lo, hi = TP._widen(data.blk_lo, data.blk_hi, omag)
            if nw * 32 > nb:
                lo, hi = TP._pad_boxes(lo, hi, nw * 32 - nb)
            res[f"{key}_sup"] = jnp.concatenate(
                [jnp.min(lo.reshape(nw, 32, 3), axis=1),
                 jnp.max(hi.reshape(nw, 32, 3), axis=1)], axis=1)
            res[f"{key}_clus"] = jnp.concatenate([lo, hi], axis=1)
            res[f"{key}_bounds"] = jnp.concatenate(
                [b.T for b in bounds])
        res[f"{name}_bvh_mask"] = J._mask_words(
            data, "bvh", org[0], org[1], org[2], dx, dy, dz, 1024, f // nb,
            f, True)[0]
        res[f"{name}_cull_mask"] = J._mask_words(
            data, "cull", org[0], org[1], org[2], dx, dy, dz, 1024, f // nb,
            f)[0]
    cfg = jax_config(scene_config(92, FRAME))
    data = JScene.build(cfg).data
    uni = jnp.asarray(JCamera.from_config(cfg.camera, 1.0).uniforms().flat())
    for accel in (("cull", "bvh") if part == "frames" else ()):
        c, dep = J.render_megakernel(data, uni, width=FRAME, height=FRAME,
                                     shadows=True, interpret=True,
                                     fused=False, accel=accel)
        res[f"frame_{accel}"] = c
        res[f"depth_{accel}"] = dep
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return jax_reference("test_torch_hiercull", "jax_hiercull",
                         tmp_path_factory.mktemp("hiercull"), part="words")


@pytest.fixture(scope="module")
def frames_ref(tmp_path_factory):
    return jax_reference("test_torch_hiercull", "jax_hiercull",
                         tmp_path_factory.mktemp("hiercull_frames"),
                         part="frames")


@pytest.fixture(scope="module")
def edge_ref(tmp_path_factory):
    return jax_reference("test_torch_hiercull", "jax_edge_words",
                         tmp_path_factory.mktemp("hiercull_edges"))


@pytest.fixture(scope="module")
def scenes():
    return {name: Scene.build(scene_config(grid)).data
            for name, grid in GRIDS.items()}


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def cone_bounds(ref, name, cone):
    if cone == "cam":
        origin = t(ref[f"{name}_origin"])
        return tile_ray_bounds(*origin, *(t(v) for v in ref[f"{name}_rays"]),
                               1024)
    o, d, act = shadow_wavefront()
    return tile_ray_bounds(*(t(v) for v in o), *(t(v) for v in d), 1024,
                           act=t(act))


CONES = [(n, c) for n in sorted(GRIDS) for c in ("cam", "shadow")]


@pytest.mark.parametrize("name,cone", CONES)
def test_hier_cull_words_match_jax(ref, scenes, name, cone):
    """The port's tables, then K5 (plain version here), from the tile
    cones: the words of JAX's hier_cull_words, bit for bit."""
    data = scenes[name]
    key = f"{name}_{cone}"
    bounds = cone_bounds(ref, name, cone)
    nw = -(-data.blk_lo.shape[0] // 32)
    sup, clus = HC.cull_tables(data.blk_lo, data.blk_hi, bounds[0],
                               bounds[1], nw)
    np.testing.assert_array_equal(sup.numpy(), ref[f"{key}_sup"])
    np.testing.assert_array_equal(clus.numpy(), ref[f"{key}_clus"])
    before = K.launch_counts()["hier_cull"]
    words = HC.hier_cull_words(data.blk_lo, data.blk_hi, *bounds, nwords=nw)
    assert K.launch_counts()["hier_cull"] == before  # CPU: the plain version
    want = ref[f"{key}_words"]
    assert (want != 0).any()
    np.testing.assert_array_equal(words.numpy(), want)


@pytest.mark.parametrize("name,cone", CONES)
def test_hier_cull_kernel_on_jax_tables(ref, name, cone):
    key = f"{name}_{cone}"
    words = K.hier_cull(t(ref[f"{key}_sup"]), t(ref[f"{key}_clus"]),
                        t(ref[f"{key}_bounds"]))
    np.testing.assert_array_equal(words.numpy(), ref[f"{key}_words"])


@pytest.mark.parametrize("name", sorted(EDGES))
def test_hier_cull_edge_cases_match_jax(edge_ref, name):
    """K5 (plain version here) on the edge cases of the card's layout
    (ragged superblock groups and tile blocks, zero, mixed-sign and tiny
    direction axes, NaN bounds, empty cones, empty padding boxes): the
    JAX kernel's words, bit for bit."""
    words = K.hier_cull(*edge_args(name))
    want = edge_ref[name]
    assert (want != 0).any() and (want == 0).any()
    np.testing.assert_array_equal(words.numpy(), want)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_bvh_mask_words_match_jax_and_cover_flat(ref, scenes, name):
    data = scenes[name]
    f = data.padded_faces
    bf = f // data.blk_lo.shape[0]
    origin = t(ref[f"{name}_origin"])
    rays = [t(v) for v in ref[f"{name}_rays"]]
    bounds = tile_ray_bounds(*origin, *rays, 1024)
    bvh, nw = P._mask_words(data, "bvh", bounds, bf)
    cull, _ = P._mask_words(data, "cull", bounds, bf)
    np.testing.assert_array_equal(bvh.numpy(), ref[f"{name}_bvh_mask"])
    np.testing.assert_array_equal(cull.numpy(), ref[f"{name}_cull_mask"])
    hw = bvh.numpy().view(np.uint32)
    fw = cull.numpy().view(np.uint32)
    assert np.unpackbits(fw.view(np.uint8)).sum() > 0
    np.testing.assert_array_equal(fw & ~hw, 0)  # superset of the flat scan
    if name == "t23":  # no bit for a padding-only cluster
        first_pad = -(-data.num_faces // bf)
        for c in range(first_pad, f // bf):
            assert not (hw.reshape(-1, nw)[:, c // 32]
                        & np.uint32(1 << (c % 32))).any()


def test_hier_cull_fits_matches_jax():
    from rust_wgpu_raytracing_tpu.ops.traverse_pallas import \
        hier_cull_fits as jax_fits

    edge = 24_224  # the last cluster count inside the JAX table budget
    for n in (1, 544, 16_352, edge - 33, edge, edge + 1, edge + 32,
              65_440):
        assert HC.hier_cull_fits(n) == jax_fits(n), n
    assert HC.hier_cull_fits(edge) and not HC.hier_cull_fits(edge + 1)


@pytest.mark.parametrize("accel", ["cull", "bvh"])
def test_streamed_frame_matches_jax(frames_ref, accel):
    """terrain:92 (past STREAM_FACES) with shadows: K9, K11 (reordered)
    and the frame tail, bit for bit the JAX split frame."""
    cfg = scene_config(92, FRAME, accel)
    data = Scene.build(cfg).data
    uni = Camera.from_config(cfg.camera, 1.0).uniforms().flat()
    color, depth = render_megakernel(data, uni, width=FRAME, height=FRAME,
                                     shadows=True, accel=accel)
    assert float((depth < 1).float().mean()) > 0.1
    np.testing.assert_array_equal(color.numpy(), frames_ref[f"frame_{accel}"])
    np.testing.assert_array_equal(depth.numpy(), frames_ref[f"depth_{accel}"])


@pytest.mark.parametrize("grid,size,fused", [(23, 96, False),
                                             (23, 96, None), (92, 64, None)])
def test_bvh_frame_equals_cull_frame(grid, size, fused):
    """Inside the port every accel draws the same frame, split, fused and
    streamed, and accel="bvh" launches K5 (counted through a KernelSet
    of the plain versions)."""
    frames = {}
    for accel in ("cull", "bvh", "brute"):
        cfg = scene_config(grid, size, accel)
        data = Scene.build(cfg).data
        uni = Camera.from_config(cfg.camera, 1.0).uniforms().flat()
        calls = []
        ks = K.KernelSet(*(
            (lambda *a, _p=p, _n=f.__name__, **kw: calls.append(_n)
             or _p(*a, **kw)) for f, p in zip(K.KERNELS, K.PLAIN)))
        frames[accel] = render_megakernel(
            data, uni, width=size, height=size, shadows=True, accel=accel,
            fused=fused, kernels=ks)[0]
        assert ("frame" in calls) == (fused is None and grid == 23)
        assert ("hier_cull" in calls) == (accel == "bvh")
    assert torch.equal(frames["bvh"], frames["cull"])
    assert torch.equal(frames["brute"], frames["cull"])


@pytest.mark.gpu
@pytest.mark.parametrize("name,cone", CONES)
def test_hier_cull_cuda_matches_plain(name, cone, cuda_device):
    """K5 on the card against its plain version, on the tables and cones
    the port's glue builds there."""
    cfg = scene_config(GRIDS[name])
    data = Scene.build(cfg).data.to(cuda_device)
    if cone == "cam":
        uni = Camera.from_config(cfg.camera, 1.0).uniforms()
        origin = torch.as_tensor(uni.origin, device=cuda_device)
        bounds = tile_ray_bounds(*origin, *P.raygen_planar(
            W, H, uni, device=cuda_device), 1024)
    else:
        o, d, act = shadow_wavefront()
        bounds = tile_ray_bounds(*(t(v).to(cuda_device) for v in o),
                                 *(t(v).to(cuda_device) for v in d), 1024,
                                 act=t(act).to(cuda_device))
    nw = -(-data.blk_lo.shape[0] // 32)
    sup, clus = HC.cull_tables(data.blk_lo, data.blk_hi, bounds[0],
                               bounds[1], nw)
    args = (sup, clus, torch.cat([b.T for b in bounds]).contiguous())
    before = K.launch_counts()["hier_cull"]
    words = K.hier_cull(*args)
    torch.cuda.synchronize()
    assert K.launch_counts()["hier_cull"] == before + 1
    assert bool((words != 0).any())
    assert torch.equal(words, K.hier_cull_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(EDGES))
def test_hier_cull_cuda_edge_cases(name, cuda_device):
    """K5 on the card against its plain version on the edge cases (words
    bitwise)."""
    args = [a.to(cuda_device) for a in edge_args(name)]
    before = K.launch_counts()["hier_cull"]
    words = K.hier_cull(*args)
    torch.cuda.synchronize()
    assert K.launch_counts()["hier_cull"] == before + 1
    assert torch.equal(words, K.hier_cull_plain(*args))
