"""PyTorch port: the LBVH build (ops/bvh.py) and its skip-pointer walk
(ops/traverse.py bvh_walk_mask_words) against the JAX package's.

The port's build is the JAX package's NumPy build (use_native=False)
vectorized over all internal nodes: its arrays, its linearized pack and
its refit must equal the loop's. The walk's words must equal JAX's and
be a superset of the flat scan's, equal to them where the JAX package's
tests/test_accel.py requires it (the walk reaches a leaf iff the flat
scan passes its cluster).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_wgpu_raytracing_tpu import config as jcfg
from rust_wgpu_raytracing_tpu.core.scene import Scene as JScene
from rust_wgpu_raytracing_tpu.ops import bvh as jbvh
from rust_wgpu_raytracing_tpu.ops import traverse as jtrav
from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
from rust_wgpu_raytracing_tpu_torch.core.scene import Scene
from rust_wgpu_raytracing_tpu_torch.ops import bvh, traverse
from rust_wgpu_raytracing_tpu_torch.ops.megakernel import (
    raygen_planar, raygen_planar_tiled)
from rust_wgpu_raytracing_tpu_torch.ops.traverse import (bvh_walk_mask_words,
                                                         cull_mask,
                                                         pack_mask_bits,
                                                         tile_ray_bounds)
from test_torch_host import port_config, terrain_config

TREE_FIELDS = ("left", "right", "parent", "node_lo", "node_hi")


def leaves(n, seed, dup_every=0):
    """Sorted Morton codes of n seeded points (every dup_every-th point
    moved onto the first, so codes repeat) and their boxes."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    if dup_every:
        pts[::dup_every] = pts[0]
    order = np.argsort(bvh.morton3d(pts), kind="stable")
    pts = pts[order]
    return bvh.morton3d(pts), pts - 0.01, pts + 0.02


@pytest.mark.parametrize("n,seed,dup", [(1, 0, 0), (2, 1, 0), (3, 2, 0),
                                        (33, 3, 0), (200, 4, 3),
                                        (1000, 5, 0), (4097, 6, 2)])
def test_build_matches_jax_numpy_build(n, seed, dup):
    codes, lo, hi = leaves(n, seed, dup)
    want = jbvh.build_lbvh(codes, lo, hi, use_native=False)
    got = bvh.build_lbvh(codes, lo, hi, use_native=False)
    assert got.n_leaves == want.n_leaves == n
    for name in TREE_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, name)
    np.testing.assert_array_equal(bvh.linearize_bvh(got),
                                  jbvh.linearize_bvh(want))


def test_refit_matches_jax():
    codes, lo, hi = leaves(300, 7)
    want = jbvh.build_lbvh(codes, lo, hi, use_native=False)
    got = bvh.build_lbvh(codes, lo, hi, use_native=False)
    rng = np.random.default_rng(8)
    moved = (rng.normal(0, 0.1, lo.shape) + lo).astype(np.float32)
    want.refit(moved, moved + 0.05)
    got.refit(moved, moved + 0.05)
    for name in ("node_lo", "node_hi"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), name)
    np.testing.assert_array_equal(bvh.linearize_bvh(got),
                                  jbvh.linearize_bvh(want))


def test_tile_cull_mask_np_matches_jax():
    rng = np.random.default_rng(9)
    dmin = rng.uniform(-1, 0.5, (6, 3)).astype(np.float32)
    dmax = dmin + rng.uniform(0, 0.6, (6, 3)).astype(np.float32)
    omin = rng.uniform(-0.2, 0.2, (6, 3)).astype(np.float32)
    omax = omin + 0.05
    lo = rng.uniform(-2, 2, (20, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 1, (20, 3)).astype(np.float32)
    args = (dmin, dmax, omin, omax, lo, hi)
    want = jbvh.tile_cull_mask_np(*args)
    assert want.any() and not want.all()
    np.testing.assert_array_equal(bvh.tile_cull_mask_np(*args), want)


def walk_case(grid, w, h, tiled):
    """(port scene data, JAX scene data, tile bounds, the flat scan's
    words (T, nwords)) of the terrain view at w x h."""
    jc = terrain_config(jcfg, grid=grid, width=w, height=h, spheres=False)
    cfg = port_config(jc)
    data = Scene.build(cfg).data
    uni = Camera.from_config(cfg.camera, w / h).uniforms()
    if tiled:
        dx, dy, dz = raygen_planar_tiled(w, h, uni, device="cpu",
                                         tile_h=8, tile_w=128)
    else:
        dx, dy, dz = raygen_planar(w, h, uni, device="cpu")
    o = torch.tensor(uni.origin, dtype=torch.float32)
    bounds = tile_ray_bounds(o[0], o[1], o[2], dx, dy, dz, 1024)
    flat = cull_mask(data.blk_lo, data.blk_hi, *bounds)
    words, nwords = pack_mask_bits(flat)
    return data, JScene.build(jc).data, bounds, words.reshape(-1, nwords)


@pytest.mark.parametrize("grid,w,h,tiled", [(23, 128, 128, False),
                                            (92, 256, 64, True)])
def test_walk_matches_jax_and_covers_the_flat_scan(grid, w, h, tiled):
    data, jd, bounds, flat = walk_case(grid, w, h, tiled)
    nwords = flat.shape[1]
    cull = data.padded_faces // data.blk_lo.shape[0]
    assert data.bvh_nodes == 2 * -(-data.num_faces // cull) - 1
    words = bvh_walk_mask_words(data.bvh_pack, data.bvh_nodes, *bounds,
                                nwords)
    want = jax.jit(jtrav.bvh_walk_mask_words, static_argnums=(1, 6))(
        jd.bvh_pack, jd.bvh_nodes, *(jnp.asarray(b.numpy()) for b in bounds),
        nwords)
    np.testing.assert_array_equal(words.numpy(), np.asarray(want))
    assert torch.equal(words & flat, flat)  # a superset of the flat scan
    assert int((flat != 0).sum()) > 0
    if grid == 23:  # tests/test_accel.py: the walk equals the flat scan
        assert torch.equal(words, flat)


def test_walk_words_do_not_depend_on_the_check_interval(monkeypatch):
    data, _, bounds, flat = walk_case(23, 128, 128, False)
    runs = []
    for k in (1, 7, 64, 4096):
        monkeypatch.setattr(traverse, "WALK_CHECK_STEPS", k)
        runs.append(bvh_walk_mask_words(data.bvh_pack, data.bvh_nodes,
                                        *bounds, flat.shape[1]))
    for r in runs[1:]:
        assert torch.equal(r, runs[0])
