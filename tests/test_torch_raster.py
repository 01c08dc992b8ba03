"""PyTorch port: the forward raster pipeline (ops/raster.py) against the
JAX package's.

The JAX side runs in the jax_reference subprocess (XLA without FMA) on
the scenes of tests/test_raster.py that need no asset (the full-screen
quad, back-face culling, depth Less in both draw orders, the equal-z
tie, the fragment at the clear depth, the fill-rule seam along the
shared diagonal, the analytic half-viewport triangle, perspective-
correct UV, compositing over existing attachments) plus a seeded random
soup (triangles crossing z 0 and 1, corners at w <= 1e-6, repeated
z for ties). Tolerances: the per-pixel winners (z, key, b0, b1) and the
depth bit for bit, the colour bit for bit; the comparison sampler (PCF)
bit for bit; the reference instance grid's matrices bit for bit; the
RasterEncoder over the reference grid bit for bit, and its draw_mesh of
a cube within a stated ulp gap of the vertex stage (see its test). The
port's output does not depend on its chunk size.
"""

import numpy as np
import pytest
import torch

from rust_wgpu_raytracing_tpu_torch.config import CameraConfig
from rust_wgpu_raytracing_tpu_torch.core import math3d
from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
from rust_wgpu_raytracing_tpu_torch.ops import raster as R
from test_torch_host import jax_reference

KEY_MAX = np.iinfo(np.int32).max


def quad(z=0.5, w=1.0, flip=False):
    """Two Ccw (in NDC) triangles covering the viewport (tests/
    test_raster.py fullscreen_quad_clip), UVs over the unit square."""
    a = [-1.0, -1.0, z, 1.0]
    b = [1.0, -1.0, z, 1.0]
    c = [1.0, 1.0, z, 1.0]
    d = [-1.0, 1.0, z, 1.0]
    ua, ub, uc, ud = [0, 0], [1, 0], [1, 1], [0, 1]
    tris = [[a, b, c], [a, c, d]]
    uvs = [[ua, ub, uc], [ua, uc, ud]]
    if flip:
        tris = [[t[0], t[2], t[1]] for t in tris]
        uvs = [[u[0], u[2], u[1]] for u in uvs]
    return (np.asarray(tris, np.float32) * np.float32(w),
            np.asarray(uvs, np.float32))


def checker(n=8):
    yy, xx = np.mgrid[0:n, 0:n]
    c = ((yy + xx) % 2).astype(np.float32)
    return np.stack([c, c, c], axis=-1)


def random_soup(seed=20261017, n=48):
    """Seeded clip-space triangles: both windings, z across [0, 1] and
    past it, some corners at w <= 1e-6, and every fourth triangle a copy
    of the one before with other UVs (equal z: draw-order ties)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1.3, 1.3, (n, 3, 2))
    z = rng.uniform(-0.2, 1.1, (n, 1, 1)) + rng.uniform(-0.05, 0.05,
                                                        (n, 3, 1))
    w = rng.uniform(0.5, 2.0, (n, 3, 1))
    w[rng.uniform(size=n) < 0.1, 0] = rng.choice([-1.0, 0.0, 1e-7])
    tc = np.concatenate([xy * w, z * w, w], axis=2).astype(np.float32)
    tu = rng.uniform(0.0, 1.0, (n, 3, 2)).astype(np.float32)
    for i in range(3, n, 4):
        tc[i] = tc[i - 1]
    tex = rng.uniform(0.0, 1.0, (5, 7, 3)).astype(np.float32)
    return tc, tu, tex


def perspective_quad():
    a = [-1.0, -1.0, 0.5, 1.0]
    b = [2.0, -2.0, 1.0, 2.0]
    c = [2.0, 2.0, 1.0, 2.0]
    d = [-1.0, 1.0, 0.5, 1.0]
    tris = np.asarray([[a, b, c], [a, c, d]], np.float32)
    uvs = np.asarray([[[0, 0], [1, 0], [1, 1]],
                      [[0, 0], [1, 1], [0, 1]]], np.float32)
    grad = np.linspace(0, 1, 256, dtype=np.float32)
    tex = np.stack([grad] * 3, -1)[None].repeat(2, 0)
    return tris, uvs, tex


def scenes():
    """name -> (tri_clip, tri_uv, width, height, tex, color, depth)."""
    ones = np.ones((2, 2, 3), np.float32)
    out = {}
    tc, tu = quad(z=0.5)
    out["quad"] = (tc, tu, 32, 32, np.full((4, 4, 3), 0.75, np.float32),
                   None, None)
    out["backface"] = (*quad(z=0.5, flip=True), 16, 16, ones, None, None)
    near, far = quad(z=0.25), quad(z=0.75)
    out["near_far"] = (np.concatenate([near[0], far[0]]),
                       np.concatenate([near[1], far[1]]), 8, 8, ones,
                       None, None)
    out["far_near"] = (np.concatenate([far[0], near[0]]),
                       np.concatenate([far[1], near[1]]), 8, 8, ones,
                       None, None)
    out["equal_z"] = (np.concatenate([tc, tc]),
                      np.concatenate([tu, tu * 0.0]), 16, 16, checker(8),
                      None, None)
    out["clear_depth"] = (*quad(z=1.0), 8, 8, ones, None, None)
    out["diagonal"] = (tc, tu, 33, 33, ones, None, None)
    out["diagonal_t0"] = (tc[:1], tu[:1], 33, 33, ones, None, None)
    out["diagonal_t1"] = (tc[1:], tu[1:], 33, 33, ones, None, None)
    a = [-1.0, -1.0, 0.5, 1.0]
    b = [1.0, -1.0, 0.5, 1.0]
    d = [-1.0, 1.0, 0.5, 1.0]
    out["half"] = (np.asarray([[a, b, d]], np.float32),
                   np.zeros((1, 3, 2), np.float32), 16, 16, ones, None,
                   None)
    out["perspective"] = (*perspective_quad()[:2], 64, 64,
                          perspective_quad()[2], None, None)
    out["composite"] = (tc, tu, 8, 8, np.full((2, 2, 3), 0.25, np.float32),
                        np.full((8, 8, 3), 0.9, np.float32),
                        np.full((8, 8), 0.3, np.float32))
    stc, stu, stex = random_soup()
    out["random"] = (stc, stu, 37, 29, stex, None, None)
    rng = np.random.default_rng(5)
    out["random_over"] = (stc, stu, 37, 29, stex,
                          rng.uniform(0, 1, (29, 37, 3)).astype(np.float32),
                          rng.uniform(0.2, 1.0, (29, 37)).astype(np.float32))
    return out


def pcf_inputs():
    rng = np.random.default_rng(3)
    return (rng.uniform(0, 1, (5, 7)).astype(np.float32),
            rng.uniform(-0.3, 1.3, 257).astype(np.float32),
            rng.uniform(-0.3, 1.3, 257).astype(np.float32),
            rng.uniform(0, 1, 257).astype(np.float32))


def grid_view_proj():
    cam = Camera.from_config(
        CameraConfig(eye=(0.0, 12.0, 20.0), target=(0.0, 0.0, 0.0)),
        aspect=1.0)
    return (math3d.OPENGL_TO_WGPU @ cam.view_proj_matrix()).astype(
        np.float32)


def tri_mesh_arrays():
    return dict(positions=np.asarray([[-1, -1, 0], [1, -1, 0], [0, 1, 0]],
                                     np.float32),
                tex_coords=np.asarray([[0, 0], [1, 0], [0.5, 1]],
                                      np.float32),
                normals=np.zeros((3, 3), np.float32),
                faces=np.asarray([[0, 1, 2]], np.int32))


def cube_arrays():
    """builtin:cube's positions, uvs and faces with a seeded texture."""
    from rust_wgpu_raytracing_tpu_torch.io.obj import make_cube

    m = make_cube()
    tex = np.random.default_rng(9).uniform(0, 1, (8, 8, 3)).astype(
        np.float32)
    return dict(positions=m.positions, tex_coords=m.uvs, normals=m.normals,
                faces=m.faces), tex


# (instances, vertices) of the vertex stage's two einsums held against
# XLA's: each branch of raster._dot4's rule
DOT_SHAPES = ((1, 1), (1, 3), (1, 8), (1, 24), (2, 5), (4, 64), (5, 3),
              (16, 40), (100, 3), (100, 24))


def dot_inputs(n_inst, n_vert):
    """Seeded view-projection, model matrices and homogeneous vertices."""
    rng = np.random.default_rng(1000 * n_inst + n_vert)
    return (rng.normal(size=(4, 4)).astype(np.float32),
            rng.normal(size=(n_inst, 4, 4)).astype(np.float32),
            np.concatenate([rng.normal(size=(n_vert, 3)),
                            np.ones((n_vert, 1))], 1).astype(np.float32))


# ---------------------------------------------------------------------------
# the JAX side (runs in the jax_reference subprocess)
# ---------------------------------------------------------------------------

def jax_raster_reference(out):
    import functools

    import jax
    import jax.numpy as jnp

    from rust_wgpu_raytracing_tpu.ops import raster as jr

    @functools.partial(jax.jit, static_argnames=("width", "height"))
    def winners(tri_clip, width, height, depth):
        # the prologue and loop of jr.rasterize (chunk 16), returning the
        # carried winners
        chunk = 16
        w_clip = tri_clip[:, :, 3]
        safe_w = jnp.where(jnp.abs(w_clip) > 1e-6, w_clip, 1.0)
        ndc = tri_clip[:, :, :3] / safe_w[:, :, None]
        tri_scr = jnp.stack([(ndc[:, :, 0] * 0.5 + 0.5) * width,
                             (0.5 - ndc[:, :, 1] * 0.5) * height,
                             ndc[:, :, 2], w_clip], axis=-1)
        pad = (-tri_scr.shape[0]) % chunk
        if pad:
            padv = jnp.zeros((pad, 3, 4), tri_scr.dtype)
            padv = padv.at[:, :, 3].set(-1.0)
            tri_scr = jnp.concatenate([tri_scr, padv], axis=0)
        xs = jnp.arange(width, dtype=jnp.float32) + 0.5
        ys = jnp.arange(height, dtype=jnp.float32) + 0.5
        px, py = jnp.tile(xs, height), jnp.repeat(ys, width)
        p = width * height
        best = (depth.reshape(-1), jnp.full((p,), jr._KEY_MAX, jnp.int32),
                jnp.zeros((p,)), jnp.zeros((p,)))

        def body(i, carry):
            tc = jax.lax.dynamic_slice_in_dim(tri_scr, i * chunk, chunk)
            return jr._face_chunk(tc, i * chunk, px, py, carry)

        return jax.lax.fori_loop(0, tri_scr.shape[0] // chunk, body, best)

    res = {}
    for name, (tc, tu, w, h, tex, color, depth) in scenes().items():
        c, d = jr.rasterize(jnp.asarray(tc), jnp.asarray(tu), w, h,
                            jnp.asarray(tex),
                            color=None if color is None else
                            jnp.asarray(color),
                            depth=None if depth is None else
                            jnp.asarray(depth))
        res[f"{name}.color"], res[f"{name}.depth"] = np.asarray(c), \
            np.asarray(d)
        seed = np.ones((h, w), np.float32) if depth is None else depth
        for k, v in zip(("z", "key", "b0", "b1"),
                        winners(jnp.asarray(tc), w, h, jnp.asarray(seed))):
            res[f"{name}.{k}"] = np.asarray(v)
    data, u, v, ref = pcf_inputs()
    res["pcf"] = np.asarray(jr.DepthTexture(jnp.asarray(data))
                            .sample_compare(jnp.asarray(u), jnp.asarray(v),
                                            jnp.asarray(ref)))
    res["grid"] = jr.reference_instance_grid()
    res["grid6"] = jr.reference_instance_grid(6, spacing=2.0)

    tri = jr.RasterMesh(name="tri", **tri_mesh_arrays())
    enc = jr.RasterEncoder(48, 48)
    enc.draw_model_instanced(
        jr.RasterModel([tri], [jr.RasterMaterial(
            "m", np.full((2, 2, 3), 0.5, np.float32))]),
        jr.reference_instance_grid(), grid_view_proj())
    res["enc_grid.color"] = np.asarray(enc.color)
    res["enc_grid.depth"] = np.asarray(enc.depth.data)
    cube, tex = cube_arrays()
    enc = jr.RasterEncoder(40, 40, clear_color=(0.1, 0.2, 0.3))
    enc.draw_mesh(jr.RasterMesh(name="cube", **cube),
                  jr.RasterMaterial("c", tex), grid_view_proj()
                  @ np.diag([4.0, 4.0, 4.0, 1.0]).astype(np.float32))
    res["enc_cube.color"] = np.asarray(enc.color)
    res["enc_cube.depth"] = np.asarray(enc.depth.data)
    for n_inst, n_vert in DOT_SHAPES:
        vp, mm, pos_h = dot_inputs(n_inst, n_vert)
        mvp = jnp.einsum("ab,ibc->iac", vp, mm)
        res[f"dot{n_inst}x{n_vert}.mvp"] = np.asarray(mvp)
        res[f"dot{n_inst}x{n_vert}.clip"] = np.asarray(
            jnp.einsum("iab,vb->iva", mvp, pos_h))
    np.savez(out, **res)


# ---------------------------------------------------------------------------
# the port side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return jax_reference("test_torch_raster", "jax_raster_reference",
                         tmp_path_factory.mktemp("raster_ref"))


def t32(a):
    return None if a is None else torch.from_numpy(np.asarray(a,
                                                              np.float32))


def port_raster(name, chunk=None):
    tc, tu, w, h, tex, color, depth = scenes()[name]
    return R.rasterize(t32(tc), t32(tu), w, h, t32(tex), color=t32(color),
                       depth=t32(depth), chunk=chunk)


def port_winners(name, chunk=None):
    tc, _, w, h, _, _, depth = scenes()[name]
    return R.rasterize_winners(R.screen_triangles(t32(tc), w, h), w, h,
                               depth=t32(depth), chunk=chunk)


def bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("name", list(scenes()))
def test_rasterize_matches_jax(ref, name):
    """Winners (z, key, b0, b1) and depth bit for bit; colour bit for bit
    (tolerance: none)."""
    z, key, b0, b1 = port_winners(name)
    for k, v in (("z", z), ("key", key)):
        np.testing.assert_array_equal(bits(v.numpy()),
                                      bits(ref[f"{name}.{k}"]), err_msg=k)
    won = key.numpy() != KEY_MAX
    for k, v in (("b0", b0), ("b1", b1)):
        np.testing.assert_array_equal(bits(v.numpy()[won]),
                                      bits(ref[f"{name}.{k}"][won]),
                                      err_msg=k)
    color, depth = port_raster(name)
    np.testing.assert_array_equal(bits(depth.numpy()),
                                  bits(ref[f"{name}.depth"]))
    np.testing.assert_array_equal(bits(color.numpy()),
                                  bits(ref[f"{name}.color"]))


@pytest.mark.parametrize("name", ["random", "random_over", "equal_z",
                                  "near_far", "diagonal"])
def test_output_does_not_depend_on_chunk(name):
    want_c, want_d = port_raster(name, chunk=1)
    wk = port_winners(name, chunk=1)[1]
    for chunk in (2, 3, 7, 16, None):
        c, d = port_raster(name, chunk=chunk)
        assert torch.equal(c, want_c) and torch.equal(d, want_d), chunk
        assert torch.equal(port_winners(name, chunk=chunk)[1], wk), chunk


def test_random_soup_exercises_the_rules(ref):
    """The seeded soup has draw-order ties, rejected w <= 1e-6 triangles
    and both windings, and some triangle wins."""
    tc, _, w, h, _, _, _ = scenes()["random"]
    scr = R.screen_triangles(t32(tc), w, h)
    front = R._front(scr)
    assert 0 < int(front.sum()) < tc.shape[0]
    assert bool((t32(tc)[:, :, 3] <= 1e-6).any(dim=1).any())
    keys = set(np.unique(ref["random.key"]).tolist()) - {KEY_MAX}
    assert len(keys) > 5


def test_fill_rule_no_double_cover_no_gap():
    """JAX test_top_left_rule_no_double_cover_no_gap: the two triangles
    of the quad own every diagonal pixel exactly once."""
    m0 = port_raster("diagonal_t0")[1] < 1.0
    m1 = port_raster("diagonal_t1")[1] < 1.0
    assert not bool((m0 & m1).any()) and bool((m0 | m1).all())
    assert bool((port_raster("diagonal")[1] < 1.0).all())


def test_analytic_half_viewport_triangle():
    """Coverage is exactly the pixels strictly below the anti-diagonal."""
    _, depth = port_raster("half")
    n = 16
    xx, yy = np.meshgrid(np.arange(n) + 0.5, np.arange(n) + 0.5)
    np.testing.assert_array_equal(depth.numpy() < 1.0, xx < yy)


def test_perspective_correct_uv():
    """u at screen fraction s is s / (2 - s) (within 0.02 of a texel
    ramp), not the affine s."""
    color, _ = port_raster("perspective")
    n = 64
    row = color.numpy()[n // 2, :, 0]
    s = (np.arange(n) + 0.5) / n
    assert np.abs(row - s / (2.0 - s)).max() < 0.02
    assert np.abs(row - s).max() > 0.1


def test_depth_rules():
    """Back faces and a fragment at the clear depth draw nothing; Less
    keeps the nearer quad in either draw order; a closer attachment
    keeps its colour and depth."""
    for name in ("backface", "clear_depth"):
        color, depth = port_raster(name)
        assert float(color.abs().max()) == 0.0
        assert bool((depth == 1.0).all())
    for name in ("near_far", "far_near"):
        assert bool((port_raster(name)[1] == np.float32(0.25)).all())
    color, depth = port_raster("composite")
    assert bool((color == np.float32(0.9)).all())
    assert bool((depth == np.float32(0.3)).all())


def test_pcf_matches_jax(ref):
    data, u, v, r = pcf_inputs()
    got = R.DepthTexture(t32(data)).sample_compare(t32(u), t32(v), t32(r))
    np.testing.assert_array_equal(bits(got.numpy()), bits(ref["pcf"]))


def test_depth_compare_rules():
    """JAX TestDepthCompare: LessEqual at texel centres, PCF halfway,
    clamp to edge."""
    d = R.DepthTexture(torch.tensor([[0.2, 0.8], [0.5, 0.5]]))
    got = d.sample_compare(torch.tensor([0.25, 0.75, 0.25, 0.75]),
                           torch.tensor([0.25, 0.25, 0.75, 0.75]), 0.5)
    np.testing.assert_allclose(got.numpy(), [0.0, 1.0, 1.0, 1.0])
    d = R.DepthTexture(torch.tensor([[0.0, 1.0]]))
    assert float(d.sample_compare(0.5, 0.5, 0.5)) == pytest.approx(0.5)
    assert float(d.sample_compare(-3.0, 0.5, 0.5)) == 0.0
    assert float(d.sample_compare(4.0, 0.5, 0.5)) == 1.0
    created = R.DepthTexture.create(3, 4, device="cpu")
    assert tuple(created.data.shape) == (3, 4)
    assert bool((created.data == 1.0).all())


def test_instance_grid_matches_jax(ref):
    np.testing.assert_array_equal(R.reference_instance_grid(), ref["grid"])
    np.testing.assert_array_equal(R.reference_instance_grid(6, spacing=2.0),
                                  ref["grid6"])
    g = R.reference_instance_grid()
    np.testing.assert_allclose(g[55], np.eye(4), atol=1e-7)
    np.testing.assert_allclose(g[0][:3, 3], [-15.0, 0.0, -15.0])


def test_encoder_reference_grid_matches_jax(ref):
    """draw_model_instanced over the reference's 10x10 grid with the
    forward camera: colour and depth bit for bit (tolerance: none)."""
    model = R.RasterModel(
        meshes=[R.RasterMesh(name="tri", **tri_mesh_arrays())],
        materials=[R.RasterMaterial("m", np.full((2, 2, 3), 0.5,
                                                 np.float32))])
    enc = R.RasterEncoder(48, 48, device="cpu")
    enc.draw_model_instanced(model, R.reference_instance_grid(),
                             grid_view_proj())
    cover = enc.depth.data < 1.0
    assert int(cover.sum()) > 40
    np.testing.assert_array_equal(bits(enc.depth.data.numpy()),
                                  bits(ref["enc_grid.depth"]))
    np.testing.assert_array_equal(bits(enc.color.numpy()),
                                  bits(ref["enc_grid.color"]))


def test_encoder_draw_mesh_matches_jax(ref):
    """draw_mesh of a textured cube over a cleared colour: one instance,
    whose vertex stage XLA's CPU dot sums pairwise (raster._dot4 takes
    its order by shape). The covered pixels equal; colour and depth bit
    for bit (tolerance: none)."""
    cube, tex = cube_arrays()
    enc = R.RasterEncoder(40, 40, clear_color=(0.1, 0.2, 0.3), device="cpu")
    enc.draw_mesh(R.RasterMesh(name="cube", **cube),
                  R.RasterMaterial("c", tex), grid_view_proj()
                  @ np.diag([4.0, 4.0, 4.0, 1.0]).astype(np.float32))
    depth = enc.depth.data.numpy()
    want = ref["enc_cube.depth"]
    assert bool((depth < 1.0).any())
    np.testing.assert_array_equal(depth < 1.0, want < 1.0)
    np.testing.assert_array_equal(bits(depth), bits(want))
    np.testing.assert_array_equal(bits(enc.color.numpy()),
                                  bits(ref["enc_cube.color"]))


@pytest.mark.parametrize("n_inst,n_vert", DOT_SHAPES)
def test_vertex_stage_sums_as_xla(ref, n_inst, n_vert):
    """instance_triangles' two products (VP @ M, then MVP @ p) on seeded
    normal inputs, where every summation order rounds differently:
    bit for bit XLA's CPU einsums at each shape of raster._dot4's rule."""
    vp, mm, pos_h = dot_inputs(n_inst, n_vert)
    mvp = R._dot4(torch.from_numpy(vp)[None], torch.from_numpy(mm), 4,
                  4 * n_inst)
    clip = R._dot4(mvp, torch.from_numpy(pos_h).t()[None], 4 * n_inst,
                   n_vert).transpose(1, 2)
    np.testing.assert_array_equal(bits(mvp.numpy()),
                                  bits(ref[f"dot{n_inst}x{n_vert}.mvp"]))
    np.testing.assert_array_equal(bits(clip.numpy()),
                                  bits(ref[f"dot{n_inst}x{n_vert}.clip"]))


def test_load_model_raster_keeps_raw_uvs(tmp_path, monkeypatch):
    """load_model_raster on a textured OBJ written here: raw (un-flipped)
    tex_coords and a decoded diffuse texture per material."""
    from test_torch_host import write_textured_assets

    name = write_textured_assets(str(tmp_path))
    monkeypatch.setenv("RWRT_ASSETS", str(tmp_path))
    model = R.load_model_raster(name)
    assert model.meshes[0].faces.shape[1] == 3
    assert model.materials[0].diffuse.shape == (8, 8, 3)
    assert float(model.meshes[0].tex_coords.max()) == pytest.approx(1.7)
