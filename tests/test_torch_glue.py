"""PyTorch port: the split frame's plain-tensor glue against the JAX
package, bit for bit.

The JAX side runs jitted, as inside its frame program, in a separate
interpreter with XLA's CPU code generation capped below FMA
(test_torch_host.jax_reference says why). Everything here must then be
EXACTLY equal: rays, face packs, origin terms, cull masks, schedules,
the winner expansion and the texel gather.

The sweeps' front end (megakernel.sweep_inputs) is held to the units it
composes, and the scene's constants (ops/scenepacks.py) to being built
once per SceneData.
"""

import dataclasses
import importlib
import os

import numpy as np
import pytest
import torch

from rust_wgpu_raytracing_tpu import config as jcfg
from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
from rust_wgpu_raytracing_tpu_torch.core.scene import Scene
from rust_wgpu_raytracing_tpu_torch.ops import kernels as K
from rust_wgpu_raytracing_tpu_torch.ops import megakernel as P
from rust_wgpu_raytracing_tpu_torch.ops import scenepacks as SP
from rust_wgpu_raytracing_tpu_torch.ops.composite import to_nonlinear_depth
from rust_wgpu_raytracing_tpu_torch.ops.shade import quantize_rgba8
from rust_wgpu_raytracing_tpu_torch.ops.traverse import (cull_mask,
                                                         perray_super_any,
                                                         tile_ray_bounds)
from rust_wgpu_raytracing_tpu_torch.runtime.profiler import count_ops
from test_torch_host import (cube_config, jax_reference, port_config,
                             terrain_config, textured_config,
                             write_textured_assets)

# the module (the package's name sweep_front is the wrapper)
SF = importlib.import_module(
    "rust_wgpu_raytracing_tpu_torch.ops.kernels.sweep_front")

RAY_SIZES = [(64, 64), (96, 64), (1920, 1080), (100, 30)]
W, H = 96, 64


def shadow_rays(n, seed=3):
    """Per-ray-origin shadow wavefront like the frame's: origins over the
    terrain toward the light, about one ray in five parked (origin 1e9,
    zero direction), `act` marking the live ones."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-1.2, -1.2, -3.4], [1.2, 1.2, -2.6],
                    (n, 3)).astype(np.float32)
    ldir = -np.array([6.0, -1.0, 1.0], np.float32)
    d = (ldir / np.linalg.norm(ldir)) + rng.normal(0, 0.05, (n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    act = rng.uniform(size=n) < 0.8
    o[~act] = 1e9
    d[~act] = 0.0
    return o.T.copy(), d.T.copy(), act


def jax_glue(out, assets):
    import jax
    import jax.numpy as jnp

    import rust_wgpu_raytracing_tpu.ops.megakernel as J
    from rust_wgpu_raytracing_tpu.core.camera import Camera as JCamera
    from rust_wgpu_raytracing_tpu.core.camera import CameraUniforms as JU
    from rust_wgpu_raytracing_tpu.core.scene import Scene as JScene
    from rust_wgpu_raytracing_tpu.ops.composite import to_nonlinear_depth
    from rust_wgpu_raytracing_tpu.ops.shade import quantize_rgba8

    os.environ["RWRT_ASSETS"] = assets
    res = {}
    cfg = terrain_config(jcfg)
    for w, h in RAY_SIZES:
        uni = jnp.asarray(JCamera.from_config(cfg.camera, w / h)
                          .uniforms().flat())
        shape = J._pick_tile_shape(w, h)
        if shape is not None:
            th, tw, rh = shape
            fn = jax.jit(lambda u: J.raygen_planar_tiled(
                w, rh, JU.unflat(u), total_height=h, tile_h=th, tile_w=tw))
        else:
            fn = jax.jit(lambda u: J.raygen_planar(w, h, JU.unflat(u)))
        res[f"ray_{w}x{h}"] = np.stack([np.asarray(a) for a in fn(uni)])

    data = JScene.build(cfg).data
    uni = JCamera.from_config(cfg.camera, W / H).uniforms()
    origin = jnp.asarray(uni.origin)
    res["fpack"] = jax.jit(J.pack_face_columns)(data)
    res["oterm"] = jax.jit(J.pack_origin_cols)(data, origin)
    f = data.tri_p0.shape[0]
    bf = J._natural_block_f(data, f)
    rays = [J._pad1(jnp.asarray(a), 1024) for a in res[f"ray_{W}x{H}"]]
    for accel in ("brute", "cull"):
        def sched(d, o, x, y, z, accel=accel):
            mask, nw = J._mask_words(d, accel, o[0], o[1], o[2], x, y, z,
                                     1024, bf, f)
            return (mask,) + J._vmem_sched(d, mask, nw, o[0], o[1], o[2],
                                           x, y, z, 1024, f, bf)
        mask, tlb, order, texit = jax.jit(sched)(data, origin, *rays)
        res[f"mask_{accel}"] = mask
        res[f"tlb_{accel}"] = tlb[:, 0]
        res[f"order_{accel}"] = order[:, 0]
        res[f"texit_{accel}"] = texit
    res["cull_mask"] = jax.jit(lambda d, o, x, y, z: J.tile_cull_mask(
        d, o[0], o[1], o[2], x, y, z, 1024))(data, origin, *rays)

    so, sd, act = shadow_rays(3000)

    def shadow_sched(d, o, dd, a):
        o = [J._pad1(v, 1024) for v in o]
        dd = [J._pad1(v, 1024) for v in dd]
        a = J._pad1(a.astype(jnp.float32), 1024)
        mask, nw = J._mask_words(d, "cull", *o, *dd, 1024, bf, f)
        return (mask,) + J._vmem_sched(d, mask, nw, *o, *dd, 1024, f, bf,
                                       act=(a > 0))
    out_s = jax.jit(shadow_sched)(data, tuple(jnp.asarray(so)),
                                  tuple(jnp.asarray(sd)), jnp.asarray(act))
    for k, v in zip(("mask", "tlb", "order", "texit"), out_s):
        res[f"shadow_{k}"] = v[:, 0] if k in ("tlb", "order") else v

    # winner expansion (with the normal-mapping planes) from the kernel's
    # own (t, face), on a table small enough for the one-hot fetch (cube)
    # and one that gathers (terrain)
    for name, c in (("cube", cube_config(jcfg)), ("terrain", cfg)):
        d = JScene.build(c).data
        u = JCamera.from_config(c.camera, 1.0).uniforms()
        dirs = jax.jit(lambda v: J.raygen_planar(64, 64, JU.unflat(v)))(
            jnp.asarray(u.flat()))
        gb, _ = J.gbuffer_pallas(d, jnp.asarray(u.origin), *dirs,
                                 with_spheres=True, with_nm=True,
                                 interpret=True)
        for k in gb._fields:
            if getattr(gb, k) is not None:
                res[f"gb_{name}_{k}"] = getattr(gb, k)

    td = JScene.build(textured_config(jcfg)).data
    rng = np.random.default_rng(5)
    u = rng.uniform(-0.3, 1.4, 4096).astype(np.float32)
    v = rng.uniform(-0.3, 1.4, 4096).astype(np.float32)
    mat = np.zeros(4096, np.float32)
    base = J._mat_const(td, mat, lambda k: td.mat_tex_base[k])
    hh = J._mat_const(td, mat, lambda k: td.mat_tex_h[k])
    ww = J._mat_const(td, mat, lambda k: td.mat_tex_w[k])
    taps, fx, fy = jax.jit(J.gather_packed_taps)(td.tex_packed, base, hh,
                                                 ww, u, v)
    res.update(tap_u=u, tap_v=v, taps=taps, tap_fx=fx, tap_fy=fy)

    x = rng.uniform(-0.5, 1.5, 100000).astype(np.float32)
    t = rng.uniform(0.005, 150.0, 100000).astype(np.float32)
    res.update(qx=x, q=jax.jit(quantize_rgba8)(x), dt=t,
               depth=jax.jit(to_nonlinear_depth)(t))
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("assets")
    write_textured_assets(str(root))
    return str(root)


@pytest.fixture(scope="module")
def ref(tmp_path_factory, assets):
    return jax_reference("test_torch_glue", "jax_glue",
                         tmp_path_factory.mktemp("glue"), assets=assets)


@pytest.fixture(scope="module")
def frame():
    cfg = port_config(terrain_config(jcfg))
    data = Scene.build(cfg).data
    uni = Camera.from_config(cfg.camera, W / H).uniforms()
    return data, uni, torch.from_numpy(uni.origin)


def rays_for(w, h):
    cfg = port_config(terrain_config(jcfg))
    uni = Camera.from_config(cfg.camera, w / h).uniforms()
    shape = P._pick_tile_shape(w, h)
    if shape is None:
        return P.raygen_planar(w, h, uni, device="cpu")
    th, tw, rh = shape
    return P.raygen_planar_tiled(w, rh, uni, device="cpu", total_height=h,
                                 tile_h=th, tile_w=tw)


def padded_rays(w=W, h=H):
    return [P._pad1(a, 1024) for a in rays_for(w, h)]


def eq(got, want):
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w,h", RAY_SIZES)
def test_raygen_matches_jax(ref, w, h):
    eq(torch.stack(rays_for(w, h)), ref[f"ray_{w}x{h}"])


@pytest.mark.parametrize("w,h", [(64, 64), (96, 64), (1920, 1080),
                                 (100, 30), (640, 8), (128, 1), (33, 17)])
def test_pick_tile_shape_matches_jax(w, h):
    from rust_wgpu_raytracing_tpu.ops.megakernel import _pick_tile_shape

    assert P._pick_tile_shape(w, h) == _pick_tile_shape(w, h)


def test_face_and_origin_packs_match_jax(ref, frame):
    data, _, origin = frame
    eq(SP.pack_face_columns(data), ref["fpack"])
    eq(P.pack_origin_cols(data, origin), ref["oterm"])


@pytest.mark.parametrize("accel", ["brute", "cull"])
def test_mask_words_and_schedule_match_jax(ref, frame, accel):
    data, _, origin = frame
    f = data.padded_faces
    bf = P._natural_block_f(data, f)
    rays = padded_rays()
    o = (origin[0], origin[1], origin[2])
    bounds = tile_ray_bounds(*o, *rays, 1024)
    mask, nw = P._mask_words(data, accel, bounds, bf)
    eq(mask, ref[f"mask_{accel}"])
    tlb, order, texit = P._vmem_sched(data, mask, nw, bounds, *o, *rays, bf)
    eq(tlb, ref[f"tlb_{accel}"])
    eq(order, ref[f"order_{accel}"])
    eq(texit, ref[f"texit_{accel}"])


def test_tile_cull_mask_matches_jax(ref, frame):
    data, _, origin = frame
    eq(cull_mask(data.blk_lo, data.blk_hi, *tile_ray_bounds(
        origin[0], origin[1], origin[2], *padded_rays(), 1024)),
       ref["cull_mask"])


def test_shadow_schedule_matches_jax(ref, frame):
    data, _, _ = frame
    f = data.padded_faces
    bf = P._natural_block_f(data, f)
    so, sd, act = shadow_rays(3000)
    o = [P._pad1(torch.from_numpy(v), 1024) for v in so]
    d = [P._pad1(torch.from_numpy(v), 1024) for v in sd]
    a = P._pad1(torch.from_numpy(act).float(), 1024)
    mask, nw = P._mask_words(data, "cull", tile_ray_bounds(*o, *d, 1024), bf)
    eq(mask, ref["shadow_mask"])
    tlb, order, texit = P._vmem_sched(
        data, mask, nw, tile_ray_bounds(*o, *d, 1024, a > 0), *o, *d, bf)
    eq(tlb, ref["shadow_tlb"])
    eq(order, ref["shadow_order"])
    eq(texit, ref["shadow_texit"])


# sweep_inputs' cases: (origin, act given, act_cull, sched, stream, the
# rays the mask's tile bounds take, the rays the schedule's take): None
# all, "act" the active ones, "live" those with a direction
FRONT_CASES = {
    "shared": ("shared", False, None, True, False, None, None),
    "shared_streamed": ("shared", False, None, True, True, None, None),
    "perray": ("perray", False, None, True, False, None, None),
    "perray_streamed": ("perray", False, None, True, True, "live", "live"),
    "anyhit_act_cull": ("perray", True, True, True, False, "act", "act"),
    "anyhit": ("perray", True, None, True, False, None, "act"),
    "anyhit_streamed": ("perray", True, None, True, True, "act", "act"),
    "words": ("perray", True, True, False, False, "act", None),
}


@pytest.mark.parametrize("case", sorted(FRONT_CASES))
def test_sweep_inputs_compose_the_units(frame, case, monkeypatch):
    """sweep_inputs, the one front end of the culled sweeps: bitwise the
    units composed by hand as each sweep composed them (the padded
    planes, _mask_words, then _vmem_sched or _stream_inputs, with the
    streamed per-ray closest hit's super_any admission between them; a
    small scene forced onto the streamed path), with one tile_ray_bounds
    call in its plain front end (kernels.sweep_front_plain) where the
    mask and the schedule take the same rays and two where they do not
    (the all-on-chip any-hit without act_cull)."""
    kind, with_act, act_cull, sched, stream, mask_by, sched_by = \
        FRONT_CASES[case]
    data = frame[0].to("cpu")
    if kind == "shared":
        o, d, act = frame[2], rays_for(W, H), None
    else:
        so, sd, act = shadow_rays(3000)
        o, d = ([torch.from_numpy(v) for v in x] for x in (so, sd))
        act = torch.from_numpy(act) if with_act else None
    calls = []

    def counted(*a, **kw):
        calls.append(a)
        return tile_ray_bounds(*a, **kw)
    monkeypatch.setattr(SF, "tile_ray_bounds", counted)
    got = P.sweep_inputs(data, o, *d, act=act, act_cull=act_cull,
                         sched=sched, stream=stream)
    monkeypatch.undo()
    assert len(calls) == (1 if mask_by == sched_by or not sched else 2)

    bf = 32 if stream else P._natural_block_f(data, data.padded_faces)
    n = 1024 * (P.STREAM_BATCH if stream else 1)
    dp = [P._pad1(v, n) for v in d]
    op = [o[0], o[1], o[2]] if kind == "shared" else [P._pad1(v, n)
                                                       for v in o]
    actp = None if act is None else P._pad1(act.to(torch.float32), n)
    by = {None: None, "act": None if actp is None else actp > 0,
          "live": (dp[0] != 0.0) | (dp[1] != 0.0) | (dp[2] != 0.0)}
    mask, nw = P._mask_words(data, "cull",
                             tile_ray_bounds(*op, *dp, 1024, by[mask_by]),
                             bf)
    bounds = tile_ray_bounds(*op, *dp, 1024, by[sched_by])
    want = (None,)
    if sched and stream:
        if case == "perray_streamed":
            ok = perray_super_any(*SP.super_boxes(data), *op, *dp, 1024,
                                  act=by["live"])
            mask = torch.where(ok.reshape(-1), mask, 0)
        want = P._stream_inputs(data, mask, nw, bounds, *op, *dp)
    elif sched:
        want = P._vmem_sched(data, mask, nw, bounds, *op, *dp, bf)
    assert (got.stream, got.block_f, got.nwords) == (stream, bf, nw)
    planes = dp if kind == "shared" else dp + op
    assert len(got.planes) == len(planes)
    assert len(got.sched) == len(want) - 1 and (got.texit is None) == (
        want[-1] is None)
    for g, w in zip((*got.planes, got.mask, *got.sched, got.texit),
                    (*planes, mask, *want)):
        assert g is w is None or torch.equal(g, w)
    assert (got.act is None) == (actp is None)
    if actp is not None:
        assert torch.equal(got.act, actp)


def n_ops(fn):
    return sum(count_ops(fn, K.PLAIN).values())


@pytest.mark.parametrize("fused", [True, False])
def test_scene_constants_are_built_once_per_scene_data(frame, fused):
    """A second frame on the same SceneData dispatches fewer torch
    operations than the first, by exactly the operations that build the
    scene's constants the frame reads (ops/scenepacks.py); a copy made
    by .to() or dataclasses.replace starts with nothing cached and
    builds them again."""
    data, uni, origin = frame

    def draw(scene):
        return lambda ks: P.render_megakernel(
            scene, uni.flat(), width=W, height=H, shadows=True, fused=fused,
            kernels=ks)
    scene = data.to("cpu")
    first, second = n_ops(draw(scene)), n_ops(draw(scene))
    probe = dataclasses.replace(data)
    bf = P._natural_block_f(data, data.padded_faces)

    def build(ks):
        SP.pack_face_columns(probe)
        SP.pack_plane_consts(probe)
        SP.block_boxes(probe, bf)
        SP.cluster_boxes(probe)
        if fused:
            SP.frame_const(probe, origin)
    consts = n_ops(build)
    if fused:  # less the origin's join, which every frame makes
        consts -= n_ops(lambda ks: SP.frame_const(probe, origin))
    assert consts > 0 and first - second == consts
    for copy in (scene.to("cpu"), dataclasses.replace(scene)):
        assert n_ops(draw(copy)) == first


@pytest.mark.parametrize("name", ["cube", "terrain"])
def test_expand_tf_gbuffer_matches_jax(ref, name):
    jc = cube_config(jcfg) if name == "cube" else terrain_config(jcfg)
    cfg = port_config(jc)
    data = Scene.build(cfg).data
    uni = Camera.from_config(cfg.camera, 1.0).uniforms()
    origin = torch.from_numpy(uni.origin)
    dirs = P.raygen_planar(64, 64, uni, device="cpu")
    t = torch.from_numpy(ref[f"gb_{name}_t"])
    face = torch.from_numpy(ref[f"gb_{name}_face"])
    assert torch.isfinite(t).any() and not torch.isfinite(t).all()
    gb = P.gather_nm_planes(data, P.expand_tf_gbuffer(
        data, t, face, *dirs, P.pack_origin_cols(data, origin)))
    for k in gb._fields:  # the normal-mapping planes included
        eq(getattr(gb, k), ref[f"gb_{name}_{k}"])


def test_gather_packed_taps_matches_jax(ref, assets, monkeypatch):
    monkeypatch.setenv("RWRT_ASSETS", assets)
    data = Scene.build(port_config(textured_config(jcfg))).data
    mat = torch.zeros(4096)
    base = P._mat_const(data, mat, lambda k: data.mat_tex_base[k])
    hh = P._mat_const(data, mat, lambda k: data.mat_tex_h[k])
    ww = P._mat_const(data, mat, lambda k: data.mat_tex_w[k])
    assert base.dtype == torch.int32
    taps, fx, fy = P.gather_packed_taps(
        data.tex_packed, base, hh, ww, torch.from_numpy(ref["tap_u"]),
        torch.from_numpy(ref["tap_v"]))
    eq(taps, ref["taps"].view(np.int16))
    eq(fx, ref["tap_fx"])
    eq(fy, ref["tap_fy"])


def test_quantize_and_depth_match_jax(ref):
    eq(quantize_rgba8(torch.from_numpy(ref["qx"])), ref["q"])
    eq(to_nonlinear_depth(torch.from_numpy(ref["dt"])), ref["depth"])


def test_tiled_to_image_inverts_tile_order():
    th, tw, rh = P._pick_tile_shape(96, 64)
    idx = torch.arange(96 * rh, dtype=torch.int32)
    img = P.tiled_to_image(idx, 96, rh, th, tw)
    # tile-major ray order: ray k of tile t lands at its screen pixel
    assert int(img[0, 0]) == 0 and int(img[0, 31]) == 31
    assert int(img[1, 0]) == 32 and int(img[0, 32]) == th * tw
    assert sorted(img.reshape(-1).tolist()) == list(range(96 * rh))
