"""PyTorch port: the streamed sweeps K9, K10, K11 and their glue against
the JAX package's streamed branches of gbuffer_pallas,
gbuffer_perray_pallas and anyhit_pallas (Pallas in interpret mode).

Scenes: builtin:terrain:23 (1,024 faces, 8-face clusters, one
superblock) and terrain:46 (4,096 faces, four superblocks) forced onto
the streamed path, and terrain:92 (16,562 faces, 17 superblocks),
which streams on its own. Rays: a 128x96 camera frame (shared origin;
12 tiles, so two batches of 8 with a padded second batch) and a seeded
bounce wavefront of 9,000 rays around the terrain (per-ray origins, a
fifth of them parked), with shadow rays toward the light from the same
origins. Both sides get the same NumPy inputs; the JAX side runs as
tests/test_torch_host.jax_reference runs it (XLA capped at SSE4.2, so
every operation rounds on its own). Tolerance: bitwise, for the
kernels on JAX's own inputs, for the port's glue (schedule, masks,
permutations) and for every G-buffer plane.
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

from rust_wgpu_raytracing_tpu_torch import config as pcfg
from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
from rust_wgpu_raytracing_tpu_torch.core.scene import Scene
from rust_wgpu_raytracing_tpu_torch.ops import kernels as K
from rust_wgpu_raytracing_tpu_torch.ops import megakernel as P
from rust_wgpu_raytracing_tpu_torch.ops import scenepacks as SP
from rust_wgpu_raytracing_tpu_torch.ops.traverse import (perray_super_any,
                                                         tile_ray_bounds)
from test_torch_host import (cuda_device, jax_config,  # noqa: F401
                             jax_reference, terrain_config)

# name: (terrain grid, stream argument)
CASES = {"t23": (23, True), "t46": (46, True), "t92": (92, None)}
W, H = 128, 96
N_BOUNCE = 9000
GB = ("t", "face", "u", "v", "nd", "uvx", "uvy", "nx", "ny", "nz", "mat")
SCHED = ("mask3", "order2", "tlb3", "texit")
LIGHT = (6.0, -1.0, 1.0)


def scene_config(grid):
    """The terrain under the streamed benchmark's close camera
    (bench_configs.py config 6), so most rays hit."""
    cfg = terrain_config(pcfg, grid=grid, width=W, height=H, shadows=False)
    return dc.replace(cfg, camera=pcfg.CameraConfig(eye=(0.0, -0.4, -1.2),
                                                    target=(0.0, 0.0, -3.0)))


def bounce_wavefront(seed=41, n=N_BOUNCE):
    """(origins (3,n), directions (3,n), shadow dirs (3,n), active (n,))
    f32/bool: bounce rays around the terrain, a fifth of them parked
    (origin 1e9, zero direction), and shadow rays toward the light from
    the same origins, 85% of them active."""
    rng = np.random.default_rng(seed)
    o = rng.uniform((-1.0, -1.0, -3.3), (1.0, 1.0, -2.65),
                    (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    dead = rng.uniform(size=n) < 0.2
    o[dead] = 1e9
    d[dead] = 0.0
    sd = -np.asarray(LIGHT, np.float64)
    sd = np.tile((sd / np.linalg.norm(sd)).astype(np.float32), (n, 1))
    act = rng.uniform(size=n) < 0.85
    return o.T.copy(), d.T.copy(), sd.T.copy(), act


def jax_stream(out, names):
    import jax.numpy as jnp

    import rust_wgpu_raytracing_tpu.ops.megakernel as J
    from rust_wgpu_raytracing_tpu.core.camera import Camera as JCamera
    from rust_wgpu_raytracing_tpu.core.camera import CameraUniforms
    from rust_wgpu_raytracing_tpu.core.scene import Scene as JScene
    from rust_wgpu_raytracing_tpu.ops.traverse import perray_super_any as jps

    res = {}
    o, d, sd, act = bounce_wavefront()
    for name in names:
        grid, stream = CASES[name]
        cfg = jax_config(scene_config(grid))
        data = JScene.build(cfg).data
        f = data.tri_p0.shape[0]
        uni = CameraUniforms.unflat(jnp.asarray(JCamera.from_config(
            cfg.camera, W / H).uniforms().flat()))
        dx, dy, dz = J.raygen_planar(W, H, uni)
        org = uni.origin
        res[f"{name}_rays"] = np.stack([np.asarray(v) for v in (dx, dy, dz)])
        res[f"{name}_origin"] = np.asarray(org)
        spack = J._stream_pack(data)
        res[f"{name}_spack"] = spack

        # K9: the shared-origin sweep's inputs and G-buffer
        pad = [J._pad1(v, 8 * 1024) for v in (dx, dy, dz)]
        mask, nw = J._mask_words(data, "cull", org[0], org[1], org[2], *pad,
                                 1024, 32, f)
        mask3 = J._stream_mask_spec(mask, pad[0].shape[0] // 1024, nw,
                                    1024, 8)[2]
        tlb3, order2, texit = J._stream_sched(data, mask, org[0], org[1],
                                              org[2], *pad, 1024, 8, nw)
        for k, v in zip(("mask",) + SCHED, (mask, mask3, order2, tlb3,
                                             texit)):
            res[f"{name}_k9_{k}"] = v
        res[f"{name}_k9_oterm"] = J.pack_origin_cols(data, org)
        gb = J.gbuffer_pallas(data, org, dx, dy, dz, interpret=True,
                              stream=stream)
        for k in GB:
            res[f"{name}_k9_{k}"] = getattr(gb, k)

        # K10 and K11 on the bounce wavefront
        oj = [jnp.asarray(v) for v in o]
        dj = [jnp.asarray(v) for v in d]
        sdj = [jnp.asarray(v) for v in sd]
        op = [J._pad1(v, 8 * 1024) for v in oj]
        dp = [J._pad1(v, 8 * 1024) for v in dj]
        live = (dp[0] != 0.0) | (dp[1] != 0.0) | (dp[2] != 0.0)
        mask, nw = J._mask_words(data, "cull", *op, *dp, 1024, 32, f,
                                 act=live)
        _, _, slo, shi = J._super_aabbs(data, nw)
        sup_ok = jps(slo, shi, *op, *dp, 1024, act=live)
        res[f"{name}_sup_ok"] = sup_ok
        mask = jnp.where(sup_ok.reshape(-1), mask, 0)
        mask3 = J._stream_mask_spec(mask, op[0].shape[0] // 1024, nw,
                                    1024, 8)[2]
        tlb3, order2, texit = J._stream_sched(data, mask, *op, *dp, 1024, 8,
                                              nw, act=live)
        for k, v in zip(SCHED, (mask3, order2, tlb3, texit)):
            res[f"{name}_k10_{k}"] = v
        gb = J.gbuffer_perray_pallas(data, *oj, *dj, interpret=True,
                                     stream=stream)
        for k in GB:
            res[f"{name}_k10_{k}"] = getattr(gb, k)

        actj = jnp.asarray(act)
        actp = J._pad1(actj.astype(jnp.float32), 8 * 1024)
        sdp = [J._pad1(v, 8 * 1024) for v in sdj]
        mask, nw = J._mask_words(data, "cull", *op, *sdp, 1024, 32, f,
                                 act=actp > 0)
        mask3 = J._stream_mask_spec(mask, op[0].shape[0] // 1024, nw,
                                    1024, 8)[2]
        tlb3, order2, texit = J._stream_sched(data, mask, *op, *sdp, 1024, 8,
                                              nw, act=actp > 0)
        for k, v in zip(SCHED, (mask3, order2, tlb3, texit)):
            res[f"{name}_k11_{k}"] = v
        res[f"{name}_k11_occ"] = J.anyhit_pallas(
            data, *oj, *sdj, actj, interpret=True, stream=stream)
        if name == "t92":
            res["t92_morton"] = J._origin_morton(data, *oj)
            res["t92_bounce_perm"] = J._bounce_sort_perm(data, *oj, *dj)
            res["t92_k11_reordered"] = J.anyhit_reordered_pallas(
                data, *oj, *sdj, actj, interpret=True)
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """refs(name): the JAX results of one scene, computed at its first
    use (one interpreter per scene keeps each test's share short)."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = jax_reference(
                "test_torch_stream", "jax_stream",
                tmp_path_factory.mktemp(f"stream_{name}"), names=[name])
        return cache[name]
    return get


@pytest.fixture(scope="module")
def scenes():
    return {name: Scene.build(scene_config(grid)).data
            for name, (grid, _) in CASES.items()}


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def bits_equal(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want, err_msg=what)


def bounce_tensors():
    o, d, sd, act = bounce_wavefront()
    return [t(v) for v in o], [t(v) for v in d], [t(v) for v in sd], t(act)


@pytest.mark.parametrize("name", sorted(CASES))
def test_stream_closest_hit_matches_jax_kernel(refs, name):
    """K9 (plain version here) on JAX's own schedule and record."""
    ref = refs(name)
    before = K.launch_counts()["stream_closest_hit"]
    args = [t(ref[f"{name}_k9_{k}"]) for k in SCHED[:3]]
    rays = [P._pad1(t(v), 8 * 1024) for v in ref[f"{name}_rays"]]
    tt, face = K.stream_closest_hit(*args, *rays, t(ref[f"{name}_k9_texit"]),
                                    t(ref[f"{name}_spack"]),
                                    t(ref[f"{name}_k9_oterm"]))
    # CPU: plain version
    assert K.launch_counts()["stream_closest_hit"] == before
    n = W * H
    assert np.isfinite(ref[f"{name}_k9_t"]).sum() > 1500
    bits_equal(tt[:n], ref[f"{name}_k9_t"], "t")
    bits_equal(face[:n], ref[f"{name}_k9_face"], "face")


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_stream_schedule_matches_jax(refs, scenes, name):
    """The port's glue for K9: mask words, the batch rows with their
    union, the entry bounds, the stable word order and the root exits."""
    ref = refs(name)
    data = scenes[name]
    origin = t(ref[f"{name}_origin"])
    rays = [P._pad1(t(v), 8 * 1024) for v in ref[f"{name}_rays"]]
    bounds = tile_ray_bounds(*origin, *rays, 1024)
    mask, nw = P._mask_words(data, "cull", bounds, 32)
    bits_equal(mask, ref[f"{name}_k9_mask"], "mask")
    got = P._stream_inputs(data, mask, nw, bounds, *origin, *rays)
    for k, v in zip(SCHED, got):
        bits_equal(v, ref[f"{name}_k9_{k}"], k)
    bits_equal(SP.stream_pack(data), ref[f"{name}_spack"], "spack")


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_gbuffer_streamed_matches_jax(refs, scenes, name):
    ref = refs(name)
    stream = CASES[name][1]
    data = scenes[name]
    gb, sph = P.gbuffer(data, t(ref[f"{name}_origin"]),
                        *(t(v) for v in ref[f"{name}_rays"]), stream=stream)
    assert sph is None  # the streamed sweep fuses no spheres
    for k in GB:
        bits_equal(getattr(gb, k), ref[f"{name}_k9_{k}"], k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_stream_closest_hit_perray_matches_jax(refs, scenes, name):
    """K10 on JAX's schedule, then the port's whole streamed glue
    (per-ray word refinement, schedule, K10, expand) for every plane."""
    ref = refs(name)
    o, d, _, _ = bounce_tensors()
    op = [P._pad1(v, 8 * 1024) for v in o]
    dp = [P._pad1(v, 8 * 1024) for v in d]
    args = [t(ref[f"{name}_k10_{k}"]) for k in SCHED]
    tt, face = K.stream_closest_hit_perray(*args[:3], *dp, *op, args[3],
                                           t(ref[f"{name}_spack"]))
    assert np.isfinite(ref[f"{name}_k10_t"]).sum() > 300
    bits_equal(tt[:N_BOUNCE], ref[f"{name}_k10_t"], "kernel t")
    bits_equal(face[:N_BOUNCE], ref[f"{name}_k10_face"], "kernel face")
    gb = P.gbuffer_perray(scenes[name], *o, *d, stream=CASES[name][1])
    for k in GB:
        bits_equal(getattr(gb, k), ref[f"{name}_k10_{k}"], k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_stream_anyhit_matches_jax(refs, scenes, name):
    ref = refs(name)
    o, _, sd, act = bounce_tensors()
    op = [P._pad1(v, 8 * 1024) for v in o]
    sdp = [P._pad1(v, 8 * 1024) for v in sd]
    actp = P._pad1(act.to(torch.float32), 8 * 1024)
    args = [t(ref[f"{name}_k11_{k}"]) for k in SCHED]
    occ = K.stream_anyhit(*args[:3], *sdp, *op, actp, args[3],
                          t(ref[f"{name}_spack"]))
    want = ref[f"{name}_k11_occ"]
    assert want.sum() > 100 and (~want & act.numpy()).sum() > 100
    np.testing.assert_array_equal(occ[:N_BOUNCE].numpy() > 0, want)
    got = P.anyhit_rays(scenes[name], *o, *sd, act, stream=CASES[name][1])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_stream_schedules_of_the_wavefronts_match_jax(refs, scenes, name):
    """The per-ray superblock admission and the K10/K11 schedules the
    port's glue builds from the bounce wavefront."""
    ref = refs(name)
    data = scenes[name]
    o, d, sd, act = bounce_tensors()
    op = [P._pad1(v, 8 * 1024) for v in o]
    dp = [P._pad1(v, 8 * 1024) for v in d]
    sdp = [P._pad1(v, 8 * 1024) for v in sd]
    live = (dp[0] != 0.0) | (dp[1] != 0.0) | (dp[2] != 0.0)
    bounds = tile_ray_bounds(*op, *dp, 1024, live)
    mask, nw = P._mask_words(data, "cull", bounds, 32)
    slo, shi = SP.super_boxes(data)
    assert slo.shape[0] == nw
    sup_ok = perray_super_any(slo, shi, *op, *dp, 1024, act=live)
    bits_equal(sup_ok, ref[f"{name}_sup_ok"], "sup_ok")
    mask = torch.where(sup_ok.reshape(-1), mask, 0)
    for k, v in zip(SCHED, P._stream_inputs(data, mask, nw, bounds, *op,
                                            *dp)):
        bits_equal(v, ref[f"{name}_k10_{k}"], f"k10 {k}")
    actp = P._pad1(act.to(torch.float32), 8 * 1024) > 0
    bounds = tile_ray_bounds(*op, *sdp, 1024, actp)
    mask, nw = P._mask_words(data, "cull", bounds, 32)
    for k, v in zip(SCHED, P._stream_inputs(data, mask, nw, bounds, *op,
                                            *sdp)):
        bits_equal(v, ref[f"{name}_k11_{k}"], f"k11 {k}")


def test_bounce_sort_and_reordered_anyhit_match_jax(refs, scenes):
    ref = refs("t92")
    data = scenes["t92"]
    o, d, sd, act = bounce_tensors()
    bits_equal(P._origin_morton(data, *o).to(torch.int32),
               ref["t92_morton"].astype(np.int32), "morton")
    perm = P._bounce_sort_perm(data, *o, *d)
    np.testing.assert_array_equal(perm.numpy(), ref["t92_bounce_perm"])
    # the key keeps 32 bits: parked rays (clipped to the last cell) tie,
    # and the stable sort keeps them in ray order
    parked = (d[0] == 0) & (d[1] == 0) & (d[2] == 0)
    tail = perm[-int(parked.sum()):]
    assert bool(parked[tail].all()) and bool((tail[1:] > tail[:-1]).all())
    got = P.anyhit_reordered(data, *o, *sd, act)
    np.testing.assert_array_equal(got.numpy(), ref["t92_k11_reordered"])
    np.testing.assert_array_equal(got.numpy(), ref["t92_k11_occ"])


@pytest.mark.parametrize("name", ["t23", "t46"])
def test_streamed_equals_on_chip_sweeps(scenes, name):
    """Port invariant: on a scene both paths take, the streamed sweeps
    (K9, K10, K11) give the all-on-chip ones' (K1, K7, K3) results."""
    data = scenes[name]
    cfg = scene_config(CASES[name][0])
    uni = Camera.from_config(cfg.camera, W / H).uniforms()
    origin = t(uni.origin)
    rays = P.raygen_planar(W, H, uni, device="cpu")
    a, _ = P.gbuffer(data, origin, *rays, stream=True)
    b, _ = P.gbuffer(data, origin, *rays, stream=False, with_spheres=False)
    for k in GB:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    o, d, sd, act = bounce_tensors()
    a = P.gbuffer_perray(data, *o, *d, stream=True)
    b = P.gbuffer_perray(data, *o, *d, stream=False)
    for k in GB:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    occ_s = P.anyhit_rays(data, *o, *sd, act, stream=True)
    occ_v = P.anyhit_rays(data, *o, *sd, act, stream=False)
    assert bool(occ_v.any()) and torch.equal(occ_s, occ_v)


def test_streamed_extend_shadow_equals_split_sweeps(scenes):
    """extend_shadow_rays past STREAM_FACES: the reordered pair of
    streamed sweeps (one sort, one scatter back) gives each ray the
    results of the two unsorted sweeps."""
    data = scenes["t92"]
    o, d, sd, act = bounce_tensors()
    hit = act & ((d[0] != 0) | (d[1] != 0) | (d[2] != 0))
    calls = {}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return call
    ks = K.KernelSet(*(counted(f.__name__, p)
                       for f, p in zip(K.KERNELS, K.PLAIN)))
    gb, occ = P.extend_shadow_rays(data, *o, *d, *o, *sd, hit, kernels=ks)
    assert calls == {"super_any": 1, "stream_closest_hit_perray": 1,
                     "stream_anyhit": 1, "sweep_front": 2}
    want = P.gbuffer_perray(data, *o, *d)
    for k in GB:
        assert torch.equal(getattr(gb, k), getattr(want, k)), k
    assert torch.equal(occ, P.anyhit_rays(data, *o, *sd, hit))


def test_streamed_record_carries_from_jax(refs, scenes):
    """Scene.build's host record past STREAM_FACES is the JAX one."""
    ref = refs("t92")
    bits_equal(scenes["t92"].spack, ref["t92_spack"], "spack")
    assert scenes["t23"].spack.shape == (0, 128)


def gpu_case(name, device):
    cfg = scene_config(CASES[name][0])
    data = Scene.build(cfg).data.to(device)
    uni = Camera.from_config(cfg.camera, W / H).uniforms()
    return data, torch.as_tensor(uni.origin, device=device), \
        P.raygen_planar(W, H, uni, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_stream_kernels_cuda_match_plain(name, cuda_device):
    """K9, K10 and K11 on the card against their plain versions on the
    glue's own inputs: every output equal by value."""
    data, origin, rays = gpu_case(name, cuda_device)
    calls = {}

    def capture(fn):
        def call(*a, **kw):
            calls[fn.__name__] = (a, kw)
            return fn(*a, **kw)
        return call
    ks = K.KernelSet(*(capture(f) for f in K.KERNELS))
    stream = CASES[name][1]
    P.gbuffer(data, origin, *rays, stream=stream, kernels=ks)
    o, d, sd, act = bounce_tensors()
    o, d, sd = ([v.to(cuda_device) for v in x] for x in (o, d, sd))
    P.gbuffer_perray(data, *o, *d, stream=stream, kernels=ks)
    P.anyhit_rays(data, *o, *sd, act.to(cuda_device), stream=stream,
                  kernels=ks)
    for fn, plain in ((K.stream_closest_hit, K.stream_closest_hit_plain),
                      (K.stream_closest_hit_perray,
                       K.stream_closest_hit_perray_plain),
                      (K.stream_anyhit, K.stream_anyhit_plain)):
        a, kw = calls[fn.__name__]
        before = K.launch_counts()[fn.__name__]
        got = fn(*a, **kw)
        torch.cuda.synchronize()
        assert K.launch_counts()[fn.__name__] == before + 1
        want = plain(*a, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for x, y in zip(got, want):
            assert torch.equal(x, y), fn.__name__


def test_streamed_glue_hands_k9_and_k11_their_boxes(scenes):
    """gbuffer's streamed branch hands K9 the camera origin and the
    32-face blocks' boxes, anyhit_rays' streamed branch hands K11 the
    boxes; the plain versions ignore them (the same values as without)."""
    data = scenes["t92"]
    cfg = scene_config(92)
    uni = Camera.from_config(cfg.camera, W / H).uniforms()
    origin = t(uni.origin)
    calls = {}

    def capture(fn):
        def call(*a, **kw):
            calls[fn.__name__] = (a, kw)
            return fn(*a, **kw)
        return call
    ks = K.KernelSet(*(capture(p) for p in K.PLAIN))
    P.gbuffer(data, origin, *P.raygen_planar(W, H, uni, device="cpu"),
              kernels=ks)
    o, _, sd, act = bounce_tensors()
    P.anyhit_rays(data, *o, *sd, act, kernels=ks)
    lo, hi = SP.block_boxes(data, 32)
    a9, _ = calls["stream_closest_hit_plain"]
    a11, _ = calls["stream_anyhit_plain"]
    assert torch.equal(a9[9], origin)
    for got in (a9[10:12], a11[12:14]):
        assert torch.equal(got[0], lo) and torch.equal(got[1], hi)
    for got, want in zip(K.stream_closest_hit(*a9),
                         K.stream_closest_hit(*a9[:9])):
        assert torch.equal(got, want)
    assert torch.equal(K.stream_anyhit(*a11), K.stream_anyhit(*a11[:12]))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_stream_split_walks_cuda_match_plain(name, cuda_device,
                                             monkeypatch):
    """K9 and K11 on the card with their walks split into items of 32,
    128, 256 and the default number of blocks (stream_sweep.SEG): every
    output equal to the plain version's."""
    data, origin, rays = gpu_case(name, cuda_device)
    calls = {}

    def capture(fn):
        def call(*a, **kw):
            calls[fn.__name__] = (a, kw)
            return fn(*a, **kw)
        return call
    ks = K.KernelSet(*(capture(f) for f in K.KERNELS))
    stream = CASES[name][1]
    P.gbuffer(data, origin, *rays, stream=stream, kernels=ks)
    o, _, sd, act = bounce_tensors()
    o, sd = ([v.to(cuda_device) for v in x] for x in (o, sd))
    P.anyhit_rays(data, *o, *sd, act.to(cuda_device), stream=stream,
                  kernels=ks)
    for fn, plain in ((K.stream_closest_hit, K.stream_closest_hit_plain),
                      (K.stream_anyhit, K.stream_anyhit_plain)):
        a, kw = calls[fn.__name__]
        want = plain(*a, **kw)
        want = want if isinstance(want, tuple) else (want,)
        for seg in (32, 128, 256, K.stream_sweep.SEG):
            monkeypatch.setattr(K.stream_sweep, "SEG", seg)
            got = fn(*a, **kw)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            for x, y in zip(got, want):
                assert torch.equal(x, y), (fn.__name__, seg)
