"""PyTorch port: kernels.sweep_front (csrc/sweep_front.cu, K13), the culled
sweeps' front end for one ray set, against its plain twin.

CPU: the plain twin (kernels.sweep_front_plain) is the code it replaced,
held to the front end's units (megakernel._mask_words, _vmem_sched and
_stream_inputs, which test_torch_glue and test_torch_stream hold to the
JAX package) on testing/raycull's adversarial ray sets and on a hand
case (signed zeros, parked and zero-direction rays, origins inside
boxes, NaN and infinite padding boxes, block counts that are not whole
words, blocks of other sizes than the clusters); its schedule is a
stable sort; megakernel.sweep_inputs counts "sweep.inputs" once a call
and calls sweep_front once a call on every path of the five benchmark
cells' programs; the wrapper refuses malformed arguments.

Card (marked gpu): the kernel against the plain twin on the same CUDA
tensors, every output bitwise but for the sign of a zero tile bound
(which no consumer reads; sweep_front.py says why), at every
sweep_front call of the five benchmark cells' programs at their sizes
(the camera rays, the shadow rays with act, K8's mask-only pair, the
streamed bounces), on the adversarial sets and the hand case; the
refscene frame's CUDA graph bitwise the eager frame, with one K13
launch a sweep_inputs call.
"""

import dataclasses as dc
import importlib
import os
from unittest import mock

import numpy as np
import pytest
import torch

import rust_wgpu_raytracing_tpu_torch as rt
from rust_wgpu_raytracing_tpu_torch import config as pcfg
from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
from rust_wgpu_raytracing_tpu_torch.core.scene import Scene
from rust_wgpu_raytracing_tpu_torch.ops import instances as pinst
from rust_wgpu_raytracing_tpu_torch.ops import kernels as K
from rust_wgpu_raytracing_tpu_torch.ops import megakernel as P
from rust_wgpu_raytracing_tpu_torch.ops.pathtrace import (PRNGKey,
                                                          render_pathtrace)
from rust_wgpu_raytracing_tpu_torch.ops.traverse import tile_ray_bounds
from rust_wgpu_raytracing_tpu_torch.runtime import profiler
from rust_wgpu_raytracing_tpu_torch.testing.raycull import (
    ADVERSARIAL_KINDS, adversarial_rays, write_grid_mesh)
from test_torch_host import cuda_device, terrain_config  # noqa: F401

# the module (the package's name sweep_front is the wrapper)
SF = importlib.import_module(
    "rust_wgpu_raytracing_tpu_torch.ops.kernels.sweep_front")
TILE = 1024
# raycull.write_grid_mesh cells: 928 faces in 8-face clusters, 5,024 in 32
GRIDS = {"bf8": 16, "bf32": 48}


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------

def bits(x):
    """x as integers: floats by their bits, every NaN as one NaN."""
    if x.dtype == torch.float32:
        x = torch.where(torch.isnan(x), float("nan"), x)
        return x.view(torch.int32)
    return x


def zero_signless(x):
    """A bound's bits with -0.0 taken as +0.0 (x + 0.0)."""
    return bits(x + 0.0)


def same_front(got, want, what=""):
    for name in ("bounds", "mask_bounds"):
        for g, w in zip(getattr(got, name), getattr(want, name)):
            assert torch.equal(zero_signless(g), zero_signless(w)), \
                f"{what} {name}"
    for name in ("words", "tlb", "order", "texit"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), f"{what} {name}"
        if g is not None:
            assert torch.equal(bits(g), bits(w)), f"{what} {name}"


def to(device, x):
    """Tensors in nested tuples and dicts moved to `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (tuple, list)):
        return type(x)(to(device, v) for v in x)
    if isinstance(x, dict):
        return {k: to(device, v) for k, v in x.items()}
    return x


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grid_scenes(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sweep_front"))
    for name, cells in GRIDS.items():
        write_grid_mesh(os.path.join(root, f"{name}.obj"), cells)
    cfgs = {name: pcfg.SceneConfig(
        meshes=(pcfg.MeshConfig(obj_path=f"{name}.obj",
                                light_direction=(0.0, 0.0, -1.0)),),
        render=pcfg.RenderConfig(width=64, height=32)) for name in GRIDS}
    with mock.patch.dict(os.environ, {"RWRT_ASSETS": root}):
        return {name: Scene.build(cfg).data for name, cfg in cfgs.items()}


def adversarial_planes(data, grid, kind, seed=3):
    """raycull's `kind` set on a grid mesh, 2,500 rays (a ragged last
    tile): (o, d, so, sd) lists of (R,) tensors and act (R,) bool."""
    o, d, so, sd, act = adversarial_rays(kind, GRIDS[grid], data.blk_lo,
                                         data.blk_hi, seed, n=2500)
    planes = [[torch.from_numpy(v) for v in x] for x in (o, d, so, sd)]
    return (*planes, torch.from_numpy(act))


# sweep_inputs' paths: (origin, act, act_cull, sched, stream)
PATHS = {
    "camera": ("shared", False, None, True, False),
    "camera_streamed": ("shared", False, None, True, True),
    "perray": ("perray", False, None, True, False),
    "perray_streamed": ("perray", False, None, True, True),
    "shadow": ("perray", True, None, True, False),
    "shadow_act_cull": ("perray", True, True, True, False),
    "shadow_streamed": ("perray", True, None, True, True),
    "k8_words": ("perray", True, True, False, False),
}


def path_args(path, o, d, so, sd, act):
    """(origin, directions, sweep_inputs keywords) of `path` on a ray set:
    an any-hit path takes the shadow rays, a camera the first live ray's
    origin."""
    kind, with_act, act_cull, sched, stream = PATHS[path]
    if with_act:
        o, d = so, sd
    if kind == "shared":
        i = int(torch.nonzero((d[0] != 0) | (d[1] != 0) | (d[2] != 0))[0])
        o = torch.stack([v[i] for v in o])
    return o, d, dict(act=act if with_act else None, act_cull=act_cull,
                      sched=sched, stream=stream)


def hand_case(seed=11, n_clusters=200, cull=8):
    """(o (3, R), d (3, R), act (R,) f32, boxes (lo, hi) (B, 3) as a scene
    holds them, faces): 3 tiles less 100 rays against B random cluster
    boxes of `cull` faces each. Rays: zero directions (parked or with
    the origin inside a box), single zero components, a tile whose x
    directions are all +-0.0 and whose origins' y are all +-0.0 (bounds
    that tie a zero of each sign), signed zero components elsewhere, a
    last tile of a narrow cone; act 0 on a tenth and on all of the
    second tile. Boxes: flat ones,
    padding as NaN, as +inf / -inf and as +inf on both sides, half-open
    ones. B = 200: 6.25 words of 8-face blocks."""
    rng = np.random.default_rng(seed)
    r = 3 * TILE - 100
    c = rng.uniform(-2.0, 2.0, (n_clusters, 3))
    h = rng.uniform(0.0, 0.5, (n_clusters, 3))
    h[rng.uniform(size=(n_clusters, 3)) < 0.1] = 0.0
    lo, hi = c - h, c + h
    pad = rng.integers(0, 4, n_clusters)
    pad[rng.uniform(size=n_clusters) < 0.8] = -1
    lo[pad == 0], hi[pad == 0] = np.nan, np.nan
    lo[pad == 1], hi[pad == 1] = np.inf, -np.inf
    lo[pad == 2], hi[pad == 2] = np.inf, np.inf
    half = np.flatnonzero(pad < 0)[:6]
    hi[half, 1] = np.inf
    lo[half[:3], 0] = -np.inf
    o = rng.uniform(-2.5, 2.5, (r, 3))
    d = rng.normal(size=(r, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    kind = rng.integers(0, 8, r)
    d[kind == 0, rng.integers(0, 3, int((kind == 0).sum()))] = 0.0
    d[kind == 1] = 0.0
    inside = np.flatnonzero(kind == 1)[::2]
    o[inside] = c[rng.integers(0, n_clusters, inside.size)]
    o[kind == 2] = 1e9  # parked
    d[kind == 2] = 0.0
    d[kind == 3, 2] = -0.0
    o[kind == 4, 1] = -0.0
    last = slice(2 * TILE, r)  # the last tile: a narrow cone from z = 3
    o[last] = rng.uniform((-0.2, -0.2, 2.8), (0.2, 0.2, 3.2),
                          (r - 2 * TILE, 3))
    d[last] = rng.normal((0.1, -0.1, -1.0), 0.03, (r - 2 * TILE, 3))
    d[last][::7, 0] = -0.0
    t0 = slice(0, TILE)  # the first tile: zeros of each sign tie
    d[t0, 0] = np.where(rng.uniform(size=TILE) < 0.5, 0.0, -0.0)
    o[t0, 1] = np.where(rng.uniform(size=TILE) < 0.5, 0.0, -0.0)
    act = (rng.uniform(size=r) < 0.9).astype(np.float32)
    act[TILE:2 * TILE] = 0.0
    f32 = [torch.from_numpy(np.ascontiguousarray(v, np.float32))
           for v in (o.T, d.T, lo, hi)]
    return f32[0], f32[1], torch.from_numpy(act), (f32[2], f32[3]), \
        n_clusters * cull


def empty_boxes(lo, hi):
    """The schedule's boxes: a padding cluster empty (+inf, -inf), as
    scenepacks.cluster_boxes makes them."""
    fin = torch.isfinite(lo) & torch.isfinite(hi)
    return torch.where(fin, lo, float("inf")), torch.where(fin, hi,
                                                           -float("inf"))


# the hand case's calls: (origin, gate, mask_gate, words: "flat", "brute",
# "random" or None, sched, root)
HAND = {
    "camera": ("shared", None, None, "flat", True, True),
    "shadow": ("perray", "act", None, "flat", True, True),
    "shadow_act_cull": ("perray", "act", "act", "flat", True, True),
    "streamed_closest": ("perray", "live", "live", "flat", False, True),
    "k8_words": ("perray", "act", "act", "flat", False, False),
    "brute": ("perray", "act", "act", "brute", True, True),
    "given_words": ("shared", None, None, "random", True, True),
    "bounds_only": ("perray", "act", None, None, False, False),
}
# faces a block against the hand case's 8-face clusters
HAND_BLOCKS = (8, 32, 4)


def hand_call(name, block_f, seed=11):
    """(args, kw) of a sweep_front call on the hand case, the rays
    padded to whole tiles as sweep_inputs pads them."""
    origin, gate, mask_gate, words, sched, root = HAND[name]
    o, d, act, boxes, faces = hand_case(seed)
    o, d = ([P._pad1(v, TILE) for v in x] for x in (o, d))
    act = P._pad1(act, TILE)
    n_tiles = d[0].shape[0] // TILE
    nwords = -(-(faces // block_f) // 32)
    kw = dict(gate=gate, mask_gate=mask_gate, faces=faces, block_f=block_f)
    if words == "flat":
        kw["cull_boxes"] = boxes
    elif words == "brute":
        kw["words"] = torch.full((n_tiles * nwords,), -1, dtype=torch.int32)
    elif words == "random":
        g = torch.Generator().manual_seed(seed)
        kw["words"] = torch.randint(-2**31, 2**31 - 1, (n_tiles * nwords,),
                                    generator=g, dtype=torch.int32)
    if sched:
        kw["sched_boxes"] = empty_boxes(*boxes)
    if root:
        blo, bhi = empty_boxes(*boxes)
        kw["root"] = (blo.amin(dim=0), bhi.amax(dim=0))
    po = torch.stack([v[0] for v in o]) if origin == "shared" else tuple(o)
    return (po, *d, act), kw


# ---------------------------------------------------------------------------
# the five benchmark cells' programs, each recording its sweep_front calls
# ---------------------------------------------------------------------------

def recording(kernels, calls):
    """kernels with sweep_front recording each call's (args, kw)."""
    def rec(*a, **kw):
        calls.append((a, kw))
        return kernels.sweep_front(*a, **kw)
    return kernels._replace(sweep_front=rec)


def uni_of(cfg, width, height):
    return Camera.from_config(cfg.camera, width / height).uniforms().flat()


def lit_frame(grid, accel, fused, width, height, device, kernels):
    cfg = terrain_config(pcfg, grid=grid, width=width, height=height,
                         accel=accel)
    if grid > 128:  # the streamed cell's close camera
        cfg = dc.replace(cfg, spheres=(), camera=pcfg.CameraConfig(
            eye=(0.0, -0.4, -1.2), target=(0.0, 0.0, -3.0)))
    data = Scene.build(cfg).data.to(device)
    return P.render_megakernel(data, uni_of(cfg, width, height),
                               width=width, height=height, shadows=True,
                               accel=accel, fused=fused, kernels=kernels)


def pt_sample(grid, bounces, width, height, device, kernels):
    cfg = terrain_config(pcfg, grid=grid, width=width, height=height)
    data = Scene.build(cfg).data.to(device)
    return render_pathtrace(data, uni_of(cfg, width, height), PRNGKey(7),
                            width=width, height=height, bounces=bounces,
                            compact_cap="auto", kernels=kernels)


def instanced_frame(mesh, n, width, height, device, kernels):
    inst = pinst.InstancedScene.from_config(pcfg.MeshConfig(obj_path=mesh),
                                            n, device=device)
    data = inst.instantiate(pinst.grid_transforms(n, z=-6.0, angle=0.3))
    cam = pcfg.CameraConfig(eye=(0.0, 7.0, -2.0), target=(0.0, 0.0, -6.0))
    uni = Camera.from_config(cam, width / height).uniforms().flat()
    return P.render_megakernel(data, uni, width=width, height=height,
                               accel="bvh", fused=False, kernels=kernels)


# name: (program, card arguments at the cell's size, CPU arguments)
PROGRAMS = {
    "refscene_orbit": (lambda *a, **kw: lit_frame(*a[:1], "cull", True,
                                                  *a[1:], **kw),
                       (91, 1920, 1080), (23, 96, 64)),
    "refscene_pt": (pt_sample, (91, 4, 480, 270), (23, 4, 32, 24)),
    "terrain_orbit": (lambda *a, **kw: lit_frame(*a[:1], "bvh", False,
                                                 *a[1:], **kw),
                      (512, 1920, 1080), (92, 48, 32)),
    "terrain_pt": (pt_sample, (512, 3, 960, 540), (92, 2, 24, 16)),
    "instances": (instanced_frame, ("builtin:terrain:23", 64, 3840, 2160),
                  ("builtin:terrain:12", 4, 48, 32)),
}


def program_calls(name, device, kernels, card=True):
    fn, card_args, cpu_args = PROGRAMS[name]
    calls = []
    fn(*(card_args if card else cpu_args), device=device,
       kernels=recording(kernels, calls))
    return calls


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

def units_front(data, o, d, act, act_cull, sched, stream, accel="cull"):
    """What the front end's units make of the padded rays, as
    sweep_inputs composed them before K13: (bounds, words, tlb, order,
    texit), the schedule's rows None on the streamed path."""
    f = data.padded_faces
    bf = 32 if stream else P._natural_block_f(data, f)
    n = TILE * (P.STREAM_BATCH if stream else 1)
    dp = [P._pad1(v, n) for v in d]
    shared = isinstance(o, torch.Tensor)
    op = [o[0], o[1], o[2]] if shared else [P._pad1(v, n) for v in o]
    actp = None if act is None else P._pad1(act.to(torch.float32), n)
    live = None if actp is None else actp > 0
    if actp is None and stream and not shared:
        live = (dp[0] != 0.0) | (dp[1] != 0.0) | (dp[2] != 0.0)
    if act_cull is None:
        act_cull = stream
    bounds = tile_ray_bounds(*op, *dp, TILE, live)
    words, nw = P._mask_words(data, accel, bounds if act_cull or act is None
                              else tile_ray_bounds(*op, *dp, TILE), bf)
    tlb = order = texit = None
    if sched and stream:
        texit = P._stream_inputs(data, words, nw, bounds, *op, *dp)[3]
    elif sched:
        tlb, order, texit = P._vmem_sched(data, words, nw, bounds, *op, *dp,
                                          bf)
    return bounds, words, tlb, order, texit


@pytest.mark.parametrize("kind", ADVERSARIAL_KINDS)
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_plain_front_is_the_replaced_code(grid_scenes, grid, kind):
    """On raycull's adversarial sets, every path's sweep_front_plain call
    (through sweep_inputs) makes the bounds, words, schedule and texit
    the units made."""
    data = grid_scenes[grid]
    o, d, so, sd, act = adversarial_planes(data, grid, kind)
    for path in PATHS:
        origin, dirs, kw = path_args(path, o, d, so, sd, act)
        calls = []
        rs = P.sweep_inputs(data, origin, *dirs,
                            kernels=recording(K.KERNELS, calls), **kw)
        assert len(calls) == 1, path
        fr = K.sweep_front(*calls[0][0], **calls[0][1])
        bounds, words, tlb, order, texit = units_front(
            data, origin, dirs, kw["act"], kw["act_cull"], kw["sched"],
            kw["stream"])
        for g, w in zip(fr.bounds, bounds):
            assert torch.equal(bits(g), bits(w)), path
        for g, w in ((fr.words, words), (fr.tlb, tlb), (fr.order, order),
                     (fr.texit, texit)):
            assert (g is None) == (w is None) and (
                g is None or torch.equal(bits(g), bits(w))), path
        if path != "perray_streamed":  # super_any clears words there
            assert torch.equal(rs.mask, fr.words), path


@pytest.mark.parametrize("block_f", HAND_BLOCKS)
@pytest.mark.parametrize("name", sorted(HAND))
def test_plain_front_on_the_hand_case(name, block_f):
    """The hand case through the plain twin: each output as the units
    compute it (the flat words from traverse.flat_mask_words with its
    regroup, the schedule of the words given or made, the root exit)."""
    a, kw = hand_call(name, block_f)
    fr = K.sweep_front(*a, **kw)
    o, d, act = a[0], a[1:4], a[4]
    op = (o[0], o[1], o[2])
    live = {None: None, "act": act > 0,
            "live": (d[0] != 0) | (d[1] != 0) | (d[2] != 0)}
    bounds = tile_ray_bounds(*op, *d, TILE, live[kw["gate"]])
    mbounds = tile_ray_bounds(*op, *d, TILE, live[kw["mask_gate"]])
    for g, w in zip(fr.bounds + fr.mask_bounds, bounds + mbounds):
        assert torch.equal(bits(g), bits(w))
    words = kw.get("words")
    if "cull_boxes" in kw:
        words = SF.flat_mask_words(*kw["cull_boxes"], mbounds, kw["faces"],
                                   block_f)
        nb = kw["faces"] // block_f
        assert words.shape == (d[0].shape[0] // TILE * (-(-nb // 32)),)
        assert int((words != 0).sum()) > 0
    assert (fr.words is None) == (words is None)
    if words is not None:
        assert torch.equal(fr.words, words)
    if "sched_boxes" in kw:
        tlb, order = SF.tile_schedule(*kw["sched_boxes"], words, bounds,
                                      kw["faces"], block_f)
        assert torch.equal(bits(fr.tlb), bits(tlb))
        assert torch.equal(fr.order, order)
    else:
        assert fr.tlb is None and fr.order is None
    if "root" in kw:
        texit = SF.sweep_root_exit(*kw["root"], *op, *d)
        assert torch.equal(bits(fr.texit), bits(texit))
        assert (fr.texit[(d[0] == 0) & (d[1] == 0) & (d[2] == 0)]
                == -1.0).all()
    else:
        assert fr.texit is None


@pytest.mark.parametrize("block_f", HAND_BLOCKS)
def test_schedule_is_a_stable_sort(block_f):
    """Each tile's order is a permutation of its blocks, non-decreasing in
    tlb, equal bounds (the culled blocks' +inf among them) in block
    order; tlb is +inf where the words clear a block."""
    a, kw = hand_call("shadow_act_cull", block_f)
    fr = K.sweep_front(*a, **kw)
    n_tiles, nb = fr.tlb.shape
    order = fr.order.long()
    assert torch.equal(order.sort(dim=1).values,
                       torch.arange(nb).expand(n_tiles, nb))
    t = fr.tlb.gather(1, order)
    assert (t[:, 1:] >= t[:, :-1]).all()
    tie = t[:, 1:] == t[:, :-1]
    assert (order[:, 1:][tie] > order[:, :-1][tie]).all()
    w = fr.words.view(n_tiles, -1)
    c = torch.arange(nb)
    cleared = ((w[:, c >> 5] >> (c & 31)) & 1) == 0
    assert (fr.tlb[cleared] == float("inf")).all()
    assert cleared.any() and torch.isfinite(fr.tlb).any()


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_one_front_call_a_sweep_inputs_call(name, monkeypatch):
    """Every benchmark cell's program (small, on the CPU) calls
    sweep_front once a sweep_inputs call, and sweep_inputs counts
    "sweep.inputs" once a call."""
    if name == "instances":  # a streamed soup at 4 small instances
        monkeypatch.setattr(pinst, "STREAM_FACES", 512)
        monkeypatch.setattr(P, "STREAM_FACES", 512)
    entered = []
    real = P.sweep_inputs

    def counted(*a, **kw):
        entered.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(P, "sweep_inputs", counted)
    if name == "refscene_orbit":  # the fused frame imports it by name
        fused = importlib.import_module(
            "rust_wgpu_raytracing_tpu_torch.ops.fusedframe")
        monkeypatch.setattr(fused, "sweep_inputs", counted)
    before = profiler.counters().get("sweep.inputs", 0)
    calls = program_calls(name, "cpu", K.KERNELS, card=False)
    n = profiler.counters().get("sweep.inputs", 0) - before
    assert n == len(entered) == len(calls) > 0
    if name in ("refscene_orbit", "terrain_orbit"):
        assert n == 2  # the camera rays and the shadow rays


@pytest.mark.parametrize("bad", [
    "ragged_rays", "origin_shape", "act_dtype", "gate", "act_missing",
    "both_words", "sched_without_words", "words_shape", "blocks",
    "root_shape"])
def test_wrapper_refuses_malformed_arguments(bad):
    a, kw = hand_call("shadow", 8)
    a = list(a)
    err = ValueError
    if bad == "ragged_rays":
        a[1:4] = [v[:-1] for v in a[1:4]]
    elif bad == "origin_shape":
        a[0] = torch.zeros(4)
    elif bad == "act_dtype":
        a[4], err = a[4] > 0, TypeError
    elif bad == "gate":
        kw["gate"] = "alive"
    elif bad == "act_missing":
        a[4] = None
    elif bad == "both_words":
        kw["words"] = torch.zeros(3 * 7, dtype=torch.int32)
    elif bad == "sched_without_words":
        del kw["cull_boxes"]
    elif bad == "words_shape":
        del kw["cull_boxes"]
        kw["words"] = torch.zeros(5, dtype=torch.int32)
    elif bad == "blocks":
        kw["block_f"] = 12
    elif bad == "root_shape":
        kw["root"] = (torch.zeros(4), torch.zeros(3))
    with pytest.raises(err):
        K.sweep_front(*a, **kw)


def test_counts_no_launch_on_the_cpu():
    a, kw = hand_call("camera", 8)
    before = K.launch_counts()["sweep_front"]
    K.sweep_front(*a, **kw)
    assert K.launch_counts()["sweep_front"] == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def kernel_is_plain(calls, what):
    """Each recorded call again through the kernel (one launch) and the
    plain twin, on the same CUDA tensors."""
    assert calls, what
    for i, (a, kw) in enumerate(calls):
        before = K.launch_counts()["sweep_front"]
        got = K.sweep_front(*a, **kw)
        torch.cuda.synchronize()
        assert K.launch_counts()["sweep_front"] == before + 1
        same_front(got, K.sweep_front_plain(*a, **kw), f"{what} call {i}")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_kernel_is_plain_on_the_cells_programs(cuda_device, name):
    """Every sweep_front call of each benchmark cell's program at its
    size: the fused 1080p frame with shadows of terrain:91, its 4-bounce
    PT sample (K8's mask-only pairs), the 1080p bvh frame of terrain:512
    and its 3-bounce 540p sample (the streamed bounces), the 4K frame of
    64 refit instances."""
    kernel_is_plain(program_calls(name, cuda_device, K.KERNELS), name)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ADVERSARIAL_KINDS)
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_kernel_is_plain_on_adversarial_rays(cuda_device, grid_scenes, grid,
                                             kind):
    data = grid_scenes[grid].to(cuda_device)
    o, d, so, sd, act = to(cuda_device, adversarial_planes(
        grid_scenes[grid], grid, kind))
    calls = []
    for path in PATHS:
        origin, dirs, kw = path_args(path, o, d, so, sd, act)
        for accel in ("cull", "brute", "bvh"):
            P.sweep_inputs(data, origin, *dirs, accel=accel,
                           kernels=recording(K.KERNELS, calls), **kw)
    kernel_is_plain(calls, f"{grid} {kind}")


@pytest.mark.gpu
@pytest.mark.parametrize("block_f", HAND_BLOCKS)
@pytest.mark.parametrize("name", sorted(HAND))
def test_kernel_is_plain_on_the_hand_case(cuda_device, name, block_f):
    a, kw = to(cuda_device, hand_call(name, block_f))
    kernel_is_plain([(a, kw)], f"{name} {block_f}")


@pytest.mark.gpu
def test_refscene_graph_is_eager_with_one_launch_a_ray_set(cuda_device):
    """The refscene orbit's fused 1080p frame with shadows through the
    Renderer: the eager and capture frames launch K13 once a
    sweep_inputs call (2 a frame), replays launch nothing on the host,
    and every replayed frame is bitwise the eager frame."""
    cfg = terrain_config(pcfg, grid=91, width=1920, height=1080)
    cfg = dc.replace(cfg, render=dc.replace(cfg.render, variant="fused"))
    r = rt.Renderer(cfg, device="cuda")
    c = profiler.counters()
    l0, s0 = c.get("launches.sweep_front", 0), c.get("sweep.inputs", 0)
    r.controller.process_key("d", True)
    for step in range(6):
        r.update()
        frame = r.render()
        rc = r.config.render
        want = P.render_megakernel(
            r.data, r.camera.uniforms().flat(), width=r.width,
            height=r.height, near=rc.kernel_near, far=rc.kernel_far,
            background=tuple(r.config.background), shadows=True,
            quantize=rc.quantize_rgba8, accel=rc.accel, fused=True)
        assert all(torch.equal(bits(x), bits(y))
                   for x, y in zip(frame, want)), step
    c = profiler.counters()
    launches = c.get("launches.sweep_front", 0) - l0
    inputs = c.get("sweep.inputs", 0) - s0
    # 6 eager reference frames, the Renderer's eager and capture frames
    assert inputs == 2 * (6 + 2) and launches == inputs
    assert c.get("frame.graph_replays", 0) >= 4
