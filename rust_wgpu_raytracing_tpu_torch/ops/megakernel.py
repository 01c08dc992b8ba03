"""The frame program: PyTorch glue around the CUDA kernels.

Counterpart of the JAX package's ops/megakernel.py. render_megakernel
draws the split frame here (fused=False) and dispatches to
ops/fusedframe.render_frame_fused where the JAX package does (fused=None
on an eligible scene). Each function keeps its JAX name (the kernel
launch sites are `gbuffer` for JAX's gbuffer_pallas, `gbuffer_perray`
for gbuffer_perray_pallas, `extend_shadow_rays` for
extend_shadow_pallas, `anyhit_rays` for anyhit_pallas,
`kernels.texshade` for _texshade_pallas and `sample_packed_texture`'s
`kernels.texfilter` for _texfilter_pallas; `_mask_words` runs the
LBVH-cut cull of accel="bvh", ops/hier_cull.py). Everything per ray is
planar: separate (R,) tensors per component, rays ordered by 32x32
screen tiles so that each 1024-ray schedule tile is a compact screen
block. Every culled sweep takes its ray set's padded planes, mask words
and schedule from one front end, sweep_inputs (its ray work one launch
of kernel K13, kernels.sweep_front), and the scene's constant tensors
from ops/scenepacks.py.

Meshes above STREAM_FACES faces take the streamed branch of gbuffer,
gbuffer_perray and anyhit_rays (stream=None decides as JAX's
_should_stream does): rays pad to batches of STREAM_BATCH tiles, the
mask words cover one 1024-face superblock each, and the sweep kernels
K9-K11 walk each batch's words front to back (_stream_inputs). The
shadow wavefronts of such scenes are re-tiled by origin Morton code
(anyhit_reordered), and the path tracer's bounce wavefront by origin
Morton code and direction octant (_bounce_sort_perm) before its
closest hit and shadow rays take two streamed sweeps.

Float semantics. Every expression keeps the JAX operation order, and
every product and sum rounds on its own (no fused multiply-add; the
kernels are compiled with -fmad=false). Where the JAX code divides by
a compile-time constant, XLA's algebraic simplifier multiplies by the
constant's f32 reciprocal instead; the port writes that multiply out
(`_rcp`), so the rays, masks and schedules are bit-identical to the
JAX package's under the same rounding rules. Squares are written as
products (XLA lowers `x ** 2` to `x * x`); the Blinn-Phong `hdotn **
32.0` stays torch's pow, within 1 ulp of XLA's, with its denormal
results flushed to zero as XLA and the TPU flush them (rounding.ftz).

Memory: JAX fuses the flat scan into one XLA loop; in the plain twin
its (tiles, clusters, 3) temporaries would take GBs at 1080p past 500k
faces, so traverse.flat_mask_words scans a chunk of tiles at a time (the
words are the same); K13 holds none.

mip=True (RenderConfig.mip) shades the split frame's mesh pass from the
texture pyramid (ops/miptex.py): a ray-cone LOD and two taps of the
pyramid pool, each through the texture filter kernel K6, in place of
the one-gather texshade kernel (K2); the fused frame does not take it.

Row slabs and gp staging (row0, total_height, emit_shadow_planes) serve
parallel/. The one-hot matrix-unit winner fetch of expand_tf_gbuffer is
a TPU device that yields the same values as the plain gather used here.
Not ported (see ROADMAP.md): the JAX package's opt-in mask and gather
switches RT_AH_PERRAY, RT_PT_KREFINE and RT_TEX_ROW_GATHER (all off by
default there, none changing an output bit). On the H100 each one was
slower than its default or within the run-to-run spread (PERF.md), so the
port keeps the default paths only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.camera import CameraUniforms
from ..core.scene import (GP_C1, GP_C2, GP_G1, GP_G2, GP_INVD, GP_MAT,
                          GP_N, GP_TAN, GP_UN, GP_UV, GP_VN, STREAM_FACES,
                          SUPER_F, SceneData)
from ..runtime.profiler import count, span
from .composite import to_nonlinear_depth
from .hier_cull import hier_cull_fits, hier_cull_words
from .rounding import ftz, sqrt
from .kernels import KERNELS, KernelSet
from .kernels.common import TILE_R
from .scenepacks import (block_boxes, cluster_boxes, pack_face_columns,
                         pack_plane_consts, stream_pack, super_boxes,
                         winner_table)
from .shade import quantize_rgba8
from .traverse import (flat_mask_words, slab_interval_entry,
                       sweep_root_exit, tile_schedule)

F32_INF = float("inf")
BLOCK_F = 32
# subtiles of 1024 rays per streamed batch (JAX STREAM_BATCH, its
# RT_STREAM_BATCH default; the variable sizes the Pallas grid's batch, a
# TPU measurement knob, and is not read here): they share one order row
# and stop row
STREAM_BATCH = 8


def _rcp(c) -> float:
    """The f32 reciprocal XLA substitutes for a division by constant c."""
    return float(np.float32(1.0) / np.float32(c))


def _f32(c) -> float:
    """A Python constant as the f32 value JAX's weak typing gives it."""
    return float(np.float32(c))


class GBuffer(NamedTuple):
    """Planar per-ray intersection + shading inputs, all (R,)."""

    t: torch.Tensor
    face: torch.Tensor  # i32, 0 on miss
    u: torch.Tensor  # normalized barycentric (corner 0 weight)
    v: torch.Tensor
    nd: torch.Tensor  # N.D at winner (sign decides normal flip)
    uvx: torch.Tensor  # interpolated texture coords (pre-V-flip)
    uvy: torch.Tensor
    nx: torch.Tensor  # unit geometric normal, NOT yet flipped
    ny: torch.Tensor
    nz: torch.Tensor
    mat: torch.Tensor  # material id as f32
    # normal-mapping extras (None until gather_nm_planes fills them)
    vnx: Optional[torch.Tensor] = None  # interpolated vertex normal
    vny: Optional[torch.Tensor] = None
    vnz: Optional[torch.Tensor] = None
    tx: Optional[torch.Tensor] = None  # per-face tangent
    ty: Optional[torch.Tensor] = None
    tz: Optional[torch.Tensor] = None
    bx: Optional[torch.Tensor] = None  # per-face bitangent
    by: Optional[torch.Tensor] = None
    bz: Optional[torch.Tensor] = None


def pack_origin_cols(scene: SceneData, origin: torch.Tensor) -> torch.Tensor:
    """(F, 8) f32 per-frame origin terms for shared-origin rays:
    cols [t_num, hc0, hc1, hc2, 0...] with t_num = -(N.O + d),
    hc_i = O.g_i - c_i. The 3-term dots are summed in index order, as
    XLA's f32 dot computes them."""
    o0, o1, o2 = origin[0], origin[1], origin[2]
    n = scene.tri_n
    t_num = -(n[:, 0] * o0 + n[:, 1] * o1 + n[:, 2] * o2 + scene.tri_d)
    g = scene.tri_g
    hc = g[:, :, 0] * o0 + g[:, :, 1] * o1 + g[:, :, 2] * o2 - scene.tri_c
    f = t_num.shape[0]
    return torch.cat([t_num[:, None], hc,
                      torch.zeros((f, 4), dtype=torch.float32,
                                  device=n.device)], dim=1)


def expand_tf_gbuffer(scene: SceneData, t, face, dx, dy, dz,
                      oterm=None, oxyz=None) -> GBuffer:
    """Resolve the G-buffer from the sweep's (t, face): ONE gather of the
    winner faces' gpack columns (scenepacks.winner_table: the scene's
    table, or one derived from the streaming record where it is stale),
    then h1/h2/ndotd and the shading attributes recomputed with the
    kernels' own expressions on the winner's values. Shared-origin rays
    pass the frame's exact origin-term floats `oterm`; per-ray-origin
    rays (bounces) pass oxyz=(ox, oy, oz), and the origin terms are
    recomputed per ray as the per-ray sweep computes them. Miss rays
    (t == inf) zero every attribute."""
    gp = winner_table(scene)
    idx = face.clamp(0, gp.shape[1] - 1).long()
    a = gp.index_select(1, idx)  # (GPACK_ROWS, R)
    hit = torch.isfinite(t)

    def m(x):
        return torch.where(hit, x, 0.0)

    ts = torch.where(hit, t, 0.0)
    nd = a[GP_N] * dx + a[GP_N + 1] * dy + a[GP_N + 2] * dz
    g1d = a[GP_G1] * dx + a[GP_G1 + 1] * dy + a[GP_G1 + 2] * dz
    g2d = a[GP_G2] * dx + a[GP_G2 + 1] * dy + a[GP_G2 + 2] * dz
    if oxyz is not None:  # per-ray origins: _chp_block_tv's h-planes
        ox, oy, oz = oxyz
        o1 = (a[GP_G1] * ox + a[GP_G1 + 1] * oy + a[GP_G1 + 2] * oz
              - a[GP_C1])
        o2 = (a[GP_G2] * ox + a[GP_G2 + 1] * oy + a[GP_G2 + 2] * oz
              - a[GP_C2])
    else:
        og = oterm[:, 2:4].index_select(0, idx)
        o1, o2 = og[:, 0], og[:, 1]
    h1 = o1 + ts * g1d
    h2 = o2 + ts * g2d

    u_n = h1 * a[GP_INVD]
    v_n = h2 * a[GP_INVD]
    w_n = 1.0 - u_n - v_n
    uvx = u_n * a[GP_UV] + v_n * a[GP_UV + 2] + w_n * a[GP_UV + 4]
    uvy = u_n * a[GP_UV + 1] + v_n * a[GP_UV + 3] + w_n * a[GP_UV + 5]
    return GBuffer(t=t, face=face, u=m(u_n), v=m(v_n), nd=m(nd),
                   uvx=m(uvx), uvy=m(uvy), nx=m(a[GP_UN]),
                   ny=m(a[GP_UN + 1]), nz=m(a[GP_UN + 2]), mat=m(a[GP_MAT]))


def gather_nm_planes(scene: SceneData, gb: GBuffer) -> GBuffer:
    """`gb` with its normal-mapping planes (the JAX package's G-buffer
    with with_nm=True, bit for bit): each winner's vertex normals
    interpolated with its weights gb.u, gb.v and 1 - u - v, and its
    face's tangent frame, from ONE gather of the winners' vertex-normal
    and tangent columns of the table (rows GP_VN to GP_TAN + 5). Miss
    rays get zero planes."""
    cols = winner_table(scene)[GP_VN:GP_TAN + 6]
    a = cols.index_select(1, gb.face.clamp(0, cols.shape[1] - 1).long())
    hit = torch.isfinite(gb.t)
    w = 1.0 - gb.u - gb.v
    nm = {}
    for ax, (vk, tk, bk) in enumerate(
            zip(("vnx", "vny", "vnz"), ("tx", "ty", "tz"),
                ("bx", "by", "bz"))):
        nm[vk] = torch.where(hit, gb.u * a[ax] + gb.v * a[3 + ax]
                             + w * a[6 + ax], 0.0)
        nm[tk] = torch.where(hit, a[9 + ax], 0.0)
        nm[bk] = torch.where(hit, a[12 + ax], 0.0)
    return gb._replace(**nm)


def _pad1(x, tile, fill=0.0):
    pad = (-x.shape[0]) % tile
    if pad:
        x = torch.cat([x, torch.full((pad,), fill, dtype=x.dtype,
                                     device=x.device)])
    return x


def _vmem_sched(scene: SceneData, mask, nwords: int, bounds, ox, oy, oz,
                dx, dy, dz, block_f: int):
    """Front-to-back schedule for the sweep kernels from the tiles' ray
    bounds (tile_ray_bounds; JAX _vmem_sched computes them itself).

    Returns (tlb (T, nb) f32, order (T, nb) i32, texit (R,) f32):
    traverse.tile_schedule over the cluster boxes with padding clusters
    empty (scenepacks.cluster_boxes) and the per-ray root-exit cap. (The
    JAX version returns tlb/order as (T, 1, nb).)"""
    blo, bhi, lo, hi = cluster_boxes(scene)
    tlb, order = tile_schedule(blo, bhi, mask, bounds, scene.padded_faces,
                               block_f)
    return tlb, order, sweep_root_exit(lo, hi, ox, oy, oz, dx, dy, dz)


def _natural_block_f(scene: SceneData, f: int) -> int:
    """The scene's own cull-cluster granularity (8 for small scenes, 32
    past SMALL_CLUSTER_FACES): the kernels' face-block size."""
    nbc = scene.blk_lo.shape[0]
    if nbc and f % nbc == 0:
        return max(1, f // nbc)
    return min(BLOCK_F, f)


def _should_stream(f: int, block_f: int) -> bool:
    """JAX _should_stream: meshes above STREAM_FACES (padded to whole
    superblocks) at the 32-face block take the streamed sweeps."""
    return f > STREAM_FACES and f % SUPER_F == 0 and block_f == BLOCK_F


def _stream_rows(scene: SceneData, mask, nwords: int, bounds):
    """The streamed sweeps' schedule over padded rays from the tiles' ray
    bounds (JAX _stream_mask_spec's data and _stream_sched): mask3 (NB,
    nsub+1, S) each batch's subtile mask rows, row nsub their union;
    order2 (NB, S) the batch's words by tlb3's row nsub (stable, as
    jnp.argsort); tlb3 (NB, nsub+1, S) per-(subtile, word) entry-t lower
    bounds (+inf for an empty word), row nsub the batch minimum."""
    slo, shi = super_boxes(scene)
    omin, omax, dmin, dmax = bounds
    n_tiles, n_super, nsub = omin.shape[0], slo.shape[0], STREAM_BATCH
    if nwords != n_super:
        raise ValueError(f"{nwords} mask words per tile for {n_super} "
                         f"superblocks")
    g = mask.reshape(n_tiles // nsub, nsub, nwords)
    union = g[:, 0, :]
    for k in range(1, nsub):
        union = union | g[:, k, :]
    mask3 = torch.cat([g, union[:, None, :]], dim=1).contiguous()

    a = slo[None, :, :] - omax[:, None, :]  # (T,S,3)
    b = shi[None, :, :] - omin[:, None, :]
    _, t0 = slab_interval_entry(a, b, dmin[:, None, :], dmax[:, None, :])
    tlb = torch.where(mask.reshape(n_tiles, n_super) != 0, t0, F32_INF)
    g = tlb.reshape(n_tiles // nsub, nsub, n_super)
    tmin = g.amin(dim=1)
    tlb3 = torch.cat([g, tmin[:, None, :]], dim=1)
    order2 = torch.argsort(tmin, dim=1, stable=True).to(torch.int32)
    return mask3, order2.contiguous(), tlb3.contiguous()


def _stream_inputs(scene: SceneData, mask, nwords: int, bounds, ox, oy, oz,
                   dx, dy, dz):
    """_stream_rows' (mask3, order2, tlb3), then texit (R,): the
    root-exit cap, -1 for zero directions."""
    _, _, lo, hi = cluster_boxes(scene)
    return (*_stream_rows(scene, mask, nwords, bounds),
            sweep_root_exit(lo, hi, ox, oy, oz, dx, dy, dz))


def _hier_cull_runs(scene: SceneData, accel: str, nb: int) -> bool:
    """Whether the words come from K5: accel="bvh" where the JAX package
    runs it (the cluster table matches the blocks and hier_cull_fits)."""
    if accel not in ("brute", "cull", "bvh"):
        raise ValueError(f"unknown accel {accel!r}")
    return accel == "bvh" and scene.blk_lo.shape[0] == nb and \
        hier_cull_fits(nb)


def _mask_words(scene: SceneData, accel: str, bounds, block_f: int,
                kernels: KernelSet = KERNELS):
    """Packed per-(tile, block) activity words from the tiles' ray
    bounds (tile_ray_bounds; JAX _mask_words computes them itself):
    "brute" sets every bit, "cull" runs the flat interval scan
    (traverse.flat_mask_words), "bvh" the two-level LBVH-cut cull
    (kernel K5) where _hier_cull_runs and the flat scan elsewhere. All
    are conservative, so the frame is bit-identical across them."""
    f = scene.padded_faces
    n_tiles = bounds[0].shape[0]
    nb = f // block_f
    nwords = -(-nb // 32)
    if accel == "brute":
        return torch.full((n_tiles * nwords,), -1, dtype=torch.int32,
                          device=bounds[0].device), nwords
    if _hier_cull_runs(scene, accel, nb):
        words = hier_cull_words(scene.blk_lo, scene.blk_hi, *bounds,
                                nwords=nwords, kernels=kernels)
        return words.reshape(-1), nwords
    return flat_mask_words(scene.blk_lo, scene.blk_hi, bounds, f,
                           block_f), nwords


class SweepInputs(NamedTuple):
    """A ray set made ready for a sweep kernel (sweep_inputs)."""

    stream: bool  # the streamed sweeps (K9-K11), else the all-on-chip ones
    block_f: int  # faces a block
    planes: tuple  # padded (dx, dy, dz), then (ox, oy, oz) if per ray
    act: Optional[torch.Tensor]  # the padded activity as f32, or None
    mask: torch.Tensor  # packed per-(tile, block) activity words
    nwords: int  # words a tile
    # the schedule, _vmem_sched's (tlb, order) or _stream_inputs' (mask3,
    # order2, tlb3), then its texit; () and None with sched=False
    sched: tuple
    texit: Optional[torch.Tensor]
    boxes: tuple  # the face blocks' (lo, hi), scenepacks.block_boxes


def sweep_inputs(scene: SceneData, o, dx, dy, dz, *, act=None,
                 act_cull: Optional[bool] = None, sched: bool = True,
                 accel: str = "cull", stream: Optional[bool] = None,
                 kernels: KernelSet = KERNELS) -> SweepInputs:
    """The front end of every culled sweep (JAX: the prologue of
    gbuffer_pallas and co.). o: the shared origin (3,) or per-ray planes
    (ox, oy, oz); dx, dy, dz (R,) pad to whole tiles, STREAM_BATCH of
    them on the streamed path (stream=None: JAX's _should_stream), which
    works in 32-face blocks. act (R,): the rays an any-hit sweep tests,
    which the schedule's tile bounds take, the mask's too where act_cull
    (None: streamed only). A per-ray closest hit (no act) on the
    streamed path keeps zero-direction rays out of both and clears the
    words no live ray's line meets (kernels.super_any). sched=False: the
    mask words only (K8 walks them).

    The tile bounds, the flat scan's words, the all-on-chip schedule and
    texit come from one launch of kernels.sweep_front (K13); K5's words
    (accel="bvh") need the bounds first, so where the all-on-chip
    schedule reads them K13 runs twice. The streamed rows
    (_stream_rows), super_any and K5 run after it. Each call counts
    "sweep.inputs"."""
    count("sweep.inputs")
    f = scene.padded_faces
    block_f = _natural_block_f(scene, f)
    if stream is None:
        stream = _should_stream(f, block_f)
    if stream and block_f != BLOCK_F:
        if f % BLOCK_F:
            raise ValueError(f"{f} faces: the streamed sweep needs whole "
                             f"{BLOCK_F}-face blocks")
        block_f = BLOCK_F
    pad_to = TILE_R * (STREAM_BATCH if stream else 1)
    d = [_pad1(v, pad_to) for v in (dx, dy, dz)]
    shared = isinstance(o, torch.Tensor)
    op = o.reshape(3).contiguous() if shared else \
        tuple(_pad1(v, pad_to) for v in o)
    actp = None if act is None else _pad1(act.to(torch.float32), pad_to)
    gate = "act" if act is not None else (
        "live" if stream and not shared else None)
    if act_cull is None:
        act_cull = stream
    mask_gate = gate if act_cull or act is None else None
    nb = f // block_f
    nwords = -(-nb // 32)
    blo, bhi, lo, hi = cluster_boxes(scene)
    root = (lo, hi) if sched else None
    sbox = (blo, bhi) if sched and not stream else None

    def front(**kw):
        return kernels.sweep_front(op, *d, actp, gate=gate,
                                   mask_gate=mask_gate, faces=f,
                                   block_f=block_f, **kw)
    if accel == "brute":
        fr = front(words=torch.full((d[0].shape[0] // TILE_R * nwords,), -1,
                                    dtype=torch.int32, device=d[0].device),
                   sched_boxes=sbox, root=root)
    elif not _hier_cull_runs(scene, accel, nb):
        fr = front(cull_boxes=(scene.blk_lo, scene.blk_hi), sched_boxes=sbox,
                   root=root)
    else:  # K5 reads the bounds, the on-chip schedule its words
        fr = front(root=None if sbox else root)
        words = hier_cull_words(scene.blk_lo, scene.blk_hi,
                                *fr.mask_bounds, nwords=nwords,
                                kernels=kernels).reshape(-1)
        fr = front(words=words, sched_boxes=sbox, root=root) if sbox \
            else fr._replace(words=words)
    mask, rows = fr.words, ()
    if sched and stream:
        if act is None and not shared:
            live = (d[0] != 0.0) | (d[1] != 0.0) | (d[2] != 0.0)
            sup_ok = kernels.super_any(*super_boxes(scene), *op, *d, TILE_R,
                                       act=live)
            mask = torch.where(sup_ok.reshape(-1), mask, 0)
        rows = _stream_rows(scene, mask, nwords, fr.bounds)
    elif sched:
        rows = (fr.tlb, fr.order)
    return SweepInputs(stream, block_f, tuple(d) if shared else tuple(d) + op,
                       actp, mask, nwords, rows, fr.texit,
                       block_boxes(scene, block_f))


def _sphere_pack(scene: SceneData, origin: torch.Tensor) -> torch.Tensor:
    """(3 + 4S,) [origin, (center, radius) per sphere] for the sweep."""
    return torch.cat([origin.reshape(3), torch.cat(
        [scene.sphere_center, scene.sphere_radius[:, None]],
        dim=1).reshape(-1)]).contiguous()


def gbuffer(scene: SceneData, origin, dx, dy, dz, *, accel: str = "cull",
            near: float = 0.01, far: float = 100.0,
            with_spheres: bool = True, stream: Optional[bool] = None,
            kernels: KernelSet = KERNELS):
    """Closest-hit G-buffer for shared-origin planar rays dx/dy/dz (R,)
    (JAX: gbuffer_pallas). Returns (GBuffer, sph). With with_spheres
    the scene's spheres are fused into the sweep and sph = (t, id_f32,
    nx, ny, nz) of the winning sphere per ray; sph is None for a scene
    without spheres, with with_spheres=False (the path tracer runs
    sphere_pass_planar per sphere instead) and on the streamed branch,
    which fuses no spheres (the caller runs the per-sphere passes).
    stream=None takes the streamed sweep (K9) past STREAM_FACES faces,
    the all-on-chip one (K1) below; K9 gets the origin and both get the
    blocks' boxes (scenepacks.block_boxes), which they test per ray.
    gather_nm_planes adds the normal-mapping planes."""
    nrays = dx.shape[0]
    rs = sweep_inputs(scene, origin, dx, dy, dz, accel=accel, stream=stream,
                      kernels=kernels)
    oterm = pack_origin_cols(scene, origin)
    if rs.stream:
        t, face = kernels.stream_closest_hit(
            *rs.sched, *rs.planes, rs.texit, stream_pack(scene), oterm,
            origin.reshape(3).contiguous(), *rs.boxes)
        sph = None
    else:
        sph_pack = (_sphere_pack(scene, origin) if with_spheres
                    else origin.reshape(3).contiguous())
        t, face, sph = kernels.closest_hit(
            *rs.sched, *rs.planes, rs.texit, pack_face_columns(scene), oterm,
            sph_pack, *rs.boxes, block_f=rs.block_f, near=near, far=far)
    t, face = t[:nrays], face[:nrays]
    if sph is not None:
        sph = tuple(p[:nrays] for p in sph)
    gb = expand_tf_gbuffer(scene, t, face, dx, dy, dz, oterm)
    return gb, sph


def anyhit_rays(scene: SceneData, ox, oy, oz, dx, dy, dz, active, *,
                accel: str = "cull", act_cull: Optional[bool] = None,
                stream: Optional[bool] = None,
                kernels: KernelSet = KERNELS):
    """Planar any-hit (JAX: anyhit_pallas): (R,) bool occlusion for
    per-ray origins; only `active` rays are tested. act_cull folds
    `active` into the tile cull mask's ray bounds (the path tracer's
    last-bounce shadow wavefront, mostly dead lanes); None folds it on
    the streamed branch only, as JAX's default. The occlusion is the
    same either way, the mask and the sweep's work are not. stream as
    for gbuffer (K11 streamed, K3 all on chip, both with the blocks'
    boxes)."""
    nrays = dx.shape[0]
    rs = sweep_inputs(scene, (ox, oy, oz), dx, dy, dz, act=active,
                      act_cull=act_cull, accel=accel, stream=stream,
                      kernels=kernels)
    if rs.stream:
        occ = kernels.stream_anyhit(*rs.sched, *rs.planes, rs.act, rs.texit,
                                    stream_pack(scene), *rs.boxes)
    else:
        occ = kernels.anyhit(*rs.sched, *rs.planes, rs.act, rs.texit,
                             pack_face_columns(scene),
                             pack_plane_consts(scene), *rs.boxes,
                             block_f=rs.block_f)
    return occ[:nrays] > 0.0


def gbuffer_perray(scene: SceneData, ox, oy, oz, dx, dy, dz, *,
                   accel: str = "cull", stream: Optional[bool] = None,
                   kernels: KernelSet = KERNELS) -> GBuffer:
    """Closest-hit G-buffer for per-ray-origin planar rays (JAX:
    gbuffer_perray_pallas): the closest-hit kernel over the cull mask
    and its front-to-back schedule, then the G-buffer expanded with
    per-ray origin terms. Terminated paths carry zero directions; they
    cannot hit. stream as for gbuffer: the streamed branch (K10) keeps
    zero-direction rays out of the tile bounds and first clears the
    words no live ray's forward line meets (kernels.super_any, the
    plain twin traverse.perray_super_any; sweep_inputs) and hands K10
    the blocks' boxes, which it tests per ray; the all-on-chip branch
    runs K7, with the same boxes."""
    nrays = dx.shape[0]
    rs = sweep_inputs(scene, (ox, oy, oz), dx, dy, dz, accel=accel,
                      stream=stream, kernels=kernels)
    if rs.stream:
        t, face = kernels.stream_closest_hit_perray(
            *rs.sched, *rs.planes, rs.texit, stream_pack(scene), *rs.boxes)
    else:
        t, face = kernels.closest_hit_perray(
            *rs.sched, *rs.planes, rs.texit, pack_face_columns(scene),
            pack_plane_consts(scene), *rs.boxes, block_f=rs.block_f)
    return expand_tf_gbuffer(scene, t[:nrays], face[:nrays], dx, dy, dz,
                             oxyz=(ox, oy, oz))


def extend_shadow_rays(scene: SceneData, ox, oy, oz, dx, dy, dz,
                       sox, soy, soz, sdx, sdy, sdz, active, *,
                       accel: str = "cull", kernels: KernelSet = KERNELS):
    """The path tracer's fused per-bounce sweep (JAX:
    extend_shadow_pallas, VMEM branch): closest hit of the extension
    rays (ox.., dx..) and any-hit occlusion of the shadow rays (sox..,
    sdx.., active) in one launch of kernel K8. Returns (GBuffer,
    occluded (R,) bool).

    Both wavefronts' cull masks take act-aware tile bounds: `active` is
    the live set of both ray sets (extension rays of dead paths park
    far away with zero directions; inactive shadow rays are act-gated
    in the kernel), so one parked ray cannot open its tile's bounds to
    the whole scene. The kernel walks the union of the two masks, gates
    each half by its own bit and tests a block's faces only for the rays
    whose line enters its box (scenepacks.block_boxes).

    Past STREAM_FACES (JAX's fallback of extend_shadow_pallas) the whole
    wavefront is first sorted by origin Morton code and direction octant
    (_bounce_sort_perm), the two ray sets take the streamed closest hit
    (K10) and any-hit (K11) on the permuted planes, and one scatter puts
    the results back in ray order: sorted tiles have cones the interval
    cull can bound, where tiles of hemisphere samples admit every
    cluster."""
    f = scene.padded_faces
    if _should_stream(f, _natural_block_f(scene, f)):
        perm = _bounce_sort_perm(scene, ox, oy, oz, dx, dy, dz)
        pv = _permute_planes([ox, oy, oz, dx, dy, dz, sox, soy, soz,
                              sdx, sdy, sdz, active.to(torch.float32)], perm)
        gb = gbuffer_perray(scene, *pv[0:6], accel=accel, kernels=kernels)
        occ = anyhit_rays(scene, *pv[6:12], pv[12] > 0.0, accel=accel,
                          kernels=kernels)
        # one scatter back; face ids ride as f32 values (exact < 2^24)
        back = _unpermute_planes(torch.stack(
            [gb.t, gb.face.to(torch.float32), gb.u, gb.v, gb.nd, gb.uvx,
             gb.uvy, gb.nx, gb.ny, gb.nz, gb.mat, occ.to(torch.float32)]),
            perm)
        gb = GBuffer(t=back[0], face=back[1].to(torch.int32), u=back[2],
                     v=back[3], nd=back[4], uvx=back[5], uvy=back[6],
                     nx=back[7], ny=back[8], nz=back[9], mat=back[10])
        return gb, back[11] > 0.0
    nrays = dx.shape[0]
    kw = dict(act=active, act_cull=True, sched=False, accel=accel,
              stream=False, kernels=kernels)
    ext = sweep_inputs(scene, (ox, oy, oz), dx, dy, dz, **kw)
    shd = sweep_inputs(scene, (sox, soy, soz), sdx, sdy, sdz, **kw)
    t, face, occ = kernels.extend_shadow(
        ext.mask, shd.mask, *ext.planes, *shd.planes, ext.act,
        pack_face_columns(scene), pack_plane_consts(scene),
        *ext.boxes, block_f=ext.block_f)
    gb = expand_tf_gbuffer(scene, t[:nrays], face[:nrays], dx, dy, dz,
                           oxyz=(ox, oy, oz))
    return gb, occ[:nrays] > 0.0


def _expand_bits(v):
    """Spread the low 10 bits of v (int64 holding u32 values) to every
    third bit (JAX _expand_bits_jnp; every mask is below 2^32, so the
    u32 wrap-around never shows)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def _origin_morton(scene: SceneData, ox, oy, oz):
    """30-bit Morton codes (int64) of per-ray origins in the scene's
    finite cluster-AABB extent (JAX _origin_morton); out-of-scene
    sentinels clip to the last cell. The extent divides as a tensor, as
    XLA divides by a traced value."""
    _, _, lo, hi = cluster_boxes(scene)
    ext = torch.clamp_min(hi - lo, _f32(1e-12))

    def q(p, a):
        return ((p - lo[a]) / ext[a] * 1023.0).clamp(0.0, 1023.0).to(
            torch.int64)

    return ((_expand_bits(q(ox, 0)) << 2) | (_expand_bits(q(oy, 1)) << 1)
            | _expand_bits(q(oz, 2)))


def _permute_planes(planes, perm):
    """One permutation applied to many (R,) planes by one gather."""
    return torch.stack(planes).index_select(1, perm)


def _unpermute_planes(stacked, perm):
    """Inverse of _permute_planes: one scatter back to ray order."""
    out = torch.zeros_like(stacked)
    out[:, perm] = stacked
    return out


def _bounce_sort_perm(scene: SceneData, ox, oy, oz, dx, dy, dz):
    """(R,) permutation re-tiling a bounce wavefront for the interval
    cull (JAX _bounce_sort_perm): the origin Morton code without its
    lowest bit, with the direction sign octant spliced in at bit 14 —
    a 32-bit key (a 33-bit one would alias scene halves in JAX's u32).
    Stable, as jnp.argsort."""
    m = _origin_morton(scene, ox, oy, oz) >> 1
    octant = (((dx < 0.0).to(torch.int64) << 2)
              | ((dy < 0.0).to(torch.int64) << 1)
              | (dz < 0.0).to(torch.int64))
    key = ((m >> 14) << 17) | (octant << 14) | (m & 0x3FFF)
    return torch.argsort(key, stable=True)


def anyhit_reordered(scene: SceneData, ox, oy, oz, dx, dy, dz, active, *,
                     accel: str = "cull", kernels: KernelSet = KERNELS):
    """anyhit_rays on the wavefront sorted by origin Morton code, the
    results scattered back (JAX anyhit_reordered_pallas): shadow rays
    of a screen tile start on surfaces spread in depth, and sorting
    them by origin gives tiles thin enough for the cull. Parked rays
    clip to the last cell and group together. Same per-ray results."""
    perm = torch.argsort(_origin_morton(scene, ox, oy, oz), stable=True)
    pv = _permute_planes([ox, oy, oz, dx, dy, dz,
                          active.to(torch.float32)], perm)
    occ = anyhit_rays(scene, *pv[0:6], pv[6] > 0.0, accel=accel,
                      kernels=kernels)
    out = torch.zeros_like(active)
    out[perm] = occ
    return out


def _ray_matrix(uni: CameraUniforms):
    """M = V^-1[:3,:3] @ (GL2WGPU P^-1)[:3,:] and the constant column,
    in f32 on the host, summed in index order like XLA's f32 dot."""
    v = np.asarray(uni.view_inv, np.float32)[:3, :3]
    p = np.asarray(uni.proj_inv_wgpu, np.float32)[:3, :]
    m = v[:, 0:1] * p[0:1, :] + v[:, 1:2] * p[1:2, :] + v[:, 2:3] * p[2:3, :]
    return m, m[:, 2] + m[:, 3]


CAMERA_LEN = 12  # the frame's camera vector (camera_vector)


def camera_vector(uni: CameraUniforms) -> np.ndarray:
    """The frame's camera as (CAMERA_LEN,) f32 on the host: the origin,
    then for each axis i the terms _directions takes, M[i, 0], M[i, 1]
    and the constant column's i-th entry (_ray_matrix)."""
    m, const = _ray_matrix(uni)
    rows = np.concatenate([m[:, :2], const[:, None]], axis=1)
    return np.concatenate([np.asarray(uni.origin, np.float32).reshape(3),
                           rows.reshape(-1)]).astype(np.float32)


def frame_camera(uni_flat, device) -> torch.Tensor:
    """camera_vector of the (35,) uniforms `uni_flat` on `device`, put
    there without waiting for the card: on the card through pinned
    memory, copied without blocking."""
    uni = CameraUniforms.unflat(np.asarray(
        uni_flat.cpu() if isinstance(uni_flat, torch.Tensor) else uni_flat,
        np.float32))
    vec = torch.from_numpy(camera_vector(uni))
    if torch.device(device).type == "cuda":
        return vec.pin_memory().to(device, non_blocking=True)
    return vec.to(device)


def _camera_terms(camera):
    """(m, const) of _directions: _ray_matrix's on the host for
    CameraUniforms, or views of a camera vector tensor (camera_vector's
    layout) whose entries stay on its device."""
    if isinstance(camera, torch.Tensor):
        rows = camera[3:CAMERA_LEN].view(3, 3)
        return rows[:, :2], rows[:, 2]
    return _ray_matrix(camera)


def _term(v):
    """A host f32 as a Python float; a 0-dim tensor as itself, which
    rounds each product and sum as the float of the same value does."""
    return v if isinstance(v, torch.Tensor) else float(v)


def _directions(m, const, xr, yr):
    dx = _term(m[0, 0]) * xr + _term(m[0, 1]) * yr + _term(const[0])
    dy = _term(m[1, 0]) * xr + _term(m[1, 1]) * yr + _term(const[1])
    dz = _term(m[2, 0]) * xr + _term(m[2, 1]) * yr + _term(const[2])
    inv_l = 1.0 / sqrt(dx * dx + dy * dy + dz * dz)
    return dx * inv_l, dy * inv_l, dz * inv_l


def ndc_planes(width, rows, total_height, tile_h=None, tile_w=None, *,
               device, row0=None):
    """Pixel-centre NDC coordinates (xr, yr), (R,) f32 each, of a
    width x rows grid: W-major scanlines, or (tile_h x tile_w)-pixel
    screen tiles when tile_h is given (rows % tile_h == 0, width % tile_w
    == 0). NDC y divides by total_height (the true image height), so
    padding rows lie beyond the frame and visible pixels keep their
    rays. row0 (a whole number) offsets the rows: the grid is the row
    slab [row0, row0 + rows) of a total_height-tall image."""
    if tile_h is None:
        x = torch.arange(width, dtype=torch.float32, device=device)
        y = torch.arange(rows, dtype=torch.float32, device=device)
        if row0 is not None:
            y = y + float(row0)
        x_nds = (2.0 * (x + 0.5)) * _rcp(width) - 1.0
        y_nds = (2.0 * (y + 0.5)) * _rcp(total_height) - 1.0
        return x_nds.repeat(rows), y_nds.repeat_interleave(width)
    tsz = tile_h * tile_w
    tiles_x = width // tile_w
    ridx = torch.arange(width * rows, dtype=torch.int32, device=device)
    tile = ridx // tsz
    within = ridx % tsz
    py = (tile // tiles_x) * tile_h + within // tile_w
    px = (tile % tiles_x) * tile_w + within % tile_w
    yb = py.to(torch.float32)
    if row0 is not None:
        yb = yb + float(row0)
    xr = (2.0 * (px.to(torch.float32) + 0.5)) * _rcp(width) - 1.0
    yr = (2.0 * (yb + 0.5)) * _rcp(total_height) - 1.0
    return xr, yr


def raygen_planar(width, height, camera, *, device, row0=None,
                  total_height=None):
    """Planar pixelToRay (sphere/compute.wgsl:87-101): returns dx, dy, dz
    (R,) f32 flat W-major (texel row 0 first). camera: CameraUniforms
    (the ray matrix as host floats) or a camera vector on `device`
    (frame_camera; the same rays, read on the device). row0/total_height
    select the row slab [row0, row0 + height) of a taller image."""
    return _directions(*_camera_terms(camera), *ndc_planes(
        width, height, total_height or height, device=device, row0=row0))


def raygen_planar_tiled(width, height, camera, *, device, row0=None,
                        total_height=None, tile_h: int = 8,
                        tile_w: int = 128):
    """raygen_planar with rays ordered by (tile_h x tile_w)-PIXEL SCREEN
    TILES, so each 1024-ray schedule tile is a compact screen block and
    its ray cone culls tightly. Requires height % tile_h == 0 and
    width % tile_w == 0 (render_megakernel pads rows and crops); NDC y
    uses total_height (the true image height) so visible pixels' rays
    equal the untiled ones. Reassemble outputs with tiled_to_image()."""
    return _directions(*_camera_terms(camera), *ndc_planes(
        width, height, total_height or height, tile_h, tile_w,
        device=device, row0=row0))


def tiled_to_image(plane, width, height, tile_h: int = 8,
                   tile_w: int = 128):
    """(R,) plane in (tile_h x tile_w)-tile order -> (H, W)."""
    tiles_x = width // tile_w
    tiles_y = height // tile_h
    return plane.reshape(tiles_y, tiles_x, tile_h, tile_w).permute(
        0, 2, 1, 3).reshape(height, width)


def _pick_tile_shape(width: int, height: int):
    """Squarest 1024-ray screen tile the frame admits: tile_w must
    divide width; rows are padded to a tile_h multiple (then cropped).
    Prefers the squarest tile unless its row padding exceeds height/8,
    in which case the least-padded tiling wins. Returns (tile_h, tile_w,
    padded_height) or None (untiled scanline order — also chosen when
    every tiling would more than double the rows)."""
    cands = []
    for tile_w in (32, 64, 128):  # squarest first
        if width % tile_w == 0:
            tile_h = TILE_R // tile_w
            h_pad = -(-height // tile_h) * tile_h
            cands.append((tile_h, tile_w, h_pad))
    if not cands:
        return None
    choice = cands[0]
    if (choice[2] - height) * 8 > height:
        choice = min(cands, key=lambda c: c[2])  # stable: ties stay squarest
    if choice[2] > 2 * height:
        return None
    return choice


def frame_rays(uni_flat, camera, width, height, row0, total_height,
               device):
    """Both lit programs' rays: (the camera vector, `camera` or else
    frame_camera of the host uniforms `uni_flat`; the ray order,
    _frame_shape's; dx, dy, dz in that order over its rows)."""
    if camera is None:
        camera = frame_camera(uni_flat, device)
    shape = _frame_shape(width, height, row0, total_height)
    if shape is None:
        return camera, shape, raygen_planar(
            width, height, camera, device=device, row0=row0,
            total_height=total_height)
    tile_h, tile_w, render_h = shape
    return camera, shape, raygen_planar_tiled(
        width, render_h, camera, device=device, row0=row0,
        total_height=total_height or height, tile_h=tile_h, tile_w=tile_w)


def _frame_shape(width: int, height: int, row0, total_height):
    """The frame's ray order: (tile_h, tile_w, render_h) screen tiles or
    None (scanlines). A row slab (row0 given) must not render past its
    rows, so where _pick_tile_shape pads them it takes 8 x 128 tiles
    when they fit the slab and scanlines otherwise (a 1080p frame's
    540-row slab takes scanlines)."""
    shape = _pick_tile_shape(width, height)
    if shape is not None and row0 is not None and shape[2] != height:
        shape = ((8, 128, height) if height % 8 == 0 and width % 128 == 0
                 else None)
    return shape


def _norm3(x, y, z):
    l = sqrt(x * x + y * y + z * z)
    return x / l, y / l, z / l


def sphere_pass_planar(scene, i, origin, dx, dy, dz):
    """Planar sphere intersect (sphere/compute.wgsl:63-85) + normal, for
    frames without a mesh (a mesh frame gets its sphere winner from the
    closest-hit kernel)."""
    cx, cy, cz = (scene.sphere_center[i, 0], scene.sphere_center[i, 1],
                  scene.sphere_center[i, 2])
    radius = scene.sphere_radius[i]
    ocx, ocy, ocz = origin[0] - cx, origin[1] - cy, origin[2] - cz
    a = dx * dx + dy * dy + dz * dz
    b = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
    c = (ocx * ocx + ocy * ocy + ocz * ocz) - radius * radius
    disc = b * b - 4.0 * a * c
    sq = sqrt(disc.clamp_min(0.0))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    t = torch.where(t1 >= 0.0, t1, torch.where(t2 >= 0.0, t2, F32_INF))
    t = torch.where(disc < 0.0, F32_INF, t)
    hit = torch.isfinite(t)
    ts = torch.where(hit, t, 0.0)
    px, py, pz = origin[0] + dx * ts, origin[1] + dy * ts, origin[2] + dz * ts
    nx, ny, nz = px - cx, py - cy, pz - cz
    l = sqrt(nx * nx + ny * ny + nz * nz)
    l = torch.where(l > 0, l, 1.0)
    return t, hit, nx / l, ny / l, nz / l


def blinn_phong_planar(nx, ny, nz, dx, dy, dz, light):
    """Shared planar Blinn-Phong factors: returns (lambert, spec_pow32).
    The power is torch's pow, within 1 ulp of XLA's, its denormal
    results flushed as the JAX package's are (rounding.py)."""
    lx, ly, lz = _norm3(light[0], light[1], light[2])
    lam = (-(nx * lx + ny * ly + nz * lz)).clamp_min(0.0)
    hx, hy, hz = -lx - dx, -ly - dy, -lz - dz
    hl = sqrt(hx * hx + hy * hy + hz * hz)
    hl = torch.where(hl > 0, hl, 1.0)
    hdotn = ((hx * nx + hy * ny + hz * nz) / hl).clamp_min(0.0)
    return lam, ftz(hdotn ** 32.0)


def gather_packed_taps(pool, base, hw_h, hw_w, u, v):
    """Clamped texel address + fractional weights, and THE one gather:
    returns (taps (12, R) int16 u16-bits, fx, fy). Clamp-to-edge: the
    packed texel at the clamped floor coordinate carries its own clamped
    2x2 neighbourhood, and fx/fy are zeroed when floor < 0."""
    x = u * hw_w - 0.5
    y = v * hw_h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = torch.where(x0f < 0, 0.0, x - x0f)
    fy = torch.where(y0f < 0, 0.0, y - y0f)
    x0 = torch.minimum(x0f.to(torch.int32).clamp_min(0),
                       (hw_w - 1.0).to(torch.int32))
    y0 = torch.minimum(y0f.to(torch.int32).clamp_min(0),
                       (hw_h - 1.0).to(torch.int32))
    flat = base.to(torch.int32) + y0 * hw_w.to(torch.int32) + x0
    return pool.index_select(1, flat.long()), fx, fy


def sample_packed_texture(pool, base, hw_h, hw_w, u, v, *,
                          kernels: KernelSet = KERNELS):
    """ONE narrow gather + the bilinear filter kernel: (r, g, b) (R,)
    f32 from the packed pool at (u, v) (v already flipped), with the
    clamp-to-edge semantics of gather_packed_taps."""
    taps, fx, fy = gather_packed_taps(pool, base, hw_h, hw_w, u, v)
    return kernels.texfilter(taps, fx, fy)


def perturb_normal(scene: SceneData, mat, nx, ny, nz, vnxp, vnyp, vnzp,
                   tx, ty, tz, bx, by, bz, tex_u, tex_v, *,
                   kernels: KernelSet = KERNELS):
    """The normal-mapping block (JAX ops/megakernel.py:2933-2964, and
    the fused tail ops/fusedframe.py:674-708, float for float): the
    flipped geometric normal n is replaced by the interpolated vertex
    normal aligned with it (where there is one), then perturbed by the
    material's map_Bump sample in the face's tangent frame (where the
    material has a map and the frame is sound). Returns (nx, ny, nz)."""
    vl2 = vnxp * vnxp + vnyp * vnyp + vnzp * vnzp
    has_vn = vl2 > _f32(1e-12)
    inv = 1.0 / sqrt(torch.where(has_vn, vl2, 1.0))
    vnx, vny, vnz = vnxp * inv, vnyp * inv, vnzp * inv
    sgn = torch.where(vnx * nx + vny * ny + vnz * nz < 0.0, -1.0, 1.0)
    nx = torch.where(has_vn, vnx * sgn, nx)
    ny = torch.where(has_vn, vny * sgn, ny)
    nz = torch.where(has_vn, vnz * sgn, nz)

    bump_base = _mat_const(scene, mat, lambda k: scene.mat_bump_base[k])
    has_bump = bump_base >= 0
    b_h = _mat_const(scene, mat, lambda k: scene.mat_bump_h[k])
    b_w = _mat_const(scene, mat, lambda k: scene.mat_bump_w[k])
    br, bg, bb = sample_packed_texture(
        scene.tex_packed_bump, bump_base.clamp_min(0), b_h, b_w,
        tex_u, tex_v, kernels=kernels)
    ntx, nty, ntz = 2.0 * br - 1.0, 2.0 * bg - 1.0, 2.0 * bb - 1.0
    frame_ok = tx * tx + ty * ty + tz * tz > _f32(1e-12)
    px = ntx * tx + nty * bx + ntz * nx
    py = ntx * ty + nty * by + ntz * ny
    pz = ntx * tz + nty * bz + ntz * nz
    plen = sqrt(px * px + py * py + pz * pz)
    use = has_bump & frame_ok & (plen > _f32(1e-12))
    plen_s = torch.where(plen > _f32(1e-12), plen, 1.0)
    return (torch.where(use, px / plen_s, nx),
            torch.where(use, py / plen_s, ny),
            torch.where(use, pz / plen_s, nz))


def _mat_const(scene: SceneData, mat_f32, getter):
    """Resolve a per-material constant via an M-way select (no gather),
    keeping the constant's dtype: texel BASE OFFSETS stay i32 (an f32
    plane loses integers past 2^24 texels)."""
    m = scene.mat_ambient.shape[0]
    out = getter(0).expand(mat_f32.shape).contiguous()
    for k in range(1, m):
        out = torch.where(mat_f32 == float(k), getter(k), out)
    return out


def present_planar(cr, cg, cb, depth, *, width, height, shape, quantize):
    """Quantize + de-tile the planar color/depth planes to ((H, W, 3),
    (H, W)). shape is the _pick_tile_shape tiling this frame rendered with."""
    if quantize:
        cr = quantize_rgba8(cr)
        cg = quantize_rgba8(cg)
        cb = quantize_rgba8(cb)
    if shape is not None:
        tile_h, tile_w, render_h = shape
        cr, cg, cb, depth = (
            tiled_to_image(p, width, render_h, tile_h, tile_w)[:height]
            for p in (cr, cg, cb, depth))
        return torch.stack([cr, cg, cb], dim=-1), depth
    color = torch.stack(
        [cr.reshape(height, width), cg.reshape(height, width),
         cb.reshape(height, width)], dim=-1)
    return color, depth.reshape(height, width)


def _spheres_occlude_planar(scene, px, py, pz, dx, dy, dz, t_min=1e-3):
    occ = torch.zeros(px.shape, dtype=torch.bool, device=px.device)
    for i in range(scene.num_spheres):
        cx, cy, cz = (scene.sphere_center[i, 0], scene.sphere_center[i, 1],
                      scene.sphere_center[i, 2])
        radius = scene.sphere_radius[i]
        ocx, ocy, ocz = px - cx, py - cy, pz - cz
        a = dx * dx + dy * dy + dz * dz
        b = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
        c = (ocx * ocx + ocy * ocy + ocz * ocz) - radius * radius
        disc = b * b - 4.0 * a * c
        sq = sqrt(disc.clamp_min(0.0))
        t1 = (-b - sq) / (2.0 * a)
        t2 = (-b + sq) / (2.0 * a)
        t = torch.where(t1 >= 0.0, t1, torch.where(t2 >= 0.0, t2, F32_INF))
        t = torch.where(disc < 0.0, F32_INF, t)
        occ = occ | ((t >= t_min) & torch.isfinite(t))
    return occ


def shadow_wavefront(origin, dx, dy, dz, relevant, w_t, w_nx, w_ny, w_nz,
                     w_lx, w_ly, w_lz):
    """The shadow rays of the visible surface (both frames): from each
    relevant pixel's winning hit point, offset 1e-3 along its normal,
    toward its light; the other rays are parked (far origin, zero
    direction) so the tile cull drops them. Returns (px, py, pz, sdx,
    sdy, sdz)."""
    ll = sqrt(w_lx * w_lx + w_ly * w_ly + w_lz * w_lz)
    ll = torch.where(ll > 0, ll, 1.0)
    park = 1e9
    sdx = torch.where(relevant, -w_lx / ll, 0.0)
    sdy = torch.where(relevant, -w_ly / ll, 0.0)
    sdz = torch.where(relevant, -w_lz / ll, 0.0)
    ts = torch.where(relevant, w_t, 0.0)
    px = torch.where(relevant, origin[0] + dx * ts + w_nx * 1e-3, park)
    py = torch.where(relevant, origin[1] + dy * ts + w_ny * 1e-3, park)
    pz = torch.where(relevant, origin[2] + dz * ts + w_nz * 1e-3, park)
    return px, py, pz, sdx, sdy, sdz


def mesh_occlusion(scene: SceneData, px, py, pz, sdx, sdy, sdz, relevant, *,
                   accel: str = "cull", kernels: KernelSet = KERNELS):
    """(R,) bool: the shadow rays occluded by the mesh (the any-hit
    kernel; past STREAM_FACES on the Morton-sorted wavefront,
    anyhit_reordered, as JAX)."""
    if scene.num_faces == 0:
        return torch.zeros(relevant.shape, dtype=torch.bool,
                           device=relevant.device)
    ah = (anyhit_reordered if _should_stream(scene.padded_faces, BLOCK_F)
          else anyhit_rays)
    return ah(scene, px, py, pz, sdx, sdy, sdz, relevant, accel=accel,
              kernels=kernels)


def winner_occlusion(scene: SceneData, origin, dx, dy, dz, relevant, w_t,
                     w_nx, w_ny, w_nz, w_lx, w_ly, w_lz, *,
                     accel: str = "cull", kernels: KernelSet = KERNELS):
    """The single deferred shadow pass of the visible surface (both
    frames) on shadow_wavefront's rays. Returns (R,) bool: occluded by
    the mesh (mesh_occlusion) or by a sphere."""
    rays = shadow_wavefront(origin, dx, dy, dz, relevant, w_t, w_nx, w_ny,
                            w_nz, w_lx, w_ly, w_lz)
    occ = mesh_occlusion(scene, *rays, relevant, accel=accel,
                         kernels=kernels)
    return occ | _spheres_occlude_planar(scene, *rays)


def check_supported(scene: SceneData, *, accel: str = "cull") -> None:
    """Raise ValueError for an unknown accel (every scene and every
    other option renders)."""
    del scene  # every mesh size renders
    if accel not in ("brute", "cull", "bvh"):
        raise ValueError(f"unknown accel {accel!r}")


def fused_eligible(scene: SceneData, *, shadows: bool,
                   normal_mapping: bool, mip: bool = False) -> bool:
    """Whether the fused frame can draw this scene (JAX
    ops/megakernel.py:2747-2770): a mesh whose face pack stays on chip,
    not normal mapping with shadows (the shadow gate needs the perturbed
    normal, which only the split frame has) and no mip sampling."""
    return (scene.num_faces > 0 and scene.padded_faces <= STREAM_FACES
            and not (normal_mapping and shadows) and not mip)


def render_megakernel(scene: SceneData, uni_flat, *, width: int, height: int,
                      near: float = 0.01, far: float = 100.0,
                      background=(0.0, 0.0, 0.0), shadows: bool = False,
                      quantize: bool = True, normal_mapping: bool = False,
                      accel: str = "cull", fused: Optional[bool] = None,
                      mip: bool = False, row0=None, total_height=None,
                      emit_shadow_planes: bool = False,
                      kernels: KernelSet = KERNELS, camera=None):
    """One frame on the scene's device. Returns (color (H,W,3) f32,
    depth (H,W) f32).

    row0/total_height render the row slab [row0, row0 + height) of a
    total_height-tall image (the dp axis of parallel/), in either
    program, with the rays of those rows (_frame_shape picks their
    order). emit_shadow_planes stops the split shadowed frame at its
    shadow wavefront and returns JAX's dict of (R,) planes in the frame's
    ray order: depth, cr..cb, w_ar..w_ab, covered, relevant, px..pz and
    sdx..sdz (the gp axis merges them and traces the merged wavefront,
    parallel/geometry_sharding.py); present_planar(shape=_frame_shape(
    ...)) finishes them.

    fused=None picks the fused frame (ops/fusedframe.py) for every
    eligible scene and the split frame otherwise, as the JAX package
    does; fused=True on an ineligible scene (mip included) raises
    ValueError. The split frame: planar raygen -> closest-hit kernel
    (spheres fused) -> [normal mapping] -> one-gather texture shade
    kernel (with mip: the ray-cone LOD and two pyramid taps through the
    texture filter kernel) -> composite -> shadow any-hit kernel, bit for
    bit the JAX package's render_megakernel(fused=False) under the same
    rounding rules; its phases are the spans "frame.raygen",
    "frame.gbuffer", "frame.shade", "frame.shadow" and "frame.present"
    (runtime/profiler.py), with "frame.normal_map" inside "frame.shade"
    around the normal-mapping block (gather_nm_planes and
    perturb_normal). A scene without a mesh ignores mip. `kernels`
    selects the kernel implementations (PLAIN composes the frame from
    the plain PyTorch versions).

    The frame reads its camera from the device: `camera`, a camera
    vector on the scene's device (frame_camera), or else the one
    frame_camera makes of the host uniforms `uni_flat`, which may then be
    None. Nothing in the frame waits for the card, so a CUDA graph can
    capture it (runtime/renderer.py)."""
    check_supported(scene, accel=accel)
    eligible = fused_eligible(scene, shadows=shadows,
                              normal_mapping=normal_mapping, mip=mip)
    if fused is None:
        fused = eligible and not emit_shadow_planes
    if emit_shadow_planes and not (shadows and not fused):
        raise ValueError("emit_shadow_planes stages the split shadowed "
                         "frame: pass shadows=True and fused=False")
    if fused:
        if not eligible:
            raise ValueError(
                "the fused frame needs a mesh of at most STREAM_FACES faces, "
                "no normal mapping with shadows and no mip; use fused=False")
        from .fusedframe import render_frame_fused

        return render_frame_fused(
            scene, uni_flat, width=width, height=height, near=near,
            far=far, background=background, shadows=shadows,
            quantize=quantize, accel=accel, normal_mapping=normal_mapping,
            row0=row0, total_height=total_height, kernels=kernels,
            camera=camera)

    device = scene.tri_n.device
    with span("frame.raygen"):
        camera, shape, (dx, dy, dz) = frame_rays(
            uni_flat, camera, width, height, row0, total_height, device)
        origin = camera[:3]
    r = dx.shape[0]

    def full(v):
        return torch.full((r,), float(np.float32(v)), dtype=torch.float32,
                          device=device)

    def plane(v):  # a 0-dim constant as an (R,) plane
        return v.expand(r)

    def composite(state, pr, pg, pb, t, hit, extra=None):
        cr, cg, cb, depth = state[:4]
        d = to_nonlinear_depth(torch.where(hit, t, 1.0), near, far)
        write = hit & (d < depth)
        out = [torch.where(write, pr, cr), torch.where(write, pg, cg),
               torch.where(write, pb, cb), torch.where(write, d, depth)]
        if extra is not None:
            out.extend(torch.where(write, new, old)
                       for new, old in zip(extra, state[4:]))
        return out, write

    has_mesh = scene.num_faces > 0
    sph_out = None
    if has_mesh:
        with span("frame.gbuffer"):
            gb, sph_out = gbuffer(scene, origin, dx, dy, dz, accel=accel,
                                  near=near, far=far, kernels=kernels)

    with span("frame.shade"):
        cr, cg, cb = (full(background[0]), full(background[1]),
                      full(background[2]))
        depth = full(1.0)
        state = [cr, cg, cb, depth]
        if shadows:
            # winner planes for the single deferred shadow pass:
            # ambient-only color, hit point inputs and light dir of the
            # VISIBLE surface (only the last pass that wins the depth test
            # reaches the screen)
            zero = full(0.0)
            state += [zero, zero, zero, zero, zero, zero, zero, zero, zero,
                      full(1.0),
                      torch.zeros(r, dtype=torch.bool, device=device)]
            covered = torch.zeros(r, dtype=torch.bool, device=device)

        # --- sphere passes, in config order (src/lib.rs:1106-1148) ---
        if sph_out is not None:
            # fused winner: per-ray constants resolve by sphere id, then ONE
            # Blinn-Phong + composite with the same strict nonlinear-depth rule
            st, sid, nx, ny, nz = sph_out
            hit = torch.isfinite(st)

            def sph_const(getter):
                out = plane(getter(0))
                for k in range(1, scene.num_spheres):
                    out = torch.where(sid == float(k), getter(k), out)
                return out

            lx = sph_const(lambda k: scene.sphere_light[k, 0])
            ly = sph_const(lambda k: scene.sphere_light[k, 1])
            lz = sph_const(lambda k: scene.sphere_light[k, 2])
            c0 = sph_const(lambda k: scene.sphere_coeff[k, 0])
            c1 = sph_const(lambda k: scene.sphere_coeff[k, 1])
            c2 = sph_const(lambda k: scene.sphere_coeff[k, 2])
            kr = sph_const(lambda k: scene.sphere_color[k, 0])
            kg = sph_const(lambda k: scene.sphere_color[k, 1])
            kb = sph_const(lambda k: scene.sphere_color[k, 2])
            lam, spec = blinn_phong_planar(nx, ny, nz, dx, dy, dz,
                                           (lx, ly, lz))
            shade = c0 + c1 * lam
            pr = kr * shade + c2 * spec
            pg = kg * shade + c2 * spec
            pb = kb * shade + c2 * spec
            extra = None
            if shadows:
                extra = [kr * c0, kg * c0, kb * c0, st, nx, ny, nz,
                         lx, ly, lz, (lam > 0.0) | (spec > 0.0)]
            state, write = composite(state, pr, pg, pb, st, hit, extra)
            if shadows:
                covered = covered | write
        else:
            for i in range(scene.num_spheres):
                t, hit, nx, ny, nz = sphere_pass_planar(scene, i, origin,
                                                        dx, dy, dz)
                light = scene.sphere_light[i]
                lam, spec = blinn_phong_planar(nx, ny, nz, dx, dy, dz, light)
                coeff = scene.sphere_coeff[i]
                col = scene.sphere_color[i]
                shade = coeff[0] + coeff[1] * lam
                pr = col[0] * shade + coeff[2] * spec
                pg = col[1] * shade + coeff[2] * spec
                pb = col[2] * shade + coeff[2] * spec
                extra = None
                if shadows:
                    extra = [plane(col[0] * coeff[0]),
                             plane(col[1] * coeff[0]),
                             plane(col[2] * coeff[0]), t, nx, ny, nz,
                             plane(light[0]), plane(light[1]), plane(light[2]),
                             (lam > 0.0) | (spec > 0.0)]
                state, write = composite(state, pr, pg, pb, t, hit, extra)
                if shadows:
                    covered = covered | write

        # --- mesh pass (closest-hit G-buffer + one-gather shading) ---
        if has_mesh:
            hit = torch.isfinite(gb.t)
            flip = gb.nd > 0.0
            nx = torch.where(flip, -gb.nx, gb.nx)
            ny = torch.where(flip, -gb.ny, gb.ny)
            nz = torch.where(flip, -gb.nz, gb.nz)

            tex_base = _mat_const(scene, gb.mat,
                                  lambda k: scene.mat_tex_base[k])
            hw_h = _mat_const(scene, gb.mat, lambda k: scene.mat_tex_h[k])
            hw_w = _mat_const(scene, gb.mat, lambda k: scene.mat_tex_w[k])
            tex_u = gb.uvx
            tex_v = 1.0 - gb.uvy  # V-flip (triangle_list/compute.wgsl:223)

            if normal_mapping:
                with span("frame.normal_map"):
                    nm = gather_nm_planes(scene, gb)
                    nx, ny, nz = perturb_normal(
                        scene, gb.mat, nx, ny, nz, nm.vnx, nm.vny, nm.vnz,
                        nm.tx, nm.ty, nm.tz, nm.bx, nm.by, nm.bz, tex_u,
                        tex_v, kernels=kernels)

            # per-pixel light dir can vary by material (reference quirk:
            # per-kernel light dirs) — resolve via M-way select
            lightx = _mat_const(scene, gb.mat, lambda k: scene.mat_light[k, 0])
            lighty = _mat_const(scene, gb.mat, lambda k: scene.mat_light[k, 1])
            lightz = _mat_const(scene, gb.mat, lambda k: scene.mat_light[k, 2])
            lam, spec = blinn_phong_planar(nx, ny, nz, dx, dy, dz,
                                           (lightx, lighty, lightz))
            amb_r = _mat_const(scene, gb.mat,
                               lambda k: scene.mat_ambient[k, 0])
            amb_g = _mat_const(scene, gb.mat,
                               lambda k: scene.mat_ambient[k, 1])
            amb_b = _mat_const(scene, gb.mat,
                               lambda k: scene.mat_ambient[k, 2])
            spc_r = _mat_const(scene, gb.mat,
                               lambda k: scene.mat_specular[k, 0])
            spc_g = _mat_const(scene, gb.mat,
                               lambda k: scene.mat_specular[k, 1])
            spc_b = _mat_const(scene, gb.mat,
                               lambda k: scene.mat_specular[k, 2])

            if mip and scene.mip_levels > 0:
                # trilinear minification (JAX megakernel.py:2981-2995): two
                # pyramid taps (K6 each) and the shade in plain ops, in place
                # of the texshade kernel
                from .miptex import ray_cone_lod, sample_mip_trilinear

                row_w = shape[1] if shape is not None else width
                lod = ray_cone_lod(scene, gb, dx, dy, dz, row_w)
                tr, tg, tb = sample_mip_trilinear(scene, gb.mat, lod, tex_u,
                                                  tex_v, kernels=kernels)
                pr = amb_r + tr * lam + spc_r * spec
                pg = amb_g + tg * lam + spc_g * spec
                pb = amb_b + tb * lam + spc_b * spec
            else:
                taps, fxw, fyw = gather_packed_taps(scene.tex_packed, tex_base,
                                                    hw_h, hw_w, tex_u, tex_v)
                pr, pg, pb = kernels.texshade(taps, fxw, fyw, lam, spec,
                                              amb_r, amb_g, amb_b,
                                              spc_r, spc_g, spc_b)
            extra = None
            if shadows:
                extra = [amb_r, amb_g, amb_b, gb.t, nx, ny, nz,
                         lightx, lighty, lightz, (lam > 0.0) | (spec > 0.0)]
            state, write = composite(state, pr, pg, pb, gb.t, hit, extra)
            if shadows:
                covered = covered | write

        cr, cg, cb, depth = state[:4]

    # --- single deferred shadow pass for the visible surface ---
    if shadows:
        with span("frame.shadow"):
            (w_ar, w_ag, w_ab, w_t, w_nx, w_ny, w_nz,
             w_lx, w_ly, w_lz, w_rel) = state[4:]
            # trace only pixels whose shading the occlusion bit can change:
            # where lam == 0 and spec == 0 the lit and shadowed colours are
            # bitwise equal
            relevant = covered & w_rel
            rays = shadow_wavefront(origin, dx, dy, dz, relevant, w_t, w_nx,
                                    w_ny, w_nz, w_lx, w_ly, w_lz)
            if emit_shadow_planes:
                return dict(cr=cr, cg=cg, cb=cb, depth=depth, w_ar=w_ar,
                            w_ag=w_ag, w_ab=w_ab, covered=covered,
                            relevant=relevant,
                            **dict(zip(("px", "py", "pz", "sdx", "sdy", "sdz"),
                                       rays)))
            occ = (mesh_occlusion(scene, *rays, relevant, accel=accel,
                                  kernels=kernels)
                   | _spheres_occlude_planar(scene, *rays))
            shadowed = covered & occ
            cr = torch.where(shadowed, w_ar, cr)
            cg = torch.where(shadowed, w_ag, cg)
            cb = torch.where(shadowed, w_ab, cb)

    with span("frame.present"):
        return present_planar(cr, cg, cb, depth, width=width,
                              height=height, shape=shape, quantize=quantize)


# ---------------------------------------------------------------------------
# drop-ins for the oracle's intersection queries (JAX: intersect_tris_pallas,
# occluded_tris_pallas)
# ---------------------------------------------------------------------------

def intersect_tris_pallas(scene: SceneData, origin, dirs, *,
                          kernels: KernelSet = KERNELS):
    """ops.intersect.intersect_tris through the closest-hit sweep
    (gbuffer): dirs (..., 3) from the shared origin (3,). Returns the
    oracle's TriHit, shaped like dirs[..., 0]."""
    from .intersect import TriHit

    shape = dirs.shape[:-1]
    d2 = dirs.reshape(-1, 3)
    gb, _ = gbuffer(scene, origin, d2[:, 0].contiguous(),
                    d2[:, 1].contiguous(), d2[:, 2].contiguous(),
                    with_spheres=False, kernels=kernels)
    return TriHit(t=gb.t.reshape(shape),
                  face=gb.face.to(torch.int64).reshape(shape),
                  u=gb.u.reshape(shape), v=gb.v.reshape(shape),
                  n_dot_d=gb.nd.reshape(shape))


def occluded_tris_pallas(scene: SceneData, origins, dirs, t_min=1e-3, *,
                         kernels: KernelSet = KERNELS):
    """ops.intersect.occluded_tris through the any-hit sweep
    (anyhit_rays), whose shadow epsilon is fixed at 1e-3 (t_min is
    ignored, as in JAX): origins broadcast to dirs (..., 3)."""
    del t_min
    shape = dirs.shape[:-1]
    d2 = dirs.reshape(-1, 3)
    o2 = origins.expand(dirs.shape).reshape(-1, 3)
    act = torch.ones(d2.shape[0], dtype=torch.bool, device=d2.device)
    occ = anyhit_rays(scene, *(o2[:, k].contiguous() for k in range(3)),
                      *(d2[:, k].contiguous() for k in range(3)), act,
                      kernels=kernels)
    return occ.reshape(shape)
