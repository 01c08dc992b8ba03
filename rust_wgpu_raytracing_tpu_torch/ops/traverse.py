"""Tile-cone culling math shared by the cull mask and the visit schedule.

Counterpart of the JAX package's ops/traverse.py (slab tests, root
exit, per-tile ray bounds, the per-ray superblock admission of the
streamed bounce sweep), with the flat scan's words (flat_mask_words)
and the all-on-chip schedule (tile_schedule) of its ops/megakernel.py:
together with tile_ray_bounds and sweep_root_exit they are the plain
twin of kernel K13 (kernels/sweep_front.py). Every expression keeps the
JAX operation order, so the masks and schedules are bit-identical to
the JAX ones.
accel="bvh" renders through the two-level LBVH cut (ops/hier_cull.py,
the JAX package's traverse_pallas); the stackless skip-pointer walk over
SceneData.bvh_pack, bvh_walk_mask_words, is here as in the JAX package,
where no render path runs it either.
"""

from __future__ import annotations

import torch

F32_INF = float("inf")
# (ray, superblock) pairs per step of perray_super_any
SUPER_ANY_PAIRS = 1 << 24
# steps of bvh_walk_mask_words between its checks for a live tile (each
# check reads one flag on the host)
WALK_CHECK_STEPS = 64
# (tile, cluster) pairs per step of the flat scan (flat_mask_words)
CULL_CHUNK_PAIRS = 1 << 22


def slab_interval_ok(a, b, dn, dp):
    """Conservative ray-interval vs AABB slab test.

    a = box_lo - origin_max, b = box_hi - origin_min, dn/dp = per-axis
    direction min/max; all (..., 3). Returns (...,) bool: True if some
    t >= 0 can reach the box for SOME ray in the interval bounds.
    """
    ok, _ = slab_interval_entry(a, b, dn, dp)
    return ok


def slab_interval_entry(a, b, dn, dp):
    """slab_interval_ok plus the conservative ENTRY-t lower bound.

    Returns (ok (...,) bool, t0 (...,) f32): t0 <= the true entry
    parameter of EVERY ray in the interval family that reaches the box
    (clamped to >= 0); +inf where the box is unreachable."""
    mixed = (dn <= 0.0) & (dp >= 0.0)
    zero = (dn == 0.0) & (dp == 0.0)  # parked rays (direction == 0)
    pos = dn > 0.0
    dp_s = torch.where(dp.abs() > 1e-30, dp, 1e-30)
    dn_s = torch.where(dn.abs() > 1e-30, dn, 1e-30)

    lo_pos = torch.where(a > 0.0, a / dp_s, 0.0)
    hi_pos = torch.where(b >= 0.0, b / dn_s, -1.0)
    lo_neg = torch.where(b < 0.0, b / dn_s, 0.0)
    hi_neg = torch.where(a <= 0.0, a / dp_s, -1.0)

    lo_t = torch.where(mixed, 0.0, torch.where(pos, lo_pos, lo_neg))
    hi_t = torch.where(mixed, F32_INF, torch.where(pos, hi_pos, hi_neg))
    hi_t = torch.where(zero & ~((a <= 0.0) & (b >= 0.0)), -1.0, hi_t)

    box_ok = (b >= a).all(dim=-1)
    t0 = lo_t.amax(dim=-1)
    t1 = hi_t.amin(dim=-1)
    ok = box_ok & (t1 >= 0.0) & (t1 >= t0)
    # deflate by ~100 f32 division ulps so rounding can never lift the
    # bound above a true entry (exactness of the early-exit skip)
    t0_lb = t0.clamp_min(0.0) * (1.0 - 1e-5) - 1e-6
    return ok, torch.where(ok, t0_lb, F32_INF)


def ray_root_exit(lo, hi, ox, oy, oz, dx, dy, dz):
    """Per-ray conservative UPPER bound of the exit parameter from the
    scene root AABB [lo, hi] ((3,) each); -1.0 for rays that miss the
    root entirely. ox.. may be 0-dim tensors (shared origin)."""
    t0 = torch.zeros_like(dx)
    t1 = torch.full_like(dx, F32_INF)
    for a, (o, d) in enumerate(((ox, dx), (oy, dy), (oz, dz))):
        d_safe = torch.where(d == 0.0, 1.0, d)
        ta = (lo[a] - o) / d_safe
        tb = (hi[a] - o) / d_safe
        tn = torch.minimum(ta, tb)
        tf = torch.maximum(ta, tb)
        inside = (o >= lo[a]) & (o <= hi[a])
        tn = torch.where(d == 0.0,
                         torch.where(inside, 0.0, F32_INF), tn)
        tf = torch.where(d == 0.0,
                         torch.where(inside, F32_INF, -F32_INF), tf)
        t0 = torch.maximum(t0, tn)
        t1 = torch.minimum(t1, tf)
    hit = t1 >= t0
    return torch.where(hit, t1 * (1.0 + 1e-5) + 1e-6, -1.0)


def sweep_root_exit(lo, hi, ox, oy, oz, dx, dy, dz):
    """The sweeps' per-ray cap `texit`: ray_root_exit, -1.0 for rays
    with a zero direction."""
    texit = ray_root_exit(lo, hi, ox, oy, oz, dx, dy, dz)
    live = (dx != 0.0) | (dy != 0.0) | (dz != 0.0)
    return torch.where(live, texit, -1.0)


def cull_mask(blk_lo, blk_hi, omin, omax, dmin, dmax):
    """(tiles, clusters) i32: the flat slab test of the tiles' cones
    (bounds (T, 3) each) against every cluster AABB (blk_lo, blk_hi
    (B, 3), padding clusters as the scene holds them)."""
    a = blk_lo[None, :, :] - omax[:, None, :]  # (T,B,3)
    b = blk_hi[None, :, :] - omin[:, None, :]
    ok = slab_interval_ok(a, b, dmin[:, None, :], dmax[:, None, :])
    return ok.to(torch.int32)


def regroup_mask(mask, f, block_f):
    """Adapt a (tiles, f/cluster) cull mask to the kernels' face-block
    granularity (coarser blocks OR the member clusters; finer repeat)."""
    cull = f // mask.shape[1]
    if block_f == cull:
        return mask
    if block_f > cull:
        return mask.reshape(mask.shape[0], -1, block_f // cull).amax(dim=2)
    return mask.repeat_interleave(cull // block_f, dim=1)


def pack_mask_bits(mask):
    """Pack a (tiles, nb) 0/1 i32 mask into (tiles * ceil(nb/32),) i32
    words, bit k of word w = block 32w + k."""
    t, nb = mask.shape
    nw = -(-nb // 32)
    pad = nw * 32 - nb
    if pad:
        mask = torch.cat([mask, torch.zeros((t, pad), dtype=mask.dtype,
                                            device=mask.device)], dim=1)
    bits = mask.reshape(t, nw, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=mask.device) << \
        torch.arange(32, dtype=torch.int64, device=mask.device)
    words = (bits * weights).sum(dim=2)  # in [0, 2^32)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32).reshape(-1), nw


def flat_mask_words(blk_lo, blk_hi, bounds, f: int, block_f: int):
    """The flat scan's packed (tile, block) activity words, (T *
    ceil(nb/32),) i32 for nb = f / block_f blocks: cull_mask over the
    clusters, regrouped to block_f faces a block and packed. Chunks of
    tiles bound the (tiles, clusters, 3) temporaries to CULL_CHUNK_PAIRS
    pairs a step (JAX fuses the scan into one XLA loop; here they would
    take GBs at 1080p past 500k faces); the words are the same."""
    n_tiles = bounds[0].shape[0]
    step = max(1, CULL_CHUNK_PAIRS // max(1, blk_lo.shape[0]))
    return torch.cat([pack_mask_bits(regroup_mask(
        cull_mask(blk_lo, blk_hi, *(x[t0:t0 + step] for x in bounds)), f,
        block_f))[0] for t0 in range(0, n_tiles, step)])


def tile_schedule(blo, bhi, words, bounds, f: int, block_f: int):
    """The all-on-chip sweeps' front-to-back schedule (JAX _vmem_sched
    without its root exit): (tlb (T, nb) f32, order (T, nb) i32) for nb
    = f / block_f blocks. tlb: each (tile, block)'s conservative entry-t
    lower bound from the tiles' ray bounds (T, 3) each against the
    cluster boxes blo, bhi (padding clusters empty: +inf, -inf),
    regrouped to blocks by their minimum, +inf where the packed mask
    words (T * nwords,) clear the block; order: each tile's blocks
    ascending in tlb, a stable sort as jnp.argsort is."""
    nb = f // block_f
    omin, omax, dmin, dmax = bounds
    n_tiles = omin.shape[0]
    a = blo[None, :, :] - omax[:, None, :]
    b = bhi[None, :, :] - omin[:, None, :]
    _, t0 = slab_interval_entry(a, b, dmin[:, None, :], dmax[:, None, :])

    cull = f // blo.shape[0]
    if block_f > cull:
        t0 = t0.reshape(n_tiles, -1, block_f // cull).amin(dim=2)
    elif block_f < cull:
        t0 = t0.repeat_interleave(cull // block_f, dim=1)

    words = words.reshape(n_tiles, -1)
    c = torch.arange(nb, dtype=torch.int32, device=words.device)
    bits = (words[:, (c >> 5).long()] >> (c & 31)) & 1
    tlb = torch.where(bits != 0, t0, F32_INF)
    order = torch.argsort(tlb, dim=1, stable=True).to(torch.int32)
    return tlb.contiguous(), order.contiguous()


def _tile_minmax(x, tile_r, act=None):
    t = x.reshape(-1, tile_r)
    if act is None:
        return t.amin(dim=1), t.amax(dim=1)
    a = act.reshape(-1, tile_r)
    return (torch.where(a, t, F32_INF).amin(dim=1),
            torch.where(a, t, -F32_INF).amax(dim=1))


def tile_ray_bounds(ox, oy, oz, dx, dy, dz, tile_r, act=None):
    """Componentwise per-tile origin/direction interval bounds.

    ox/oy/oz may be 0-dim tensors (shared-origin primary rays) or padded
    (R,) planes (per-ray shadow origins). Returns (omin, omax, dmin,
    dmax), each (T, 3) f32. act (optional, (R,) bool) restricts the
    bounds to live rays, so parked rays cannot widen a tile's cone."""
    def bounds(v):
        if v.dim() == 0:
            b = v.expand(dx.shape[0] // tile_r)
            return b, b
        return _tile_minmax(v, tile_r, act)

    oxm, oxM = bounds(ox)
    oym, oyM = bounds(oy)
    ozm, ozM = bounds(oz)
    dxm, dxM = _tile_minmax(dx, tile_r, act)
    dym, dyM = _tile_minmax(dy, tile_r, act)
    dzm, dzM = _tile_minmax(dz, tile_r, act)
    omin = torch.stack([oxm, oym, ozm], dim=1)
    omax = torch.stack([oxM, oyM, ozM], dim=1)
    dmin = torch.stack([dxm, dym, dzm], dim=1)
    dmax = torch.stack([dxM, dyM, dzM], dim=1)
    return omin, omax, dmin, dmax


# the smallest normal f32: a direction component below it takes the
# inside rule in ray_box_enter
F32_MIN_NORMAL = 1.17549435e-38


def ray_box_enter(lo, hi, ox, oy, oz, dx, dy, dz):
    """Per-ray slab test of rays (o, d) against AABBs [lo, hi] (lo/hi
    (..., 3), the ray planes broadcasting against lo[..., 0]): the plain
    twin of csrc/rt_common.cuh box_ray + ray_box_enter, bit for bit.

    Returns (ok bool, entry f32). ok: the ray's forward line (t >= 0)
    meets the box widened in space on each axis: by |bound| * 1e-5 +
    1e-6, and by the ray's |o| * 1e-5, folded into the origin (p = o +
    |o| 1e-5 meets the low side, q = o - |o| 1e-5 the high side); then
    perray_super_any's margins: the exit inflated by |t| * 1e-5 + 1e-6,
    the entry deflated to entry = t_in * (1 - 1e-5) - 1e-6 (at most the
    line's entry), a direction component below the smallest normal f32
    admitted only where the origin lies inside the widened slab. The
    slab parameters are products with 1/d. A box with lo > hi on some
    axis (padding clusters: +inf, -inf) is never admitted. Minima and
    maxima ignore a NaN operand, as CUDA's fminf / fmaxf do.

    Why the box is widened: a face test (perray_hit) may accept a point
    a rounding error outside its triangle, and its t may lie below the
    line's entry into the exact box (cancellation in N.o + d for origins
    near the plane). Both errors are spatial, ~1e-7 (|origin| + |point|);
    perray_super_any's margins are in t and vanish for a ray nearly
    parallel to a slab. The widening covers them by ~50x, so no hit is
    culled and no winner lies before its block's entry. A component below
    the smallest normal f32 would need t > 1e31 to cross the 1e-6
    margin."""
    wlo = lo - (lo.abs() * 1e-5 + 1e-6)
    whi = hi + (hi.abs() * 1e-5 + 1e-6)
    tn = torch.zeros((), dtype=torch.float32, device=lo.device)
    tf = torch.full((), F32_INF, dtype=torch.float32, device=lo.device)
    one = torch.ones((), dtype=torch.float32, device=lo.device)
    for a, (o, d) in enumerate(((ox, dx), (oy, dy), (oz, dz))):
        om = o.abs() * 1e-5
        p, q = o + om, o - om
        flat = d.abs() < F32_MIN_NORMAL
        inv = torch.where(flat, 0.0, one / torch.where(flat, 1.0, d))
        ta = (wlo[..., a] - p) * inv
        tb = (whi[..., a] - q) * inv
        inside = (p >= wlo[..., a]) & (q <= whi[..., a])
        na = torch.where(flat, torch.where(inside, 0.0, F32_INF),
                         torch.fmin(ta, tb))
        fa = torch.where(flat, torch.where(inside, F32_INF, -F32_INF),
                         torch.fmax(ta, tb))
        tn = torch.fmax(tn, na)
        tf = torch.fmin(tf, fa)
    entry = tn * (1.0 - 1e-5) - 1e-6
    ok = (lo <= hi).all(dim=-1) & ((tf + tf.abs() * 1e-5 + 1e-6) >= entry)
    return ok, entry


def perray_super_any(slo, shi, ox, oy, oz, dx, dy, dz, tile_r: int,
                     act=None):
    """(T, S) bool exact per-ray union superblock admission (JAX
    ops/traverse.py perray_super_any): tile t admits superblock s iff
    some live ray of the tile has a forward line (t >= 0) that meets
    s's AABB (slo/shi (S, 3)). Margins as JAX's: the exit inflated and
    the entry deflated by ~100 ulps relative, sign-aware. Zero-direction
    rays with their origin outside a slab self-cull; padding lanes need
    `act`.

    Each (ray, superblock) pair is independent, so the chunking (over
    superblocks, at most SUPER_ANY_PAIRS pairs per step; JAX takes 64
    superblocks) only bounds the temporaries: at 1080p x 511 superblocks
    a 64-wide chunk would hold ~0.5 GB per temporary."""
    r = dx.shape[0]
    n_tiles = r // tile_r
    s = slo.shape[0]
    chunk = max(1, min(64, SUPER_ANY_PAIRS // max(r, 1)))
    cols = []
    for c0 in range(0, s, chunk):
        c1 = min(s, c0 + chunk)
        lo = slo[c0:c1]
        hi = shi[c0:c1]
        tn = torch.zeros((r, c1 - c0), dtype=torch.float32, device=dx.device)
        tf = torch.full((r, c1 - c0), F32_INF, dtype=torch.float32,
                        device=dx.device)
        for a, (o, d) in enumerate(((ox, dx), (oy, dy), (oz, dz))):
            o_ = o[:, None]
            d_ = d[:, None]
            d_safe = torch.where(d_ == 0.0, 1.0, d_)
            ta = (lo[None, :, a] - o_) / d_safe
            tb = (hi[None, :, a] - o_) / d_safe
            na = torch.minimum(ta, tb)
            fa = torch.maximum(ta, tb)
            inside = (o_ >= lo[None, :, a]) & (o_ <= hi[None, :, a])
            na = torch.where(d_ == 0.0,
                             torch.where(inside, 0.0, F32_INF), na)
            fa = torch.where(d_ == 0.0,
                             torch.where(inside, F32_INF, -F32_INF), fa)
            tn = torch.maximum(tn, na)
            tf = torch.minimum(tf, fa)
        ok = (tf + tf.abs() * 1e-5 + 1e-6) >= (tn * (1.0 - 1e-5) - 1e-6)
        if act is not None:
            ok = ok & act[:, None]
        cols.append(ok.reshape(n_tiles, tile_r, c1 - c0).any(dim=1))
    return torch.cat(cols, dim=1)


def bvh_walk_mask_words(bvh_pack, n_nodes: int, omin, omax, dmin, dmax,
                        nwords: int):
    """Stackless skip-pointer LBVH walk -> packed cluster mask words (JAX
    ops/traverse.py bvh_walk_mask_words).

    bvh_pack: (9, M) f32 DFS node pack (ops/bvh.py linearize_bvh). Tile
    bounds (T, 3) from tile_ray_bounds. Returns (T, nwords) i32, bit
    c%32 of word c//32 set iff cluster c's leaf AABB passed the tile's
    cone test. Every tile holds one pointer and steps in lockstep with
    the others: one gather of the node, the slab test, the leaf's bit,
    then hit_next or miss_next. JAX's loop tests for a live tile at
    every step; here the test (a host read) comes every
    WALK_CHECK_STEPS steps. Pointers only increase and a finished tile's
    steps change nothing, so the words do not depend on the interval."""
    t_cnt = omin.shape[0]
    dev = omin.device
    rows = torch.arange(t_cnt, device=dev)
    # column nwords takes the bits of the steps that set none
    words = torch.zeros((t_cnt, nwords + 1), dtype=torch.int32, device=dev)
    ptr = torch.zeros((t_cnt,), dtype=torch.int64, device=dev)
    one = torch.ones((), dtype=torch.int32, device=dev)
    while bool((ptr < n_nodes).any()):
        for _ in range(WALK_CHECK_STEPS):
            active = ptr < n_nodes
            rec = bvh_pack.index_select(1, ptr.clamp_max(n_nodes - 1))
            lo = rec[0:3].T
            hi = rec[3:6].T
            hit = slab_interval_ok(lo - omax, hi - omin, dmin, dmax) & active
            set_bit = hit & (rec[8] >= 0.0)
            cl = rec[8].to(torch.int32)
            widx = torch.where(set_bit, cl >> 5, nwords).long()
            bit = torch.where(set_bit, one << (cl & 31), 0)
            # a leaf is visited at most once per tile: or == add
            words[rows, widx] = words[rows, widx] | bit
            nxt = torch.where(hit, rec[6], rec[7]).to(torch.int64)
            ptr = torch.where(active, nxt, ptr)
    return words[:, :nwords].contiguous()
