"""The per-ray union superblock admission of the streamed bounce sweep.

The wrapper `super_any` launches csrc/super_any.cu for CUDA tensors and
runs `super_any_plain` for CPU tensors; each launch adds 1 to the
counter `launches.super_any` (runtime/profiler.py). Both compute
ops/traverse.perray_super_any (the JAX package's function of the same
name, plain jnp that XLA fuses): (T, S) bool, tile t admits superblock s
iff some live ray of the tile has a forward line that meets s's AABB,
by JAX's margins in t. The plain version is that function; it builds
(rays x superblocks) temporaries chunk by chunk, the kernel none.
"""

from __future__ import annotations

import torch

from ...runtime.profiler import count
from ..traverse import perray_super_any
from .build import check, library
from .common import is_cuda_call, ptr, require, stream_ptr

super_any_plain = perray_super_any


def _check(slo, shi, planes, tile_r, act):
    n_super = slo.shape[0] if slo.dim() == 2 else -1
    require(slo, "slo", torch.float32, (n_super, 3))
    require(shi, "shi", torch.float32, (n_super, 3))
    n_rays = planes[0].shape[0] if planes[0].dim() == 1 else -1
    for name, p in zip(("ox", "oy", "oz", "dx", "dy", "dz"), planes):
        require(p, name, torch.float32, (n_rays,))
    if act is not None:
        require(act, "act", torch.bool, (n_rays,))
    if tile_r <= 0 or n_rays % tile_r:
        raise ValueError(f"tile_r {tile_r} does not divide {n_rays} rays")
    return n_rays // tile_r, n_super


def super_any(slo, shi, ox, oy, oz, dx, dy, dz, tile_r: int, act=None):
    """(T, S) bool: slo, shi (S, 3) f32 superblock boxes; the ray planes
    (R,) f32; tile_r rays a tile (R a multiple of it); act (R,) bool or
    None (every ray live)."""
    planes = (ox, oy, oz, dx, dy, dz)
    n_tiles, n_super = _check(slo, shi, planes, tile_r, act)
    extra = () if act is None else (act,)
    if not is_cuda_call(slo, shi, *planes, *extra):
        return super_any_plain(slo, shi, *planes, tile_r, act=act)
    out = torch.empty((n_tiles, n_super), dtype=torch.bool,
                      device=slo.device)
    err = library().rt_super_any(
        ptr(slo), ptr(shi), *(ptr(p) for p in planes),
        ptr(act) if act is not None else None, n_tiles, tile_r, n_super,
        ptr(out), stream_ptr(slo.device))
    check(err, "rt_super_any")
    count("launches.super_any")
    return out
