"""Argument checks and pointer plumbing shared by the kernel wrappers."""

from __future__ import annotations

import ctypes

import torch

TILE_R = 1024  # rays per schedule tile: one CUDA block of the sweep kernels
INT_MAX = 2**31 - 1
# K1 and K3 (csrc/cull_walk.cuh run_chunk's HYBRID) take a chunk
# ray-major where its (ray, block) pairs reach RAY_MAJOR[kernel] times
# the warps' visits of the blocks they enter (a visit holds at most 64
# rays), else by pairs; read at each launch (0: always ray-major, 65:
# never). Of 0-65, the least sum of each kernel's times at the smoke and
# dense views and the path tracer's arguments on the H100 (PERF.md).
# K4's in-kernel shadow loop runs K3's walk and takes K3's threshold.
RAY_MAJOR = {"closest_hit": 32, "anyhit": 48}


def is_cuda_call(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on one CUDA device, False when every one
    is on the CPU; raises on a mix or on any other device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs on several devices: {sorted(map(str, devs))}")
    dev = next(iter(devs))
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {dev}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    """Raise unless `t` has this dtype and shape and is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def box_args(blk_lo, blk_hi, nb: int):
    """() without boxes, else (blk_lo, blk_hi) checked to be (nb, 3) f32
    each; raises when only one is given."""
    if blk_lo is None and blk_hi is None:
        return ()
    if blk_lo is None or blk_hi is None:
        raise ValueError("blk_lo and blk_hi: give both or neither")
    require(blk_lo, "blk_lo", torch.float32, (nb, 3))
    require(blk_hi, "blk_hi", torch.float32, (nb, 3))
    return blk_lo, blk_hi


def open_boxes(nb: int, device):
    """(lo, hi) (nb, 3): boxes that admit every ray (-inf, +inf)."""
    lo = torch.full((nb, 3), -float("inf"), dtype=torch.float32,
                    device=device)
    return lo, -lo


def admitted_tiles(tlb: torch.Tensor):
    """For each face block j, the tiles whose schedule admits it (finite
    entry bound) as an index tensor on tlb's device, or None. The plain
    sweeps visit exactly these (tile, block) pairs."""
    adm = torch.isfinite(tlb).T.cpu()
    out = []
    for j in range(adm.shape[0]):
        idx = adm[j].nonzero().squeeze(1)
        out.append(idx.to(tlb.device) if idx.numel() else None)
    return out


def block_rows(x: torch.Tensor, tiles: torch.Tensor) -> torch.Tensor:
    """The rays of `tiles` of a (T*TILE_R,) plane, flattened."""
    return x.view(-1, TILE_R).index_select(0, tiles).reshape(-1)
