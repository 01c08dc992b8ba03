"""The port's device mesh: named axes over the ranks of torch.distributed.

The JAX package lays its devices out as a jax.sharding.Mesh and lets
shard_map issue the collectives. Here every rank is one process with one
device; RankMesh holds the axis sizes, this rank's coordinate on each
axis and one process group per axis line (the ranks that differ only in
that axis), made with dist.new_group by every rank in the same order.
Ranks are laid out row-major over the axes, as np.array(devices)
.reshape(shape) lays out JAX's devices.

The backend is the caller's (init_process_group, or parallel.launch.
spawn): gloo where ranks share a card (NCCL refuses two ranks on one
device), NCCL with a card per rank. Gloo reduces CUDA tensors through
host memory (torch's ProcessGroupGloo copies them to pinned host buffers
and back); the work itself stays on the card.

A mesh of one rank needs no process group: its collectives are the
identity, so the sharded functions run on one device as JAX's do on a
one-device mesh.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


def rank_device(device="cuda") -> torch.device:
    """The device this rank renders on: cuda:(rank % cards) for "cuda"
    (raising where torch sees no card: no rank falls back to the CPU),
    or the device given."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available")
        if dev.index is None:
            rank = dist.get_rank() if dist.is_initialized() else 0
            dev = torch.device("cuda", rank % torch.cuda.device_count())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


class RankMesh:
    """Named axes over ranks; shape maps axis name -> size in layout
    order. The product of the sizes is the world size."""

    def __init__(self, shape: Dict[str, int], *, device="cuda"):
        self.shape = dict(shape)
        self.names = tuple(self.shape)
        sizes = tuple(self.shape.values())
        n = int(np.prod(sizes))
        if dist.is_initialized():
            self.rank, world = dist.get_rank(), dist.get_world_size()
        else:
            self.rank, world = 0, 1
        if n != world:
            raise ValueError(f"mesh {self.shape} holds {n} ranks, the "
                             f"process group {world}")
        self.coords = dict(zip(self.names, np.unravel_index(self.rank,
                                                            sizes)))
        self.coords = {k: int(v) for k, v in self.coords.items()}
        self.device = rank_device(device)
        self.groups = {}
        grid = np.arange(n).reshape(sizes)
        for ax, name in enumerate(self.names):
            # every line along this axis, in the same order on every rank
            lines = np.moveaxis(grid, ax, -1).reshape(-1, sizes[ax])
            for line in lines:
                ranks = [int(r) for r in line]
                group = (dist.new_group(ranks) if n > 1 and len(ranks) > 1
                         else None)
                if self.rank in ranks:
                    self.groups[name] = group

    def size(self, name: str) -> int:
        return self.shape.get(name, 1)

    def index(self, name: str) -> int:
        """This rank's coordinate on axis `name` (0 where the mesh has no
        such axis), JAX's lax.axis_index."""
        return self.coords.get(name, 0)

    def all_reduce(self, x: torch.Tensor, axes, op=None) -> torch.Tensor:
        """x reduced over the ranks that differ in `axes` (one axis name,
        or a tuple of every axis of the mesh: the whole world), in place,
        and returned. op: a dist.ReduceOp (SUM by default). Axes of size
        1 issue no collective."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        names = tuple(a for a in names if self.size(a) > 1)
        if not names:
            return x
        op = dist.ReduceOp.SUM if op is None else op
        if set(names) == {a for a in self.names if self.size(a) > 1}:
            dist.all_reduce(x, op=op)
        elif len(names) == 1:
            dist.all_reduce(x, op=op, group=self.groups[names[0]])
        else:
            raise ValueError(f"a reduction over {names}: one axis or all")
        return x

    def gather_rows(self, slab: torch.Tensor, height: int,
                    axis: str = "dp") -> torch.Tensor:
        """The whole image from each rank's row slab along `axis`: the slab
        written into a full frame of -0.0 and one SUM over the axis. The
        slabs are disjoint, and -0.0 + x is x for every x (the sign of a
        zero included), so the sum is exact."""
        n = self.size(axis)
        if n == 1:
            return slab
        rows = slab.shape[0]
        full = torch.full((height,) + tuple(slab.shape[1:]), -0.0,
                          dtype=slab.dtype, device=slab.device)
        row0 = self.index(axis) * rows
        full[row0:row0 + rows] = slab
        return self.all_reduce(full, axis)


def _world(n_devices: Optional[int]) -> int:
    world = dist.get_world_size() if dist.is_initialized() else 1
    return n_devices or world


def make_render_mesh(n_devices: Optional[int] = None, sp: int = 1, *,
                     device="cuda") -> RankMesh:
    """A (dp, sp) mesh over the n ranks of the process group (all of
    them by default)."""
    n = _world(n_devices)
    if n % sp:
        raise ValueError(f"{n} ranks do not split into sp={sp}")
    return RankMesh({"dp": n // sp, "sp": sp}, device=device)


def make_gp_mesh(n_devices: Optional[int] = None, dp: int = 1, sp: int = 1,
                 *, device="cuda") -> RankMesh:
    """('gp',), ('dp', 'gp'), ('sp', 'gp') or ('dp', 'sp', 'gp'): image
    rows x path samples x face shards, axes of size 1 dropped as JAX
    drops them (dp and sp lead, gp varies fastest)."""
    n = _world(n_devices)
    if n % (dp * sp):
        raise ValueError(f"{n} ranks do not split into dp={dp} x sp={sp}")
    shape = {name: size for name, size in (("dp", dp), ("sp", sp))
             if size > 1}
    shape["gp"] = n // (dp * sp)
    return RankMesh(shape, device=device)


__all__ = ["RankMesh", "make_render_mesh", "make_gp_mesh", "rank_device"]
