"""A small launcher: n ranks of one function on this host.

    from rust_wgpu_raytracing_tpu_torch.parallel.launch import spawn
    frame = spawn(render_fn, 4, scene_cfg, backend="gloo")

spawn starts n processes (the "spawn" start method), joins them into one
process group through a file:// rendezvous in a fresh temporary
directory (so that concurrent launches on one host never share a port),
runs fn(*args, **kwargs) on every rank and returns rank 0's result with
every tensor in it as a NumPy array. It raises with the failing rank's
traceback when a rank raises or dies, and ends every rank it started
before it returns or raises. fn must be importable by name (a module's
top-level function).

Under torchrun (or any launcher that sets RANK, WORLD_SIZE and a
rendezvous), call init_process_group yourself and then the sharded
functions: they take the default process group.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist


def to_numpy(tree):
    """tree with every tensor as a NumPy array (on the host)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree


def _rank_main(rank, n, root, backend, fn, args, kwargs):
    try:
        # ranks share the host's cores: one intra-op thread each
        torch.set_num_threads(1)
        dist.init_process_group(backend, init_method=f"file://{root}/rdv",
                                world_size=n, rank=rank)
        try:
            out = to_numpy(fn(*args, **kwargs))
            dist.barrier()
        finally:
            dist.destroy_process_group()
        if rank == 0:
            with open(os.path.join(root, "result.pkl"), "wb") as fh:
                pickle.dump(out, fh)
    except BaseException:
        with open(os.path.join(root, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise SystemExit(1)


def spawn(fn, n: int, *args, backend: str = "gloo", timeout: float = 900.0,
          **kwargs):
    """Run fn(*args, **kwargs) on n ranks (see the module docstring)."""
    ctx = mp.get_context("spawn")
    root = tempfile.mkdtemp(prefix="rt_ranks_")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, root, backend, fn, args, kwargs),
                         daemon=True)
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break  # one rank failed: the others may wait forever
            if time.monotonic() > deadline:
                raise TimeoutError(f"{n} ranks of {fn.__name__} still "
                                   f"running after {timeout} s")
            time.sleep(0.05)
        errors = []
        for r, p in enumerate(procs):
            path = os.path.join(root, f"rank{r}.err")
            if os.path.exists(path):
                with open(path) as fh:
                    errors.append(f"rank {r}:\n{fh.read()}")
            elif p.exitcode not in (None, 0):
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if errors:
            raise RuntimeError(f"{fn.__name__} on {n} ranks failed:\n"
                               + "\n".join(errors))
        with open(os.path.join(root, "result.pkl"), "rb") as fh:
            return pickle.load(fh)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(root, ignore_errors=True)
