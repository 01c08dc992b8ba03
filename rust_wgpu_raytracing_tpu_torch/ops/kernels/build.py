"""Build and load the port's CUDA kernels.

Every kernel source under csrc/ compiles with its own nvcc process, all
started together, and one more nvcc call links the objects into one
shared library with a plain C interface, loaded with ctypes (no
PyTorch headers, so the build takes seconds). The library lands in
build/kernels/ at the repository root (git-ignored), named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged
one loads at once.

Flags: sm_90a (Hopper), -O3, and -fmad=false. nvcc contracts a*b+c
into a fused multiply-add by default; that changes the last ulp of the
plane math (t = o0/ndotd, h = o + t*(g.d)) and of the texture mix, and
the kernels must agree bit for bit with their plain PyTorch versions,
which round every product. --use_fast_math is never passed, so
division and sqrt stay IEEE-rounded.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-fmad=false", "-Xcompiler", "-fPIC"]

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float

# C signatures (csrc/*.cu): pointers and the stream are c_void_p
_SIGNATURES = {
    "rt_closest_hit": [_VOIDP] * 11 + [_INT] * 5 + [_FLOAT] * 2 + [_INT]
    + [_VOIDP] * 7 + [_VOIDP],
    "rt_anyhit": [_VOIDP] * 14 + [_INT] * 5 + [_VOIDP] + [_VOIDP],
    "rt_texshade": [_VOIDP] * 11 + [_INT] + [_VOIDP] * 3 + [_VOIDP],
    "rt_frame": [_VOIDP] * 12 + [_INT] * 7 + [_FLOAT] * 2 + [_VOIDP]
    + [_VOIDP],
    "rt_texfilter": [_VOIDP] * 3 + [_INT] + [_VOIDP] + [_VOIDP],
    "rt_closest_hit_perray": [_VOIDP] * 13 + [_INT] * 4 + [_VOIDP] * 2
    + [_VOIDP],
    "rt_extend_shadow": [_VOIDP] * 19 + [_INT] * 5 + [_VOIDP] * 3
    + [_VOIDP],
    "rt_hier_cull": [_VOIDP] * 3 + [_INT] * 2 + [_VOIDP] + [_VOIDP],
    "rt_super_any": [_VOIDP] * 9 + [_INT] * 3 + [_VOIDP] + [_VOIDP],
    "rt_sweep_front": [_VOIDP] * 15 + [_INT] * 6 + [_VOIDP] * 6 + [_VOIDP],
    "rt_stream_closest_hit": [_VOIDP] * 14 + [_INT] + [_VOIDP] + [_INT] * 4
    + [_VOIDP] + [_VOIDP],
    "rt_stream_closest_hit_perray": [_VOIDP] * 13 + [_INT] * 5
    + [_VOIDP] * 2 + [_VOIDP],
    "rt_stream_anyhit": [_VOIDP] * 16 + [_INT] + [_VOIDP] + [_INT] * 5
    + [_VOIDP] + [_VOIDP],
    # (int out[4]): registers, spilled bytes, shared bytes, blocks an SM
    "rt_closest_hit_resources": [_VOIDP],
    "rt_anyhit_resources": [_VOIDP],
    "rt_closest_hit_perray_resources": [_VOIDP],
    "rt_extend_shadow_resources": [_VOIDP],
    "rt_stream_closest_hit_resources": [_VOIDP],
    "rt_stream_closest_hit_perray_resources": [_VOIDP],
    "rt_stream_anyhit_resources": [_VOIDP],
    "rt_hier_cull_resources": [_VOIDP],
    "rt_super_any_resources": [_VOIDP],
    "rt_sweep_front_resources": [_VOIDP],
    "rt_frame_resources": [_INT, _VOIDP],  # (int mode, int out[4])
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"librt_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into the shared library (if not built yet) and
    return its path: one nvcc per source, in parallel, then one link.
    Raises on a compiler error, with its output."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    # processes building at once (ranks at their first launch) take turns:
    # the first builds, the others find its library when they get the lock
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(path):
                return path
            return _build(path, verbose)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build(path: str, verbose: bool) -> str:
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    extra = ["--ptxas-options=-v"] if verbose else []
    jobs = []
    for src in (s for s in sources() if s.endswith(".cu")):
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *extra, *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs = []
    failed = None
    for cmd, _, proc in jobs:
        log = proc.communicate()[0]
        logs.append(log)
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, cmd, log)
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed is not None:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n"
                               f"{' '.join(failed[1])}\n{failed[2]}")
        tmp = f"{path}.{tag}"
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    if verbose:
        print("".join(logs) + res.stdout + res.stderr, flush=True)
    os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _INT
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
