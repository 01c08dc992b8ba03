"""ctypes bindings for the native C++ host components (rtnative.cpp):
the OBJ parser, Morton codes, the radix argsort and the LBVH builder.

The library is built at first use with g++ (-O2 -fPIC -shared
-std=c++17, as the JAX package's native/Makefile builds its copy) into
build/native/ at the repository root (git-ignored), named by a hash of
the source and the flags: an edited source rebuilds, an unchanged one
loads at once. Each build writes its own temporary file and renames it
into place, so processes that build at once never load half a file.
Every entry point returns None where the library is unavailable (no
g++, a failed build, or RWRT_NO_NATIVE=1), and its callers
(io/obj.load_obj, ops/bvh.build_lbvh) then take their Python/NumPy
path, which gives the same arrays.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "rtnative.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "native")
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_tried = False


class _ObjResult(ctypes.Structure):
    _fields_ = [
        ("positions", ctypes.POINTER(ctypes.c_float)),
        ("uvs", ctypes.POINTER(ctypes.c_float)),
        ("normals", ctypes.POINTER(ctypes.c_float)),
        ("faces", ctypes.POINTER(ctypes.c_int32)),
        ("face_mat", ctypes.POINTER(ctypes.c_int32)),
        ("mesh_start", ctypes.POINTER(ctypes.c_int32)),
        ("n_verts", ctypes.c_int64),
        ("n_faces", ctypes.c_int64),
        ("n_meshes", ctypes.c_int64),
        ("mtllib", ctypes.c_char_p),
        ("mat_names", ctypes.c_char_p),
        ("error", ctypes.c_char_p),
    ]


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"librtnative_{h.hexdigest()[:16]}.so")


def build() -> Optional[str]:
    """Compile rtnative.cpp (if not built yet) and return the library's
    path; None without g++ or when the build fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)  # atomic: a concurrent build never sees half
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable
    or disabled via RWRT_NO_NATIVE=1."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried or os.environ.get("RWRT_NO_NATIVE") == "1":
        return _lib
    _tried = True
    path = build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.obj_parse.restype = ctypes.POINTER(_ObjResult)
    lib.obj_parse.argtypes = [ctypes.c_char_p]
    lib.obj_free.argtypes = [ctypes.POINTER(_ObjResult)]
    lib.morton3d.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint32)]
    lib.radix_sort_u32.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32)]
    lib.lbvh_build.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    lib.lbvh_refit.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
    for fn in (lib.obj_free, lib.morton3d, lib.radix_sort_u32,
               lib.lbvh_build, lib.lbvh_refit):
        fn.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def obj_parse_native(path: str):
    """Parse an OBJ into the flat soup. Returns (positions, uvs, normals,
    faces, face_mat, mesh_start, mtllib, mat_names) or None if the
    library is unavailable. Raises ValueError on parse errors."""
    lib = get_lib()
    if lib is None:
        return None
    res = lib.obj_parse(path.encode())
    try:
        r = res.contents
        if r.error:
            raise ValueError(r.error.decode())
        nv, nf, nm = r.n_verts, r.n_faces, r.n_meshes
        pos = np.ctypeslib.as_array(r.positions, (nv, 3)).copy()
        uv = np.ctypeslib.as_array(r.uvs, (nv, 2)).copy() if nv else \
            np.zeros((0, 2), np.float32)
        nrm = np.ctypeslib.as_array(r.normals, (nv, 3)).copy() if nv else \
            np.zeros((0, 3), np.float32)
        faces = np.ctypeslib.as_array(r.faces, (nf, 3)).copy() if nf else \
            np.zeros((0, 3), np.int32)
        fmat = np.ctypeslib.as_array(r.face_mat, (nf,)).copy() if nf else \
            np.zeros((0,), np.int32)
        starts = np.ctypeslib.as_array(r.mesh_start, (nm,)).copy()
        mtllib = r.mtllib.decode() if r.mtllib else ""
        mat_names = (r.mat_names.decode().split("\n")
                     if r.mat_names else [])
        mat_names = [m for m in mat_names if m]
        return pos, uv, nrm, faces, fmat, starts, mtllib, mat_names
    finally:
        lib.obj_free(res)


def morton3d_native(points: np.ndarray) -> Optional[np.ndarray]:
    """30-bit Morton codes (ops/bvh.morton3d's), or None."""
    lib = get_lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points: shape {pts.shape}, expected (N, 3)")
    out = np.empty((pts.shape[0],), np.uint32)
    lib.morton3d(_ptr(pts, ctypes.c_float), pts.shape[0],
                 _ptr(out, ctypes.c_uint32))
    return out


def radix_argsort_native(codes: np.ndarray) -> Optional[np.ndarray]:
    """The stable ascending argsort of u32 codes, or None."""
    lib = get_lib()
    if lib is None:
        return None
    c = np.ascontiguousarray(codes, np.uint32)
    order = np.empty((c.shape[0],), np.int32)
    lib.radix_sort_u32(_ptr(c, ctypes.c_uint32), c.shape[0],
                       _ptr(order, ctypes.c_int32))
    return order


def lbvh_build_native(codes_sorted: np.ndarray, leaf_lo: np.ndarray,
                      leaf_hi: np.ndarray):
    """Returns (left, right, parent, node_lo, node_hi) or None."""
    lib = get_lib()
    if lib is None:
        return None
    c = np.ascontiguousarray(codes_sorted, np.uint32)
    n = c.shape[0]
    left = np.zeros((max(n - 1, 0),), np.int32)
    right = np.zeros((max(n - 1, 0),), np.int32)
    parent = np.full((2 * n - 1,), -1, np.int32)
    lib.lbvh_build(_ptr(c, ctypes.c_uint32), n,
                   _ptr(left, ctypes.c_int32), _ptr(right, ctypes.c_int32),
                   _ptr(parent, ctypes.c_int32))
    node_lo = np.zeros((2 * n - 1, 3), np.float32)
    node_hi = np.zeros((2 * n - 1, 3), np.float32)
    node_lo[n - 1:] = leaf_lo
    node_hi[n - 1:] = leaf_hi
    lib.lbvh_refit(_ptr(left, ctypes.c_int32), _ptr(right, ctypes.c_int32),
                   _ptr(parent, ctypes.c_int32), n,
                   _ptr(node_lo, ctypes.c_float),
                   _ptr(node_hi, ctypes.c_float))
    return left, right, parent, node_lo, node_hi
