"""OBJ/MTL importer to flat SoA arrays.

The TPU-native analogue of the reference's asset pipeline
(src/resources.rs:163-264): where the reference parses OBJ with tobj
(`triangulate: true, single_index: true`, resources.rs:175-179) and uploads
GPU-padded ModelVertexSmall/ModelFaceSmall storage buffers
(src/model.rs:45-79), we parse to flat NumPy arrays — positions (V,3) f32,
uvs (V,2) f32, faces (F,3) i32 — which become device-resident torch tensors
with no layout padding.

Semantics matched to tobj:
- polygons are fan-triangulated (v0, vi, vi+1);
- `single_index`: each distinct (v, vt, vn) index triple becomes one output
  vertex, numbered in order of first appearance — so vertex/face counts
  match what the reference's GPU buffers contain;
- OBJ indices are 1-based; negative indices are relative to the current end
  of the respective array;
- missing vt/vn are filled with zeros (tobj fills missing texcoords with 0).

A native C++ parser (native/rtnative.cpp, the port's copy of the JAX
package's) serves single-group files when its library builds; this
module's pure-Python parser is the reference implementation and the
fallback (same meshes, same materials).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class ObjMaterial:
    """MTL material — superset of the reference's Material
    (src/model.rs:108-115: name, diffuse texture, ambient/diffuse/specular).
    `map_bump` is parsed for the normal-mapping extension (the reference
    ships cube-normal.png but never samples it)."""

    name: str = ""
    ambient: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # Ka
    diffuse: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # Kd
    specular: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # Ks
    shininess: float = 0.0  # Ns
    map_kd: Optional[str] = None
    map_bump: Optional[str] = None


@dataclass
class ObjMesh:
    """One OBJ object/group after single-index re-indexing."""

    name: str
    positions: np.ndarray  # (V,3) f32
    uvs: np.ndarray  # (V,2) f32
    normals: np.ndarray  # (V,3) f32
    faces: np.ndarray  # (F,3) i32
    material_id: int = 0


def parse_mtl(path: str) -> List[ObjMaterial]:
    materials: List[ObjMaterial] = []
    cur: Optional[ObjMaterial] = None
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                cur = ObjMaterial(name=parts[1] if len(parts) > 1 else "")
                materials.append(cur)
            elif cur is None:
                continue
            elif key == "Ka":
                cur.ambient = tuple(float(x) for x in parts[1:4])
            elif key == "Kd":
                cur.diffuse = tuple(float(x) for x in parts[1:4])
            elif key == "Ks":
                cur.specular = tuple(float(x) for x in parts[1:4])
            elif key == "Ns":
                cur.shininess = float(parts[1])
            elif key == "map_Kd":
                cur.map_kd = parts[-1]
            elif key in ("map_Bump", "map_bump", "bump"):
                cur.map_bump = parts[-1]
    return materials


def _parse_index(token: str, length: int) -> int:
    i = int(token)
    return i - 1 if i > 0 else length + i


def load_obj(path: str, use_native: Optional[bool] = None
             ) -> Tuple[List[ObjMesh], List[ObjMaterial]]:
    """Parse an OBJ file (+ its mtllib) into single-indexed SoA meshes.

    use_native: True forces the C++ parser (native/rtnative.cpp), False
    forces pure Python, None (default) picks native when available for
    single-group files (multi-group files use the Python path, which
    splits per-mesh vertex pools).
    """
    if use_native is not False:
        result = _load_obj_native(path)
        if result is not None:
            return result
        if use_native is True:
            raise RuntimeError("native OBJ parser unavailable or file "
                               "needs the python path")
    return _load_obj_python(path)


def _load_obj_native(path: str):
    from .. import native as nat

    try:
        parsed = nat.obj_parse_native(path)
    except ValueError:
        return None
    if parsed is None:
        return None
    pos, uv, nrm, faces, fmat, starts, mtllib, mat_names = parsed
    if len(starts) != 1:
        return None  # multi-group: python path splits per-mesh pools
    if len(fmat) and len(np.unique(np.asarray(fmat))) > 1:
        # multiple usemtl runs inside one group: tobj splits a model
        # whenever the material changes — the python path implements
        # that split (per-mesh vertex pools), so defer to it
        return None

    materials: List[ObjMaterial] = []
    if mtllib:
        mtl_path = os.path.join(os.path.dirname(path), mtllib)
        if os.path.exists(mtl_path):
            materials = parse_mtl(mtl_path)
    if not materials:
        materials = [ObjMaterial(name="default", ambient=(0.01,) * 3,
                                 diffuse=(0.8,) * 3, specular=(0.17,) * 3)]
    name_to_id = {m.name: i for i, m in enumerate(materials)}
    # the native parser numbers usemtl names by first appearance; remap
    # to MTL order (mesh-level material = first face's material, matching
    # the python path / tobj's mesh.material_id)
    mat_id = 0
    if len(fmat) and mat_names:
        first = mat_names[int(fmat[0])] if int(fmat[0]) < len(mat_names) else ""
        mat_id = name_to_id.get(first, 0)

    mesh = ObjMesh(name=os.path.basename(path), positions=pos, uvs=uv,
                   normals=nrm, faces=faces, material_id=mat_id)
    return [mesh], materials


def _load_obj_python(path: str) -> Tuple[List[ObjMesh], List[ObjMaterial]]:
    """Pure-Python reference parser."""
    positions: List[Tuple[float, float, float]] = []
    uvs: List[Tuple[float, float]] = []
    normals: List[Tuple[float, float, float]] = []
    materials: List[ObjMaterial] = []
    mat_ids: Dict[str, int] = {}

    meshes: List[ObjMesh] = []

    # per-mesh accumulation state
    name = "default"
    cur_mat = 0
    group_mat = None  # material of the group's FIRST face — the mesh's
    #                   material_id (tobj single-material-per-mesh
    #                   semantics; matches the native parser's remap)
    remap: Dict[Tuple[int, int, int], int] = {}
    out_pos: List = []
    out_uv: List = []
    out_nrm: List = []
    out_faces: List[Tuple[int, int, int]] = []

    def flush():
        nonlocal remap, out_pos, out_uv, out_nrm, out_faces, group_mat
        if out_faces:
            meshes.append(ObjMesh(
                name=name,
                positions=np.asarray(out_pos, dtype=np.float32).reshape(-1, 3),
                uvs=np.asarray(out_uv, dtype=np.float32).reshape(-1, 2),
                normals=np.asarray(out_nrm, dtype=np.float32).reshape(-1, 3),
                faces=np.asarray(out_faces, dtype=np.int32).reshape(-1, 3),
                material_id=group_mat if group_mat is not None else cur_mat,
            ))
        remap, out_pos, out_uv, out_nrm, out_faces = {}, [], [], [], []
        group_mat = None

    def corner(token: str) -> int:
        comps = token.split("/")
        vi = _parse_index(comps[0], len(positions))
        ti = _parse_index(comps[1], len(uvs)) if len(comps) > 1 and comps[1] else -1
        ni = _parse_index(comps[2], len(normals)) if len(comps) > 2 and comps[2] else -1
        key = (vi, ti, ni)
        idx = remap.get(key)
        if idx is None:
            idx = len(out_pos)
            remap[key] = idx
            out_pos.append(positions[vi])
            out_uv.append(uvs[ti] if ti >= 0 else (0.0, 0.0))
            out_nrm.append(normals[ni] if ni >= 0 else (0.0, 0.0, 0.0))
        return idx

    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                positions.append(tuple(float(x) for x in parts[1:4]))
            elif key == "vt":
                uvs.append(tuple(float(x) for x in parts[1:3]))
            elif key == "vn":
                normals.append(tuple(float(x) for x in parts[1:4]))
            elif key == "f":
                if group_mat is None:
                    group_mat = cur_mat
                corners = [corner(t) for t in parts[1:]]
                for i in range(1, len(corners) - 1):  # fan triangulation
                    out_faces.append((corners[0], corners[i], corners[i + 1]))
            elif key in ("o", "g"):
                flush()
                name = parts[1] if len(parts) > 1 else "default"
            elif key == "usemtl":
                mat_name = parts[1] if len(parts) > 1 else ""
                new_mat = mat_ids.get(mat_name, 0)
                if out_faces and group_mat is not None \
                        and new_mat != group_mat:
                    # tobj splits a model whenever the material changes
                    # (single-material-per-mesh), even mid-group — flush
                    # the accumulated faces as their own mesh so later
                    # faces shade with the right material
                    flush()
                cur_mat = new_mat
            elif key == "mtllib":
                mtl_path = os.path.join(os.path.dirname(path), " ".join(parts[1:]))
                if os.path.exists(mtl_path):
                    materials = parse_mtl(mtl_path)
                    mat_ids = {m.name: i for i, m in enumerate(materials)}
    flush()

    if not materials:
        materials = [ObjMaterial(name="default", ambient=(0.01,) * 3,
                                 diffuse=(0.8,) * 3, specular=(0.17,) * 3)]
    return meshes, materials


def make_cube(size: float = 1.0) -> ObjMesh:
    """Procedural unit cube with per-face UVs — a standalone test asset so
    the framework's tests do not depend on external files."""
    s = size / 2.0
    # 6 faces x 4 corners, standard box
    face_defs = [
        # normal, corners (ccw seen from outside)
        ((0, 0, 1), [(-s, -s, s), (s, -s, s), (s, s, s), (-s, s, s)]),
        ((0, 0, -1), [(s, -s, -s), (-s, -s, -s), (-s, s, -s), (s, s, -s)]),
        ((1, 0, 0), [(s, -s, s), (s, -s, -s), (s, s, -s), (s, s, s)]),
        ((-1, 0, 0), [(-s, -s, -s), (-s, -s, s), (-s, s, s), (-s, s, -s)]),
        ((0, 1, 0), [(-s, s, s), (s, s, s), (s, s, -s), (-s, s, -s)]),
        ((0, -1, 0), [(-s, -s, -s), (s, -s, -s), (s, -s, s), (-s, -s, s)]),
    ]
    uv4 = [(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)]
    pos, uv, nrm, faces = [], [], [], []
    for n, corners in face_defs:
        base = len(pos)
        pos.extend(corners)
        uv.extend(uv4)
        nrm.extend([n] * 4)
        faces.append((base, base + 1, base + 2))
        faces.append((base, base + 2, base + 3))
    return ObjMesh(
        name="cube",
        positions=np.asarray(pos, dtype=np.float32),
        uvs=np.asarray(uv, dtype=np.float32),
        normals=np.asarray(nrm, dtype=np.float32),
        faces=np.asarray(faces, dtype=np.int32),
    )


def make_terrain(n: int = 512, size: float = 2.0,
                 height: float = 0.25) -> ObjMesh:
    """Procedural heightfield: an n x n vertex grid in the XY plane with
    a deterministic sum-of-sines height in Z, 2*(n-1)^2 triangles.

    The large-scene stress asset (512 -> 522,242 faces): the reference
    caps out at 428 faces (cube.obj), so scaling the face-count axis
    (SURVEY §5.7) is exercised with generated geometry. Fully vectorized
    NumPy; UVs span the grid, vertex normals are the analytic surface
    normals of the height function.
    """
    assert n >= 2
    u = np.linspace(0.0, 1.0, n, dtype=np.float32)
    gx, gy = np.meshgrid(u, u, indexing="xy")
    x = (gx - 0.5) * size
    y = (gy - 0.5) * size

    def h(xx, yy):
        return height * (np.sin(3.1 * xx + 1.7 * yy)
                         + 0.5 * np.sin(7.3 * yy - 2.9 * xx)
                         + 0.25 * np.sin(13.7 * xx * yy + 0.5))

    z = h(x, y).astype(np.float32)
    # analytic partials for smooth shading normals
    dzx = height * (3.1 * np.cos(3.1 * x + 1.7 * y)
                    - 0.5 * 2.9 * np.cos(7.3 * y - 2.9 * x)
                    + 0.25 * 13.7 * y * np.cos(13.7 * x * y + 0.5))
    dzy = height * (1.7 * np.cos(3.1 * x + 1.7 * y)
                    + 0.5 * 7.3 * np.cos(7.3 * y - 2.9 * x)
                    + 0.25 * 13.7 * x * np.cos(13.7 * x * y + 0.5))
    nrm = np.stack([-dzx, -dzy, np.ones_like(z)], axis=-1)
    nrm = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)

    positions = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    uvs = np.stack([gx, gy], axis=-1).reshape(-1, 2).astype(np.float32)
    normals = nrm.reshape(-1, 3).astype(np.float32)

    idx = np.arange(n * n, dtype=np.int32).reshape(n, n)
    v00 = idx[:-1, :-1].ravel()
    v01 = idx[:-1, 1:].ravel()
    v10 = idx[1:, :-1].ravel()
    v11 = idx[1:, 1:].ravel()
    faces = np.concatenate([
        np.stack([v00, v01, v11], axis=1),
        np.stack([v00, v11, v10], axis=1),
    ], axis=0).astype(np.int32)
    return ObjMesh(name=f"terrain{n}", positions=positions, uvs=uvs,
                   normals=normals, faces=faces)
