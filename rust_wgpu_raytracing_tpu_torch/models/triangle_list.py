"""Triangle-mesh model (reference src/models/triangle_list/).

The reference TriangleList owns a loaded Model, its storage buffers and
an 8-entry bind-group layout (triangle_list.rs:79-226); here it owns a
MeshConfig, loads its asset and places it in world space. Scene.build
concatenates every mesh into the scene's triangle soup.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..config import MeshConfig, resolve_asset
from ..io.obj import ObjMaterial, ObjMesh


@dataclass
class TriangleList:
    config: MeshConfig

    def load(self) -> Tuple[List[ObjMesh], List[ObjMaterial]]:
        """Resolve + load this config's asset — the analogue of
        resources::load_model feeding TriangleList::new
        (src/resources.rs:116-213, triangle_list.rs:79). Builtin
        procedural assets (cube / terrain stress mesh) need no files;
        anything else goes through the OBJ loader (io/obj.py)."""
        path = self.config.obj_path
        if path == "builtin:cube":
            from ..io.obj import make_cube

            return [make_cube()], [ObjMaterial(
                name="builtin", ambient=(0.05,) * 3, diffuse=(0.8,) * 3,
                specular=(0.2,) * 3)]
        if path.startswith("builtin:terrain"):
            # "builtin:terrain" or "builtin:terrain:<grid_n>" — the
            # large-scene stress asset (512 -> 522k faces)
            from ..io.obj import make_terrain

            parts = path.split(":")
            grid_n = int(parts[2]) if len(parts) > 2 else 512
            return [make_terrain(grid_n)], [ObjMaterial(
                name="builtin", ambient=(0.05,) * 3, diffuse=(0.8,) * 3,
                specular=(0.2,) * 3)]
        from ..io.obj import load_obj

        return load_obj(resolve_asset(path))

    def world_positions(self, mesh: ObjMesh) -> np.ndarray:
        """Model transform (scale then translate) into world space — the
        instance-matrix analogue the reference bakes per TriangleList
        (triangle_list.rs:94-117)."""
        return (mesh.positions * np.float32(self.config.scale)
                + np.asarray(self.config.translation, np.float32))
