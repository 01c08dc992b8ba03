"""The heightfield scene kind's inputs, made from the seed, and their
asset files (rtbench/scenes/heightfield.py; other kinds may build on
these functions).

A configuration names a heightfield (grid, size, amplitude: fixed), a
texture size, the spheres, the light and the material. The seed draws
the height function's three phases and the texture's palette and noise,
so every seed gives a mesh of the same size and shape class and a frame
of much the same work. The program loads the mesh as an OBJ/MTL/PNG
triple through its asset path; the reference takes the same arrays.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class SceneInputs:
    positions: np.ndarray  # (V, 3) f32, object space
    uvs: np.ndarray  # (V, 2) f32
    normals: np.ndarray  # (V, 3) f32
    faces: np.ndarray  # (F, 3) i32
    texture_u8: np.ndarray  # (TH, TW, 3) u8, sRGB
    spheres: List[dict]
    translation: tuple
    scale: float
    light_direction: tuple
    ambient: tuple
    diffuse: tuple
    specular: tuple


def heightfield(n: int, size: float, amplitude: float, phases):
    """An n x n vertex grid in the XY plane with a sum-of-sines height
    in Z (the port's procedural terrain, with seeded phases): positions,
    uvs spanning the grid, the analytic normals, 2 (n - 1)^2 faces."""
    p0, p1, p2 = (float(p) for p in phases)
    u = np.linspace(0.0, 1.0, n, dtype=np.float32)
    gx, gy = np.meshgrid(u, u, indexing="xy")
    x = (gx - 0.5) * size
    y = (gy - 0.5) * size
    z = amplitude * (np.sin(3.1 * x + 1.7 * y + p0)
                     + 0.5 * np.sin(7.3 * y - 2.9 * x + p1)
                     + 0.25 * np.sin(13.7 * x * y + 0.5 + p2))
    dzx = amplitude * (3.1 * np.cos(3.1 * x + 1.7 * y + p0)
                       - 0.5 * 2.9 * np.cos(7.3 * y - 2.9 * x + p1)
                       + 0.25 * 13.7 * y * np.cos(13.7 * x * y + 0.5 + p2))
    dzy = amplitude * (1.7 * np.cos(3.1 * x + 1.7 * y + p0)
                       + 0.5 * 7.3 * np.cos(7.3 * y - 2.9 * x + p1)
                       + 0.25 * 13.7 * x * np.cos(13.7 * x * y + 0.5 + p2))
    nrm = np.stack([-dzx, -dzy, np.ones_like(z)], axis=-1)
    nrm = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
    positions = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    uvs = np.stack([gx, gy], -1).reshape(-1, 2).astype(np.float32)
    idx = np.arange(n * n, dtype=np.int32).reshape(n, n)
    v00, v01 = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()
    v10, v11 = idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([v00, v01, v11], 1),
                            np.stack([v00, v11, v10], 1)]).astype(np.int32)
    return positions, uvs, nrm.reshape(-1, 3).astype(np.float32), faces


def texture(size: int, cells: int, rng: np.random.Generator) -> np.ndarray:
    """A size x size checker of `cells` cells a side in two seeded
    colours, with seeded per-texel noise of +-24 levels."""
    palette = rng.integers(40, 216, size=(2, 3))
    yy, xx = np.mgrid[0:size, 0:size]
    cell = ((yy * cells // size) + (xx * cells // size)) % 2
    noise = rng.integers(-24, 25, size=(size, size, 3))
    return np.clip(palette[cell] + noise, 0, 255).astype(np.uint8)


def make_inputs(config: dict, seed: int) -> SceneInputs:
    scene = config["scene"]
    mesh = scene["mesh"]
    seed %= 1 << 64
    rng = np.random.default_rng(np.random.SeedSequence([seed & 0xFFFFFFFF,
                                                        seed >> 32]))
    phases = rng.uniform(0.0, 2.0 * np.pi, size=3)
    pos, uv, nrm, faces = heightfield(mesh["grid"], mesh["size"],
                                      mesh["amplitude"], phases)
    return SceneInputs(
        positions=pos, uvs=uv, normals=nrm, faces=faces,
        texture_u8=texture(mesh["texture_size"], mesh["texture_cells"], rng),
        spheres=[dict(s) for s in scene.get("spheres", ())],
        translation=tuple(mesh["translation"]), scale=float(mesh["scale"]),
        light_direction=tuple(mesh["light_direction"]),
        ambient=tuple(mesh["ambient"]), diffuse=tuple(mesh["diffuse"]),
        specular=tuple(mesh["specular"]))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) u8 top-down image -> PNG bytes (8-bit RGB, filter 0)."""
    h, w, _ = img.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = img.reshape(h, 3 * w)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + chunk(b"IEND", b""))


def _rows(tag: str, a: np.ndarray) -> str:
    line = tag + " %.9g" * a.shape[1] + "\n"
    return (line * a.shape[0]) % tuple(a.ravel().tolist())


def write_assets(inputs: SceneInputs, directory: str) -> str:
    """Write mesh.obj, mesh.mtl and albedo.png into `directory`; returns
    the OBJ's file name. Vertex i carries uv i and normal i; floats are
    written with 9 significant digits, so they read back as the same f32."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "albedo.png"), "wb") as fh:
        fh.write(encode_png(inputs.texture_u8))
    with open(os.path.join(directory, "mesh.mtl"), "w") as fh:
        fh.write("newmtl surface\n"
                 "Ka %.9g %.9g %.9g\n" % inputs.ambient
                 + "Kd %.9g %.9g %.9g\n" % inputs.diffuse
                 + "Ks %.9g %.9g %.9g\n" % inputs.specular
                 + "map_Kd albedo.png\n")
    f1 = inputs.faces.astype(np.int64) + 1
    corners = np.repeat(f1, 3, axis=1)
    with open(os.path.join(directory, "mesh.obj"), "w") as fh:
        fh.write("mtllib mesh.mtl\no heightfield\n")
        fh.write(_rows("v", inputs.positions.astype(np.float64)))
        fh.write(_rows("vt", inputs.uvs.astype(np.float64)))
        fh.write(_rows("vn", inputs.normals.astype(np.float64)))
        fh.write("usemtl surface\n")
        line = "f" + " %d/%d/%d" * 3 + "\n"
        fh.write((line * f1.shape[0]) % tuple(corners.ravel().tolist()))
    return "mesh.obj"
