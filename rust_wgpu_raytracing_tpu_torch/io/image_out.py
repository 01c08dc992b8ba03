"""Framebuffer presentation: sRGB encode, and PNG read/write from the
standard library alone (zlib + struct), so presenting a frame needs no
PIL.

Framebuffer convention: fb[y, x] with y=0 being the reference's texel row 0,
which the screenquad displays at the BOTTOM of the window (NDC (-1,-1) maps
to tex (0,0), src/lib.rs:39-64). Image files use top-down rows, so writers
flip vertically.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from ..core.math3d import linear_to_srgb


def framebuffer_to_image(fb, srgb: bool = True) -> np.ndarray:
    """(H,W,3|4) float framebuffer -> (H,W,3) u8 image, top-down rows
    (host encode, numpy; the goldens' encoder)."""
    if isinstance(fb, torch.Tensor):
        fb = fb.detach().cpu().numpy()
    fb = np.asarray(fb)
    rgb = np.clip(fb[..., :3], 0.0, 1.0).astype(np.float32)
    if srgb:
        rgb = linear_to_srgb(rgb)
    img = (rgb * 255.0 + 0.5).astype(np.uint8)
    return img[::-1]  # texel row 0 is screen bottom -> image bottom


def encode_u8_device(color: torch.Tensor, srgb: bool = True) -> torch.Tensor:
    """Device-side present encode: (H,W,3|4) f32 framebuffer -> (H,W,3)
    u8 on the same device, still bottom-up, so only the u8 image crosses
    to the host. pow may differ from numpy's by an ulp, so a pixel on a
    quantization boundary can land 1 level off framebuffer_to_image;
    file writers keep the host encode."""
    rgb = color[..., :3].to(torch.float32).clamp(0.0, 1.0)
    if srgb:
        rgb = torch.where(rgb <= 0.0031308, rgb * 12.92,
                          1.055 * rgb ** (1.0 / 2.4) - 0.055)
    return (rgb * 255.0 + 0.5).to(torch.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """(H,W,3) u8 top-down image -> PNG bytes (8-bit RGB, filter 0)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, ch = img.shape
    if ch != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = img.reshape(h, 3 * w)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, fb, srgb: bool = True) -> None:
    with open(path, "wb") as fh:
        fh.write(encode_png(framebuffer_to_image(fb, srgb=srgb)))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(h, 1 + stride)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        cur = np.zeros(stride, np.int32)
        if kind in (0, 2):
            cur = (line + (prev if kind == 2 else 0)) & 0xFF
        else:  # sub / average / paeth depend on the left pixel: sequential
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) // 2
                elif kind == 4:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                else:
                    raise ValueError(f"bad PNG filter type {kind}")
                cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out.astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """PNG file -> (H,W,3) u8 (8-bit RGB or RGBA, non-interlaced)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or color not in (2, 6) or interlace:
        raise ValueError(f"{path}: only 8-bit RGB/RGBA non-interlaced PNG")
    ch = 3 if color == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    return img[..., :3]
