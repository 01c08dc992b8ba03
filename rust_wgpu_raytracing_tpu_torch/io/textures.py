"""Texture decode and sampler semantics.

The reference decodes PNG/JPEG to RGBA8, uploads as Rgba8UnormSrgb
(texture.rs:108-148) and samples with clamp-to-edge + linear mag filter
(texture.rs:151-158); `textureSampleGrad(..., 0, 0)`
(triangle_list/compute.wgsl:225) forces LOD<=0, i.e. bilinear mip-0
sampling. Here a texture is decoded once, linearized on the host and
kept as a (H,W,3) f32 array; core/scene.py packs it into the u16 texel
pool that ops/megakernel.py gathers from.

8-bit RGB/RGBA PNGs (non-interlaced) decode with the standard-library
reader io/image_out.read_png, so a textured, bump-mapped scene loads
where PIL is not installed. Every other image format imports PIL when
it is loaded (ImportError without it); scenes without image textures
never import it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.math3d import srgb_to_linear
from .image_out import read_png

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


@dataclass(frozen=True)
class TextureData:
    """Decoded, linearized texture."""

    name: str
    rgb_linear: np.ndarray  # (H,W,3) f32, linear light
    rgb_u8: np.ndarray  # (H,W,3) u8, as-decoded sRGB bytes

    @property
    def height(self) -> int:
        return self.rgb_linear.shape[0]

    @property
    def width(self) -> int:
        return self.rgb_linear.shape[1]


def load_texture_file(path: str, srgb: bool = True) -> TextureData:
    """Decode an image file to a linear-light f32 texture.

    Matches Texture::from_image (texture.rs:108-133): convert to RGBA8 then
    treat as sRGB (so kernel-visible values are linearized). The alpha
    channel is dropped — the reference never uses texture alpha.
    """
    if _is_plain_png(path):
        rgb_u8 = read_png(path)
    else:
        from PIL import Image

        with Image.open(path) as im:
            rgba = np.asarray(im.convert("RGBA"), dtype=np.uint8)
        rgb_u8 = rgba[..., :3]
    rgb = rgb_u8.astype(np.float32) / 255.0
    if srgb:
        rgb = srgb_to_linear(rgb)
    return TextureData(name=path, rgb_linear=rgb.astype(np.float32), rgb_u8=rgb_u8)


def _is_plain_png(path: str) -> bool:
    """True for an 8-bit RGB or RGBA, non-interlaced PNG (what read_png
    decodes): signature, then the IHDR chunk's bit depth (byte 24),
    colour type (25) and interlace method (28)."""
    with open(path, "rb") as fh:
        head = fh.read(29)
    return (len(head) == 29 and head[:8] == _PNG_SIGNATURE
            and head[12:16] == b"IHDR" and head[24] == 8
            and head[25] in (2, 6) and head[28] == 0)


def solid_texture(color, size: int = 4, name: str = "solid") -> TextureData:
    """1-color texture used when a material has no map_Kd."""
    rgb = np.broadcast_to(np.asarray(color, dtype=np.float32), (size, size, 3)).copy()
    u8 = np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return TextureData(name=name, rgb_linear=rgb, rgb_u8=u8)


def checkerboard_texture(size: int = 64, cells: int = 8,
                         name: str = "checker") -> TextureData:
    """Procedural test texture (standalone test asset)."""
    yy, xx = np.mgrid[0:size, 0:size]
    cell = ((yy * cells // size) + (xx * cells // size)) % 2
    rgb = np.where(cell[..., None] == 0, 0.2, 0.9).astype(np.float32)
    rgb = rgb * np.array([1.0, 0.8, 0.6], dtype=np.float32)
    u8 = np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return TextureData(name=name, rgb_linear=rgb, rgb_u8=u8)
