"""Framebuffer quantization (the rgba8unorm storage write)."""

from __future__ import annotations

import numpy as np
import torch

# the f32 constant the JAX package folds on the host (no divide op)
_INV255 = float(np.float32(1.0 / 255.0))


def quantize_rgba8(color: torch.Tensor) -> torch.Tensor:
    """Model the rgba8unorm storage-texture write (sphere/compute.wgsl:2):
    clamp to [0,1] and round to 8-bit levels.

    The dequantize multiplies by an EXPLICIT f32 reciprocal instead of
    dividing, exactly as the JAX package's shade.quantize_rgba8 does, so
    the two agree bit for bit."""
    c = color.clamp(0.0, 1.0)
    return torch.floor(c * 255.0 + 0.5) * _INV255
