"""Correctly rounded f32 helpers.

The frame's parity with the JAX package rests on every f32 operation
being IEEE-rounded. torch's vectorized CPU sqrt is not (about 1 result
in 130 lands one ulp off), so on the CPU the square root is taken in
f64 and rounded once to f32, which is exact for sqrt. CUDA's sqrtf is
correctly rounded, and the kernels use it.
"""

from __future__ import annotations

import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(x.dtype)
    return torch.sqrt(x)
