"""Correctly rounded f32 helpers.

The frame's parity with the JAX package rests on every f32 operation
being IEEE-rounded. torch's vectorized CPU sqrt is not (about 1 result
in 130 lands one ulp off), so on the CPU the square root is taken in
f64 and rounded once to f32, which is exact for sqrt. CUDA's sqrtf is
correctly rounded, and the kernels use it.

The JAX package's f32 arithmetic flushes denormal results to zero (the
TPU has no denormals, and XLA's CPU backend runs with flush-to-zero);
torch and CUDA (built without -ftz) keep them. The frame's one source
of denormals is the Blinn-Phong specular power (N.H)^32 of a small
N.H, so the port flushes that result with `ftz`.
"""

from __future__ import annotations

import numpy as np
import torch

FLT_MIN = float(np.finfo(np.float32).tiny)  # smallest normal f32


def sqrt(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(x.dtype)
    return torch.sqrt(x)


def ftz(x: torch.Tensor) -> torch.Tensor:
    """x with denormal values flushed to zero."""
    return torch.where(x.abs() < FLT_MIN, 0.0, x)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a * b + c rounded once (a fused multiply-add), on any device.

    The product of two f32 values is exact in f64; the f64 sum s rounds,
    and rounding s again to f32 is the single rounding of the exact sum
    except where s lies exactly halfway between two f32 values and the
    f64 sum dropped a remainder e: the exact sum is then past the
    midpoint on e's side, and the result steps to that neighbour."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c64 = c.to(torch.float64)
    s = p + c64
    bv = s - p
    e = (p - (s - bv)) + (c64 - bv)  # s + e == p + c exactly (TwoSum)
    r = s.to(torch.float32)
    d = s - r.to(torch.float64)
    toward = torch.where(d > 0, float("inf"), float("-inf")).to(r.dtype)
    nb = torch.nextafter(r, toward)
    mid = (r.to(torch.float64) + nb.to(torch.float64)) * 0.5
    step = (d != 0) & (s == mid) & (e * d > 0)
    return torch.where(step, nb, r)
