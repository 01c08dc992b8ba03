"""Depth mapping for the reference's pass compositing.

The reference composites sequential compute passes with a strict `<`
test on a nonlinear depth (sphere/compute.wgsl:128-156); the frame
(ops/megakernel.py render_megakernel) folds each pass into planar
(color, depth) tensors with the same rule.
"""

from __future__ import annotations

import numpy as np


def depth_constants(near: float = 0.01, far: float = 100.0):
    """(inv_near, rcp_span) as exact f32 values held in Python floats:
    toNonLinearDepth(t) = (1/t - inv_near) * rcp_span.

    XLA rewrites a division by a constant into a multiply by the
    constant's f32 reciprocal (its algebraic simplifier, on every
    backend), so the JAX package's `(1/t - 1/near) / (1/far - 1/near)`
    computes this product; the port writes the product out."""
    inv_near = float(np.float32(1.0 / near))
    span = np.float32((1.0 / far) - (1.0 / near))
    return inv_near, float(np.float32(1.0) / span)


def to_nonlinear_depth(t, near: float = 0.01, far: float = 100.0):
    """toNonLinearDepth (sphere/compute.wgsl:59-61): inverse-depth mapped so
    near->0, far->1. NOTE near/far here are the KERNEL constants (.01/100),
    not the camera znear/zfar — reference quirk preserved
    (config.RenderConfig.kernel_near/kernel_far)."""
    inv_near, rcp_span = depth_constants(near, far)
    return ((1.0 / t) - inv_near) * rcp_span
