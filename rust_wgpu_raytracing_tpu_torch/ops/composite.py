"""Depth mapping and the reference's pass compositing.

The reference composites sequential compute passes with a strict `<`
test on a nonlinear depth (sphere/compute.wgsl:128-156). The oracle
(ops/oracle.py) folds each pass with composite_pass; the frames
(ops/megakernel.py render_megakernel) fold each pass into planar
(color, depth) tensors with the same rule.
"""

from __future__ import annotations

import numpy as np
import torch


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


def composite_pass(color, depth, pass_color, pass_t, pass_hit, near, far):
    """Fold one pass into the framebuffer (JAX ops/composite.py).

    color: (..., 3) current; depth: (...) current NONLINEAR depth
    (initialized to 1.0 = cleared); pass_t: (...) ray distance (+inf
    miss); pass_hit: (...) bool. Write where hit AND nonlinear(t) < depth
    (strict, so earlier passes win ties — sphere/compute.wgsl:133)."""
    d = to_nonlinear_depth(pass_t, near, far)
    write = pass_hit & (d < depth)
    color = torch.where(write[..., None], pass_color, color)
    depth = torch.where(write, d, depth)
    return color, depth


def clear(shape, background, *, device):
    """The analogue of the compute_clear_buffer copies
    (src/lib.rs:1024-1104): color = background, stored depth = 0 which
    reads back as current_depth 1.0. `shape` is the framebuffer's (...)
    shape."""
    color = torch.tensor(background, dtype=torch.float32,
                         device=device).expand(*shape, 3).contiguous()
    depth = torch.ones(shape, dtype=torch.float32, device=device)
    return color, depth
