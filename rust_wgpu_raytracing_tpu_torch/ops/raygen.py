"""Primary-ray generation for the oracle (JAX ops/raygen.py).

Matches `pixelToRay` (sphere/compute.wgsl:87-101 == triangle_list
/compute.wgsl:150-164) including the premultiplied OPENGL_TO_WGPU quirk in
the proj_inv uniform (see core/camera.py):

    x_nds = 2(x+0.5)/W - 1;  y_nds = 2(y+0.5)/H - 1
    view  = (GL2WGPU @ P^-1) @ (x_nds, y_nds, 1, 1);  view.w = 0
    world = V^-1 @ view;  dir = normalize(world.xyz);  origin = eye

Pixel (x=0, y=0) is texel (0,0), displayed at the BOTTOM-left of the
window. All math in f32, in the JAX package's operation order: the 3x4
camera product summed in index order (ops/megakernel.py _ray_matrix),
each direction's three terms added left to right, and the direction
divided by its length sqrt(x*x + y*y + z*z) (jnp.linalg.norm's value;
torch.linalg.norm computes it another way). The split and fused frames
take their planar rays from ops/megakernel.py raygen_planar, which
multiplies by the reciprocal length as the JAX planar raygen does.
"""

from __future__ import annotations

import torch

from ..core.camera import CameraUniforms
from .megakernel import _ray_matrix, _rcp
from .rounding import sqrt


def ndc_grid(width: int, height: int, *, device):
    """Returns (x_nds[W], y_nds[H]) pixel-center NDC coordinates, f32.
    A division by the width is the multiply by its f32 reciprocal that
    XLA substitutes."""
    x = torch.arange(width, dtype=torch.float32, device=device)
    y = torch.arange(height, dtype=torch.float32, device=device)
    return ((2.0 * (x + 0.5)) * _rcp(width) - 1.0,
            (2.0 * (y + 0.5)) * _rcp(height) - 1.0)


def ray_directions(width: int, height: int, uni: CameraUniforms, *,
                   device) -> torch.Tensor:
    """(H, W, 3) f32 normalized world-space ray directions: with M =
    V^-1[:3,:3] @ (GL2WGPU @ P^-1)[:3,:], d = M[:,0] x + M[:,1] y +
    (M[:,2] + M[:,3]), then d / |d|."""
    m, const = _ray_matrix(uni)
    x_nds, y_nds = ndc_grid(width, height, device=device)
    col = [torch.tensor(m[:, k], dtype=torch.float32, device=device)
           for k in (0, 1)]
    c = torch.tensor(const, dtype=torch.float32, device=device)
    d = (col[0][None, None, :] * x_nds[None, :, None]
         + col[1][None, None, :] * y_nds[:, None, None]
         + c[None, None, :])
    return d / sqrt(d[..., 0:1] * d[..., 0:1] + d[..., 1:2] * d[..., 1:2]
                    + d[..., 2:3] * d[..., 2:3])


def ray_directions_ortho(width: int, height: int, origin, scale: float = 5.0,
                         *, device):
    """Dead-code parity: `pixelToRay_ortho`. Returns (origins (H,W,3),
    dir (3,)) — rays at z-offset grid positions pointing -z."""
    x_nds, y_nds = ndc_grid(width, height, device=device)
    o = torch.as_tensor(origin, dtype=torch.float32, device=device)
    origins = torch.stack([
        (o[0] + x_nds[None, :] * scale).expand(height, width),
        (o[1] + y_nds[:, None] * scale).expand(height, width),
        o[2].expand(height, width),
    ], dim=-1)
    return origins, torch.tensor([0.0, 0.0, -1.0], dtype=torch.float32,
                                 device=device)
