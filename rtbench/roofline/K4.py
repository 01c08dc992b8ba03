"""K4, the fused frame kernel (csrc/frame.cu frame_kernel): one launch a
lit frame of a mesh the card holds on chip. Its work: every pixel's
camera ray against the mesh and the spheres, the winner's shading
inputs, and its shadow ray.

Bytes: the rays' directions (3 f32 a pixel; the origin is shared), the
triangles (9 f32 each) and the spheres (4 f32 each) read once; written
once a pixel: the winner's depth, face and occlusion (3 x 4 bytes).
Operations: no floor is defensible (a ray that misses every bound
needs no triangle test), so the share is bound by bytes."""

from . import F32, I32, TRIANGLE

KERNEL = "frame_kernel"


def work(shape: dict):
    px = shape["width"] * shape["height"]
    nbytes = (px * 3 * F32 + shape["faces"] * TRIANGLE
              + shape["spheres"] * 4 * F32 + px * (2 * F32 + I32))
    return 0.0, float(nbytes)
