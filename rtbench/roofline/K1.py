"""K1, the all-on-chip closest hit (csrc/closest_hit.cu
closest_hit_kernel): in the split lit frame, every pixel's camera ray
against a mesh the card holds on chip and, fused into the same walk, the
spheres.

Bytes: the rays' directions (3 f32 a pixel; the origin is shared), the
triangles (9 f32 each) and the spheres (4 f32 each) read once; written
once a pixel, the hit record: the mesh winner's t and face (f32, i32)
and, where the scene has spheres, the sphere winner's t, id and unit
normal (5 f32). Operations: no defensible floor (a ray that misses every
bound needs no triangle test); bound by bytes."""

from . import F32, I32, TRIANGLE

KERNEL = "closest_hit_kernel"


def work(shape: dict):
    px = shape["width"] * shape["height"]
    record = F32 + I32 + (5 * F32 if shape["spheres"] else 0)
    return 0.0, float(px * 3 * F32 + shape["faces"] * TRIANGLE
                      + shape["spheres"] * 4 * F32 + px * record)
