"""K9, the streamed closest hit from the camera (csrc/stream_sweep.cu
shared_culled_kernel): every pixel's camera ray of a lit frame against a
mesh past the on-chip limit, in launches of subtile batches.

Bytes: the rays' directions (3 f32 a pixel; the origin is shared) and
the triangles (9 f32 each) read once; the winner's t and face (f32, i32)
written once a pixel. Operations: no defensible floor; bound by bytes."""

from . import F32, I32, TRIANGLE

KERNEL = "shared_culled_kernel"


def work(shape: dict):
    px = shape["width"] * shape["height"]
    return 0.0, float(px * 3 * F32 + shape["faces"] * TRIANGLE
                      + px * (F32 + I32))
