"""K10, the streamed per-ray closest hit (csrc/stream_sweep.cu
perray_culled_kernel): the path tracer's extension rays at each bounce
but the last, against a mesh past the on-chip limit.

Bytes a sample: at each of the `bounces` calls, every pixel's ray
(origin and direction, 6 f32) and the triangles (9 f32 each) read once,
the winner's t and face (f32, i32) written once a pixel. A path that
ended still has its lane in the call. Operations: no defensible floor;
bound by bytes."""

from . import F32, I32, TRIANGLE

KERNEL = "perray_culled_kernel"


def work(shape: dict):
    px = shape["width"] * shape["height"]
    per_call = px * 6 * F32 + shape["faces"] * TRIANGLE + px * (F32 + I32)
    return 0.0, float(shape["bounces"] * per_call)
