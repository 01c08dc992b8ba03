"""K8, the path tracer's fused extension and shadow sweep
(csrc/extend_shadow.cu extend_shadow_kernel): at each bounce but the
last, the closest hit of every lane's extension ray and the occlusion of
its shadow ray, against a mesh the card holds on chip.

Bytes a sample: at each of the `bounces` calls, both rays of every pixel
(origin and direction, 6 f32 each) read once, the triangles (9 f32
each) read once, and the winner's t and face (f32, i32) and the
occlusion (1 byte) written once a pixel. A path that ended still has its
lane in the call. Operations: no defensible floor; bound by bytes."""

from . import F32, I32, TRIANGLE

KERNEL = "extend_shadow_kernel"


def work(shape: dict):
    px = shape["width"] * shape["height"]
    per_call = (px * 12 * F32 + shape["faces"] * TRIANGLE
                + px * (F32 + I32 + 1))
    return 0.0, float(shape["bounces"] * per_call)
