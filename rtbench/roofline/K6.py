"""K6, the texture filter (csrc/texfilter.cu texfilter_kernel): in the
normal-mapped split lit frame, one launch a frame, the bump map's
bilinear sample at every pixel.

Bytes a pixel: the texel's packed 2x2 neighbourhood (12 u16 taps) and
the two f32 weights read once, the filtered RGB (3 f32) written once.
Operations: a few multiply-adds a channel, far under the bytes' time;
bound by bytes."""

from . import F32

KERNEL = "texfilter_kernel"
U16 = 2


def work(shape: dict):
    px = shape["width"] * shape["height"]
    return 0.0, float(px * (12 * U16 + 2 * F32 + 3 * F32))
