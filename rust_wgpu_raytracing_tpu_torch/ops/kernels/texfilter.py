"""Bilinear texture mix (kernel K6).

The wrapper `texfilter` launches csrc/texfilter.cu for CUDA tensors and
runs `texfilter_plain` for CPU tensors; each launch adds 1 to the
counter `launches.texfilter` (runtime/profiler.py). Both compute the JAX
package's _texfilter_kernel: per channel the bilinear mix of the 12 u16
taps scaled by the f32 constant 1/65535, with no shading (the
normal-mapping bump sample).
"""

from __future__ import annotations

import torch

from ...runtime.profiler import count
from .build import check, library
from .common import is_cuda_call, ptr, require, stream_ptr
from .texshade import TAP_SCALE


def _check(taps, fx, fy):
    n = fx.shape[0]
    require(taps, "taps", torch.int16, (12, n))
    require(fx, "fx", torch.float32, (n,))
    require(fy, "fy", torch.float32, (n,))
    return n


def texfilter(taps, fx, fy):
    """(r, g, b) (R,) f32. taps (12, R) int16 holding the u16 texel bits
    [t00, t01, t10, t11] x RGB; fx, fy (R,) f32 weights."""
    n = _check(taps, fx, fy)
    if not is_cuda_call(taps, fx, fy):
        return texfilter_plain(taps, fx, fy)
    out = torch.empty((3, n), dtype=torch.float32, device=fx.device)
    err = library().rt_texfilter(ptr(taps), ptr(fx), ptr(fy), n, ptr(out),
                                 stream_ptr(fx.device))
    check(err, "rt_texfilter")
    count("launches.texfilter")
    return out[0], out[1], out[2]


def texfilter_plain(taps, fx, fy):
    """Plain PyTorch version of texfilter (same arguments, same results)."""
    def tap(k):
        return (taps[k].to(torch.int32) & 0xFFFF).to(torch.float32) * TAP_SCALE

    out = []
    for ch in range(3):
        top = tap(ch) * (1.0 - fx) + tap(3 + ch) * fx
        bot = tap(6 + ch) * (1.0 - fx) + tap(9 + ch) * fx
        out.append(top * (1.0 - fy) + bot * fy)
    return tuple(out)
