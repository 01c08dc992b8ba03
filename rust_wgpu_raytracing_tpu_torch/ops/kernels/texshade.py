"""Bilinear texture mix + Blinn-Phong combine (kernel K2).

The wrapper `texshade` launches csrc/texshade.cu for CUDA tensors and
runs `texshade_plain` for CPU tensors; each launch adds 1 to the counter
`launches.texshade` (runtime/profiler.py). Both compute the JAX
package's _texshade_kernel: p = ambient + tex * lam + specular * spec
per channel, tex the bilinear mix of the 12 u16 taps scaled by the f32
constant 1/65535.
"""

from __future__ import annotations

import numpy as np
import torch

from ...runtime.profiler import count
from .build import check, library
from .common import is_cuda_call, ptr, require, stream_ptr

TAP_SCALE = float(np.float32(1.0 / 65535.0))


def _check(taps, planes):
    n = planes[0].shape[0]
    require(taps, "taps", torch.int16, (12, n))
    for name, x in zip(("fx", "fy", "lam", "spec", "ar", "ag", "ab",
                        "sr", "sg", "sb"), planes):
        require(x, name, torch.float32, (n,))
    return n


def texshade(taps, fx, fy, lam, spec, ar, ag, ab, sr, sg, sb):
    """(pr, pg, pb) (R,) f32. taps (12, R) int16 holding the u16 texel
    bits [t00, t01, t10, t11] x RGB; the rest (R,) f32 planes."""
    planes = (fx, fy, lam, spec, ar, ag, ab, sr, sg, sb)
    n = _check(taps, planes)
    if not is_cuda_call(taps, *planes):
        return texshade_plain(taps, *planes)
    out = [torch.empty(n, dtype=torch.float32, device=fx.device)
           for _ in range(3)]
    err = library().rt_texshade(ptr(taps), *[ptr(p) for p in planes], n,
                                *[ptr(o) for o in out],
                                stream_ptr(fx.device))
    check(err, "rt_texshade")
    count("launches.texshade")
    return tuple(out)


def texshade_plain(taps, fx, fy, lam, spec, ar, ag, ab, sr, sg, sb):
    """Plain PyTorch version of texshade (same arguments, same results)."""
    def tap(k):
        return (taps[k].to(torch.int32) & 0xFFFF).to(torch.float32) * TAP_SCALE

    out = []
    for ch, amb, spc in ((0, ar, sr), (1, ag, sg), (2, ab, sb)):
        top = tap(ch) * (1.0 - fx) + tap(3 + ch) * fx
        bot = tap(6 + ch) * (1.0 - fx) + tap(9 + ch) * fx
        tex = top * (1.0 - fy) + bot * fy
        out.append(amb + tex * lam + spc * spec)
    return tuple(out)
