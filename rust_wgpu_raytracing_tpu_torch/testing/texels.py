"""Seeded texel fixtures for the texture kernels (K2, K6).

`far_texel_case` puts texels past 2^24 in the packed pool, where an f32
base offset mis-addresses; the tests and chip_smoke.py hold texshade and
texfilter to their plain versions on it. It is not on any render path.
"""

from __future__ import annotations

import numpy as np
import torch


# a float32 holds every integer up to 2^24 exactly, not beyond
F32_EXACT = 2 ** 24


def far_texel_case(device, n: int = 1 << 16, seed: int = 24):
    """Seeded inputs whose texels lie past 2^24 in the packed pool, where
    an f32 base offset mis-addresses (JAX ops/megakernel.py documents
    it; the port holds the offsets as i32). The pool is (12, N) u16 bits
    (int16), about 400 MB: zeros but for two textures of random non-zero
    texels, 64 x 64 at base 2^24 + 3 and 33 x 97 at 2^24 + 4,107 (odd
    bases, which no f32 holds). n rays, half on each texture, at seeded
    (u, v) in [-0.1, 1.1) (clamp-to-edge included).

    Returns (pool, base (n,) i32, hw_h (n,) f32, hw_w (n,) f32, u, v
    (n,) f32, want (12, n) int16 on the CPU: the taps at each ray's
    texel address, computed in int64 on the host)."""
    rng = np.random.default_rng(seed)
    texs = ((F32_EXACT + 3, 64, 64), (F32_EXACT + 4107, 33, 97))
    n_texels = texs[-1][0] + texs[-1][1] * texs[-1][2] + 1
    pool = torch.zeros((12, n_texels), dtype=torch.int16, device=device)
    held = []
    for b, h, w in texs:
        t = rng.integers(1, 65536, (12, h * w), dtype=np.uint16)
        pool[:, b:b + h * w] = torch.from_numpy(t.view(np.int16)).to(device)
        held.append(t.view(np.int16))
    which = np.arange(n) % 2
    base = np.array([texs[k][0] for k in which], np.int32)
    hh = np.array([texs[k][1] for k in which], np.float32)
    ww = np.array([texs[k][2] for k in which], np.float32)
    u = rng.uniform(-0.1, 1.1, n).astype(np.float32)
    v = rng.uniform(-0.1, 1.1, n).astype(np.float32)
    # the glue's texel address (gather_packed_taps), the sum in int64
    x0f = np.floor(u * ww - np.float32(0.5))
    y0f = np.floor(v * hh - np.float32(0.5))
    x0 = np.minimum(np.maximum(x0f, 0), ww - 1).astype(np.int64)
    y0 = np.minimum(np.maximum(y0f, 0), hh - 1).astype(np.int64)
    local = y0 * ww.astype(np.int64) + x0
    want = np.empty((12, n), np.int16)
    for k in range(2):
        want[:, which == k] = held[k][:, local[which == k]]
    dev = [torch.from_numpy(a).to(device) for a in (base, hh, ww, u, v)]
    return (pool, *dev, torch.from_numpy(want))
