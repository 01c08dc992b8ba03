"""Counter-based random draws: threefry-2x32 with 20 rounds, keyed as
jax.random's PRNGKey, fold_in and split, and its uniform floats.

Written out from the published algorithm (Salmon et al., "Parallel
random numbers: as easy as 1, 2, 3", SC 2011) and jax.random's key
conventions: a key is two u32 words; PRNGKey(s) = (0, s); fold_in(k, x)
and split(k)[i] hash the counter (0, x) or (0, i) under k; uniform(k)
at lane i hashes (0, i), xors the two words, keeps the top 23 bits as
the mantissa of a float in [1, 2) and subtracts 1.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)


def threefry2x32(k0: int, k1: int, x0, x1):
    """On Python ints, or int64 tensors holding u32 values."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[(i % 2) * 4:(i % 2) * 4 + 4]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & M32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def prng_key(seed: int):
    return (0, int(seed) & M32)


def fold_in(key, data: int):
    return threefry2x32(key[0], key[1], 0, int(data) & M32)


def split(key, num: int = 2):
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def uniform_at(key, lanes: torch.Tensor) -> torch.Tensor:
    """f32 uniforms in [0, 1) at the lane ids (int64 tensor)."""
    x0, x1 = threefry2x32(key[0], key[1], 0, lanes.to(torch.int64) & M32)
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
