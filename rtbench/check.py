"""The comparison that decides `correct`.

A presented pixel is a u8 sRGB code per channel (the program's present:
clamp, sRGB encode, x 255 + 0.5, truncate). A pixel is bad where, in
some channel, it departs from the reference by more than one step of the
coarsest quantizer on its path:

- a lit frame is quantized to rgba8 (linear u8 levels) before the
  present, so its tolerance is TOL_LEVELS linear levels: the codes that
  could come from a linear value form an interval of linear values, and
  the reference's value may lie at most that far outside the interval of
  the presented code;
- a path-traced frame presents its float mean, so its tolerance is
  TOL_CODES presented codes from the reference's own encode.

A reference value that is not finite makes its pixel bad. A checked
frame's number is the share of its sampled pixels that are bad; the
run's number is the largest over its checked frames.
"""

from __future__ import annotations

import numpy as np
import torch

TOL_LEVELS = 1.0
TOL_CODES = 1


def srgb_decode(s):
    s = np.clip(s, 0.0, 1.0)
    return np.where(s <= 0.04045, s / 12.92, ((s + 0.055) / 1.055) ** 2.4)


def code_interval(codes: np.ndarray):
    """Linear values [lo, hi] whose presented code is `codes` (u8)."""
    c = codes.astype(np.float64)
    lo = np.where(c <= 0, 0.0, srgb_decode((c - 0.5) / 255.0))
    hi = np.where(c >= 255, 1.0, srgb_decode((c + 0.5) / 255.0))
    return lo, hi


def bad_share(codes: np.ndarray, ref_linear, quantized: bool) -> float:
    """Share of pixels (rows of (P, 3) presented codes) that depart from
    the reference's linear values (P, 3) by more than the tolerance."""
    if isinstance(ref_linear, torch.Tensor):
        ref_linear = ref_linear.detach().float().cpu().numpy()
    raw = np.asarray(ref_linear, np.float64)
    ref = np.clip(np.nan_to_num(raw), 0.0, 1.0)
    if quantized:
        lo, hi = code_interval(codes)
        bad = np.maximum(lo - ref, ref - hi) * 255.0 > TOL_LEVELS
    else:
        diff = codes.astype(np.int64) - present_codes(ref).astype(np.int64)
        bad = np.abs(diff) > TOL_CODES
    bad |= ~np.isfinite(raw)
    return float(bad.any(axis=1).mean())


def present_codes(linear) -> np.ndarray:
    """The program's present encode of linear values, for a reference put
    in the program's place (the control)."""
    if isinstance(linear, torch.Tensor):
        linear = linear.detach().float().cpu().numpy()
    rgb = np.clip(np.nan_to_num(np.asarray(linear, np.float32)), 0.0, 1.0)
    rgb = np.where(rgb <= 0.0031308, rgb * 12.92,
                   1.055 * rgb ** (1.0 / 2.4) - 0.055)
    return (rgb * 255.0 + 0.5).astype(np.uint8)
