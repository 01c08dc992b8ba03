"""The port's hand-written CUDA kernels, each with its plain PyTorch
version and a launch counter (the recorder's "launches.<wrapper>",
runtime/profiler.py; launch_counts() reads them).

| kernel | wrapper | CUDA source | replaces (JAX package) |
| --- | --- | --- | --- |
| K1 | closest_hit | csrc/closest_hit.cu | ops/megakernel.py _make_closest_hit_kernel |
| K2 | texshade | csrc/texshade.cu | ops/megakernel.py _texshade_kernel |
| K3 | anyhit | csrc/anyhit.cu | ops/megakernel.py _make_anyhit_kernel |
| K4 | frame | csrc/frame.cu | ops/fusedframe.py _make_frame_kernel |
| K6 | texfilter | csrc/texfilter.cu | ops/megakernel.py _texfilter_kernel |
| K7 | closest_hit_perray | csrc/closest_hit_perray.cu | ops/megakernel.py _make_closest_hit_perray_kernel |
| K8 | extend_shadow | csrc/extend_shadow.cu | ops/megakernel.py _make_fused_extend_shadow_kernel |
| K5 | hier_cull | csrc/hier_cull.cu | ops/traverse_pallas.py _make_smem_kernel |
| K9 | stream_closest_hit | csrc/stream_sweep.cu | ops/megakernel.py _make_streaming_ch_slim_kernel |
| K10 | stream_closest_hit_perray | csrc/stream_sweep.cu | ops/megakernel.py _make_streaming_chp_slim_kernel |
| K11 | stream_anyhit | csrc/stream_sweep.cu | ops/megakernel.py _make_streaming_anyhit_kernel |
| K12 | super_any | csrc/super_any.cu | none: XLA's fusion of ops/traverse.py perray_super_any |
| K13 | sweep_front | csrc/sweep_front.cu | none: XLA's fusion of ops/megakernel.py tile_ray_bounds, _mask_words' flat scan and _vmem_sched |

A wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors. The frames and the path tracer take a
KernelSet, so a caller can compose the same frame from the plain
versions on the card (PLAIN) to check the kernels against it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from ...runtime import profiler
from .anyhit import anyhit, anyhit_plain
from .closest_hit import closest_hit, closest_hit_plain
from .closest_hit_perray import closest_hit_perray, closest_hit_perray_plain
from .extend_shadow import extend_shadow, extend_shadow_plain
from .frame import frame, frame_plain
from .hier_cull import hier_cull, hier_cull_plain
from .stream_sweep import (stream_anyhit, stream_anyhit_plain,
                           stream_closest_hit,
                           stream_closest_hit_perray,
                           stream_closest_hit_perray_plain,
                           stream_closest_hit_plain)
from .super_any import super_any, super_any_plain
from .sweep_front import sweep_front, sweep_front_plain
from .texfilter import texfilter, texfilter_plain
from .texshade import texshade, texshade_plain


class KernelSet(NamedTuple):
    closest_hit: Callable
    anyhit: Callable
    texshade: Callable
    frame: Callable
    texfilter: Callable
    closest_hit_perray: Callable
    extend_shadow: Callable
    hier_cull: Callable
    stream_closest_hit: Callable
    stream_closest_hit_perray: Callable
    stream_anyhit: Callable
    super_any: Callable
    sweep_front: Callable


KERNELS = KernelSet(closest_hit, anyhit, texshade, frame, texfilter,
                    closest_hit_perray, extend_shadow, hier_cull,
                    stream_closest_hit, stream_closest_hit_perray,
                    stream_anyhit, super_any, sweep_front)
PLAIN = KernelSet(closest_hit_plain, anyhit_plain, texshade_plain,
                  frame_plain, texfilter_plain, closest_hit_perray_plain,
                  extend_shadow_plain, hier_cull_plain,
                  stream_closest_hit_plain, stream_closest_hit_perray_plain,
                  stream_anyhit_plain, super_any_plain, sweep_front_plain)


def launch_counts() -> dict:
    """Launches of each wrapper since the last reset, by wrapper name."""
    counts = profiler.counters()
    return {f.__name__: counts.get("launches." + f.__name__, 0)
            for f in KERNELS}


def reset_launch_counts() -> None:
    profiler.reset_counters("launches.")
