"""The port's spans and counters, and the interactive loop's frame times.

The recorder. Program code marks where its time goes:

    with profiler.span("frame.gbuffer"):        # a phase of the work
        ...
    with profiler.wait("compact"):              # the host waits on the card
        tidx = live.nonzero()
    profiler.count("launches.frame")            # a counter

- A span records its name, its start and end on time.perf_counter_ns(),
  the index of the span that encloses it (-1 at the top) and the step id
  set by set_step() (FrameLoop.step sets its frame_index, so every span
  of one frame shares it). A wait is a span of kind "wait" named
  "<site>.wait", and it adds 1 to the counter "syncs.<site>".
- Counters are always on: count() is an integer add. The kernel
  wrappers count "launches.<wrapper>" (ops/kernels.launch_counts()), the
  path tracer "pt.compacted" and "pt.full" (its choice, a sample).
- Spans are off by default: with the recorder off and no torch.profiler
  running, span() and wait() read two flags and return the shared null
  context NULL, with no call into torch. enable() switches the
  recorder on; drain() returns (spans, counters) and empties it.
- While torch.profiler runs, each span also opens
  torch.profiler.record_function("rt." + name), on or off, so the
  program's phases appear in the trace on the device operations' clock.
- timed(name) is a span whose length in ns is also added to the counter
  "ns.<name>" whether or not the recorder is on, for phases that run
  once, such as a Renderer's set-up ("setup.scene_build",
  "setup.upload").

One thread records: the spans' nesting follows the calls of the thread
that steps the frames.

count_ops counts the torch operations a call dispatches, with each
kernel call as one: the host's launches, on any device (on the CPU,
where there is no trace, it is the only way to see them). Profiler
keeps the interactive loop's rolling frame times (runtime/frame_loop.py,
the server's /stats), as in the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode

NULL = contextlib.nullcontext()  # what a span site gets with nothing on


@dataclass
class Span:
    """One recorded span: [start_ns, end_ns) on time.perf_counter_ns(),
    `parent` the index of the enclosing span in the drained list (-1 at
    the top), `step` the step id when it opened, `kind` "span" or
    "wait"."""

    name: str
    kind: str
    start_ns: int
    end_ns: int
    parent: int
    step: Optional[int]
    attrs: dict

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


class _Recorder:
    def __init__(self):
        self.on = False
        self.spans: List[Span] = []
        self.open: List[int] = []  # indices of the open spans, innermost last
        self.counters: Dict[str, int] = {}
        self.step: Optional[int] = None


_REC = _Recorder()


class _Recording:
    """A span while the recorder is on (and its record_function while
    torch.profiler runs)."""

    __slots__ = ("span", "annotation")

    def __init__(self, name: str, kind: str, attrs: dict):
        self.span = Span(name, kind, 0, 0, -1, None, attrs)
        self.annotation = None

    def __enter__(self):
        s = self.span
        if _autograd_profiler._is_profiler_enabled:
            self.annotation = torch.profiler.record_function("rt." + s.name)
            self.annotation.__enter__()
        s.parent = _REC.open[-1] if _REC.open else -1
        s.step = _REC.step
        _REC.open.append(len(_REC.spans))
        _REC.spans.append(s)
        s.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.span.end_ns = time.perf_counter_ns()
        _REC.open.pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A context manager around one phase of the work (module docstring)."""
    if _REC.on:
        return _Recording(name, "span", attrs)
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function("rt." + name)
    return NULL


def wait(site: str):
    """A context manager around a place where the host waits on the card;
    counts "syncs.<site>" and records a span "<site>.wait"."""
    count("syncs." + site)
    if _REC.on:
        return _Recording(site + ".wait", "wait", {})
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function("rt." + site + ".wait")
    return NULL


@contextlib.contextmanager
def timed(name: str):
    """span(name), whose length in ns is also added to the counter
    "ns.<name>" with the recorder on or off (for phases that run once)."""
    with span(name):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            count("ns." + name, time.perf_counter_ns() - t0)


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` (always on)."""
    c = _REC.counters
    c[name] = c.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of the counters, without emptying them."""
    return dict(_REC.counters)


def reset_counters(prefix: str = "") -> None:
    """Drop the counters whose names start with `prefix`."""
    for name in [k for k in _REC.counters if k.startswith(prefix)]:
        del _REC.counters[name]


def set_step(step: Optional[int]) -> None:
    """The step id of the spans opened from now on."""
    _REC.step = step


def enable(on: bool = True) -> None:
    """Switch span recording on or off (counters are always on)."""
    _REC.on = bool(on)


def enabled() -> bool:
    return _REC.on


def drain() -> Tuple[List[Span], Dict[str, int]]:
    """The recorded spans, in the order they opened, and the counters;
    empties both. Call it between steps, with no span open."""
    if _REC.open:
        raise RuntimeError(f"drain() inside {len(_REC.open)} open span(s)")
    spans, counts = _REC.spans, _REC.counters
    _REC.spans, _REC.counters = [], {}
    return spans, counts


def self_ns(spans: List[Span]) -> List[int]:
    """Each span's length less its children's lengths (drained spans)."""
    out = [s.ns for s in spans]
    for s in spans:
        if s.parent >= 0:
            out[s.parent] -= s.ns
    return out


# aten operations that only make views or metadata (no device kernel)
_VIEW_OPS = frozenset((
    "aten.alias", "aten.as_strided", "aten.detach", "aten.expand",
    "aten.lift_fresh", "aten.permute", "aten.select", "aten.slice",
    "aten.split", "aten.squeeze", "aten.t", "aten.unbind",
    "aten.unsqueeze", "aten.view", "aten._unsafe_view"))


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if not self.paused and name not in _VIEW_OPS:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


def count_ops(fn, kernels) -> collections.Counter:
    """Run fn(kernels') and count the non-view torch operations it
    dispatches by aten name; each call of a `kernels` member (a
    ops.kernels.KernelSet) counts once, as "kernel <name>", and the
    operations inside it not at all. Scalars a frame makes on the host
    (aten.scalar_tensor) are counted too."""
    counter = _OpCounter()

    def as_one(fn_k):
        def call(*args, **kwargs):
            counter.paused = True
            try:
                return fn_k(*args, **kwargs)
            finally:
                counter.paused = False
                counter.counts[f"kernel {fn_k.__name__}"] += 1
        return call

    with counter:
        fn(type(kernels)(*(as_one(f) for f in kernels)))
    return counter.counts


@dataclass
class Profiler:
    """Rolling frame statistics for the interactive loop (the JAX
    package's runtime/profiler.Profiler): the last `window` frame times
    in ms, host clock."""

    window: int = 60
    _times: List[float] = field(default_factory=list)

    def record(self, frame_ms: float):
        self._times.append(frame_ms)
        if len(self._times) > self.window:
            self._times.pop(0)

    @property
    def mean_ms(self) -> float:
        return float(np.mean(self._times)) if self._times else float("nan")

    @property
    def p99_ms(self) -> float:
        return (float(np.percentile(self._times, 99)) if self._times
                else float("nan"))

    def summary(self) -> Dict[str, float]:
        return {"mean_ms": self.mean_ms, "p99_ms": self.p99_ms,
                "frames": len(self._times)}
