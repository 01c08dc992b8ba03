"""Interactive frame loop — the analogue of the reference's winit event
loop (src/lib.rs:1305-1352: MainEventsCleared -> request_redraw ->
update() -> render(), with SurfaceError recovery).

Counterpart of the JAX package's runtime/frame_loop.py. Headless-
friendly: input events come from a queue (the HTTP shell in server.py
feeds it; scripts push keys programmatically) and frames are presented
through a callback. Render errors are classified as the reference
matches its SurfaceError (lib.rs:1338-1347): a lost device is reset
(Renderer.reset_device) and resized, then the frame is retried once; a
timeout skips the frame; out of memory stops the loop; anything else is
a programming error and surfaces as itself. JAX classifies XLA's
runtime errors by their type name; here the errors are torch's: its
OutOfMemoryError (and MemoryError) is "oom", and a RuntimeError that
reports a CUDA error is "timeout" or "lost" by its message or by the
error code the kernel wrappers report (ops/kernels/build.py).
"""

from __future__ import annotations

import logging
import queue
import re
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from . import profiler
from .profiler import Profiler
from .renderer import Renderer


@dataclass
class KeyEvent:
    key: str
    pressed: bool


# torch's messages for the CUDA runtime's errors, and the codes
# (cudaError_t) that the kernel wrappers print as "CUDA error <code>"
_OOM_MARKERS = ("out of memory",)
_TIMEOUT_MARKERS = ("launch timed out",)
_LOST_MARKERS = ("unspecified launch failure",
                 "an illegal memory access was encountered",
                 "uncorrectable ECC error", "busy or unavailable",
                 "GPU is lost", "fallen off the bus")
_OOM_CODES = {2}  # cudaErrorMemoryAllocation
_TIMEOUT_CODES = {702}  # cudaErrorLaunchTimeout
# cudaErrorDevicesUnavailable, cudaErrorECCUncorrectable,
# cudaErrorIllegalAddress, cudaErrorLaunchFailure
_LOST_CODES = {46, 214, 700, 719}
_CODE = re.compile(r"CUDA error (\d+)")


def classify_render_error(exc: BaseException) -> str:
    """'oom' | 'lost' | 'timeout' | 'fatal' for a render-path exception.

    Only device errors are ever recoverable: torch.cuda.OutOfMemoryError
    and MemoryError are 'oom'; a RuntimeError that reports a CUDA error
    is classified by its message or code; every other exception is a
    deterministic programming error and 'fatal'."""
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return "oom"
    msg = str(exc)
    if not isinstance(exc, RuntimeError) or "CUDA" not in msg:
        return "fatal"
    m = _CODE.search(msg)
    code = int(m.group(1)) if m else None
    if code in _OOM_CODES or any(k in msg for k in _OOM_MARKERS):
        return "oom"
    if code in _TIMEOUT_CODES or any(k in msg for k in _TIMEOUT_MARKERS):
        return "timeout"
    if code in _LOST_CODES or any(k in msg for k in _LOST_MARKERS):
        return "lost"
    return "fatal"


class FrameLoop:
    def __init__(self, renderer: Renderer,
                 present: Optional[Callable[[np.ndarray], None]] = None,
                 max_fps: Optional[float] = None, pipeline: bool = True):
        self.renderer = renderer
        self.present = present
        self.max_fps = max_fps
        self.pipeline = pipeline
        self.events: "queue.Queue[KeyEvent]" = queue.Queue()
        self.profiler = Profiler()
        self.running = False
        self.frame_index = 0
        self._stopped = False  # sticky: a stop() before run() must win
        self._resize_req: Optional[tuple] = None
        self._inflight = None  # device framebuffer of the youngest render

    # --- input path (State::input, src/lib.rs:990-992) ---
    def push_key(self, key: str, pressed: bool = True):
        self.events.put(KeyEvent(key, pressed))

    def request_resize(self, width: int, height: int):
        """Thread-safe resize request (WindowEvent::Resized,
        src/lib.rs:1325): applied by the render thread at the start of
        the next step, so that it never races a render."""
        self._resize_req = (int(width), int(height))

    def _drain_events(self):
        req, self._resize_req = self._resize_req, None
        if req is not None and req != (self.renderer.width,
                                       self.renderer.height):
            # the in-flight frame has the old size: never present it
            self._inflight = None
            self.renderer.resize(*req)
        while True:
            try:
                ev = self.events.get_nowait()
            except queue.Empty:
                return
            self.renderer.controller.process_key(ev.key, ev.pressed)

    # --- one iteration of the redraw cycle ---
    def step(self) -> Optional[np.ndarray]:
        """One redraw: the spans "step", "update", "render",
        "present.encode" and the wait "present" (runtime/profiler.py),
        with frame_index as their step id."""
        profiler.set_step(self.frame_index)
        with profiler.span("step"):
            return self._step()

    def _step(self) -> Optional[np.ndarray]:
        self._drain_events()
        with profiler.span("update"):
            self.renderer.update()
        t0 = time.perf_counter()
        # Present overlap: the previous frame's encode and its copy to
        # the host are queued ahead of this frame's kernels, and waited
        # for after this frame is enqueued, so the host's enqueue of
        # frame k runs while frame k-1 finishes on the card. One frame of
        # latency; run()/flush() present the last frame.
        pending = None
        if self.pipeline and self._inflight is not None:
            with profiler.span("present.encode"):
                pending = self.renderer.fetch_image(color=self._inflight)
            self._inflight = None
        color = None  # this step's framebuffer; None on a skipped frame
        try:
            with profiler.span("render"):
                color, _ = self.renderer.render()
        except Exception as err:
            kind = classify_render_error(err)
            if kind == "oom":
                # the reference exits on OutOfMemory (lib.rs:1343)
                self.running = False
                raise
            if kind == "timeout":
                # the reference warns and carries on (lib.rs:1345-1346)
                logging.getLogger(__name__).warning(
                    "frame %d render timeout: %s", self.frame_index, err)
            elif kind == "lost":
                # Lost/Outdated: reset the device state, resize and retry
                # once (lib.rs:1341-1342); if that fails too, re-raise
                # the ORIGINAL error
                pending = None  # rendered before the reset
                try:
                    self.renderer.reset_device()
                    self.renderer.resize(self.renderer.width,
                                         self.renderer.height)
                    with profiler.span("render"):
                        color, _ = self.renderer.render()
                except Exception:
                    self.running = False
                    raise err
            else:
                # a deterministic programming error: surface as itself
                self.running = False
                raise
        # A skipped frame (timeout) presents the in-flight frame and
        # queues nothing (no double present).
        img = None
        if self.pipeline:
            self._inflight = color
            if pending is not None:
                with profiler.wait("present"):
                    img = pending()
        else:
            with profiler.span("present.encode"):
                pending = self.renderer.fetch_image()
            with profiler.wait("present"):
                img = pending()
        self.profiler.record((time.perf_counter() - t0) * 1e3)
        if img is not None and self.present is not None:
            self.present(img)
        self.frame_index += 1
        return img

    def flush(self) -> Optional[np.ndarray]:
        """Present the youngest rendered but unpresented frame (the
        pipeline's one-frame tail)."""
        color, self._inflight = self._inflight, None
        if color is None:
            return None
        img = self.renderer.present_image(color=color)
        if self.present is not None:
            self.present(img)
        return img

    def run(self, n_frames: Optional[int] = None):
        """Blocking loop (the event_loop.run analogue). A stop() issued
        before run() starts is honoured: running is never re-asserted
        over a sticky stop."""
        self.running = not self._stopped
        count = 0
        while self.running and (n_frames is None or count < n_frames):
            t0 = time.perf_counter()
            self.step()
            count += 1
            if self.max_fps:
                budget = 1.0 / self.max_fps - (time.perf_counter() - t0)
                if budget > 0:
                    time.sleep(budget)
        self.running = False
        self.flush()

    def run_async(self, n_frames: Optional[int] = None) -> threading.Thread:
        th = threading.Thread(target=self.run, args=(n_frames,), daemon=True)
        th.start()
        return th

    def stop(self):
        self._stopped = True
        self.running = False
