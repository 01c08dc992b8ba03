"""Local interactive window shell — the analogue of the reference's
winit window (src/main.rs:3-5 opens a 600x600 window,
src/lib.rs:1244-1251; the event loop feeds keys to the controller and
presents each rendered frame).

Counterpart of the JAX package's runtime/window.py. GPU hosts are often
headless, so the primary live view is the HTTP shell
(runtime/server.py); this module is the desktop equivalent for hosts
with a display, built on tkinter (stdlib): a window showing the
framebuffer, with the key map of the reference's CircleCameraController
(src/circle_camera_control.rs:32-74 — WASD / arrows / Space / LShift)
wired to press/release events, and <Configure> resizes forwarded to
Renderer.resize (State::resize, src/lib.rs:772).

The render loop runs on a worker thread (a render must not block the Tk
main loop); frames cross to the UI thread through a 1-deep mailbox and
are shown as a PPM-encoded PhotoImage (tkinter decodes P6 natively).
Without a display, or without tkinter, Window raises RuntimeError.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from .frame_loop import FrameLoop
from .renderer import Renderer

# tkinter keysym -> controller key (reference key map,
# circle_camera_control.rs:32-74; same canonical names server.py uses)
KEYSYM_MAP = {
    "w": "w", "a": "a", "s": "s", "d": "d",
    "Up": "up", "Down": "down", "Left": "left", "Right": "right",
    "space": "space", "Shift_L": "lshift",
}


def image_to_ppm(img: np.ndarray) -> bytes:
    """(H,W,3) u8 top-down image -> binary PPM (P6) bytes. tkinter's
    PhotoImage accepts PPM data directly, which keeps presentation
    dependency-free."""
    h, w, _ = img.shape
    return f"P6\n{w} {h}\n255\n".encode() + np.ascontiguousarray(img).tobytes()


class Window:
    """Interactive desktop shell around a FrameLoop.

    Raises RuntimeError at construction when no display is available
    (headless host) — callers should fall back to RenderServer.
    """

    def __init__(self, renderer: Renderer, title: str = "rwrt-cuda",
                 max_fps: Optional[float] = None):
        try:
            import tkinter as tk
        except ImportError as err:  # a Python built without Tk
            raise RuntimeError(
                "no display available (tkinter is missing); use "
                "runtime.server.RenderServer for the headless live view"
            ) from err
        try:
            self.root = tk.Tk()
        except tk.TclError as err:  # no $DISPLAY
            raise RuntimeError(
                "no display available; use runtime.server.RenderServer "
                "for the headless live view") from err
        self.root.title(title)
        # size the window to the renderer up front: the first
        # <Configure> fires at window map, BEFORE the first frame has
        # sized the label — without an initial geometry it would report
        # the default tiny root size and collapse the renderer's
        # configured resolution
        self.root.geometry(f"{renderer.width}x{renderer.height}")
        self.loop = FrameLoop(renderer, present=self._on_frame,
                              max_fps=max_fps)
        self._tk = tk
        self._photo = None
        self._label = tk.Label(self.root)
        self._label.pack()
        self._mail: Optional[np.ndarray] = None
        self._mail_lock = threading.Lock()
        self._worker: Optional[threading.Thread] = None

        self.root.bind("<KeyPress>", self._on_key(True))
        self.root.bind("<KeyRelease>", self._on_key(False))
        self.root.bind("<Configure>", self._on_configure)
        self.root.protocol("WM_DELETE_WINDOW", self.close)

    # --- input path (the reference's WindowEvent::KeyboardInput,
    #     src/lib.rs:1313 -> State::input) ---
    def _on_key(self, pressed: bool):
        def handler(event):
            key = KEYSYM_MAP.get(event.keysym,
                                 KEYSYM_MAP.get(event.keysym.lower()))
            if key is not None:
                self.loop.push_key(key, pressed)
        return handler

    # --- resize path (WindowEvent::Resized -> State::resize,
    #     src/lib.rs:1325 -> 772); applied by the render thread ---
    def _on_configure(self, event):
        if event.widget is self.root and event.width > 1 \
                and event.height > 1:
            self.loop.request_resize(event.width, event.height)

    # --- present path (worker thread -> UI mailbox) ---
    def _on_frame(self, img: np.ndarray):
        with self._mail_lock:
            self._mail = img

    def _poll(self):
        with self._mail_lock:
            img, self._mail = self._mail, None
        if img is not None:
            self._photo = self._tk.PhotoImage(data=image_to_ppm(img))
            self._label.configure(image=self._photo)
        if self.loop.running:
            self.root.after(16, self._poll)

    def run(self, n_frames: Optional[int] = None):
        """Open the window and run until closed (event_loop.run
        analogue). Blocks in the Tk main loop; rendering happens on a
        worker thread. (FrameLoop.run sets running; a close() racing
        the thread spin-up is safe — stop() is sticky.)"""
        self.loop.running = True  # keep _poll scheduling until run() owns it
        self._worker = threading.Thread(
            target=self.loop.run, kwargs=dict(n_frames=n_frames),
            daemon=True)
        self._worker.start()
        self.root.after(16, self._poll)
        self.root.mainloop()

    def close(self):
        self.loop.stop()
        if self._worker is not None:
            self._worker.join(timeout=5.0)
        self.root.destroy()
