"""HTTP presentation shell — the analogue of the reference's web shell
(web/index.html + the wasm canvas glue, src/lib.rs:1255-1300).

Counterpart of the JAX package's runtime/server.py. Serves:
  /            a minimal page with the live view + WASD/orbit key capture
  /stream      a multipart stream of the rendered frames
  /frame.png   the latest frame as PNG
  /key?k=w&p=1 key events (pressed p=1 / released p=0)
  /stats       JSON frame statistics

Standard library only (http.server); frames come from a FrameLoop
running in a background thread. The JAX package encodes with PIL and
streams JPEG; this one encodes every frame as PNG with the stdlib
encoder (io.image_out.encode_png), /stream included
(multipart/x-mixed-replace of image/png parts), so it runs where PIL is
not installed.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..io.image_out import encode_png
from .frame_loop import FrameLoop

_PAGE = b"""<!doctype html>
<html><head><title>rust_wgpu_raytracing_tpu_torch</title></head>
<body style="background:#111;color:#eee;font-family:monospace">
<h3>rust_wgpu_raytracing_tpu_torch &mdash; CUDA ray tracer</h3>
<img id="v" src="/stream" style="image-rendering:pixelated">
<p>WASD/arrows orbit &middot; space/shift up-down (reference key map)</p>
<script>
const send=(k,p)=>fetch(`/key?k=${encodeURIComponent(k)}&p=${p?1:0}`);
onkeydown=e=>send(e.key.toLowerCase(),1);
onkeyup=e=>send(e.key.toLowerCase(),0);
</script></body></html>
"""
# browser key names -> controller keys (the reference key map)
_KEYS = {"arrowup": "up", "arrowdown": "down", "arrowleft": "left",
         "arrowright": "right", " ": "space", "shift": "lshift"}


class RenderServer:
    def __init__(self, loop: FrameLoop, host: str = "127.0.0.1",
                 port: int = 8080):
        self.loop = loop
        self.latest: Optional[np.ndarray] = None
        self.frame_event = threading.Event()
        self._closing = threading.Event()
        loop.present = self._on_frame
        self.httpd = ThreadingHTTPServer((host, port), self._handler())
        self.port = self.httpd.server_address[1]

    def _on_frame(self, img: np.ndarray):
        self.latest = img
        self.frame_event.set()
        self.frame_event = threading.Event()

    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/":
                    self._send(200, "text/html", _PAGE)
                elif url.path == "/frame.png":
                    img = server.latest
                    if img is None:
                        self._send(503, "text/plain", b"no frame yet")
                    else:
                        self._send(200, "image/png", encode_png(img))
                elif url.path == "/key":
                    q = parse_qs(url.query)
                    key = q.get("k", [""])[0]
                    pressed = q.get("p", ["1"])[0] == "1"
                    server.loop.push_key(_KEYS.get(key, key), pressed)
                    self._send(200, "text/plain", b"ok")
                elif url.path == "/stats":
                    body = json.dumps({
                        **server.loop.profiler.summary(),
                        "frames_rendered": server.loop.frame_index,
                        "size": [server.loop.renderer.width,
                                 server.loop.renderer.height],
                    }).encode()
                    self._send(200, "application/json", body)
                elif url.path == "/stream":
                    self._stream()
                else:
                    self._send(404, "text/plain", b"not found")

            def _stream(self):
                self.send_response(200)
                self.send_header("Content-Type",
                                 "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                try:
                    sent_first = False
                    # until the client goes away or the server shuts down;
                    # a frame is sent when a new one arrived (and once at
                    # connect, so a paused loop shows its last frame)
                    while not server._closing.is_set():
                        fired = server.frame_event.wait(timeout=5.0)
                        if not fired and sent_first:
                            continue
                        img = server.latest
                        if img is None:
                            continue
                        png = encode_png(img)
                        self.wfile.write(
                            b"--frame\r\nContent-Type: image/png\r\n"
                            + f"Content-Length: {len(png)}\r\n\r\n".encode()
                            + png + b"\r\n")
                        sent_first = True
                except (BrokenPipeError, ConnectionResetError):
                    pass

        return Handler

    def serve_async(self) -> threading.Thread:
        th = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        th.start()
        return th

    def shutdown(self):
        self._closing.set()
        self.frame_event.set()  # wake blocked stream handlers now
        self.httpd.shutdown()
        self.httpd.server_close()
