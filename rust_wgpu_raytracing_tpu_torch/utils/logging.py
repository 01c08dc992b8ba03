"""Structured logging: the JAX package's utils/logging.py (a copy). The
reference has only scattered log::warn! breadcrumbs via
env_logger/console_log (lib.rs:1235-1242).

One logger per subsystem + a structured per-frame stats emitter
(JSON-lines when RWRT_LOG_JSON=1, human-readable otherwise).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"
_configured = False


def get_logger(name: str = "rwrt") -> logging.Logger:
    global _configured
    if not _configured:
        level = os.environ.get("RWRT_LOG", "INFO").upper()
        logging.basicConfig(stream=sys.stderr, format=_FORMAT,
                            level=getattr(logging, level, logging.INFO))
        _configured = True
    return logging.getLogger(name)


def log_frame_stats(logger: logging.Logger, *, frame: int, frame_ms: float,
                    width: int, height: int, **extra) -> None:
    rays = width * height
    stats = {
        "t": time.time(),
        "frame": frame,
        "frame_ms": round(frame_ms, 3),
        "mrays_per_s": round(rays / max(frame_ms, 1e-9) / 1e3, 1),
        "size": [width, height],
        **extra,
    }
    if os.environ.get("RWRT_LOG_JSON") == "1":
        logger.info(json.dumps(stats))
    else:
        logger.info("frame %d: %.2f ms (%.0f Mrays/s)",
                    frame, frame_ms, stats["mrays_per_s"])
