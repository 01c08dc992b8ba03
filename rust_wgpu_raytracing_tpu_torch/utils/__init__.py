"""Utilities: structured logging."""

from .logging import get_logger, log_frame_stats

__all__ = ["get_logger", "log_frame_stats"]
