"""Structured metrics + logging — the loguru/Utils.h analogue.

The reference logs through loguru macros with file rotation
(Utils.h:15-30, Utils.cpp:10-42). Here: stdlib logging with an optional
JSON-lines metrics sink recording per-step render statistics (rays/s,
ms/frame, early-exit rate) — observability suited to batch accelerator
jobs rather than an interactive window.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

__all__ = ["get_logger", "MetricsWriter", "init_logs"]

_LOGGER_NAME = "volumetricrenderer_tpu"


def get_logger() -> logging.Logger:
    return logging.getLogger(_LOGGER_NAME)


def init_logs(log_dir: Optional[str] = None, level=logging.INFO):
    """Configure logging; if log_dir is given, also write a rotating-style
    timestamped file like the reference's LogsInit (Utils.cpp:10-42, which
    renames latest.log to a timestamped backup). Returns the logger."""
    logger = get_logger()
    logger.setLevel(level)
    if not logger.handlers:
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        latest = os.path.join(log_dir, "latest.log")
        if os.path.exists(latest):
            stamp = time.strftime("%Y%m%d-%H%M%S",
                                  time.localtime(os.path.getmtime(latest)))
            os.replace(latest, os.path.join(log_dir, f"{stamp}.log"))
        fh = logging.FileHandler(latest)
        fh.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s: %(message)s"))
        logger.addHandler(fh)
    return logger


class MetricsWriter:
    """Append-only JSON-lines metrics sink."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = open(path, "a") if path else None

    def write(self, **metrics):
        metrics.setdefault("ts", time.time())
        line = json.dumps(metrics)
        get_logger().info("metrics %s", line)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
