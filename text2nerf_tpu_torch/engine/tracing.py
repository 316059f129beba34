"""Metrics logging and phase timing (port of ``MetricsLogger`` and
``phase_timer`` from ``text2nerf_tpu/engine/tracing.py``).

- :class:`MetricsLogger` appends JSON lines of scalars;
- :func:`phase_timer` logs a named phase's wall clock as
  ``phase/<name>_s``.  Given a CUDA device it synchronizes before each
  clock read, so a phase is charged its own device work.

The JAX package's ``profile_trace`` wraps JAX's profiler and has no
counterpart here; the port's profiles are ``profile_render`` and
``profile_train`` (``torch.profiler``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch


class MetricsLogger:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._f = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")

    def scalars(self, step: int, values: Dict[str, float]):
        rec = {"step": int(step), "t": time.time(), **values}
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def phase_timer(name: str, logger: Optional[MetricsLogger] = None, device=None):
    _sync(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync(device)
        dt = time.perf_counter() - t0
        if logger is not None:
            logger.scalars(0, {f"phase/{name}_s": dt})
