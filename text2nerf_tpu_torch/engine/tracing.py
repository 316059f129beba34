"""Metrics logging, phase timing, and the port's one way to open a
profiler span and one place to count (``MetricsLogger`` and
``phase_timer`` port ``text2nerf_tpu/engine/tracing.py``).

- :class:`MetricsLogger` appends JSON lines of scalars;
- :func:`phase_timer` logs a named phase's wall clock as
  ``phase/<name>_s``.  Given a CUDA device it synchronizes before each
  clock read, so a phase is charged its own device work;
- :func:`span` opens a ``torch.profiler`` host range (``t2n.*``) while a
  profiler is recording, and is one shared no-op context otherwise;
- :func:`count` adds to a named counter while a profiler is recording;
  :func:`counts` reads the counters and :func:`reset_counts` clears them.

Tracing on means any ``torch.profiler`` run around the program: its
spans are the profiler's own ranges, on the device trace's clock, and the
counters cover exactly the profiled stretch.  With no profiler no span is
opened and no counter moves.

The spans, outermost first (each nests inside the one above it where
both run): ``t2n.view`` one ``render_view`` frame; ``t2n.view.base`` one
base-rung chunk; ``t2n.view.need`` the view's escalation readback and
its host work; ``t2n.view.escalate`` one escalation group;
``t2n.view.out`` the frame's copy to the host; ``t2n.batch`` the
trainer's gather and copy of one batch; ``t2n.step`` one train step;
``t2n.subbatch`` one sub-batch's loss and backward; and inside a render
``t2n.select``, ``t2n.features``, ``t2n.head``, ``t2n.composite``, then
``t2n.loss`` and ``t2n.reg`` in the step.  The counters: ``view.rays``
(rays of a view's base pass, padding excluded), ``view.rays_escalated``
(rays re-rendered at a higher rung), ``head.samples`` (rows handed to
kernel B's noview mode), ``head.view_samples`` (rows handed to its
view-dependent ``MLP_Fea`` mode), ``select.kernel_rays`` /
``select.plain_rays`` (rays whose compacted eval prepass ran as the kernel
/ as its plain version), and ``cp.sigma_samples`` / ``cp.app_samples``
(samples of kernel C's eval launches that compute the density / the app
channels; a fused launch counts in both).

The JAX package's ``profile_trace`` wraps JAX's profiler and has no
counterpart here; the port's profiles are ``profile_render`` and
``profile_train`` (``torch.profiler``).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


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


#: the context every span is while no profiler records
_NO_SPAN = contextlib.nullcontext()

_COUNTS: Dict[str, int] = {}
_COUNTS_LOCK = threading.Lock()


def span(name: str):
    """A ``torch.profiler`` host range named ``name`` while a profiler is
    recording, else the shared no-op context."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` (a host number) to the counter ``name`` while a profiler
    is recording."""
    if _autograd_profiler._is_profiler_enabled:
        with _COUNTS_LOCK:
            _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


def counts() -> Dict[str, int]:
    """A copy of the counters."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def reset_counts() -> None:
    with _COUNTS_LOCK:
        _COUNTS.clear()
