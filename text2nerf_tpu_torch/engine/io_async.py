"""Asynchronous artifact writing (port of
``text2nerf_tpu/engine/io_async.py``).

Scene expansion writes a dozen PNG artifacts a view (the ``DIBR/`` tree).
A background thread encodes and writes them, so the main thread goes on
launching device work.  ``flush(root)`` waits for the writes under
``root`` and re-raises the first error among them: a failed write is
never silent.  Scenes that run at once share the writer, and a scoped
flush neither waits on nor raises another scene's writes.

Images are PNGs through :mod:`..utils.png` (no image library needed):
floats with a maximum of at most 1.5 are taken as [0, 1] and written as
uint8 (x 255, truncated), other floats as uint16 (clipped to [0, 65535],
truncated), integer arrays as they are.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.png import write_png


class AsyncArtifactWriter:
    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._errors: List[Tuple[str, BaseException]] = []
        self._pending: Dict[str, int] = {}  # path -> enqueued-not-done count
        self._lock = threading.Lock()
        self._done = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None

    def _ensure_thread(self):
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._loop, daemon=True)
                self._thread.start()

    def _loop(self):
        while True:
            path, arr = self._q.get()
            try:
                _write_image_sync(path, arr)
            except BaseException as e:  # noqa: BLE001 — raised on flush
                with self._lock:
                    self._errors.append((path, e))
            with self._done:
                self._pending[path] -= 1
                if self._pending[path] <= 0:
                    del self._pending[path]
                self._done.notify_all()

    def write(self, path: str, arr):
        """Enqueue an image write; the array is copied now, so the caller
        may change its buffer afterwards."""
        self._ensure_thread()
        with self._lock:
            self._pending[path] = self._pending.get(path, 0) + 1
        self._q.put((path, np.array(arr, copy=True)))

    def flush(self, root: Optional[str] = None):
        """Block until every enqueued write under ``root`` (every write
        when None) is on disk; re-raise the first of their errors (the
        others are logged), leaving other roots' errors for their own
        flush."""
        rootp = None if root is None else os.path.abspath(root)

        def under(p: str) -> bool:
            if rootp is None:
                return True
            ap = os.path.abspath(p)
            # separator-aware: '.../exp_0.3' must not claim '.../exp_0.35'
            return ap == rootp or ap.startswith(rootp + os.sep)

        with self._done:
            while any(under(p) for p in self._pending):
                self._done.wait(timeout=60.0)
            mine = [(p, e) for (p, e) in self._errors if under(p)]
            if mine:
                self._errors[:] = [(p, e) for (p, e) in self._errors if not under(p)]
                for p, e in mine[1:]:
                    logging.getLogger(__name__).error("async write also failed: %s: %r", p, e)
                raise mine[0][1]


def _write_image_sync(path: str, a: np.ndarray):
    """Write one artifact now (see the module docstring for the types)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if a.dtype in (np.float32, np.float64):
        if a.max() <= 1.5:
            a = (np.clip(a, 0, 1) * 255).astype(np.uint8)
        else:
            a = np.clip(a, 0, 65535).astype(np.uint16)
    write_png(path, a)


_writer = AsyncArtifactWriter()


def write_async(path: str, arr):
    """Enqueue a write on the module's shared writer."""
    _writer.write(path, arr)


def flush(root: Optional[str] = None):
    _writer.flush(root)
