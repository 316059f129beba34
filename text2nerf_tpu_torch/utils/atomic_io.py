"""Crash-safe archive writes (port of ``text2nerf_tpu/utils/atomic_io.py``).

The file at ``path`` is always either the previous complete archive or
the new complete archive: a kill mid-write never leaves a truncated npz.
:func:`temp_dir` / :func:`replace_dir` give a checkpoint directory the
same guarantee.
"""

from __future__ import annotations

import glob
import os
import shutil

import numpy as np


def atomic_savez(path: str, **arrays) -> None:
    """``np.savez`` with write-to-temp + ``os.replace`` atomicity.

    Appends ``.npz`` when missing, as ``np.savez`` does.
    """
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # pid-suffixed temp: concurrent writers never interleave into one file
    tmp = f"{path}.tmp.{os.getpid()}"
    _sweep_dead_tmp(path)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def temp_dir(path: str) -> str:
    """A fresh ``path.tmp.<pid>`` directory beside ``path`` to write a
    directory into, leftovers of dead writers swept first."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _sweep_dead_tmp(path, (".tmp.", ".old."))
    tmp = f"{path}.tmp.{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    return tmp


def replace_dir(tmp: str, path: str) -> None:
    """Put the complete directory ``tmp`` at ``path`` in place of what is
    there.  Two renames: a kill between them leaves no directory at
    ``path`` (the previous one waits at ``path.old.<pid>``), never a
    partial one."""
    if os.path.lexists(path):
        old = f"{path}.old.{os.getpid()}"
        shutil.rmtree(old, ignore_errors=True)
        os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old)
    else:
        os.replace(tmp, path)


def _remove(path: str) -> None:
    if os.path.isdir(path) and not os.path.islink(path):
        shutil.rmtree(path, ignore_errors=True)
    else:
        os.remove(path)


def _sweep_dead_tmp(path: str, tags=(".tmp.",)) -> None:
    """Remove ``path<tag><pid>`` leftovers (files or directories) whose
    writer process is dead."""
    for stale in (s for tag in tags for s in glob.glob(glob.escape(path) + tag + "*")):
        try:
            pid = int(stale.rsplit(".", 1)[-1])
        except ValueError:
            continue
        if pid == os.getpid():
            continue
        try:
            os.kill(pid, 0)  # raises if no such process
        except ProcessLookupError:
            try:
                _remove(stale)
            except OSError:
                pass
        except PermissionError:
            pass  # alive under another uid: leave it
