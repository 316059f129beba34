"""Build the port's CUDA sources and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/lib<name>-<hash>.so`` at first use.
The hash covers the source, every local header it includes (``#include
"x.cuh"`` from ``csrc/``, followed recursively) and the full flag list,
so an edited source, header or flag is rebuilt and a stale library is
never loaded.  No fast math: the shading head's sin/cos arguments reach
32·|f|, where the fast intrinsics lose accuracy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("factor_features", "factor_features_bwd", "shading_mlp", "cp_features",
           "eval_prepass")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)

_LIBS: dict = {}
#: serializes build-and-load within a process: farm workers are threads
#: that may launch a kernel for the first time at the same moment
BUILD_LOCK = threading.RLock()
#: guards the wrappers' launch counts: ``+=`` on a module global is a read
#: and a write that two worker threads can interleave
COUNT_LOCK = threading.Lock()
#: nvcc's output per source built by this process (ptxas register and
#: shared-memory report)
BUILD_LOGS: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
        f"{CSRC_DIR} at first use"
    )


def dependencies(name: str) -> list:
    """``csrc/<name>.cu`` and the local headers it includes, recursively,
    in first-include order."""
    seen = []
    todo = [CSRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        if not path.exists():
            raise FileNotFoundError(f"{path} (included by the {name} kernel) is missing")
        seen.append(path)
        todo.extend(path.parent / inc for inc in _LOCAL_INCLUDE.findall(path.read_text()))
    return seen


def hashed_path(stem: str, sources, flags) -> Path:
    """``build/lib<stem>-<hash>.so``, the hash over the sources' names and
    bytes and the flag list."""
    h = hashlib.sha256()
    for path in sources:
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def library_path(name: str) -> Path:
    return hashed_path(name, dependencies(name), NVCC_FLAGS)


def _tmp_path(out: Path) -> Path:
    """A temporary output beside ``out`` that no other process or thread
    writes: named by process and thread."""
    return out.with_name(f"{out.stem}.tmp{os.getpid()}-{threading.get_ident()}.so")


def build_host_library(stem: str, source: Path, flags) -> Path:
    """Compile one C++ source with ``g++ <flags>`` into its hashed path
    unless it is there already; raises with g++'s output on failure."""
    with BUILD_LOCK:
        return _build_host_library(stem, source, flags)


def _build_host_library(stem: str, source: Path, flags) -> Path:
    out = hashed_path(stem, [source], flags)
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: {source.name} is built at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _tmp_path(out)
    try:
        proc = subprocess.run([gxx, *flags, "-o", str(tmp), str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {source.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def build(names=SOURCES) -> None:
    """Compile every named source that is not built yet; one ``nvcc`` per
    source, all started together.  Raises with nvcc's output on failure."""
    with BUILD_LOCK:
        _build(names)


def _build(names) -> None:
    jobs = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = _tmp_path(out)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            jobs[name] = (proc, tmp, out)
        failed = []
        for name, (proc, tmp, out) in jobs.items():
            log, _ = proc.communicate()
            BUILD_LOGS[name] = log
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for proc, tmp, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        with BUILD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                _build((name,))
                lib = ctypes.CDLL(str(library_path(name)))
                _LIBS[name] = lib
    return lib


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (None for no tensor)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
