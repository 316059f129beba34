"""Native host kernels (C++ through ctypes), built at first use.

``host_ops.cpp`` beside this file is the port's own copy of the JAX
package's native host kernels: the sparse bilateral filter, the
raster-order hole fills ``dibr_hole_fill2`` (expansion) and
``dibr_hole_fill1``, and the first-writer-wins z-buffer point splat.
They are sequential raster-order loops, so they stay on the host.  It
is compiled with ``g++ -O3 -shared -fPIC`` into
``text2nerf_tpu_torch/build/libhost_ops-<hash>.so`` (the hash covers the
source and the flags, as for the CUDA kernels).  A build or load failure
raises: there is no quiet fallback.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ..ops.kernels import _build

SOURCE = Path(__file__).resolve().parent / "host_ops.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LIB = None


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _build.BUILD_LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(_build.build_host_library("host_ops", SOURCE, GXX_FLAGS)))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.sparse_bilateral.argtypes = [
            f32p, f32p, f32p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            i32p, ctypes.c_int, ctypes.c_float,
        ]
        lib.sparse_bilateral.restype = None
        lib.dibr_hole_fill2.argtypes = [
            f32p, f32p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float,
        ]
        lib.dibr_hole_fill2.restype = None
        lib.dibr_hole_fill1.argtypes = [
            f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ]
        lib.dibr_hole_fill1.restype = None
        i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.zbuffer_point_splat.argtypes = [
            i16p, i16p, f32p, f32p, f32p, ctypes.c_void_p, u8p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.zbuffer_point_splat.restype = None
        _LIB = lib
    return _LIB


def sparse_bilateral(depth, image, filter_size, depth_threshold: float, mask=None):
    """Iterative sparse bilateral filter, one weighted-median pass per entry
    of ``filter_size`` (the per-pass windows).  Returns (image', depth')
    as float32 numpy; the inputs are not modified."""
    lib = load()
    d = np.array(depth, np.float32, order="C")  # copies: filtered in place
    img = np.array(image, np.float32, order="C")
    d0 = np.ascontiguousarray(np.asarray(depth, np.float32))
    # a 2-D image would make c == W below and the kernel would write H·W·W
    # floats, so the shapes are checked here
    if d.ndim != 2 or img.ndim != 3 or img.shape[:2] != d.shape:
        raise ValueError(f"need depth (H, W) and image (H, W, C), got {d.shape} and {img.shape}")
    h, w = d.shape
    fs = np.ascontiguousarray(np.asarray(filter_size, np.int32))
    m = None
    if mask is not None:
        m = np.ascontiguousarray(np.asarray(mask, np.float32))
        if m.shape != (h, w):
            raise ValueError(f"mask {m.shape} is not the depth's {d.shape}")
    lib.sparse_bilateral(
        d, img, d0, None if m is None else m.ctypes.data_as(ctypes.c_void_p),
        h, w, img.shape[-1], fs, len(fs), ctypes.c_float(depth_threshold),
    )
    return img, d


def hole_fill2(image, mask, depth=None, threshold: float = 0.65):
    """The reference's raster-order hole fill (``dibr_filter_mask2``) of a
    warped view: ``image`` (H, W, C), its coverage ``mask`` (H, W) and
    optionally its ``depth`` (H, W).  Returns float32 copies (image, mask[,
    depth]); the inputs are not modified."""
    lib = load()
    img = np.array(image, np.float32, order="C")
    m = np.array(mask, np.float32, order="C")
    if img.ndim != 3 or m.shape != img.shape[:2]:
        raise ValueError(f"need image (H, W, C) and mask (H, W), got {img.shape} and {m.shape}")
    h, w, c = img.shape
    d = None
    if depth is not None:
        d = np.array(depth, np.float32, order="C")
        if d.shape != (h, w):
            raise ValueError(f"depth {d.shape} is not the mask's {m.shape}")
    lib.dibr_hole_fill2(img, m, None if d is None else d.ctypes.data_as(ctypes.c_void_p),
                        h, w, c, ctypes.c_float(threshold))
    return (img, m) if d is None else (img, m, d)


def hole_fill1(image, mask, fill_value: float = 255.0):
    """The reference's other raster-order hole fill (``dibr_filter_mask``)
    of ``image`` (H, W, C) under its coverage ``mask`` (H, W): a 5x5 and a
    3x3 pass, border extension, and isolated known pixels reset to
    ``fill_value``.  Returns float32 copies (image, mask)."""
    lib = load()
    img = np.array(image, np.float32, order="C")
    m = np.array(mask, np.float32, order="C")
    if img.ndim != 3 or m.shape != img.shape[:2]:
        raise ValueError(f"need image (H, W, C) and mask (H, W), got {img.shape} and {m.shape}")
    h, w, c = img.shape
    lib.dibr_hole_fill1(img, m, h, w, c, ctypes.c_float(fill_value))
    return img, m


def zbuffer_splat(xs, ys, zs, src):
    """First-writer-wins point splat of ``src`` (H, W, C) to the rounded
    target pixels ``xs``, ``ys`` (H, W) with target depths ``zs`` (H, W),
    sources in raster order.  Returns (out (H, W, C) with ones where
    nothing landed, points_z (H, W), mask (H, W) uint8)."""
    lib = load()
    xs = np.ascontiguousarray(np.asarray(xs, np.int16))
    ys = np.ascontiguousarray(np.asarray(ys, np.int16))
    zs = np.ascontiguousarray(np.asarray(zs, np.float32))
    src = np.ascontiguousarray(np.asarray(src, np.float32))
    h, w = zs.shape
    if xs.shape != (h, w) or ys.shape != (h, w) or src.ndim != 3 or src.shape[:2] != (h, w):
        raise ValueError(f"need xs, ys, zs (H, W) and src (H, W, C), got {xs.shape}, "
                         f"{ys.shape}, {zs.shape} and {src.shape}")
    c = src.shape[-1]
    out = np.ones((h, w, c), np.float32)
    points = np.zeros((h, w), np.float32)
    mask = np.zeros((h, w), np.uint8)
    lib.zbuffer_point_splat(xs, ys, zs, src, out, points.ctypes.data_as(ctypes.c_void_p),
                            mask, h, w, c)
    return out, points, mask
