"""Image, depth and camera files (port of ``text2nerf_tpu/data/io.py``).

The on-disk scene layout of the JAX package: ``<datadir>/rgbs/%05d.png``,
``<datadir>/depth/%05d.png|npy``, ``<datadir>/cam/%05d_pose.npy`` and
``cam/intrinsic.npy``.  PNGs go through :mod:`..utils.png`, so no image
library is needed.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np

from ..utils.png import read_png, write_png


def read_rgb(path: str) -> np.ndarray:
    """Load an RGB image as float32 [0, 1] (H, W, 3)."""
    img = read_png(path)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    if img.shape[-1] == 2:  # gray + alpha
        img = np.repeat(img[..., :1], 3, -1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    elif img.dtype == np.uint16:
        img = img.astype(np.float32) / 65535.0
    return img.astype(np.float32)


def write_rgb(path: str, rgb01: np.ndarray):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_png(path, (np.clip(np.asarray(rgb01), 0, 1) * 255).astype(np.uint8))


def read_depth_raw(path: str) -> np.ndarray:
    """Raw stored depth: 16-bit PNG counts or .npy floats."""
    if path.endswith(".npy"):
        return np.load(path)
    return np.asarray(read_png(path)).astype(np.float64)


def write_depth_png(path: str, depth_counts: np.ndarray):
    """Write 16-bit depth counts."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_png(path, np.clip(depth_counts, 0, 65535).astype(np.uint16))


def depth_process(
    depth,
    depth_net_type: int = 2,
    disp_min: float = 0.14,
    disp_rescale: float = 10.0,
    push_depth: float = 2.0,
):
    """Stored depth counts → metric depth.

    MiDaS (type 0): disparity renormalization and inversion; LeReS (type
    2): counts/12000 + push_depth.
    """
    depth = np.asarray(depth, np.float64)
    if depth_net_type == 0:
        depth = depth / 32768.0 - 1.0
        depth = depth - depth.min()
        depth = (depth / depth.max()) * disp_rescale
        return (1.0 / np.maximum(depth, disp_min)).astype(np.float32)
    return (depth / 12000.0 + push_depth).astype(np.float32)


def read_pfm(path: str):
    """Portable float map reader → (data, scale)."""
    with open(path, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError("not a PFM file")
        m = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode("utf-8"))
        if not m:
            raise ValueError("malformed PFM header")
        w, h = map(int, m.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if color else (h, w)
    return np.flipud(data.reshape(shape)), abs(scale)


def write_pfm(path: str, data: np.ndarray, scale: float = 1.0):
    data = np.flipud(np.asarray(data, np.float32))
    color = data.ndim == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(f"{-scale}\n".encode())  # little-endian
        data.astype("<f").tofile(f)


def scene_paths(datadir: str):
    return {
        "rgb": os.path.join(datadir, "rgbs"),
        "depth": os.path.join(datadir, "depth"),
        "cam": os.path.join(datadir, "cam"),
    }


def load_poses(cam_dir: str):
    files = sorted(glob.glob(os.path.join(cam_dir, "*_pose.npy")))
    return np.stack([np.load(f) for f in files]) if files else None


def save_poses(cam_dir: str, poses: np.ndarray, intrinsic_matrix: np.ndarray):
    os.makedirs(cam_dir, exist_ok=True)
    np.save(os.path.join(cam_dir, "intrinsic.npy"), intrinsic_matrix)
    for i, p in enumerate(poses):
        np.save(os.path.join(cam_dir, "%05d_pose.npy" % i), p)
