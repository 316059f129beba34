"""Blender-style ``transforms_<split>.json`` scenes (port of
``text2nerf_tpu/data/blender.py``): the NeRF-synthetic format, intrinsics
from ``camera_angle_x`` and a camera-to-world matrix per frame.  PNGs go
through :mod:`..utils.png` and the downsample through
:mod:`..services.image_ops`' INTER_AREA, so no image library is needed.
"""

from __future__ import annotations

import json
import math
import os
from typing import Tuple

import numpy as np

from ..ops import rays as ray_ops
from ..utils.png import read_png
from .scene_state import SceneState

BLENDER2OPENCV = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], np.float64
)


def _read_image(path: str) -> np.ndarray:
    img = read_png(path)
    scale = 65535.0 if img.dtype == np.uint16 else 255.0
    img = img.astype(np.float32) / np.float32(scale)
    return img[..., None] if img.ndim == 2 else img


def load_blender_scene(
    datadir: str,
    split: str = "train",
    downsample: float = 1.0,
    scene_bound: float = 1.5,
    near_far: Tuple[float, float] = (2.0, 6.0),
    white_bg: bool = True,
) -> SceneState:
    """``transforms_<split>.json`` under ``datadir`` as a SceneState: the
    frames' poses (OpenCV axes), images (alpha blended onto white) and
    rays; every view is a generated view with a full mask and zero depth,
    and its own render path."""
    from ..services.image_ops import resize_area

    with open(os.path.join(datadir, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    img0 = _read_image(os.path.join(datadir, meta["frames"][0]["file_path"] + ".png"))
    h = int(img0.shape[0] / downsample)
    w = int(img0.shape[1] / downsample)
    focal = 0.5 * w / math.tan(0.5 * meta["camera_angle_x"])
    intrinsic = (focal, focal, w / 2.0, h / 2.0)

    poses, images = [], []
    for frame in meta["frames"]:
        c2w = np.array(frame["transform_matrix"]) @ BLENDER2OPENCV
        poses.append(c2w.astype(np.float32))
        img = _read_image(os.path.join(datadir, frame["file_path"] + ".png"))
        if downsample != 1.0:
            img = np.stack([resize_area(img[..., c], (w, h)) for c in range(img.shape[-1])],
                           -1)
        if img.shape[-1] == 4:  # alpha blended onto white
            img = img[..., :3] * img[..., 3:] + (1 - img[..., 3:])
        images.append(img)
    poses = np.stack(poses)
    images = np.stack(images)
    rays_split = ray_ops.rays_split_np(poses, intrinsic, h, w)

    n = poses.shape[0]
    return SceneState(
        hw=(h, w), intrinsic=intrinsic,
        scene_bbox=np.array([[-scene_bound] * 3, [scene_bound] * 3], np.float32),
        near_far=near_far, white_bg=white_bg,
        poses_gen=poses, poses_support=poses[:1],
        all_rays=rays_split.reshape(-1, 6),
        all_rgbs=images.reshape(-1, 3),
        all_depth=np.zeros((n * h * w,), np.float32),
        rays_gen_split=rays_split,
        rgbs_gen_split=images,
        depth_gen_split=np.zeros((n, h, w), np.float32),
        masks_gen_split=np.ones((n, h, w), np.float32),
        rays_support_split=rays_split,
        render_path=poses,
    )
