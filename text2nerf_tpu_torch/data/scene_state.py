"""Scene state (port of ``text2nerf_tpu/data/scene_state.py``: the ray
pools, the scene bootstrap, the scene-aware eval z-floor, the read side
of scene snapshots and the append of a generated view).

The scene is an explicit state object of numpy arrays; the bootstrap
returns it.  The generative priors (text2img, depth estimation) are
injected callables, so the pipeline runs on the procedural services.
Pools stay host numpy: the trainer gathers each batch from them and
copies it to the device.  The support-set warp runs on ``device``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..engine.tracing import phase_timer
from ..ops import filters as filter_ops
from ..ops import rays as ray_ops
from ..ops import splat as splat_ops
from . import io as scene_io
from . import trajectories as traj


def formatted_ray_pool(images, depths, masks, poses, intrinsic, h, w):
    """Flattened masked training pools and per-view split arrays: rays
    [o|d] with normalized directions, selected where each view's mask is
    set.

    Returns (rays [M,6], rgbs [M,3], depths [M],
             rays_split [N,H*W,6], rgbs_split [N,H,W,3], depths_split [N,H,W]).
    """
    rays_split = ray_ops.rays_split_np(poses, intrinsic, h, w)

    images = np.asarray(images, np.float32)
    depths = np.asarray(depths, np.float32)
    masks = np.asarray(masks)

    n = poses.shape[0]
    sel_rays, sel_rgbs, sel_depths = [], [], []
    for i in range(n):
        m = masks[i].reshape(-1) > 0.5
        sel_rays.append(rays_split[i][m])
        sel_rgbs.append(images[i].reshape(-1, 3)[m])
        sel_depths.append(depths[i].reshape(-1)[m])
    return (
        np.concatenate(sel_rays, 0),
        np.concatenate(sel_rgbs, 0),
        np.concatenate(sel_depths, 0),
        rays_split,
        images.reshape(n, h, w, 3),
        depths.reshape(n, h, w),
    )


def test_ray_split(poses, intrinsic, h, w):
    """Per-view rays of the test split."""
    return ray_ops.rays_split_np(poses, intrinsic, h, w)


@dataclasses.dataclass
class SceneState:
    """Everything the trainer needs about the scene."""

    hw: Tuple[int, int]
    intrinsic: Tuple[float, float, float, float]
    scene_bbox: np.ndarray            # (2, 3), ±scene_bound
    near_far: Tuple[float, float]     # (0.5, 8.0)
    white_bg: bool
    poses_gen: np.ndarray             # (V, 4, 4) trajectory poses
    poses_support: np.ndarray         # (9, 4, 4) support poses of view 0
    # flat masked pools over the seed's support set (stage-1 training data)
    all_rays: np.ndarray
    all_rgbs: np.ndarray
    all_depth: np.ndarray
    # per-view split arrays
    rays_gen_split: np.ndarray        # (V, H*W, 6)
    rgbs_gen_split: np.ndarray        # (k, H, W, 3)
    depth_gen_split: np.ndarray       # (k, H, W)
    masks_gen_split: np.ndarray       # (k, H, W) inpaint masks
    # support-view split rays (for preview rendering)
    rays_support_split: np.ndarray
    # per-view ray pools: view id -> (rays, rgbs, depths)
    updates: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]] = (
        dataclasses.field(default_factory=dict)
    )
    render_path: Optional[np.ndarray] = None  # test split video poses


@dataclasses.dataclass
class SceneConfig:
    """Bootstrap options (the flags that shape the scene)."""

    datadir: str
    prompt: str = "a cozy living room"
    negative_prompt: str = "blurry, bad art, blurred, text, watermark"
    pose_traj: str = "local_fixed"
    num_training: int = 24
    angle: float = 0.2
    trans_range: float = 0.2
    push_depth: float = 2.0
    scene_bound: float = 8.0
    hw: Tuple[int, int] = (512, 512)
    use_support_set: bool = True
    regen_pose: bool = True
    depth_net_type: int = 2
    white_bg: bool = True
    filter_size: Tuple[int, ...] = (5, 5, 3, 3)
    num_filter_iter: int = 4


def resize_nearest(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Nearest-neighbour resize to (h, w), the source pixel of each target
    pixel chosen as ``cv2.resize(INTER_NEAREST)`` chooses it."""
    sh, sw = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / sw))).astype(np.int64), sw - 1)
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / sh))).astype(np.int64), sh - 1)
    return img[ys][:, xs]


def _scene_bbox(cfg: SceneConfig) -> np.ndarray:
    return np.array([[-cfg.scene_bound] * 3, [cfg.scene_bound] * 3], np.float32)


def bootstrap_scene(
    cfg: SceneConfig,
    split: str = "train",
    text2img: Optional[Callable[[str, str], np.ndarray]] = None,
    estimate_depth: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    auto_accept: bool = True,
    confirm: Optional[Callable[[np.ndarray], bool]] = None,
    log=None,
    device=None,
) -> SceneState:
    """Build the initial scene.

    - the seed image from disk or the injected ``text2img`` service;
    - metric depth from disk or the injected ``estimate_depth`` service,
      through ``depth_process``;
    - sparse bilateral filtering of the seed RGBD (native library);
    - intrinsics f = max(H, W), c = center;
    - the trajectory, the support poses and the support-set warp (on
      ``device``, cuda unless asked).

    ``auto_accept`` skips the interactive approval loop; a ``confirm``
    callable keeps a human gate (regenerates while it returns False).
    ``log`` (a tracing.MetricsLogger) records each sub-phase's wall clock
    as ``phase/bootstrap_<name>_s``.
    """
    dev = resolve_device(device)
    h, w = cfg.hw
    paths = scene_io.scene_paths(cfg.datadir)
    for p in paths.values():
        os.makedirs(p, exist_ok=True)

    # ---- seed image -------------------------------------------------------
    seed_path = os.path.join(paths["rgb"], "00000.png")
    with phase_timer("bootstrap_seed_image", log):
        if os.path.isfile(seed_path):
            img = scene_io.read_rgb(seed_path)
        else:
            if text2img is None:
                raise FileNotFoundError(
                    f"no seed image at {seed_path} and no text2img service given"
                )
            while True:
                img = np.asarray(text2img(cfg.prompt, cfg.negative_prompt))
                if auto_accept or confirm is None or confirm(img):
                    break
            scene_io.write_rgb(seed_path, img)

    # crop to square if needed
    ih, iw = img.shape[:2]
    if ih != iw:
        s = min(ih, iw)
        img = img[:s, :s]

    # ---- depth ------------------------------------------------------------
    depth_png = os.path.join(paths["depth"], "00000.png")
    depth_npy = os.path.join(paths["depth"], "00000.npy")
    with phase_timer("bootstrap_depth", log):
        if os.path.isfile(depth_png):
            depth = scene_io.depth_process(
                scene_io.read_depth_raw(depth_png), cfg.depth_net_type,
                push_depth=cfg.push_depth,
            )
        elif os.path.isfile(depth_npy):
            depth = (np.load(depth_npy) / 2.0).astype(np.float32)
        else:
            if estimate_depth is None:
                raise FileNotFoundError(
                    f"no depth at {depth_png} and no depth service given"
                )
            counts = np.asarray(estimate_depth(img))
            scene_io.write_depth_png(depth_png, counts)
            depth = scene_io.depth_process(
                counts, cfg.depth_net_type, push_depth=cfg.push_depth
            )
    if depth.shape[0] != img.shape[0]:
        depth = resize_nearest(depth, img.shape[1], img.shape[0])

    # resize to the target resolution
    if img.shape[:2] != (h, w):
        img = resize_nearest(img, w, h)
        depth = resize_nearest(depth, w, h)

    # ---- seed RGBD filtering ----------------------------------------------
    with phase_timer("bootstrap_bilateral", log):
        img, depth = filter_ops.sparse_bilateral_filtering(
            depth, img, filter_size=cfg.filter_size,
            depth_threshold=0.02, num_iter=cfg.num_filter_iter,
        )

    # ---- intrinsics and poses ---------------------------------------------
    fx, fy, cx, cy = ray_ops.default_intrinsics(h, w)
    intrinsic = (fx, fy, cx, cy)
    existing = scene_io.load_poses(paths["cam"])
    if existing is not None and not cfg.regen_pose:
        poses = existing
    else:
        poses = traj.training_trajectory(
            cfg.pose_traj, cfg.num_training, cfg.angle, cfg.trans_range
        )
        k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        scene_io.save_poses(paths["cam"], poses, k)

    # support poses
    if cfg.pose_traj == "local_circle":
        poses_sprt = traj.local_orbit_poses(poses[0], range_center=cfg.trans_range)
    else:
        poses_sprt = traj.local_fixed_poses(
            poses[0], angle=cfg.angle, range_center=cfg.trans_range,
            range_yaw=0.6, range_pitch=0.2,
        )

    if split != "train":
        vposes = traj.test_trajectory(
            cfg.pose_traj, poses[0], cfg.angle, cfg.trans_range
        )
        rays_split = test_ray_split(vposes, intrinsic, h, w)
        return SceneState(
            hw=(h, w), intrinsic=intrinsic, scene_bbox=_scene_bbox(cfg),
            near_far=(0.5, 8.0), white_bg=cfg.white_bg,
            poses_gen=vposes, poses_support=poses_sprt,
            all_rays=rays_split.reshape(-1, 6),
            all_rgbs=np.zeros((0, 3), np.float32),
            all_depth=np.zeros((0,), np.float32),
            rays_gen_split=rays_split,
            rgbs_gen_split=np.zeros((0, h, w, 3), np.float32),
            depth_gen_split=np.zeros((0, h, w), np.float32),
            masks_gen_split=np.zeros((0, h, w), np.float32),
            rays_support_split=rays_split,
            render_path=vposes,
        )

    # ---- support set via warping -------------------------------------------
    # sub-timers: the warp on the device, the readback of the warped stack,
    # the host-numpy pool
    with phase_timer("bootstrap_support_pool", log):
        if cfg.use_support_set:
            with phase_timer("bootstrap_sprt_warp", log, dev):
                def t(x):
                    return torch.as_tensor(np.asarray(x, np.float32), device=dev)

                rgbs_w, masks_w, depth_w = splat_ops.warp_one_to_many(
                    t(img), t(depth), t(poses_sprt[0]), t(poses_sprt[1:]), intrinsic,
                )
            with phase_timer("bootstrap_sprt_readback", log):
                images = np.concatenate([img[None], rgbs_w.cpu().numpy()], 0)
                masks = np.concatenate(
                    [np.ones((1, h, w), np.int32), masks_w.cpu().numpy()], 0
                )
                depths = np.concatenate([depth[None], depth_w.cpu().numpy()], 0)
            with phase_timer("bootstrap_sprt_raypool", log):
                pool = formatted_ray_pool(
                    images, depths, masks, poses_sprt, intrinsic, h, w
                )
        else:
            pool = formatted_ray_pool(
                img[None], depth[None], np.ones((1, h, w), np.int64),
                poses_sprt[:1], intrinsic, h, w,
            )
    all_rays, all_rgbs, all_depth, rays_split, rgbs_split, depth_split = pool
    rays_support_split = (
        rays_split
        if cfg.use_support_set
        else test_ray_split(poses_sprt, intrinsic, h, w)
    )

    state = SceneState(
        hw=(h, w), intrinsic=intrinsic, scene_bbox=_scene_bbox(cfg),
        near_far=(0.5, 8.0), white_bg=cfg.white_bg,
        poses_gen=poses, poses_support=poses_sprt,
        all_rays=all_rays, all_rgbs=all_rgbs, all_depth=all_depth,
        rays_gen_split=test_ray_split(poses, intrinsic, h, w),
        rgbs_gen_split=rgbs_split[:1],
        depth_gen_split=depth_split[:1],
        masks_gen_split=np.ones((1, h, w), np.float32),
        rays_support_split=rays_support_split,
    )
    # the seed view's pool
    state.updates["00000"] = (all_rays, all_rgbs, all_depth)
    return state


def supervised_z_floor(
    scene, margin: float = 0.1, ceiling: float = 2.0, floor: float = 0.05,
) -> float:
    """Scene-aware eval-time world-z cull threshold: min(ceiling, the
    lowest world z of any generated view's ground-truth depth points -
    margin), clamped to ``floor``.  The reference culls z <= 2 at eval;
    trajectories can place supervised content below that."""
    n_views = int(np.asarray(scene.rgbs_gen_split).shape[0])
    z_min = float("inf")
    for v in range(n_views):
        rays = np.asarray(scene.rays_gen_split[v], np.float32)
        d = np.asarray(scene.depth_gen_split[v], np.float32).reshape(-1)
        z = rays[:, 2] + rays[:, 5] * d
        z_min = min(z_min, float(z.min()))
    if not np.isfinite(z_min):
        return ceiling
    return max(floor, min(ceiling, z_min - margin))


def load_scene_snapshot(path: str) -> SceneState:
    """The scene a ``scene_snapshot.npz`` holds: the generated views'
    images, depths and inpaint masks, their poses and the support poses,
    with every view's rays recomputed.  No ray pool is rebuilt (the JAX
    package's ``n_views_pools=0``): enough for :func:`supervised_z_floor`
    and for renders, not for resuming a fit."""
    data = np.load(path)
    h, w = (int(x) for x in data["hw"])
    intrinsic = tuple(float(x) for x in data["intrinsic"])
    poses = data["poses_gen"]
    return SceneState(
        hw=(h, w), intrinsic=intrinsic,
        scene_bbox=data["scene_bbox"],
        near_far=tuple(float(x) for x in data["near_far"]),
        white_bg=bool(data["white_bg"]),
        poses_gen=poses, poses_support=data["poses_support"],
        all_rays=np.zeros((0, 6), np.float32),
        all_rgbs=np.zeros((0, 3), np.float32),
        all_depth=np.zeros((0,), np.float32),
        rays_gen_split=test_ray_split(poses, intrinsic, h, w),
        rgbs_gen_split=data["rgbs_gen_split"],
        depth_gen_split=data["depth_gen_split"],
        masks_gen_split=data["masks_gen_split"],
        rays_support_split=test_ray_split(data["poses_support"], intrinsic, h, w),
    )


def append_generated_view(
    state: SceneState, img: np.ndarray, depth: np.ndarray, inpaint_mask: np.ndarray
) -> SceneState:
    """A new scene with one more completed RGBD view (its image, depth and
    inpaint mask appended to the generation splits); the pools dict is
    copied, so the caller's scene keeps its own."""
    return dataclasses.replace(
        state,
        rgbs_gen_split=np.concatenate(
            [state.rgbs_gen_split, np.asarray(img, np.float32)[None]], 0
        ),
        depth_gen_split=np.concatenate(
            [state.depth_gen_split, np.asarray(depth, np.float32)[None]], 0
        ),
        masks_gen_split=np.concatenate(
            [state.masks_gen_split, np.asarray(inpaint_mask, np.float32)[None]], 0
        ),
        updates=dict(state.updates),
    )
