"""Rendering and evaluating views of a field (port of ``render_view``,
``evaluation``, ``evaluation_path`` and ``write_video`` from
``text2nerf_tpu/engine/renderer.py``).

Frames are written as PNGs through :mod:`..utils.png` and videos, where
neither imageio nor PIL can be imported, as uncompressed AVIs
(:mod:`..utils.mjpeg_avi`): no image library is needed.  With
``compute_extra_metrics`` the evaluation adds SSIM and LPIPS-alex, both on
its device; LPIPS without weights warns once and is left out, as in the
JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..ops import rays as ray_ops
from ..ops import render as render_ops
from ..utils.mjpeg_avi import write_mjpeg_avi, write_rgb_avi
from ..utils.png import write_png
from . import metrics as M
from .tracing import span

_lpips_warned = False


def _lpips_or_warn(gt, rgb, net, weights_dir, device):
    """LPIPS of ``rgb`` against ``gt``, or None when its weights are
    missing: the first such call warns, later ones are silent.  Any other
    failure (a device error, a shape fault) propagates."""
    global _lpips_warned
    try:
        return M.lpips(gt, rgb, net, weights_dir, device=device)
    except FileNotFoundError as e:
        if not _lpips_warned:
            import warnings

            warnings.warn(
                f"LPIPS unavailable ({type(e).__name__}: {e}); evals will omit the lpips "
                "metric. Put the torchvision backbone and the lpips heads (or the JAX "
                "package's converted lpips_<net>.npz) in the weights directory to enable it.",
                stacklevel=3,
            )
            _lpips_warned = True
        return None


def write_video(path: str, frames, fps: int = 30, quality: int = 9) -> str:
    """Write ``frames`` ((H, W, 3) uint8) as an mp4 through imageio, else
    as an MJPEG AVI (PIL's JPEG encoder), else as an uncompressed RGB AVI
    (numpy only, so a video is written on any machine).  Returns the path
    written."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        imageio = None
    if imageio is not None:
        try:
            imageio.mimwrite(path, np.stack(frames), fps=fps, quality=quality)
            return path
        except (ValueError, RuntimeError, OSError):  # no ffmpeg backend
            pass
    avi = os.path.splitext(path)[0] + ".avi"
    try:
        return write_mjpeg_avi(avi, frames, fps=fps, quality=quality)
    except ImportError:  # no PIL
        return write_rgb_avi(avi, frames, fps=fps)


def render_view(
    field, aabb, rays, hw, *, n_samples, chunk=16384, app_k=64,
    white_bg=True, ndc=False, alpha_mask=None, compact_k=0,
    eval_z_min=2.0, feature_dtype="fp32",
    k_ladder=render_ops.ADAPTIVE_EVAL_LADDER, device=None,
):
    """Render one view; returns (rgb (H, W, 3), depth (H, W)) numpy arrays.
    Features default to fp32 here: view renders feed metrics and saved
    frames."""
    h, w = hw
    with span("t2n.view"):
        out = render_ops.render_chunked(
            field, aabb, rays, n_samples=n_samples, chunk=chunk, app_k=app_k,
            white_bg=white_bg, ndc=ndc, alpha_mask=alpha_mask,
            compact_k=compact_k, eval_z_min=eval_z_min,
            feature_dtype=feature_dtype, k_ladder=k_ladder, device=device,
        )
        with span("t2n.view.out"):
            rgb = torch.clamp(out.rgb, 0.0, 1.0).cpu().numpy().reshape(h, w, 3)
            depth = out.depth.cpu().numpy().reshape(h, w)
    return rgb, depth


def evaluation(
    field, aabb, rays_split, hw, *, n_samples, gt_rgbs=None, save_path=None,
    prefix: str = "", chunk: int = 16384, app_k: int = 64, white_bg: bool = True,
    ndc: bool = False, compute_extra_metrics: bool = False, video: bool = False,
    push_depth: float = 2.0, near_far=(0.5, 8.0), lpips_weights_dir=None,
    alpha_mask=None, compact_k: int = 0,
    eval_z_min: float = 2.0, n_vis: int = -1, feature_dtype: str = "fp32",
    k_ladder=render_ops.ADAPTIVE_EVAL_LADDER, device=None,
):
    """Render a stack of views (``rays_split`` (V, H*W, 6)), PSNR against
    ``gt_rgbs`` where given, and optionally PNGs (``save_path/rgbs``,
    ``save_path/depths``) and videos.

    The depth visualization shifts depth by ``-push_depth + 0.8``; with
    ``n_vis > 0`` only every ``len(views) // n_vis``-th view is rendered.
    Features default to fp32: these renders carry the reported metrics.
    ``compute_extra_metrics`` adds SSIM and LPIPS-alex (weights from
    ``lpips_weights_dir``) where ``gt_rgbs`` is given, both on ``device``.
    Returns {'psnr': [...], 'rgb': [uint8 frames], 'depth': [depth-vis
    frames]}, plus 'ssim' and 'lpips_alex' lists when computed."""
    dev = resolve_device(device)
    psnrs, ssims, lpips_a, rgb_maps, depth_maps = [], [], [], [], []
    if save_path:
        os.makedirs(os.path.join(save_path, "rgbs"), exist_ok=True)
        os.makedirs(os.path.join(save_path, "depths"), exist_ok=True)

    n_views = len(rays_split)
    interval = 1 if n_vis < 0 else max(n_views // n_vis, 1)
    for idx in range(0, n_views, interval):
        rgb, depth = render_view(
            field, aabb, rays_split[idx], hw, n_samples=n_samples, chunk=chunk,
            app_k=app_k, white_bg=white_bg, ndc=ndc, alpha_mask=alpha_mask,
            compact_k=compact_k, eval_z_min=eval_z_min, feature_dtype=feature_dtype,
            k_ladder=k_ladder, device=dev,
        )
        depth_vis, _ = M.visualize_depth(np.maximum(depth - push_depth + 0.8, 0), near_far)
        if gt_rgbs is not None:
            gt = np.asarray(gt_rgbs[idx]).reshape(hw[0], hw[1], 3)
            psnrs.append(M.psnr(rgb, gt))
            if compute_extra_metrics:
                ssims.append(M.ssim(rgb, gt, 1.0, device=dev))
                lp = _lpips_or_warn(gt, rgb, "alex", lpips_weights_dir, dev)
                if lp is not None:
                    lpips_a.append(lp)
        rgb_maps.append((rgb * 255).astype(np.uint8))
        depth_maps.append(depth_vis)
        if save_path:
            write_png(os.path.join(save_path, "rgbs", f"{prefix}{idx:03d}_rgb.png"),
                      rgb_maps[-1])
            write_png(os.path.join(save_path, "depths", f"{prefix}{idx:03d}_depth.png"),
                      depth_vis)

    if video and save_path:
        write_video(os.path.join(save_path, f"{prefix}video.mp4"), rgb_maps)
        write_video(os.path.join(save_path, f"{prefix}depthvideo.mp4"), depth_maps)
    out = {"psnr": psnrs, "rgb": rgb_maps, "depth": depth_maps}
    if ssims:
        out["ssim"] = ssims
    if lpips_a:
        out["lpips_alex"] = lpips_a
    return out


def evaluation_path(
    field, aabb, c2ws, hw, intrinsic, *, n_samples, save_path=None,
    chunk: int = 8192, app_k: int = 64, white_bg: bool = False, ndc: bool = False,
    near_far=(0.5, 8.0), alpha_mask=None, compact_k: int = 0,
    eval_z_min: float = 2.0, feature_dtype: str = "fp32",
    k_ladder=render_ops.ADAPTIVE_EVAL_LADDER, device=None,
):
    """Render along a camera path, generating rays per pose.  Pass
    ``alpha_mask`` (and ``compact_k``; -1 is the adaptive renderer) for
    the mask's culling.  With ``save_path``, PNG frames and the two
    videos.  Returns (rgb uint8 frames, depth-vis frames)."""
    dev = resolve_device(device)
    h, w = hw
    fx, fy, cx, cy = intrinsic
    dirs = ray_ops.ray_directions(h, w, (fx, fy), (cx, cy), device=dev)
    rgb_maps, depth_maps = [], []
    for idx, c2w in enumerate(np.asarray(c2ws)):
        o, d = ray_ops.rays_from_pose(dirs, torch.as_tensor(c2w, dtype=torch.float32))
        rays = torch.cat([o, d], -1)
        rgb, depth = render_view(
            field, aabb, rays, hw, n_samples=n_samples, chunk=chunk,
            app_k=app_k, white_bg=white_bg, ndc=ndc,
            alpha_mask=alpha_mask, compact_k=compact_k,
            eval_z_min=eval_z_min, feature_dtype=feature_dtype,
            k_ladder=k_ladder, device=dev,
        )
        depth_vis, _ = M.visualize_depth(depth, near_far)
        rgb_maps.append((rgb * 255).astype(np.uint8))
        depth_maps.append(depth_vis)
        if save_path:
            os.makedirs(os.path.join(save_path, "rgbd"), exist_ok=True)
            write_png(os.path.join(save_path, f"{idx:03d}.png"), rgb_maps[-1])
            write_png(os.path.join(save_path, "rgbd", f"{idx:03d}.png"),
                      np.concatenate([rgb_maps[-1], depth_vis], axis=1))
    if save_path:
        write_video(os.path.join(save_path, "video.mp4"), rgb_maps, quality=8)
        write_video(os.path.join(save_path, "depthvideo.mp4"), depth_maps, quality=8)
    return rgb_maps, depth_maps
