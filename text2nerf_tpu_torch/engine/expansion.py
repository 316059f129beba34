"""Progressive scene expansion: render → warp → inpaint → align → append
(port of ``text2nerf_tpu/engine/expansion.py``).

:func:`expand_scene` completes one view of the trajectory from the
current field and scene, and returns the scene with that view appended
and its support-set ray pool in ``updates``:

1. render the known views (kernels A and B on the device) and filter
   them (native sparse bilateral filter);
2. warp them into the new view, first view first, and fill small holes
   (native raster-order hole fill);
3. render the new view;
4. inpaint the holes (rounds of candidates) and keep the best-ranked;
5. estimate its depth and align it globally to the rendered depth;
6. finetune the merge net to align it locally;
7. filter the completed view;
8. append it and build its support pool (warps of the view to its
   support poses, restricted to what its inpainted region covers).

Artifacts go under ``<logdir>/DIBR/`` through :mod:`.io_async` (the
trainer flushes before it returns).  Each step's wall clock is logged as
``phase/expand{view}_<name>_s``.

As in the JAX package, the renders use the scene's box
(``scene.scene_bbox``), not a box the trainer may have shrunk.
``update_known_views`` (warping the new content back into the known
views) is not ported and raises before any work.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import native
from ..data import scene_state as ss
from ..data import trajectories as traj
from ..device import as_tensor, resolve_device
from ..ops import filters as filter_ops
from ..ops import render as render_ops
from ..ops import splat as splat_ops
from ..services.registry import Services
from . import io_async
from .tracing import phase_timer


def _write(path, arr):
    io_async.write_async(path, np.asarray(arr))


def global_depth_alignment(
    depth_rendered, depth_est, known_mask, push_depth, max_samples=10000, seed=0
):
    """Global (scale, shift) of the monocular estimate onto the rendered
    depth, from sampled known pixels: scale the mean ratio of consecutive
    samples' depth differences (kept where |s - 1| <= 5 |thresh - 1| and
    s >= 0), shift the mean residual (kept where |shift| <= 2 |thresh|)."""
    rng = np.random.default_rng(seed)
    ys, xs = np.nonzero(np.asarray(known_mask) > 0)
    if len(ys) == 0:
        return 1.0, 0.0
    n = min(len(ys), max_samples)
    sel = rng.choice(len(ys), size=n, replace=False)
    ys, xs = ys[sel], xs[sel]
    dr = np.asarray(depth_rendered)[ys, xs]
    de = np.asarray(depth_est)[ys, xs]

    thresh_s = (np.asarray(depth_rendered).max() - push_depth) / (
        np.asarray(depth_est).max() - push_depth + 1e-12
    )
    dd1 = dr[:-1] - dr[1:]
    dd2 = de[:-1] - de[1:]
    s = dd1 / (dd2 + 1e-8)
    ok = np.isfinite(s) & (np.abs(s - 1) <= 5 * abs(thresh_s - 1)) & (s >= 0)
    scale = float(s[ok].mean()) if ok.any() else float(thresh_s)

    de_scaled = np.asarray(depth_est) * scale
    thresh_t = de_scaled.max() - np.asarray(depth_rendered).max()
    shifts = de_scaled[ys, xs] - dr
    ok_t = np.abs(shifts) <= 2 * abs(thresh_t)
    shift = float(shifts[ok_t].mean()) if ok_t.any() else float(thresh_t)
    return scale, shift


@dataclasses.dataclass
class ExpansionConfig:
    prompt: str
    negative_prompt: str = "blurry, bad art, blurred, text, watermark"
    push_depth: float = 2.0
    trans_range: float = 0.2
    use_support_set: bool = True
    update_known_views: bool = False
    use_filter_filling_holes: bool = True
    use_rendered_img_to_warp: bool = True
    frame_select_type: str = "auto_cos"  # auto_cos | first
    n_candidates: int = 20
    candidates_per_round: int = 5
    merge_iters: int = 500
    merge_lr: float = 1e-5
    chunk: int = 16384
    app_k: int = 64


def _f32(x, dev):
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def expand_scene(
    view_idx: int,
    field,
    scene: ss.SceneState,
    services: Services,
    expansion: ExpansionConfig,
    logdir: str,
    *,
    n_samples: int,
    white_bg: bool = False,
    seed: int = 0,
    alpha_mask=None,
    compact_k: int = 0,
    eval_z_min: float = 2.0,
    log=None,
    device=None,
) -> ss.SceneState:
    """Complete view ``view_idx`` of the trajectory and return the scene
    with it (see the module docstring).  Renders run on ``device`` (cuda
    unless asked); with ``alpha_mask`` and ``compact_k`` (-1: the
    adaptive renderer) they take the compacted path.  ``log`` (a
    tracing.MetricsLogger) records each step's wall clock."""
    ex = expansion
    if ex.update_known_views:
        raise NotImplementedError(
            "update_known_views=True (warping new content back into the known views) "
            "is not ported yet")
    dev = resolve_device(device)
    h, w = scene.hw
    aabb = as_tensor(scene.scene_bbox, dev)
    dibr = os.path.join(logdir, "DIBR")
    tag = f"expand{view_idx}"

    def render(rays):
        out = render_ops.render_chunked(
            field, aabb, rays, n_samples=n_samples, chunk=ex.chunk, app_k=ex.app_k,
            white_bg=white_bg, alpha_mask=alpha_mask, compact_k=compact_k,
            eval_z_min=eval_z_min, device=dev,
        )
        return torch.clamp(out.rgb, 0, 1), out.depth

    # --- 1. render and filter the known views: every render is launched
    # before the first readback, so the host filters one view while the
    # device renders the next
    rgbs_pre, depths_pre = [], []
    with phase_timer(f"{tag}_render_filter_known", log, dev):
        if ex.use_rendered_img_to_warp:
            outs = [render(scene.rays_gen_split[n]) for n in range(view_idx)]
            for rgb_d, depth_d in outs:
                rgb_j, depth_j = filter_ops.sparse_bilateral_filtering(
                    depth_d.cpu().numpy().reshape(h, w), rgb_d.cpu().numpy().reshape(h, w, 3),
                    filter_size=(7, 5, 5, 3, 3), depth_threshold=0.02, num_iter=5,
                )
                rgbs_pre.append(rgb_j)
                depths_pre.append(depth_j)
            del outs
        else:
            rgbs_pre = [np.asarray(scene.rgbs_gen_split[n]) for n in range(view_idx)]
            depths_pre = [np.asarray(scene.depth_gen_split[n]) for n in range(view_idx)]

    # --- 2. warp every known view into the target, fill the small holes
    with phase_timer(f"{tag}_dibr_warp", log, dev):
        my_map, warped_img, warped_depth = splat_ops.warp_many_to_one(
            _f32(np.stack(rgbs_pre), dev), _f32(np.stack(depths_pre), dev),
            _f32(scene.poses_gen[:view_idx], dev), _f32(scene.poses_gen[view_idx], dev),
            scene.intrinsic,
        )
        my_map = my_map.cpu().numpy().astype(np.float32)
        warped_img, warped_depth = warped_img.cpu().numpy(), warped_depth.cpu().numpy()
    if ex.use_filter_filling_holes:
        with phase_timer(f"{tag}_dibr_holefill", log):
            warped_img, my_map_f, warped_depth = native.hole_fill2(
                warped_img, my_map, warped_depth)
    else:
        my_map_f = my_map

    _write(os.path.join(dibr, "warped", "%05d.png" % view_idx), warped_img)
    _write(os.path.join(dibr, "mask", "%05d.png" % view_idx), my_map_f)
    _write(os.path.join(dibr, "mask_inv", "%05d.png" % view_idx), 1 - my_map_f)

    # --- 3. render the target view
    with phase_timer(f"{tag}_render_target", log, dev):
        rgb_d, depth_d = render(scene.rays_gen_split[view_idx])
        rgb_render = rgb_d.cpu().numpy().reshape(h, w, 3)
        depth_rendered = depth_d.cpu().numpy().reshape(h, w) * my_map_f
    _write(os.path.join(dibr, "rendered", "%05d_ori.png" % view_idx), rgb_render)

    # --- 4. inpaint the holes and rank the candidates
    mask_inv = 1.0 - my_map_f
    with phase_timer(f"{tag}_inpaint_rank", log):
        if ex.frame_select_type == "auto_cos":
            candidates = []
            rounds = max(1, ex.n_candidates // ex.candidates_per_round)
            for r in range(rounds):
                candidates += list(services.inpaint(
                    rgb_render, mask_inv, prompt=ex.prompt,
                    negative_prompt=ex.negative_prompt,
                    num_images=ex.candidates_per_round, seed=seed * 100 + r,
                ))
            scores = services.rank(candidates, scene.rgbs_gen_split[0])
            img_new = np.asarray(candidates[int(np.argmax(scores))], np.float32)
            for i, cand in enumerate(candidates):
                _write(os.path.join(dibr, "rgbs", "%05d_%03d.png" % (view_idx, i)), cand)
        else:
            img_new = np.asarray(services.inpaint(
                rgb_render, mask_inv, prompt=ex.prompt, negative_prompt=ex.negative_prompt,
                num_images=1, seed=seed,
            )[0], np.float32)
    _write(os.path.join(dibr, "rgbs", "%05d.png" % view_idx), img_new)

    # --- 5. monocular depth and its global alignment
    with phase_timer(f"{tag}_depth_align", log):
        counts = np.asarray(services.estimate_depth(img_new))
        depth_est = counts / 12000.0 + ex.push_depth
        scale, shift = global_depth_alignment(
            depth_rendered, depth_est, my_map_f, ex.push_depth, seed=seed
        )
        depth_shift = depth_est * scale - shift

    # --- 6. local alignment: the merge net finetuned on the known pixels
    depth_ref = ((depth_rendered - ex.push_depth) * 12000.0 / 32768.0 - 1.0) * my_map_f
    depth_src = (depth_shift - ex.push_depth) * 12000.0 / 32768.0 - 1.0
    with phase_timer(f"{tag}_merge_finetune", log):
        merged = services.merge.run_finetune(
            depth_ref.astype(np.float32), depth_src.astype(np.float32), my_map_f.copy(),
            outsize=max(h, w), lr=ex.merge_lr, iters=ex.merge_iters,
        )
        depth_new = ((merged + 1.0) * 32768.0) / 12000.0 + ex.push_depth
        depth_new = depth_new.astype(np.float32)
    _write(os.path.join(dibr, "depth", "%05d_depth_finetuning2.png" % view_idx),
           (merged + 1.0) * 32768.0)

    # --- 7. filter the completed view
    with phase_timer(f"{tag}_filter_new", log):
        img_new, depth_new = filter_ops.sparse_bilateral_filtering(
            depth_new, img_new, filter_size=(5, 5, 3, 3), depth_threshold=0.02, num_iter=4,
        )
    _write(os.path.join(dibr, "depth", "%05d_new.png" % view_idx), depth_new * 12000)

    # --- 8. append, and the view's support pool
    inpaint_mask = 1.0 - my_map_f
    scene = ss.append_generated_view(scene, img_new, depth_new, inpaint_mask)
    with phase_timer(f"{tag}_support_pool", log, dev):
        if ex.use_support_set:
            poses_support = traj.local_fixed_poses(
                scene.poses_gen[view_idx], angle=0, range_center=ex.trans_range,
                range_yaw=0.6, range_pitch=0.2,
            )
            rgbs_w, _, depth_w, masks_w = splat_ops.warp_one_to_many_with_mask(
                _f32(img_new, dev), _f32(depth_new, dev), _f32(poses_support[0], dev),
                _f32(poses_support[1:], dev), scene.intrinsic,
                extra_mask=_f32(inpaint_mask, dev),
            )
            images = np.concatenate([img_new[None], rgbs_w.cpu().numpy()], 0)
            masks = np.concatenate([inpaint_mask[None], masks_w.cpu().numpy()], 0)
            depths = np.concatenate([depth_new[None], depth_w.cpu().numpy()], 0)
            rays_p, rgbs_p, depths_p, _, _, _ = ss.formatted_ray_pool(
                images, depths, masks, poses_support, scene.intrinsic, h, w
            )
        else:
            rays_p, rgbs_p, depths_p, _, _, _ = ss.formatted_ray_pool(
                img_new[None], depth_new[None], inpaint_mask[None],
                scene.poses_gen[view_idx][None], scene.intrinsic, h, w,
            )
    scene.updates["%05d" % view_idx] = (rays_p, rgbs_p, depths_p)
    return scene
