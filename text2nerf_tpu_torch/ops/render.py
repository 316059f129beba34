"""Volume rendering of a TensoRF field (port of
``text2nerf_tpu/ops/render.py``).

- :func:`render_rays`: dense marching, appearance on the top-``app_k``
  samples per ray by weight; ``is_train=True`` is the train branch
  (per-ray jitter, no eval z-cull, the autograd head, the random
  background coin).
- :func:`render_rays_compact` / :func:`render_rays_compact_need`: the
  alpha-mask compacted eval renderer (first ``compact_k`` mask-live
  samples per ray), the second also returning each ray's escalation rung.
- :func:`render_rays_train_compact`: the compacted train renderer (the
  first or the depth-anchored last ``compact_k`` mask-live samples, in
  groups of ``density_group`` ray-consecutive samples).
- :func:`render_chunked_adaptive`: the serving renderer; one base-rung
  pass per chunk, then one repacked pass over the rays that need more.
- :func:`render_chunked`: chunked dispatch over the eval renderers.

Factor features go through kernel A (and, in training, its backward
kernel A') on CUDA tensors, and the eval ``MLP_Fea_noview`` head through
kernel B; the train head is plain ``torch`` matmuls under autograd, as the
JAX package's training runs its XLA head.  Sample placement, occupancy,
the live selection, compositing and the escalation bookkeeping are plain
PyTorch in this port slice.  Randomness (jitter, the background coin) is
drawn from a ``torch.Generator`` unless the caller passes it in.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..device import as_tensor, check_on, resolve_device
from ..models import mlp as mlp_mod
from ..models import tensorf as tf
from .kernels import shading_mlp
from .rays import aabb_slab_entry


class RenderOutput(NamedTuple):
    rgb: torch.Tensor      # (B, 3) composited color in [0, 1]
    depth: torch.Tensor    # (B,) expected termination depth (with bg fill)
    z_vals: torch.Tensor   # (B, S) sample depths along each ray
    weights: torch.Tensor  # (B, S) compositing weights
    acc: torch.Tensor      # (B,) accumulated opacity


def _shade(cfg, field, app_feat, is_train: bool = False):
    """Shading head: in eval kernel B on CUDA tensors (its plain version on
    the CPU); in training the autograd head."""
    if cfg.shading_mode != "MLP_Fea_noview":
        raise NotImplementedError(
            f"shading mode {cfg.shading_mode!r} is not ported yet"
        )
    if is_train:
        return mlp_mod.shade(cfg.shading_mode, field.mlp, None, None, app_feat,
                             fea_pe=cfg.fea_pe)
    return shading_mlp.shade_fea_noview(field.mlp, app_feat, cfg.fea_pe)


def _feature_dtype(feature_dtype: str):
    if feature_dtype not in ("fp32", "bf16"):
        raise ValueError(f"feature_dtype must be 'fp32' or 'bf16', got {feature_dtype!r}")
    return torch.bfloat16 if feature_dtype == "bf16" else None


def raw2alpha(sigma, dists):
    """alpha, weights and background weight from density."""
    alpha = 1.0 - torch.exp(-sigma * dists)
    ones = torch.ones_like(alpha[:, :1])
    t = torch.cumprod(torch.cat([ones, 1.0 - alpha + 1e-10], dim=-1), dim=-1)
    weights = alpha * t[:, :-1]
    return alpha, weights, t[:, -1:]


def _march(cfg, field, aabb, rays, n_samples, jitter=None):
    """Slab entry and fixed-step sample depths; ``jitter`` (B, 1) offsets
    each ray's steps (training)."""
    rays_o, rays_d = rays[:, :3], rays[:, 3:6]
    step = tf.step_size(aabb, tf.grid_resolution(field), cfg.step_ratio)
    t_min = aabb_slab_entry(rays_o, rays_d, aabb, cfg.near, cfg.far)
    steps = torch.arange(n_samples, dtype=rays.dtype, device=rays.device)[None, :]
    if jitter is not None:
        steps = steps + jitter
    z_vals = t_min[:, None] + step * steps
    return rays_o, rays_d, step, t_min, z_vals


def _in_aabb(pts, aabb):
    return torch.all((pts >= aabb[0]) & (pts <= aabb[1]), dim=-1)


def clip01(x):
    """Clip to [0, 1] as ``jnp.clip`` differentiates: at a tie the
    gradient splits 0.5 / 0.5 (``torch.clamp`` passes it whole), so a
    white-background ray that lands exactly on 1.0 trains as in JAX."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def _composite(cfg, weights, acc, w_top, rgb_a, z, rays, white_bg, train=False,
               bg_coin=None):
    app_ok = (w_top > cfg.raymarch_weight_thres)[..., None]
    rgb_a = torch.where(app_ok, rgb_a, torch.zeros_like(rgb_a))
    rgb = torch.sum(w_top[..., None] * rgb_a, dim=1)
    if white_bg:
        rgb = rgb + (1.0 - acc[..., None])
    elif train:
        # the random background: white for the whole batch on a coin < 0.5
        rgb = torch.where(bg_coin < 0.5, rgb + (1.0 - acc[..., None]), rgb)
    rgb = clip01(rgb) if train else torch.clamp(rgb, 0.0, 1.0)
    depth = torch.sum(weights * z, dim=-1) + (1.0 - acc) * rays[:, -1]
    return rgb, depth


def _draws(b, device, jitter, bg_coin, generator, white_bg):
    """The train renders' per-ray jitter (B, 1) and background coin: the
    caller's, else drawn from ``generator`` (torch's default one if
    None)."""
    if jitter is None:
        jitter = torch.rand((b, 1), generator=generator, device=device)
    if not white_bg and bg_coin is None:
        bg_coin = torch.rand((), generator=generator, device=device)
    if bg_coin is not None:
        bg_coin = torch.as_tensor(bg_coin, dtype=torch.float32, device=device)
    return jitter.to(device=device, dtype=torch.float32).reshape(b, 1), bg_coin


def render_rays(
    field,
    aabb,
    rays,
    *,
    n_samples: int,
    app_k: int = 64,
    is_train: bool = False,
    white_bg: bool = True,
    ndc: bool = False,
    alpha_mask=None,
    eval_z_min: float = 2.0,
    feature_dtype: str = "fp32",
    jitter=None,
    bg_coin=None,
    generator: Optional[torch.Generator] = None,
) -> RenderOutput:
    """Dense render of a chunk of rays (B, 6) [o | d]: every ray carries
    ``n_samples`` samples, out-of-AABB and mask-dead samples get sigma 0,
    and appearance runs on the top ``app_k`` samples by weight.

    Eval (``is_train=False``, under no_grad): samples at z <=
    ``eval_z_min`` are culled too, and the head is kernel B.
    Train: each ray's steps are offset by ``jitter`` (B, 1) in [0, 1), no
    z-cull, the autograd head, and with ``white_bg=False`` a white
    background when ``bg_coin`` < 0.5; both are drawn from ``generator``
    when not given.  Density is gathered per sample: the JAX package's
    grouped density gathers (``density_group`` > 1) read the same values
    up to one ulp of its hat weights."""
    if ndc:
        raise NotImplementedError("NDC rays are not ported yet")
    cfg = field.cfg
    fdt = _feature_dtype(feature_dtype)
    b = rays.shape[0]
    if is_train:
        jitter, bg_coin = _draws(b, rays.device, jitter, bg_coin, generator, white_bg)
    with torch.no_grad(), record_function("t2n.select"):
        rays_o, rays_d, _, _, z_vals = _march(
            cfg, field, aabb, rays, n_samples, jitter if is_train else None
        )
        pts = rays_o[:, None] + rays_d[:, None] * z_vals[..., None]
        dists = torch.cat(
            [z_vals[:, 1:] - z_vals[:, :-1], torch.zeros_like(z_vals[:, :1])], dim=-1
        )
        valid = _in_aabb(pts, aabb)
        if alpha_mask is not None:
            am = _nearest_alpha_lookup(alpha_mask, pts.reshape(-1, 3)).reshape(b, -1)
            valid = valid & (am > 0)
        if not is_train:
            valid = valid & (pts[..., 2] > eval_z_min)
        xn = torch.clamp(tf.normalize_coord(aabb, pts), -1.0, 1.0)

    with torch.set_grad_enabled(is_train and torch.is_grad_enabled()):
        with record_function("t2n.features"):
            feat = field.density_feature(xn.reshape(-1, 3), fdt).reshape(b, n_samples)
        with record_function("t2n.composite"):
            sigma = torch.where(valid, tf.feature2density(cfg, feat), torch.zeros_like(feat))
            _, weights, _ = raw2alpha(sigma, dists * cfg.distance_scale)
            acc = torch.sum(weights, dim=-1)

        # appearance on the top-K weighted samples
        k = min(app_k, n_samples)
        with record_function("t2n.select"):
            w_top, idx = torch.topk(weights, k, dim=-1)
            xn_k = torch.gather(xn, 1, idx[..., None].expand(-1, -1, 3))
        with record_function("t2n.features"):
            app_feat = field.app_feature(xn_k.reshape(-1, 3), fdt)
        with record_function("t2n.head"):
            rgb_k = _shade(cfg, field, app_feat, is_train).reshape(b, k, 3)
        with record_function("t2n.composite"):
            rgb, depth = _composite(cfg, weights, acc, w_top, rgb_k, z_vals, rays, white_bg,
                                    is_train, bg_coin)
    return RenderOutput(rgb=rgb, depth=depth, z_vals=z_vals, weights=weights, acc=acc)


def occupancy_stride_safe(field, aabb, alpha_mask, stride: int) -> bool:
    """True when testing occupancy only every ``stride``-th sample stays
    conservative: an untested sample drifts at most (stride-1)·step from
    its tested neighbour (directions are normalized, so no component
    exceeds 1), which must stay inside the mask's extra dilation of
    (pool-3)/2 voxels.  Memoized in the mask dict."""
    if stride <= 1:
        return True
    reso = tf.grid_resolution(field)
    key = (reso, float(field.cfg.step_ratio), int(stride))
    cache = alpha_mask.setdefault("_stride_safe", {})
    if key not in cache:
        pool = int(alpha_mask.get("pool", 3))
        slack = (pool - 3) // 2
        if slack <= 0:
            cache[key] = False
        else:
            d, h, w = alpha_mask["volume"].shape
            m_aabb = np.asarray(torch.as_tensor(alpha_mask["aabb"]).cpu(), np.float64)
            mask_unit = (
                (m_aabb[1] - m_aabb[0]) / np.array([w - 1, h - 1, d - 1])
            ).min()
            a = np.asarray(torch.as_tensor(aabb).cpu(), np.float64)
            step = ((a[1] - a[0]) / (np.asarray(reso) - 1)).mean() * float(
                field.cfg.step_ratio
            )
            cache[key] = bool(
                (stride - 1) * step <= slack * mask_unit + 1e-9
            )
    return cache[key]


def _nearest_alpha_lookup(alpha_mask, pts):
    """Occupancy test: nearest-voxel lookup into the dilated alpha volume
    [z, y, x] (one read per sample)."""
    volume, aabb = alpha_mask["volume"], alpha_mask["aabb"]
    d, h, w = volume.shape
    xn = torch.clamp(tf.normalize_coord(aabb, pts), -1.0, 1.0)
    ix = torch.round((xn[..., 0] + 1) * 0.5 * (w - 1)).to(torch.int64)
    iy = torch.round((xn[..., 1] + 1) * 0.5 * (h - 1)).to(torch.int64)
    iz = torch.round((xn[..., 2] + 1) * 0.5 * (d - 1)).to(torch.int64)
    return volume.reshape(-1)[(iz * h + iy) * w + ix]


def first_k_live(live, k: int, impl: str = "sort"):
    """Per-row indices of the first ``k`` True entries of ``live`` (B, N),
    ascending, padded with N - 1 where a row has fewer; plus the mask of
    real entries.  Only the ``sort`` lowering is ported."""
    if impl != "sort":
        raise ValueError(f"first_k_live impl must be 'sort' in this port, got {impl!r}")
    _, n = live.shape
    steps = torch.arange(n, dtype=torch.int32, device=live.device)[None, :]
    order_key = torch.where(live, steps, torch.full_like(steps, n))
    idx = torch.sort(order_key, dim=-1).values[:, :k]
    sel = idx < n
    return torch.clamp(idx, max=n - 1), sel


def last_k_live(live, k: int, impl: str = "sort"):
    """Per-row indices of the LAST ``k`` True entries of ``live`` (B, N),
    ascending, plus the selection mask; pad slots are False, point at 0
    and stand at the front, so the kept indices stay in march order."""
    n = live.shape[1]
    idx_r, sel_r = first_k_live(torch.flip(live, (1,)), k, impl=impl)
    idx = torch.where(sel_r, (n - 1) - idx_r, torch.zeros_like(idx_r))
    return torch.flip(idx, (1,)), torch.flip(sel_r, (1,))


_SELECT_IMPLS = ("sort",)


def _resolve_select_impl(impl: Optional[str]) -> str:
    """None → 'sort'; anything but 'sort' raises (a typo must not fall
    back silently)."""
    if impl is None:
        impl = "sort"
    if impl not in _SELECT_IMPLS:
        raise ValueError(f"select_impl must be one of {_SELECT_IMPLS}, got {impl!r}")
    return impl


#: compact_k buckets an adaptive eval picks from
ADAPTIVE_K_BUCKETS = (16, 32, 48, 64, 96, 128)

#: per-(field, mask, ladder) memo of the adaptive renderer's starting rung
#: (render_chunked_adaptive); bounded and hint-only
_ADAPTIVE_PROBE_CACHE: dict = {}


def adaptive_compact_k(max_live: int, buckets=ADAPTIVE_K_BUCKETS) -> int:
    """Smallest bucket covering ``max_live`` mask-live samples (the largest
    bucket when none does)."""
    for b in buckets:
        if b >= max_live:
            return b
    return buckets[-1]


def _occ_stride(field, aabb, alpha_mask) -> int:
    stride = max(1, (int(alpha_mask.get("pool", 3)) - 1) // 2)
    if stride > 1 and not occupancy_stride_safe(field, aabb, alpha_mask, stride):
        stride = 1
    return stride


@torch.no_grad()
def render_rays_compact(
    field, aabb, rays, alpha_mask, *, n_samples: int, compact_k: int = 96,
    app_k: int = 48, white_bg: bool = True, eval_z_min: float = 2.0,
    feature_dtype: str = "bf16", select_impl: Optional[str] = None,
) -> RenderOutput:
    """Eval renderer with alpha-mask sample compaction: compositing over
    the first ``compact_k`` mask-live samples per ray equals the dense
    render for rays with at most that many; longer rays lose their tail
    (white background fills the missing acc).  Occupancy is tested every
    (pool-1)//2-th sample when the mask's dilation licenses it."""
    return _render_rays_compact(
        field, aabb, rays, alpha_mask, n_samples=n_samples,
        compact_k=compact_k, app_k=app_k, white_bg=white_bg,
        eval_z_min=eval_z_min, occ_stride=_occ_stride(field, aabb, alpha_mask),
        feature_dtype=feature_dtype,
        select_impl=_resolve_select_impl(select_impl),
    )


@torch.no_grad()
def render_rays_compact_need(
    field, aabb, rays, alpha_mask, *, n_samples, compact_k, app_k, k_ladder,
    white_bg=True, eval_z_min=2.0, feature_dtype="bf16", acc_tol=1e-3,
    select_impl=None,
):
    """render_rays_compact + a per-ray escalation target: for each ray
    whose mask-live samples overflow ``compact_k`` while acc < 1 - acc_tol,
    the int8 index of the smallest ``k_ladder`` rung covering its live
    count (0 for rays needing no escalation)."""
    return _render_rays_compact(
        field, aabb, rays, alpha_mask, n_samples=n_samples,
        compact_k=compact_k, app_k=app_k, white_bg=white_bg,
        eval_z_min=eval_z_min, occ_stride=_occ_stride(field, aabb, alpha_mask),
        feature_dtype=feature_dtype, overflow_tol=float(acc_tol),
        select_impl=_resolve_select_impl(select_impl),
        need_ladder=tuple(int(k) for k in k_ladder),
    )


def _render_rays_compact(
    field, aabb, rays, alpha_mask, *, n_samples: int, compact_k: int,
    app_k: int, white_bg: bool, eval_z_min: float, occ_stride: int,
    feature_dtype: str, overflow_tol: Optional[float] = None,
    select_impl: str = "sort", need_ladder: Optional[tuple] = None,
):
    cfg = field.cfg
    fdt = _feature_dtype(feature_dtype)
    b = rays.shape[0]
    rays_o, rays_d, step, t_min, z_vals = _march(cfg, field, aabb, rays, n_samples)
    pts = rays_o[:, None] + rays_d[:, None] * z_vals[..., None]

    valid = _in_aabb(pts, aabb) & (pts[..., 2] > eval_z_min)
    if occ_stride == 1:
        occ = _nearest_alpha_lookup(alpha_mask, pts.reshape(-1, 3)).reshape(b, n_samples)
    else:
        # every occ_stride-th sample is tested and its value broadcast to
        # its group: the mask's dilation covers the untested samples
        n_t = (n_samples + occ_stride - 1) // occ_stride
        pts_t = rays_o[:, None] + rays_d[:, None] * z_vals[:, ::occ_stride, None]
        occ_t = _nearest_alpha_lookup(alpha_mask, pts_t.reshape(-1, 3)).reshape(b, n_t)
        occ = torch.repeat_interleave(occ_t, occ_stride, dim=1)[:, :n_samples]
    live = valid & (occ > 0)
    n_live = torch.sum(live, dim=-1)

    # first-K live samples per ray, in ray order; z and points recomputed
    # from the indices with the expression that built z_vals
    k = min(compact_k, n_samples)
    idx, k_live = first_k_live(live, k, impl=select_impl)
    z_k = t_min[:, None] + step * idx.to(rays.dtype)
    pts_k = rays_o[:, None] + rays_d[:, None] * z_k[..., None]
    xn_k = torch.clamp(tf.normalize_coord(aabb, pts_k), -1.0, 1.0)

    # app_k >= k shades every compacted sample: one fused pass over the
    # tables serves density and appearance
    shade_all = app_k >= k
    if shade_all:
        feat, app_feat = field.fused_features(xn_k.reshape(-1, 3), fdt)
    else:
        feat = field.density_feature(xn_k.reshape(-1, 3), fdt)
    feat = feat.reshape(b, k)
    sigma = torch.where(k_live, tf.feature2density(cfg, feat), torch.zeros_like(feat))
    # uniform eval sampling: every inter-sample dist is `step`, except the
    # dense march's final sample, which carries dist 0
    dists = torch.where(idx == n_samples - 1, torch.zeros_like(z_k), step) * cfg.distance_scale
    _, weights, _ = raw2alpha(sigma, dists)
    acc = torch.sum(weights, dim=-1)

    if shade_all:
        k2 = k
        w_top = weights
    else:
        k2 = min(app_k, k)
        w_top, aidx = torch.topk(weights, k2, dim=-1)
        xn_a = torch.gather(xn_k, 1, aidx[..., None].expand(-1, -1, 3))
        app_feat = field.app_feature(xn_a.reshape(-1, 3), fdt)
    rgb_a = _shade(cfg, field, app_feat).reshape(b, k2, 3)
    rgb, depth = _composite(cfg, weights, acc, w_top, rgb_a, z_k, rays, white_bg)
    out = RenderOutput(rgb=rgb, depth=depth, z_vals=z_k, weights=weights, acc=acc)
    if overflow_tol is not None:
        flagged = (n_live > k) & (acc < 1.0 - overflow_tol)
        if need_ladder is not None:
            # smallest ladder rung whose K covers the ray's live count,
            # clipped to the top rung
            ladder = torch.as_tensor(need_ladder, dtype=n_live.dtype, device=n_live.device)
            rung = torch.clamp(torch.searchsorted(ladder, n_live), 0, len(need_ladder) - 1)
            need = torch.where(flagged, rung, torch.zeros_like(rung)).to(torch.int8)
            return out, need
        return out, torch.sum(flagged)
    return out


def render_rays_train_compact(
    field, aabb, rays, alpha_mask, *, n_samples: int, compact_k: int = 96,
    app_k: int = 48, white_bg: bool = True, density_group: int = 1,
    feature_dtype: str = "fp32",
    select_impl: Optional[str] = None, depth_gt=None, cap_band_samples: int = 0,
    jitter=None, bg_coin=None, generator: Optional[torch.Generator] = None,
    device=None,
) -> RenderOutput:
    """Train render over alpha-mask compacted samples: features (and, in
    the backward, scatter-adds) only for ``compact_k`` mask-live samples
    per ray, taken in groups of ``density_group`` ray-consecutive samples.

    The march is jittered per ray and padded to a multiple of the group;
    occupancy is tested every ``density_group``-th sample (for group 1,
    every (pool-1)//2-th when the mask's dilation licenses it), which is
    only sound when the mask's pool dilation covers the skipped samples:
    a group the mask does not license raises.  ``depth_gt`` (B,) with
    ``cap_band_samples`` > 0 keeps the LAST live groups at z <= depth_gt +
    band·step (rays with depth_gt <= 0 are uncapped), so the window ends
    at the supervised surface; otherwise the first live groups.  Features
    are gathered per sample (the JAX package's ``density_block`` packing
    has no counterpart).  Runs on ``device`` (cuda unless asked)."""
    dev, aabb, rays = _on_device(field, aabb, rays, alpha_mask, device)
    g = max(1, int(density_group))
    occ_stride = g
    if g == 1:
        occ_stride = _occ_stride(field, aabb, alpha_mask)
    elif not occupancy_stride_safe(field, aabb, alpha_mask, g):
        raise ValueError(
            "density_group=%d needs a mask pool dilation licensing stride-%d "
            "occupancy tests (update_alpha_mask(pool>=%d))" % (g, g, 2 * g + 1)
        )
    if depth_gt is not None:
        depth_gt = as_tensor(depth_gt, dev)
    out, _ = _render_rays_train_compact(
        field, aabb, rays, alpha_mask, n_samples=n_samples, compact_k=compact_k,
        app_k=app_k, white_bg=white_bg, density_group=g, occ_stride=occ_stride,
        feature_dtype=feature_dtype, select_impl=_resolve_select_impl(select_impl),
        depth_gt=depth_gt, cap_band_samples=cap_band_samples, jitter=jitter,
        bg_coin=bg_coin, generator=generator,
    )
    return out


def _render_rays_train_compact(
    field, aabb, rays, alpha_mask, *, n_samples: int, compact_k: int, app_k: int,
    white_bg: bool, density_group: int, occ_stride: int, feature_dtype: str,
    select_impl: str = "sort", depth_gt=None, cap_band_samples: int = 0,
    jitter=None, bg_coin=None, generator=None,
):
    """(RenderOutput, member sample indices (B, Kg·g)) of the compacted
    train render; the selection carries no gradient."""
    cfg = field.cfg
    fdt = _feature_dtype(feature_dtype)
    g = density_group
    b = rays.shape[0]
    jitter, bg_coin = _draws(b, rays.device, jitter, bg_coin, generator, white_bg)
    with torch.no_grad(), record_function("t2n.select"):
        # the jittered march, padded to a multiple of g so groups are
        # ray-consecutive samples; padding samples are never live
        s_pad = n_samples + ((-n_samples) % g)
        rays_o, rays_d, step, t_min, z_vals = _march(cfg, field, aabb, rays, s_pad, jitter)
        steps = torch.arange(s_pad, dtype=rays.dtype, device=rays.device)[None, :] + jitter
        pts = rays_o[:, None] + rays_d[:, None] * z_vals[..., None]
        valid = _in_aabb(pts, aabb) & (steps < n_samples)

        # occupancy every occ_stride-th sample, broadcast to its neighbours
        n_t = (s_pad + occ_stride - 1) // occ_stride
        pts_t = rays_o[:, None] + rays_d[:, None] * z_vals[:, ::occ_stride, None]
        occ_t = _nearest_alpha_lookup(alpha_mask, pts_t.reshape(-1, 3)).reshape(b, n_t)
        occ = torch.repeat_interleave(occ_t, occ_stride, dim=1)[:, :s_pad]
        live = valid & (occ > 0)

        anchored = depth_gt is not None and cap_band_samples > 0
        if anchored:
            # drop live samples behind the supervised surface (+band)
            cap = torch.where(depth_gt > 0, depth_gt + cap_band_samples * step,
                              torch.full_like(depth_gt, float("inf")))
            live = live & (z_vals <= cap[:, None])

        kg = max(1, min(compact_k, n_samples) // g)
        live_g = live.reshape(b, s_pad // g, g).any(dim=-1) if g > 1 else live
        select = last_k_live if anchored else first_k_live
        gidx, g_live = select(live_g, kg, impl=select_impl)

        # the selected groups' member samples; z and points recomputed from
        # the indices through the expression that built z_vals.  A member
        # is rendered when its group is live, whatever its own occupancy.
        midx = (gidx[..., None] * g + torch.arange(g, device=rays.device)).reshape(b, kg * g)
        steps_k = midx.to(rays.dtype) + jitter
        z_k = t_min[:, None] + step * steps_k
        pts_k = rays_o[:, None] + rays_d[:, None] * z_k[..., None]
        valid_k = (
            _in_aabb(pts_k, aabb)
            & (steps_k < n_samples)
            & torch.repeat_interleave(g_live, g, dim=1)
        )
        xn_k = torch.clamp(tf.normalize_coord(aabb, pts_k), -1.0, 1.0)
        # uniform spacing: every dist is `step`, except the dense march's
        # final sample, which carries 0
        dists = torch.where(midx == n_samples - 1, torch.zeros_like(z_k), step)
        dists = dists * cfg.distance_scale

    # app_k covering the compacted set (the trainer's default) shades every
    # sample: one fused pass over the tables serves density and appearance
    shade_all = app_k >= kg * g
    with record_function("t2n.features"):
        if shade_all:
            feat, app_feat = field.fused_features(xn_k.reshape(-1, 3), fdt)
        else:
            feat = field.density_feature(xn_k.reshape(-1, 3), fdt)
    with record_function("t2n.composite"):
        feat = feat.reshape(b, kg * g)
        sigma = torch.where(valid_k, tf.feature2density(cfg, feat), torch.zeros_like(feat))
        _, weights, _ = raw2alpha(sigma, dists)
        acc = torch.sum(weights, dim=-1)

    if shade_all:
        k2 = kg * g
        w_top = weights
    else:
        k2 = min(app_k, kg * g)
        with record_function("t2n.select"):
            w_top, aidx = torch.topk(weights, k2, dim=-1)
            xn_a = torch.gather(xn_k, 1, aidx[..., None].expand(-1, -1, 3))
        with record_function("t2n.features"):
            app_feat = field.app_feature(xn_a.reshape(-1, 3), fdt)
    with record_function("t2n.head"):
        rgb_a = _shade(cfg, field, app_feat, is_train=True).reshape(b, k2, 3)
    with record_function("t2n.composite"):
        rgb, depth = _composite(cfg, weights, acc, w_top, rgb_a, z_k, rays, white_bg, True,
                                bg_coin)
    return RenderOutput(rgb=rgb, depth=depth, z_vals=z_k, weights=weights, acc=acc), midx


#: default K ladder of the adaptive compacted eval
ADAPTIVE_EVAL_LADDER = (32, 64, 128)


def _widen(out: RenderOutput, k_to: int) -> RenderOutput:
    kw = out.weights.shape[1]
    if kw < k_to:
        zpad = torch.zeros(
            (out.weights.shape[0], k_to - kw), dtype=out.weights.dtype,
            device=out.weights.device,
        )
        out = out._replace(
            z_vals=torch.cat([out.z_vals, zpad], 1),
            weights=torch.cat([out.weights, zpad], 1),
        )
    return out


def _map(fn, out: RenderOutput) -> RenderOutput:
    return RenderOutput(*(fn(x) for x in out))


def _concat(outs) -> RenderOutput:
    return RenderOutput(*(torch.cat(xs, 0) for xs in zip(*outs)))


def _on_device(field, aabb, rays, alpha_mask, device):
    dev = resolve_device(device)
    check_on(dev, field)
    if alpha_mask is not None and alpha_mask["volume"].device.type != dev.type:
        raise ValueError(
            f"alpha mask is on {alpha_mask['volume'].device}, the call asked for {dev}"
        )
    return dev, as_tensor(aabb, dev), as_tensor(rays, dev)


@torch.no_grad()
def render_chunked_adaptive(
    field,
    aabb,
    rays,
    alpha_mask,
    *,
    n_samples: int,
    chunk: int = 16384,
    app_k: int = 64,
    white_bg: bool = True,
    eval_z_min: float = 2.0,
    k_ladder=ADAPTIVE_EVAL_LADDER,
    acc_tol: float = 1e-3,
    feature_dtype: str = "bf16",
    probe: bool = True,
    sample_budget: int = 1_048_576,
    device=None,
):
    """Chunked eval renderer with per-ray adaptive compact-K.

    A ray is rendered at a rung whose K covers all its mask-live samples,
    unless it saturated at the base rung (acc >= 1 - acc_tol) or its live
    count exceeds the top rung (top-rung truncation).

    1. every chunk renders once at the base rung, which also yields each
       ray's escalation target (int8);
    2. one host readback per view collects the targets;
    3. the flagged rays, and only those, are gathered by index into fixed
       16384-ray groups, rendered at the largest rung any of them needs,
       and scattered back.

    The base rung is memoized per (field, mask, ladder, ...) identity as
    the median effective rung of the last view (``probe=False`` disables
    the memo).  Returns (RenderOutput, per-chunk list of the largest K
    applied to any ray of that chunk).
    """
    dev, aabb, rays = _on_device(field, aabb, rays, alpha_mask, device)
    n = rays.shape[0]
    ladder = tuple(int(k) for k in k_ladder)
    top = len(ladder) - 1

    cache_key = (
        id(field), id(alpha_mask["volume"]), n_samples, ladder,
        float(acc_tol), int(app_k), float(eval_z_min),
    )
    base = _ADAPTIVE_PROBE_CACHE.get(cache_key, 0) if probe else 0
    k_base = ladder[base]
    # cap the phase-1 chunk by rung width: sample_budget selected samples
    # per pass, floor 16384 rays
    while chunk > 16384 and chunk * k_base > sample_budget:
        chunk //= 2

    # --- phase 1: one base-rung render per chunk, flags ride along ------
    outs, needs, pads = [], [], []
    for s in range(0, n, chunk):
        part = rays[s : s + chunk]
        pad = chunk - part.shape[0]
        if pad:
            # pad by repeating the last ray: its copies flag like it and
            # are trimmed below
            part = torch.cat([part, part[-1:].expand(pad, -1)], 0)
        if base == top:
            out, need = render_rays_compact(
                field, aabb, part, alpha_mask, n_samples=n_samples,
                compact_k=k_base, app_k=min(app_k, k_base),
                white_bg=white_bg, eval_z_min=eval_z_min,
                feature_dtype=feature_dtype,
            ), None
        else:
            out, need = render_rays_compact_need(
                field, aabb, part, alpha_mask, n_samples=n_samples,
                compact_k=k_base, app_k=min(app_k, k_base),
                k_ladder=ladder, white_bg=white_bg, eval_z_min=eval_z_min,
                acc_tol=acc_tol, feature_dtype=feature_dtype,
            )
        outs.append(out)
        needs.append(need)
        pads.append(pad)

    ks = [k_base] * len(outs)
    idx_by_rung: dict = {}
    need_np = None
    if outs and base != top:
        # the view's one host sync: 1 byte/ray of escalation targets
        need_mat = torch.stack(needs).cpu().numpy()
        need_np = np.concatenate(
            [need_mat[i, : chunk - pads[i]] for i in range(len(needs))]
        )
        esc = np.nonzero(need_np)[0]
        for r in np.unique(need_np[esc]):
            idx_by_rung[int(r)] = esc[need_np[esc] == r]
        for i in range(len(outs)):
            lo, hi = i * chunk, min((i + 1) * chunk, n)
            m = int(need_np[lo:hi].max(initial=0))
            if m:
                ks[i] = ladder[m]

    used_rungs = sorted(idx_by_rung)
    k_max = max([k_base] + [ladder[r] for r in used_rungs])

    trimmed = []
    for out, pad in zip(outs, pads):
        out = _widen(out, k_max)
        if pad:
            out = _map(lambda x: x[: chunk - pad], out)
        trimmed.append(out)
    merged = _concat(trimmed)

    # --- phase 2: all flagged rays in one top-needed-rung pass ----------
    if used_rungs:
        # one fixed group shape (16384 rays, padded by repeating the last
        # index): a superset window is exact, since first-K_top live covers
        # any smaller need
        gchunk = min(chunk, 16384)
        k_r = ladder[max(used_rungs)]
        idx_all = np.sort(np.concatenate([idx_by_rung[r] for r in used_rungs]))
        for s0 in range(0, len(idx_all), gchunk):
            sl = idx_all[s0 : s0 + gchunk]
            part_idx = sl
            if gchunk - len(sl):
                part_idx = np.concatenate([sl, np.repeat(sl[-1:], gchunk - len(sl))])
            # gather on the device: only the indices cross the host link
            gidx = torch.as_tensor(part_idx, dtype=torch.int64, device=dev)
            out_r = _widen(
                render_rays_compact(
                    field, aabb, rays.index_select(0, gidx), alpha_mask,
                    n_samples=n_samples, compact_k=k_r,
                    app_k=min(app_k, k_r), white_bg=white_bg,
                    eval_z_min=eval_z_min, feature_dtype=feature_dtype,
                ),
                k_max,
            )
            for dst, src in zip(merged, out_r):
                dst[gidx] = src

    if probe and outs and need_np is not None:
        # memoize the median effective rung as the next base
        med = int(np.median(np.maximum(need_np, base)))
        if len(_ADAPTIVE_PROBE_CACHE) >= 8:
            _ADAPTIVE_PROBE_CACHE.clear()
        _ADAPTIVE_PROBE_CACHE[cache_key] = med

    return merged, ks


@torch.no_grad()
def render_chunked(
    field,
    aabb,
    rays,
    *,
    n_samples: int,
    chunk: int = 16384,
    app_k: int = 64,
    white_bg: bool = True,
    ndc: bool = False,
    alpha_mask=None,
    compact_k: int = 0,
    eval_z_min: float = 2.0,
    feature_dtype: str = "bf16",
    k_ladder=ADAPTIVE_EVAL_LADDER,
    device=None,
) -> RenderOutput:
    """Chunked renderer over any ray count.  ``compact_k > 0`` with a mask
    takes render_rays_compact; ``compact_k = -1`` the adaptive renderer
    (with ``k_ladder``); otherwise the dense render_rays.  The last chunk
    is padded, so every pass has one shape."""
    dev, aabb, rays = _on_device(field, aabb, rays, alpha_mask, device)
    if compact_k == -1 and alpha_mask is not None and not ndc:
        out, _ = render_chunked_adaptive(
            field, aabb, rays, alpha_mask, n_samples=n_samples,
            chunk=chunk, app_k=app_k, white_bg=white_bg,
            eval_z_min=eval_z_min, k_ladder=k_ladder,
            feature_dtype=feature_dtype, device=dev,
        )
        return out
    n = rays.shape[0]
    outs = []
    for s in range(0, n, chunk):
        part = rays[s : s + chunk]
        pad = chunk - part.shape[0]
        if pad:
            part = torch.cat([part, part.new_zeros((pad, 6))], 0)
        if compact_k and alpha_mask is not None and not ndc:
            out = render_rays_compact(
                field, aabb, part, alpha_mask,
                n_samples=n_samples, compact_k=compact_k,
                app_k=min(app_k, compact_k), white_bg=white_bg,
                eval_z_min=eval_z_min, feature_dtype=feature_dtype,
            )
        else:
            # the dense path keeps fp32 features, as the JAX package's does
            out = render_rays(
                field, aabb, part, n_samples=n_samples, app_k=app_k,
                white_bg=white_bg, ndc=ndc, alpha_mask=alpha_mask,
                eval_z_min=eval_z_min,
            )
        if pad:
            out = _map(lambda x: x[: chunk - pad], out)
        outs.append(out)
    return _concat(outs)
