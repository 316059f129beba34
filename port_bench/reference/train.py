"""Plain PyTorch reference of Text2NeRF's train step: the dense train
render (every march step of a ray, appearance on its ``app_k`` heaviest
samples) or the compacted one (the last ``compact_k`` mask-live samples
in groups, behind a band past the supervised depth), the loss (rgb mse,
depth mse, the transmittance loss in front of the supervised depth, TV)
and two-group Adam.  The gradient of a batch is taken in blocks of rays,
each block's share of the batch means added up, so the reference fits
in memory at any batch.
"""

from __future__ import annotations

import numpy as np
import torch

from . import field as F

BETAS, EPS = (0.9, 0.99), 1e-8


def march(cfg, aabb, rays, reso, n, jitter):
    """(z (B, n), step) of the jittered fixed-step march from the box
    entry."""
    step = F.step_size(aabb, reso, cfg["step_ratio"])
    t0 = F.box_entry(rays, aabb, cfg["near"], cfg["far"])
    steps = torch.arange(n, dtype=torch.float32, device=rays.device)[None, :] + jitter
    return t0[:, None] + step * steps, t0, step


def _shade(cfg, p, w_top, xn_a, rays, precision):
    k = xn_a.shape[1]
    dirs = rays[:, None, 3:6].expand(-1, k, 3).reshape(-1, 3)
    app = F.features(cfg, p, xn_a.reshape(-1, 3), sigma=False, precision=precision)[1]
    rgb = F.head(cfg, p, app, dirs, precision).reshape(-1, k, 3)
    return torch.where((w_top > cfg["raymarch_weight_thres"])[..., None], rgb,
                       torch.zeros_like(rgb))


def dense_render(cfg, p, aabb, rays, jitter, reso, n, app_k, precision, probe=None):
    """The dense train render: (rgb, depth, z, weights).  ``probe`` gets the
    normalised coordinates of the density samples (B, n, 3) and of the
    shaded ones (B, app_k, 3)."""
    with torch.no_grad():
        z, _, _ = march(cfg, aabb, rays, reso, n, jitter)
        pts = rays[:, None, :3] + rays[:, None, 3:6] * z[..., None]
        dists = torch.cat([z[:, 1:] - z[:, :-1], torch.zeros_like(z[:, :1])], -1)
        valid = F.inside(pts, aabb)
        xn = torch.clamp(F.normalize(aabb, pts), -1.0, 1.0)
    b = rays.shape[0]
    feat = F.features(cfg, p, xn.reshape(-1, 3), app=False, precision=precision)[0].reshape(b, n)
    sigma = torch.where(valid, F.density(cfg, feat), torch.zeros_like(feat))
    weights, acc = F.alpha_weights(sigma, dists * cfg["distance_scale"])
    w_top, idx = torch.topk(weights, min(app_k, n), dim=-1)
    xn_a = torch.gather(xn, 1, idx[..., None].expand(-1, -1, 3))
    if probe is not None:
        probe(xn, xn_a)
    rgb_k = _shade(cfg, p, w_top, xn_a, rays, precision)
    rgb = F.clip01(torch.sum(w_top[..., None] * rgb_k, 1) + (1.0 - acc[:, None]))
    depth = torch.sum(weights * z, -1) + (1.0 - acc) * rays[:, 5]
    return rgb, depth, z, weights


def _first_k(live, k):
    n = live.shape[1]
    order = torch.arange(n, device=live.device)[None, :].expand_as(live)
    key = torch.where(live, order, torch.full_like(order, n))
    idx = torch.sort(key, -1).values[:, :k]
    return torch.clamp(idx, max=n - 1), idx < n


def _last_k(live, k):
    n = live.shape[1]
    idx_r, sel_r = _first_k(torch.flip(live, (1,)), k)
    idx = torch.where(sel_r, (n - 1) - idx_r, torch.zeros_like(idx_r))
    return torch.flip(idx, (1,)), torch.flip(sel_r, (1,))


def compact_render(cfg, p, aabb, rays, jitter, reso, n, mask, depth_gt, k, group, band,
                   precision, probe=None):
    """The compacted train render: the last ``k`` // ``group`` mask-live
    groups of ``group`` consecutive samples at or before depth_gt + band
    steps, occupancy tested at each group's first sample; every sample
    shaded (``app_k`` covering them).  (rgb, depth, z, weights)."""
    b, g = rays.shape[0], group
    with torch.no_grad():
        s_pad = n + (-n) % g
        z, t0, step = march(cfg, aabb, rays, reso, s_pad, jitter)
        steps = torch.arange(s_pad, dtype=torch.float32, device=rays.device)[None, :] + jitter
        pts = rays[:, None, :3] + rays[:, None, 3:6] * z[..., None]
        valid = F.inside(pts, aabb) & (steps < n)
        occ = F.mask_lookup(mask, pts[:, ::g])
        live = valid & torch.repeat_interleave(occ, g, 1)[:, :s_pad]
        if band > 0:
            cap = torch.where(depth_gt > 0, depth_gt + band * step,
                              torch.full_like(depth_gt, float("inf")))
            live = live & (z <= cap[:, None])
            pick = _last_k
        else:
            pick = _first_k
        kg = max(1, min(k, n) // g)
        gidx, g_live = pick(live.reshape(b, s_pad // g, g).any(-1), kg)
        midx = (gidx[..., None] * g + torch.arange(g, device=rays.device)).reshape(b, kg * g)
        steps_k = midx.float() + jitter
        z_k = t0[:, None] + step * steps_k
        pts_k = rays[:, None, :3] + rays[:, None, 3:6] * z_k[..., None]
        valid_k = F.inside(pts_k, aabb) & (steps_k < n) & torch.repeat_interleave(g_live, g, 1)
        xn = torch.clamp(F.normalize(aabb, pts_k), -1.0, 1.0)
        dists = torch.where(midx == n - 1, torch.zeros_like(z_k), step) * cfg["distance_scale"]
    if probe is not None:
        probe(xn, xn)
    feat = F.features(cfg, p, xn.reshape(-1, 3), app=False, precision=precision)[0]
    feat = feat.reshape(b, kg * g)
    sigma = torch.where(valid_k, F.density(cfg, feat), torch.zeros_like(feat))
    weights, acc = F.alpha_weights(sigma, dists)
    rgb_k = _shade(cfg, p, weights, xn, rays, precision)
    rgb = F.clip01(torch.sum(weights[..., None] * rgb_k, 1) + (1.0 - acc[:, None]))
    depth = torch.sum(weights * z_k, -1) + (1.0 - acc) * rays[:, 5]
    return rgb, depth, z_k, weights


def _tv_plane(t):
    h, w, c = t.shape
    return 2.0 * (torch.sum((t[1:] - t[:-1]) ** 2) / ((h - 1) * w * c)
                  + torch.sum((t[:, 1:] - t[:, :-1]) ** 2) / (h * (w - 1) * c))


def _tv_line(t):
    l, c = t.shape
    return 2.0 * torch.sum((t[1:] - t[:-1]) ** 2) / ((l - 1) * c)


def tv_terms(cfg, p, recipe, decay):
    """(density TV, app TV), weighted and decayed."""
    nd, _ = F.components(cfg)
    if cfg["model_name"] == "cp":
        tv, scale, keys = _tv_line, 1e-3, [f"lines.{i}" for i in range(3)]
        split = [(p[k][:, :nd[i]], p[k][:, nd[i]:]) for i, k in enumerate(keys)]
    else:
        tv, scale = _tv_plane, 1e-2
        split = [(p[f"planes.{i}"][..., :nd[i]], p[f"planes.{i}"][..., nd[i]:]) for i in range(3)]
    dens = sum(tv(a) for a, _ in split) * scale * recipe["tv_weight_density"] * decay
    app = sum(tv(b) for _, b in split) * scale * recipe["tv_weight_app"] * decay
    return dens, app


def batch_loss(cfg, p, aabb, reso, batch, jitter, n, recipe, precision, block, mask=None,
               probe=None):
    """Backpropagates the batch's ray terms block by block; returns their
    total (a float)."""
    rays, rgb_gt, depth_gt = batch
    total_rays = rays.shape[0]
    total = 0.0
    for s in range(0, total_rays, block):
        r, g, d, j = rays[s:s + block], rgb_gt[s:s + block], depth_gt[s:s + block], jitter[s:s + block]
        if recipe["train_compact_k"] > 0 and mask is not None:
            rgb, depth, z, w = compact_render(
                cfg, p, aabb, r, j, reso, n, mask, d, recipe["train_compact_k"],
                recipe["density_group"], recipe["train_depth_cap_band"], precision, probe)
        else:
            rgb, depth, z, w = dense_render(cfg, p, aabb, r, j, reso, n, recipe["app_k"],
                                            precision, probe)
        depth = torch.nan_to_num(depth)
        front = (z - d[:, None] + recipe["trans_margin"]) < 0
        trans = torch.sum(w * front, 1) / n
        loss = (torch.sum((rgb - g) ** 2) / (3 * total_rays)
                + recipe["depth_weight"] * torch.sum((depth - d) ** 2) / total_rays
                + recipe["trans_weight"] * torch.sum(trans ** 2) / total_rays)
        loss.backward()
        total += float(loss.detach())
    return total


def adam_step(params, grads, state, t, lr_of):
    b1, b2 = BETAS
    with torch.no_grad():
        for name, prm in params.items():
            g = grads[name]
            m, v = state.setdefault(name, (torch.zeros_like(prm), torch.zeros_like(prm)))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / np.sqrt(1 - b2 ** t)) + EPS
            prm.addcdiv_(m, denom, value=-lr_of(name) / (1 - b1 ** t))


def run(cfg, weights, aabb, reso, pools, steps, n, recipe, *, precision="fp32", block=2048,
        mask=None, keep=1.0, probe=None):
    """Follows the program's first ``len(steps)`` train steps from
    ``weights`` (not changed).  ``steps``: dicts with the batch's pool
    rows ``ids``, ``jitter`` (B, 1), ``tv_decay`` and ``lr_decay``.
    ``keep`` < 1 trains on that leading share of each batch (a fault);
    ``probe`` sees the first step's sample coordinates block by block.

    Returns {'loss': [per step], 'grad': {leaf: first gradient's norm},
    'change': {leaf: norm of the change over the steps}}."""
    dev = aabb.device
    p = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    state, out = {}, {"loss": [], "grad": {}, "change": {}}
    spatial = {k for k in p if k.startswith(("planes.", "lines."))}
    for t, st in enumerate(steps, start=1):
        ids = st["ids"][: int(len(st["ids"]) * keep)]
        batch = tuple(torch.as_tensor(a[ids], device=dev) for a in pools)
        jitter = st["jitter"].to(dev)[: len(ids)]
        for v in p.values():
            v.grad = None
        total = batch_loss(cfg, p, aabb, reso, batch, jitter, n, recipe, precision, block, mask,
                           probe if t == 1 else None)
        tv_d, tv_a = tv_terms(cfg, p, recipe, float(np.float32(st["tv_decay"])))
        (tv_d + tv_a).backward()
        out["loss"].append(total + float(tv_d.detach()) + float(tv_a.detach()))
        grads = {k: v.grad for k, v in p.items()}
        if t == 1:
            out["grad"] = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
        lr = float(np.float32(st["lr_decay"]))
        adam_step(p, grads, state, t,
                  lambda k: (recipe["lr_init"] if k in spatial else recipe["lr_basis"]) * lr)
    with torch.no_grad():
        out["change"] = {k: float(torch.linalg.vector_norm(p[k] - weights[k])) for k in p}
    return out
