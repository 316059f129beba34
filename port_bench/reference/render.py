"""Plain PyTorch reference of a rendered view: the adaptive compacted eval
of Text2NeRF's evaluations and videos.

A ray marches fixed steps from its box entry; a sample is live when it
lies in the box, beyond ``z_min`` in world z, and in an occupied voxel of
the alpha mask.  The ray is composited over its first K live samples (the
rest of the march is left out), appearance on all of them when ``app_k``
>= K, else on its ``app_k`` heaviest; the white background fills what the
samples leave.  K comes from a ladder: every ray starts at the base rung,
and a ray whose live samples overflow it while its opacity is still below
1 - ``acc_tol`` is rendered again at the ladder's rung that covers the
largest need among such rays of the view (its own need covered).

The base rung is the renderer's own choice, made from the views before
(any rung gives a correct frame), so :func:`frame` returns the frame for
every possible base rung.
"""

from __future__ import annotations

import torch

from . import field as F


@torch.no_grad()
def live_samples(cfg, aabb, rays, reso, n, mask, z_min, stride):
    """(t0, step, live (B, n)): the eval march and its live rule, occupancy
    tested every ``stride``-th sample and held for the samples after it."""
    step = F.step_size(aabb, reso, cfg["step_ratio"])
    t0 = F.box_entry(rays, aabb, cfg["near"], cfg["far"])
    z = t0[:, None] + step * torch.arange(n, dtype=torch.float32, device=rays.device)[None, :]
    pts = rays[:, None, :3] + rays[:, None, 3:6] * z[..., None]
    valid = F.inside(pts, aabb) & (pts[..., 2] > z_min)
    occ = F.mask_lookup(mask, pts[:, ::stride])
    occ = torch.repeat_interleave(occ, stride, 1)[:, :n]
    return t0, step, valid & occ


def occupancy_stride(cfg, aabb, reso, mask) -> int:
    """The stride of the occupancy test that the mask's dilation licenses:
    (pool - 1) // 2 when an untested sample stays inside the dilation."""
    pool = mask["pool"]
    stride = max(1, (pool - 1) // 2)
    if stride == 1:
        return 1
    d, h, w = mask["volume"].shape
    m = mask["aabb"].double().cpu()
    unit = float(((m[1] - m[0]) / torch.tensor([w - 1, h - 1, d - 1], dtype=torch.float64)).min())
    a = aabb.double().cpu()
    step = float(((a[1] - a[0]) / (torch.tensor(reso, dtype=torch.float64) - 1)).mean()) \
        * cfg["step_ratio"]
    return stride if (stride - 1) * step <= (pool - 3) // 2 * unit + 1e-9 else 1


@torch.no_grad()
def frame(cfg, p, aabb, rays, reso, n, mask, *, ladder, app_k, acc_tol, z_min, block=16384,
          precision="fp32"):
    """{base rung index: (rgb (N, 3), depth (N,))} of one view's rays."""
    stride = occupancy_stride(cfg, aabb, reso, mask)
    top = min(ladder[-1], n)
    parts = []
    for s in range(0, rays.shape[0], block):
        r = rays[s:s + block]
        b = r.shape[0]
        t0, step, live = live_samples(cfg, aabb, r, reso, n, mask, z_min, stride)
        n_live = live.sum(-1)
        order = torch.arange(n, device=r.device)[None, :].expand_as(live)
        idx = torch.sort(torch.where(live, order, torch.full_like(order, n)), -1).values[:, :top]
        sel = idx < n
        idx = torch.clamp(idx, max=n - 1)
        z = t0[:, None] + step * idx.float()
        pts = r[:, None, :3] + r[:, None, 3:6] * z[..., None]
        xn = torch.clamp(F.normalize(aabb, pts), -1.0, 1.0).reshape(-1, 3)
        sig_feat, app = F.features(cfg, p, xn, precision=precision)
        sigma = torch.where(sel, F.density(cfg, sig_feat.reshape(b, top)), torch.zeros_like(z))
        dists = torch.where(idx == n - 1, torch.zeros_like(z), step) * cfg["distance_scale"]
        weights, _ = F.alpha_weights(sigma, dists)
        dirs = r[:, None, 3:6].expand(-1, top, 3).reshape(-1, 3)
        rgb_s = F.head(cfg, p, app, dirs, precision).reshape(b, top, 3)
        at = {}
        for k in ladder:
            kk = min(k, n)
            w = weights[:, :kk]
            acc = w.sum(-1)
            shaded = w > cfg["raymarch_weight_thres"]
            if app_k < kk:
                heavy = torch.zeros_like(shaded)
                heavy.scatter_(1, torch.topk(w, app_k, -1).indices, True)
                shaded = shaded & heavy
            rgb = torch.sum(torch.where(shaded[..., None], w[..., None] * rgb_s[:, :kk],
                                        torch.zeros_like(rgb_s[:, :kk])), 1)
            rgb = torch.clamp(rgb + (1.0 - acc[:, None]), 0.0, 1.0)
            depth = torch.sum(w * z[:, :kk], -1) + (1.0 - acc) * r[:, 5]
            at[k] = (rgb, depth, acc)
        parts.append((n_live, at))
    n_live = torch.cat([pt[0] for pt in parts])
    at = {k: tuple(torch.cat([pt[1][k][i] for pt in parts]) for i in range(3)) for k in ladder}
    ladder_t = torch.tensor(ladder, dtype=n_live.dtype, device=n_live.device)
    need = torch.clamp(torch.searchsorted(ladder_t, n_live), 0, len(ladder) - 1)
    out = {}
    for base, k_base in enumerate(ladder):
        rgb, depth, acc = at[k_base]
        if base == len(ladder) - 1:
            out[base] = (rgb, depth)
            continue
        flagged = (n_live > k_base) & (acc < 1.0 - acc_tol)
        if not bool(flagged.any()):
            out[base] = (rgb, depth)
            continue
        k_r = ladder[int(need[flagged].max())]
        rgb_r, depth_r, _ = at[k_r]
        out[base] = (torch.where(flagged[:, None], rgb_r, rgb), torch.where(flagged, depth_r, depth))
    return out
