"""Camera rays (port of ``text2nerf_tpu/ops/rays.py``), the AABB slab
test, the NDC helpers, the near/far ray marcher and hierarchical
inverse-CDF sampling.

Pinhole camera looking along +z with image y down: the direction of pixel
(i, j) is ``[(i + .5 - cx)/fx, (j + .5 - cy)/fy, 1]``, L2-normalized.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def pixel_centers(h: int, w: int, *, device=None, dtype=torch.float32):
    """Pixel-center grids ``(i, j)`` of shape (h, w): ``i`` the column
    (x) coordinate, ``j`` the row (y) coordinate, both offset by +0.5."""
    dev = resolve_device(device)
    j, i = torch.meshgrid(
        torch.arange(h, dtype=dtype, device=dev) + 0.5,
        torch.arange(w, dtype=dtype, device=dev) + 0.5,
        indexing="ij",
    )
    return i, j


def ray_directions(h: int, w: int, focal, center=None, normalize: bool = True,
                   *, device=None):
    """Per-pixel camera-space directions, shape (h, w, 3)."""
    fx, fy = float(focal[0]), float(focal[1])
    if center is None:
        cx, cy = w / 2.0, h / 2.0
    else:
        cx, cy = float(center[0]), float(center[1])
    i, j = pixel_centers(h, w, device=device)
    dirs = torch.stack([(i - cx) / fx, (j - cy) / fy, torch.ones_like(i)], dim=-1)
    if normalize:
        dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True))
    return dirs


def ray_directions_blender(h: int, w: int, focal, center=None, *, device=None):
    """Blender-convention directions (y up, looking down -z), (h, w, 3),
    not normalized."""
    fx, fy = float(focal[0]), float(focal[1])
    if center is None:
        cx, cy = w / 2.0, h / 2.0
    else:
        cx, cy = float(center[0]), float(center[1])
    i, j = pixel_centers(h, w, device=device)
    return torch.stack([(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)], dim=-1)


def rays_from_pose(directions, c2w):
    """World-space ray origins and directions for one camera: camera-space
    directions rotated by c2w[:3, :3] (not re-normalized), origins the
    camera center.  The rotation runs in float64 and rounds to float32, as
    close as fp32 gets to the JAX package's Precision.HIGHEST product.

    Returns rays_o, rays_d, each (N, 3) float32.
    """
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=directions.device)
    rot = c2w[:3, :3].to(torch.float64)
    rays_d = (directions.to(torch.float64) @ rot.T).to(torch.float32)
    rays_o = c2w[:3, 3].to(torch.float32).expand(rays_d.shape)
    return rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)


def rays_from_poses(directions, c2ws):
    """Rays for many cameras: (V, H*W, 6) [o | d]."""
    return torch.stack(
        [torch.cat(rays_from_pose(directions, c2w), dim=-1) for c2w in c2ws]
    )


def rays_split_np(poses, intrinsic, h: int, w: int) -> np.ndarray:
    """Host-numpy rays of many cameras, (V, H*W, 6) [o | d] float32, the
    training pools' layout: the math of :func:`ray_directions` and
    :func:`rays_from_pose` (fp32 normalized directions, rotation in
    float64)."""
    fx, fy, cx, cy = (float(x) for x in intrinsic)
    jj, ii = np.meshgrid(
        np.arange(h, dtype=np.float32) + 0.5,
        np.arange(w, dtype=np.float32) + 0.5,
        indexing="ij",
    )
    dirs = np.stack(
        [(ii - cx) / fx, (jj - cy) / fy, np.ones_like(ii)], axis=-1
    ).reshape(-1, 3)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs64 = dirs.astype(np.float64)
    poses = np.asarray(poses, np.float64).reshape(-1, *np.asarray(poses).shape[-2:])
    out = np.empty((poses.shape[0], h * w, 6), np.float32)
    for v in range(poses.shape[0]):
        out[v, :, 0:3] = poses[v, :3, 3].astype(np.float32)
        out[v, :, 3:6] = (dirs64 @ poses[v, :3, :3].T).astype(np.float32)
    return out


def default_intrinsics(h: int, w: int):
    """The scene-gen intrinsics rule: f = max(H, W), c = (W//2, H//2)."""
    f = float(max(h, w))
    return f, f, float(w // 2), float(h // 2)


def aabb_slab_entry(rays_o, rays_d, aabb, near, far):
    """Per-ray AABB entry parameter t_min, clamped to [near, far]; zero
    direction components are replaced with 1e-6 before division."""
    vec = torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)
    rate_a = (aabb[1] - rays_o) / vec
    rate_b = (aabb[0] - rays_o) / vec
    t_min = torch.amax(torch.minimum(rate_a, rate_b), dim=-1)
    return torch.clamp(t_min, near, far)


def aabb_slab_interval(rays_o, rays_d, aabb):
    """(t_min, t_max) of the ray/AABB intersection."""
    vec = torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)
    rate_a = (aabb[1] - rays_o) / vec
    rate_b = (aabb[0] - rays_o) / vec
    t_min = torch.amax(torch.minimum(rate_a, rate_b), dim=-1)
    t_max = torch.amin(torch.maximum(rate_a, rate_b), dim=-1)
    return t_min, t_max


def ndc_rays(h: int, w: int, focal, near, rays_o, rays_d, blender: bool = False):
    """Rays projected to NDC space.  ``blender=True`` takes the sign
    convention of ``ndc_rays_blender`` (origins moved to z = -near), else
    ``ndc_rays`` (z = near).  Returns (rays_o, rays_d), each (..., 3)."""
    sgn = -1.0 if blender else 1.0
    if blender:
        t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    else:
        t = (near - rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = sgn / (w / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = sgn / (h / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 - sgn * 2.0 * near / rays_o[..., 2]
    d0 = sgn / (w / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2]
    )
    d1 = sgn / (h / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2]
    )
    d2 = sgn * 2.0 * near / rays_o[..., 2]
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def ndc_bbox(all_rays):
    """AABB (2, 3) of the rays' near points (origins) and far points
    (origin + direction) in NDC space."""
    o = all_rays[..., :3].reshape(-1, 3)
    far = (all_rays[..., :3] + all_rays[..., 3:6]).reshape(-1, 3)
    lo = torch.minimum(o.amin(dim=0), far.amin(dim=0))
    hi = torch.maximum(o.amax(dim=0), far.amax(dim=0))
    return torch.stack([lo, hi])


def depth2dist(z_vals, cos_angle):
    """Sample depths → inter-sample distances (the last 1e10) scaled by the
    ray's angle."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    return dists * cos_angle[..., None]


def ndc2dist(ndc_pts, cos_angle):
    """An NDC point chain (B, S, 3) → distances (B, S), the last one
    1e10·cos_angle."""
    dists = torch.linalg.norm(ndc_pts[:, 1:] - ndc_pts[:, :-1], dim=-1)
    return torch.cat([dists, 1e10 * cos_angle[..., None]], -1)


def ray_marcher(rays, n_samples: int = 64, lindisp: bool = False, perturb: float = 0.0,
                bbox=None, generator=None, u=None):
    """Near/far stratified point sampling.  ``rays`` (N, 8) [o | d | near
    | far]; with ``bbox`` the near and far come from the AABB
    intersection.  With ``perturb`` > 0 each sample moves within its
    stratum by ``u`` (N, n_samples) uniforms, drawn from ``generator``
    when not given (neither: no perturbation, as the JAX function without
    an rng).  Returns (xyz, rays_o, rays_d, z_vals)."""
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    if bbox is not None:
        t_min, t_max = aabb_slab_interval(rays_o, rays_d, torch.as_tensor(
            bbox, dtype=rays.dtype, device=rays.device))
        near, far = t_min[:, None], t_max[:, None]
    else:
        near, far = rays[:, 6:7], rays[:, 7:8]
    z_steps = torch.linspace(0.0, 1.0, n_samples, dtype=rays.dtype, device=rays.device)
    if not lindisp:
        z_vals = near * (1 - z_steps) + far * z_steps
    else:
        z_vals = 1.0 / (1.0 / near * (1 - z_steps) + 1.0 / far * z_steps)
    z_vals = z_vals.expand(rays.shape[0], n_samples)
    if perturb > 0 and (u is not None or generator is not None):
        if u is None:
            u = torch.rand(z_vals.shape, generator=generator, device=rays.device)
        mids = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        upper = torch.cat([mids, z_vals[:, -1:]], -1)
        lower = torch.cat([z_vals[:, :1], mids], -1)
        z_vals = lower + (upper - lower) * perturb * torch.as_tensor(u, device=rays.device)
    xyz = rays_o[:, None] + rays_d[:, None] * z_vals[..., None]
    return xyz, rays_o, rays_d, z_vals


def sample_pdf(bins, weights, n_samples: int, generator=None, u=None):
    """Hierarchical inverse-CDF sampling of ``n_samples`` points per row
    from the bins' ``weights``: at the uniforms ``u`` (..., n_samples)
    when given, else drawn from ``generator``, else deterministic (a
    linspace over [0, 1], as the JAX function without an rng)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    # the cdf summed bin by bin in the weights' dtype, as the JAX function's
    # cumsum rounds (torch's CPU cumsum accumulates wider): a uniform on a
    # boundary ulp, such as the last u = 1, picks the same bin
    parts = [torch.zeros_like(pdf[..., 0])]
    for i in range(pdf.shape[-1]):
        parts.append(parts[-1] + pdf[..., i])
    cdf = torch.stack(parts, -1)
    shape = cdf.shape[:-1] + (n_samples,)
    if u is not None:
        u = torch.as_tensor(u, dtype=cdf.dtype, device=cdf.device).expand(shape)
    elif generator is not None:
        u = torch.rand(shape, generator=generator, device=cdf.device, dtype=cdf.dtype)
    else:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=cdf.dtype, device=cdf.device).expand(shape)
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_g0 = torch.gather(cdf, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    last = bins.shape[-1] - 1
    bins_g0 = torch.gather(bins, -1, torch.clamp(below, max=last))
    bins_g1 = torch.gather(bins, -1, torch.clamp(above, max=last))
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_g0) / denom
    return bins_g0 + t * (bins_g1 - bins_g0)
