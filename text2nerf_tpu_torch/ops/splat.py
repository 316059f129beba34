"""Forward warping of RGBD views by bilinear splatting (port of
``text2nerf_tpu/ops/splat.py``: the one-to-many warps of the support
sets, with and without the coverage of a masked region, and the
many-to-one merge of the known views into a new one).

Unproject each pixel with its depth, move it into the target camera,
reproject, and scatter-add it into the 4 bilinear neighbours of its
target position with a soft exponential z-buffer weight.  The scatter is
``index_put_(accumulate=True)`` per corner, a loop over target poses; on
CUDA its additions land in a run-to-run order, so values may move by
rounding while the coverage masks stay exact.

The reference quantizes the source image to uint8 levels before warping
and rounds the warped image to uint8 levels (:func:`quantize_u8`,
``is_image``).  The small 3x3/4x4 matrix products are fused
multiply-add chains in fp32 (:func:`_matvec`), so no TF32 path can reach
them and the target positions match the JAX package's on the CPU.
"""

from __future__ import annotations

import torch


def intrinsic_from_tuple(intrinsic, device=None):
    """(fx, fy, cx, cy) → 3x3 K (fp32)."""
    fx, fy, cx, cy = (float(v) for v in intrinsic)
    return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                        dtype=torch.float32, device=device)


def _matvec(m, v):
    """m (R, K) applied to the last axis of v (..., K) in fp32 as a chain
    of fused multiply-adds, the order XLA's CPU dot uses: each product and
    sum taken exactly in float64 and rounded once to fp32."""
    m64, v64 = m.to(torch.float64), v.to(torch.float64)
    rows = []
    for i in range(m.shape[0]):
        acc = (m64[i, 0] * v64[..., 0]).to(torch.float32)
        for j in range(1, m.shape[1]):
            acc = (m64[i, j] * v64[..., j] + acc.to(torch.float64)).to(torch.float32)
        rows.append(acc)
    return torch.stack(rows, -1)


def _matmul(a, b):
    return _matvec(a, b.T).T


def transform_points(depth, w2c_src, w2c_tar, k_src, k_tar):
    """Per-pixel target-camera homogeneous positions (H, W, 3): [x*z, y*z,
    z] after unprojecting pixel (x, y) at ``depth`` through K_src^-1,
    applying T = w2c_tar @ c2w_src and reprojecting through K_tar."""
    h, w = depth.shape
    y2d, x2d = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=depth.device),
        torch.arange(w, dtype=torch.float32, device=depth.device),
        indexing="ij",
    )
    pos = torch.stack([x2d, y2d, torch.ones_like(x2d)], -1)
    t = _matmul(w2c_tar, torch.linalg.inv(w2c_src))
    world = depth[..., None] * _matvec(torch.linalg.inv(k_src), pos)
    trans = _matvec(t[:3, :3], world) + t[:3, 3]
    return _matvec(k_tar, trans)


def bilinear_splat(frame, mask, depth, trans_pos, is_image: bool = False):
    """Scatter ``frame`` (H, W, C) to ``trans_pos`` (H, W, 2) target pixel
    positions (x, y) with bilinear weights and a soft z-buffer on
    ``depth`` (H, W); ``mask`` (H, W) gates the sources.  ``is_image``
    rounds the normalized output to uint8 levels.  Returns (warped (H, W,
    C), mask2 (H, W) bool)."""
    h, w, c = frame.shape
    dev = frame.device
    mask = mask.to(torch.float32)
    pos_off = trans_pos + 1.0
    pos_floor = torch.floor(pos_off).to(torch.int32)
    pos_ceil = torch.ceil(pos_off).to(torch.int32)
    lim = torch.tensor([w + 1, h + 1], dtype=torch.int32, device=dev)
    pos_off = torch.minimum(torch.clamp(pos_off, min=0.0), lim.to(torch.float32))
    pos_floor = torch.minimum(torch.clamp(pos_floor, min=0), lim)
    pos_ceil = torch.minimum(torch.clamp(pos_ceil, min=0), lim)

    fx = pos_off[..., 0] - pos_floor[..., 0]
    fy = pos_off[..., 1] - pos_floor[..., 1]
    cx = pos_ceil[..., 0] - pos_off[..., 0]
    cy = pos_ceil[..., 1] - pos_off[..., 1]
    prox_nw = (1 - fy) * (1 - fx)
    prox_sw = (1 - cy) * (1 - fx)
    prox_ne = (1 - fy) * (1 - cx)
    prox_se = (1 - cy) * (1 - cx)

    log_depth = torch.log1p(torch.clamp(depth, 0.0, 1000.0))
    depth_w = torch.exp(log_depth / torch.clamp(log_depth.max(), min=1e-12) * 50.0)
    base = mask / depth_w

    acc = torch.zeros((h + 2, w + 2, c), dtype=torch.float32, device=dev)
    acc_w = torch.zeros((h + 2, w + 2), dtype=torch.float32, device=dev)
    xf, yf = pos_floor[..., 0].long(), pos_floor[..., 1].long()
    xc, yc = pos_ceil[..., 0].long(), pos_ceil[..., 1].long()
    for yy, xx, prox in ((yf, xf, prox_nw), (yc, xf, prox_sw), (yf, xc, prox_ne),
                         (yc, xc, prox_se)):
        ww = prox * base
        acc.index_put_((yy, xx), frame * ww[..., None], accumulate=True)
        acc_w.index_put_((yy, xx), ww, accumulate=True)

    cropped = acc[1:-1, 1:-1]
    cropped_w = acc_w[1:-1, 1:-1]
    mask2 = cropped_w > 0
    out = torch.where(
        mask2[..., None], cropped / torch.clamp(cropped_w, min=1e-30)[..., None],
        torch.zeros_like(cropped),
    )
    if is_image:
        out = torch.round(torch.clamp(out, 0.0, 255.0))
    return out, mask2


def forward_warp(frame_u8, mask, depth, w2c_src, w2c_tar, k_src, k_tar):
    """Forward warp of one view: (warped_u8, mask2 bool, warped_depth,
    flow (H, W, 2)).  ``frame_u8`` holds 0..255 levels in float storage."""
    trans = transform_points(depth, w2c_src, w2c_tar, k_src, k_tar)
    z = trans[..., 2]
    coords = trans[..., :2] / z[..., None]
    warped, mask2 = bilinear_splat(frame_u8, mask, z, coords, is_image=True)
    warped_depth, _ = bilinear_splat(z[..., None], mask, z, coords, is_image=False)
    h, w = depth.shape
    y2d, x2d = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=depth.device),
        torch.arange(w, dtype=torch.float32, device=depth.device),
        indexing="ij",
    )
    flow = coords - torch.stack([x2d, y2d], -1)
    return warped, mask2, warped_depth[..., 0], flow


def quantize_u8(rgb01):
    """(rgb * 255).astype(uint8) truncation, kept in float storage."""
    return torch.floor(torch.clamp(rgb01, 0.0, 1.0) * 255.0)


@torch.no_grad()
def warp_one_to_many(rgb01, depth, pose_src, poses_tar, intrinsic, mask=None):
    """Warp one RGBD view (tensors on one device) to many target poses,
    with a white background where nothing lands.  Returns (rgbs01 (V, H,
    W, 3), masks (V, H, W) int32, depths (V, H, W))."""
    dev = depth.device
    k = intrinsic_from_tuple(intrinsic, dev)
    frame = quantize_u8(rgb01)
    h, w = depth.shape
    if mask is None:
        mask = torch.ones((h, w), dtype=torch.float32, device=dev)
    w2c_src = torch.linalg.inv(pose_src)
    rgbs, masks, depths = [], [], []
    for pose_tar in poses_tar:
        warped, m2, wdepth, _ = forward_warp(
            frame, mask, depth, w2c_src, torch.linalg.inv(pose_tar), k, k
        )
        mf = m2.to(torch.float32)[..., None]
        rgbs.append((warped * mf + 255.0 * (1.0 - mf)) / 255.0)
        masks.append(m2.to(torch.int32))
        depths.append(wdepth)
    return torch.stack(rgbs), torch.stack(masks), torch.stack(depths)


@torch.no_grad()
def warp_one_to_many_with_mask(rgb01, depth, pose_src, poses_tar, intrinsic, extra_mask):
    """One RGBD view (tensors on one device) warped to many target poses,
    plus, per target, the coverage of the content under ``extra_mask``
    (H, W), sharing the reprojection: the support-pool warp of a generated
    view, whose pool keeps only what its inpainted region covers.  The
    coverage depends only on the gated splat weights, so it equals
    ``warp_one_to_many(..., mask=extra_mask)``'s mask.  Returns (rgbs01
    (V, H, W, 3), masks (V, H, W) int32, depths (V, H, W), masks_extra
    (V, H, W) int32)."""
    dev = depth.device
    k = intrinsic_from_tuple(intrinsic, dev)
    frame = quantize_u8(rgb01)
    h, w = depth.shape
    ones = torch.ones((h, w), dtype=torch.float32, device=dev)
    extra = extra_mask.to(torch.float32)
    w2c_src = torch.linalg.inv(pose_src)
    rgbs, masks, depths, extras = [], [], [], []
    for pose_tar in poses_tar:
        trans = transform_points(depth, w2c_src, torch.linalg.inv(pose_tar), k, k)
        z = trans[..., 2]
        pos = trans[..., :2] / z[..., None]
        warped, m2 = bilinear_splat(frame, ones, z, pos, is_image=True)
        wdepth, _ = bilinear_splat(z[..., None], ones, z, pos)
        _, m_extra = bilinear_splat(extra[..., None], extra, z, pos)
        mf = m2.to(torch.float32)[..., None]
        rgbs.append((warped * mf + 255.0 * (1.0 - mf)) / 255.0)
        masks.append(m2.to(torch.int32))
        depths.append(wdepth[..., 0])
        extras.append(m_extra.to(torch.int32))
    return torch.stack(rgbs), torch.stack(masks), torch.stack(depths), torch.stack(extras)


@torch.no_grad()
def warp_many_to_one(rgbs01, depths, poses, pose_tar, intrinsic):
    """Several RGBD views (V, H, W, 3) / (V, H, W) at ``poses`` (V, 4, 4)
    merged into the view at ``pose_tar``, first view first: a pixel an
    earlier view covers is its own, later views fill only what is still
    empty.  Each contribution is truncated to uint8 levels, as the
    reference accumulates in uint8.  Returns (mask (H, W) int32, rgb01
    (H, W, 3) with a white background, depth (H, W))."""
    dev = depths.device
    k = intrinsic_from_tuple(intrinsic, dev)
    w2c_tar = torch.linalg.inv(pose_tar)
    _, h, w = depths.shape
    ones = torch.ones((h, w), dtype=torch.float32, device=dev)
    out_img = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    out_depth = torch.zeros((h, w), dtype=torch.float32, device=dev)
    mask_final = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for v in range(depths.shape[0]):
        warped, m2, wdepth, _ = forward_warp(
            quantize_u8(rgbs01[v]), ones, depths[v], torch.linalg.inv(poses[v]), w2c_tar,
            k, k,
        )
        m2f = m2.to(torch.float32)
        mask_new = m2f * (1.0 - torch.clamp(mask_final, max=1.0))
        out_img = out_img * mask_final[..., None] + torch.floor(warped) * mask_new[..., None]
        out_depth = out_depth * mask_final + wdepth * mask_new
        mask_final = torch.clamp(mask_final + m2f, max=1.0)
    out_img = out_img * mask_final[..., None] + 255.0 * (1.0 - mask_final[..., None])
    return mask_final.to(torch.int32), out_img / 255.0, out_depth
