"""Training losses (port of ``text2nerf_tpu/ops/losses.py``).

The loss stack of the reference training loop: rgb mse, the depth terms
(mse, scale/shift-invariant, scale-invariant log, Gaussian NLL) and the
transmittance regularizers.  Plain PyTorch with autograd.
"""

from __future__ import annotations

import math

import torch


def mse(pred, target):
    return torch.mean((pred - target) ** 2)


def mse2psnr(x):
    """-10 log10(mse)."""
    return -10.0 * torch.log(x) / math.log(10.0)


def transmittance_mask_loss(weights, mask, denom=None):
    """MSE against 0 of the per-ray mean of ``weights * mask``: drives the
    compositing weights in front of the supervised surface to zero.
    ``denom`` replaces the mean's denominator; the compacted train render
    passes the dense sample count, so the loss keeps the scale of the
    full-S mean (its culled samples contribute exactly 0)."""
    d = weights.shape[1] if denom is None else denom
    mean_trans = torch.sum(weights * mask, dim=1) / d
    return torch.mean(mean_trans ** 2)


def transmittance_const_loss(weights, target: float = 0.8):
    mean_trans = torch.mean(weights, dim=1)
    return torch.mean((mean_trans - target) ** 2)


def depth_front_mask(z_vals, target_depth, delta: float = 0.1):
    """Samples strictly before (depth - delta)."""
    return (z_vals - target_depth[:, None] + delta) < 0


def gaussian_nll_depth_loss(depth_map, z_vals, weights, target_depth, target_std=0.1):
    """Uncertainty-gated Gaussian NLL depth loss, fixed-shape: the "apply"
    gate is a weight mask instead of boolean indexing."""
    pred_mean = depth_map
    pred_var = torch.sum((z_vals - pred_mean[:, None]) ** 2 * weights, dim=-1) + 1e-8
    delta_bad = (torch.abs(pred_mean - target_depth) - target_std) > 0.0
    var_bad = target_std ** 2 < pred_var
    apply = delta_bad | var_bad
    # torch.maximum splits the gradient at a tie, as jnp.maximum does
    var = torch.maximum(pred_var, pred_var.new_tensor(0.001))
    nll = 0.5 * (torch.log(var) + (target_depth - pred_mean) ** 2 / var)
    denom = torch.clamp(torch.sum(apply), min=1)
    return torch.abs(torch.sum(torch.where(apply, nll, torch.zeros_like(nll))) / denom)


def scale_invariant_log_depth_loss(depth_map, target_depth):
    log_pred = torch.log(depth_map)
    log_target = torch.log(target_depth)
    alpha = torch.mean(log_target - log_pred)
    return torch.mean(torch.abs(log_pred - log_target + alpha))


def scale_shift_invariant_depth_loss(z_vals, weights, target_depth):
    """Fits target ≈ s·z + t by weighted least squares (the closed-form 2x2
    normal equations) with the fit detached, then returns
    (mean(w·(s·z + t - target)²), s, t)."""
    target = torch.broadcast_to(target_depth[:, None], z_vals.shape)
    w = weights.reshape(-1).detach()
    y = target.reshape(-1).detach()
    zs = z_vals.reshape(-1).detach()
    sw = torch.sum(w) + 1e-12
    swz = torch.sum(w * zs)
    swzz = torch.sum(w * zs * zs)
    swy = torch.sum(w * y)
    swzy = torch.sum(w * zs * y)
    det = sw * swzz - swz * swz + 1e-12
    s = (sw * swzy - swz * swy) / det
    t = (swzz * swy - swz * swzy) / det
    loss = torch.mean(weights * (s * z_vals + t - target) ** 2)
    return loss, s, t


def charbonnier(pred, target, eps: float = 1e-3):
    return torch.mean(torch.sqrt((pred - target) ** 2 + eps * eps))
