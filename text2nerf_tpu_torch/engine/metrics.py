"""Quality metrics (port of ``text2nerf_tpu/engine/metrics.py``): PSNR,
SSIM and LPIPS, and the depth visualization.  No OpenCV or scipy: SSIM's
Gaussian window runs as shifted sums in float64 on the device, LPIPS is
:mod:`..models.lpips`."""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def psnr(img0, img1, max_val: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(img0) - np.asarray(img1)) ** 2))
    if mse == 0:
        return float("inf")
    return float(-10.0 * np.log(mse / max_val ** 2) / np.log(10.0))


def _gaussian_window(filter_size: int, filter_sigma: float) -> np.ndarray:
    hw = filter_size // 2
    shift = (2 * hw - filter_size + 1) / 2
    f_i = ((np.arange(filter_size) - hw + shift) / filter_sigma) ** 2
    filt = np.exp(-0.5 * f_i)
    return filt / np.sum(filt)


def _filter_valid(z, filt, axis: int):
    """The 'valid' correlation of ``z`` with the symmetric window ``filt``
    along ``axis`` (scipy's convolve2d of the JAX package, the window
    being its own flip)."""
    n = z.shape[axis] - len(filt) + 1
    out = None
    for k, f in enumerate(filt):
        term = float(f) * z.narrow(axis, k, n)
        out = term if out is None else out + term
    return out


def ssim(img0, img1, max_val: float = 1.0, filter_size: int = 11,
         filter_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03,
         return_map: bool = False, device=None):
    """Gaussian-window SSIM of two (H, W, 3) images (the reference's
    ``rgb_ssim``, the mipnerf formulation), in float64 on ``device``
    (cuda unless asked)."""
    dev = resolve_device(device)

    def t(x):
        x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        return x.to(device=dev, dtype=torch.float64)

    a, b = t(img0), t(img1)
    assert a.shape == b.shape and a.shape[-1] == 3
    filt = _gaussian_window(filter_size, filter_sigma)

    def filt_fn(z):
        return _filter_valid(_filter_valid(z, filt, 0), filt, 1)

    mu0, mu1 = filt_fn(a), filt_fn(b)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    sigma00 = torch.clamp(filt_fn(a * a) - mu00, min=0.0)
    sigma11 = torch.clamp(filt_fn(b * b) - mu11, min=0.0)
    sigma01 = filt_fn(a * b) - mu01
    sigma01 = torch.sign(sigma01) * torch.minimum(torch.sqrt(sigma00 * sigma11),
                                                  torch.abs(sigma01))
    c1, c2 = (k1 * max_val) ** 2, (k2 * max_val) ** 2
    ssim_map = ((2 * mu01 + c1) * (2 * sigma01 + c2)) / (
        (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2))
    return ssim_map.cpu().numpy() if return_map else float(torch.mean(ssim_map))


_LPIPS = {}


def lpips(img0, img1, net: str = "alex", weights_dir=None, device=None) -> float:
    """The LPIPS distance of two (H, W, 3) images in [0, 1] (the
    reference's ``rgb_lpips``), on ``device`` (cuda unless asked).  The
    model is cached per (net, weights_dir, device); without weights it
    raises FileNotFoundError."""
    dev = resolve_device(device)
    key = (net, weights_dir, str(dev))
    if key not in _LPIPS:
        from ..services.weights import load_lpips

        _LPIPS[key] = load_lpips(net, weights_dir, device=dev)
    return _LPIPS[key].distance(img0, img1)


def _jet_bgr(x8):
    """OpenCV's COLORMAP_JET (BGR, uint8) as the piecewise-linear jet
    formula; within one level of cv2.applyColorMap."""
    x = x8.astype(np.float64) / 255.0
    r = np.clip(1.5 - np.abs(4.0 * x - 3.0), 0.0, 1.0)
    g = np.clip(1.5 - np.abs(4.0 * x - 2.0), 0.0, 1.0)
    b = np.clip(1.5 - np.abs(4.0 * x - 1.0), 0.0, 1.0)
    return np.round(255.0 * np.stack([b, g, r], axis=-1)).astype(np.uint8)


def visualize_depth(depth, minmax=None, colorize: bool = True):
    """Depth → JET colormap uint8 (H, W, 3), plus the (min, max) used."""
    x = np.nan_to_num(np.asarray(depth))
    if minmax is None:
        positive = x[x > 0]
        mi = float(positive.min()) if positive.size else 0.0
        ma = float(x.max())
    else:
        mi, ma = minmax
    xn = np.maximum((x - mi) / (ma - mi + 1e-8), 0)
    x8 = (255 * xn).astype(np.uint8)
    if colorize:
        return _jet_bgr(x8), (mi, ma)
    return np.repeat(x8[..., None], 3, -1), (mi, ma)
