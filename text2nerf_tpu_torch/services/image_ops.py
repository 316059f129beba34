"""The port's own equivalents of the OpenCV calls of the boosted depth
service (``text2nerf_tpu/services/depth_service.py``); the port does
not import cv2.

On the host, numpy, reproducing OpenCV's arithmetic so the booster's
discrete decisions equal the JAX package's:

- :func:`sobel_grad`: ``|Sobel(dy)| + |Sobel(dx)|``, ksize 3, CV_64F,
  BORDER_REFLECT_101;
- :func:`resize_area`: ``INTER_AREA`` of a float32 or float64 image:
  OpenCV's area tables (fp32 weights, the float64 image accumulated in
  float64 and the float32 one in float32, in OpenCV's order), its fast
  path for integer scales, a copy at the same size;
- :func:`dilate`: ``cv2.dilate`` by a k x k box of ones, anchor at k//2,
  the border taking no part;
- :func:`integral`: ``cv2.integral`` in float64.

On tensors, so the same code runs on the CPU and on the card (fp32
unless said):

- :func:`resize`: ``INTER_CUBIC`` (Keys, A = −0.75) and ``INTER_LINEAR``
  (no antialias), half-pixel centres, edge taps clamped, the coordinates
  and weights as cv2 computes them on x86 (through IPP), the width
  resized first, the products summed left to right;
- :func:`gaussian_kernel` (``getGaussianKernel``, fp32 taps) and
  :func:`gaussian_blur` (``GaussianBlur``, separable, reflect-101);
- :func:`blurred_box` and :func:`gaussian_blend_mask`: the patch blend
  mask as the outer product of two blurred 1-D boxes (the 2-D box is
  their product, so this is the 2-D blur exactly);
- :func:`polyfit_map`: ``np.polyval(np.polyfit(x, y, 1), x)`` of fp32
  data, numpy's rank cut included, in fp64.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Host: the decisions' OpenCV arithmetic
# ---------------------------------------------------------------------------


def rgb2gray(img: np.ndarray) -> np.ndarray:
    return 0.2989 * img[..., 0] + 0.5870 * img[..., 1] + 0.1140 * img[..., 2]


def sobel_grad(gray: np.ndarray) -> np.ndarray:
    """``|Sobel(gray, CV_64F, 0, 1)| + |Sobel(gray, CV_64F, 1, 0)|``, 3x3,
    reflect-101 borders; the taps (1, 2, 1) and (−1, 0, 1) are exact in
    float64, the row filter first as in OpenCV."""
    p = np.pad(np.asarray(gray, np.float64), 1, mode="reflect")
    # dx: derivative along the row, smoothing down the column
    rd = p[:, 2:] - p[:, :-2]
    gx = rd[:-2] + 2.0 * rd[1:-1] + rd[2:]
    # dy: smoothing along the row, derivative down the column
    rs = p[:, :-2] + 2.0 * p[:, 1:-1] + p[:, 2:]
    gy = rs[2:] - rs[:-2]
    return np.abs(gy) + np.abs(gx)


def _area_tab(ssize: int, dsize: int, scale: float):
    """OpenCV's computeResizeAreaTab: (dst index, src index, fp32 weight)
    entries in its order."""
    di, si, alpha = [], [], []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            di.append(dx), si.append(sx1 - 1), alpha.append((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            di.append(dx), si.append(sx), alpha.append(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            di.append(dx), si.append(sx2), alpha.append(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return np.asarray(di), np.asarray(si), np.asarray(alpha, np.float32)


def _area_dense(di, si, alpha, dsize):
    """The table as (dsize, k) source indices and weights, entries of one
    destination in table order, padded with weight 0 on index 0."""
    k = np.bincount(di, minlength=dsize).max()
    idx = np.zeros((dsize, k), np.int64)
    w = np.zeros((dsize, k), np.float32)
    pos = np.zeros(dsize, np.int64)
    for d, s, a in zip(di, si, alpha):
        idx[d, pos[d]], w[d, pos[d]] = s, a
        pos[d] += 1
    return idx, w, pos


def resize_area(src: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(src, dsize, interpolation=INTER_AREA)`` of a 2-D
    float32 or float64 image, shrinking or at the same size (dsize is
    (width, height), cv2's order)."""
    src = np.asarray(src)
    wt = np.float64 if src.dtype == np.float64 else np.float32
    src = src.astype(wt, copy=False)
    sh, sw = src.shape
    dw, dh = dsize
    if (dh, dw) == (sh, sw):
        return src.copy()
    scale_x, scale_y = sw / dw, sh / dh
    if scale_x < 1 or scale_y < 1:
        raise ValueError("resize_area only shrinks")
    ix, iy = int(round(scale_x)), int(round(scale_y))
    if abs(scale_x - ix) < np.finfo(np.float64).eps and abs(scale_y - iy) < np.finfo(
            np.float64).eps:
        # the fast path: the cell's sum in row-major order, times fp32 1/area
        # (OpenCV adds the cell's terms four at a time, ((a + b) + c) + d;
        # its SIMD route for 2x2 float32 cells adds (a + b) + (c + d): the
        # same sum for the 0/1 images the booster shrinks)
        cells = src[: dh * iy, : dw * ix].reshape(dh, iy, dw, ix)
        terms = [cells[:, sy, :, sx] for sy in range(iy) for sx in range(ix)]
        acc = np.zeros((dh, dw), wt)
        k = 0
        while k <= len(terms) - 4:
            acc = acc + (((terms[k] + terms[k + 1]) + terms[k + 2]) + terms[k + 3])
            k += 4
        for t in terms[k:]:
            acc = acc + t
        return (acc * wt(np.float32(1.0) / np.float32(ix * iy))).astype(wt)
    xi, xw, _ = _area_dense(*_area_tab(sw, dw, scale_x), dw)
    yd, ys, ya = _area_tab(sh, dh, scale_y)
    xw = xw.astype(wt)
    # each source row resized across: buf[dx] += S[si] * alpha, in order
    rows = np.zeros((sh, dw), wt)
    for k in range(xi.shape[1]):
        rows = rows + src[:, xi[:, k]] * xw[:, k]
    out = np.zeros((dh, dw), wt)
    first = np.ones(dh, bool)
    for d, s, b in zip(yd, ys, ya.astype(wt)):
        out[d] = rows[s] * b if first[d] else out[d] + rows[s] * b
        first[d] = False
    return out


def dilate(binary: np.ndarray, k: int) -> np.ndarray:
    """``cv2.dilate(binary, ones((k, k)))`` of a 0/1 float32 image: the
    window rows and columns ``i − k//2 .. i − k//2 + k − 1``, clipped to
    the image."""
    b = (np.asarray(binary) > 0).astype(np.int64)
    h, w = b.shape
    a = k // 2
    s = np.zeros((h + 1, w + 1), np.int64)
    s[1:, 1:] = b.cumsum(0).cumsum(1)
    y0 = np.clip(np.arange(h) - a, 0, h)
    y1 = np.clip(np.arange(h) - a + k, 0, h)
    x0 = np.clip(np.arange(w) - a, 0, w)
    x1 = np.clip(np.arange(w) - a + k, 0, w)
    box = s[y1][:, x1] - s[y0][:, x1] - s[y1][:, x0] + s[y0][:, x0]
    return (box > 0).astype(np.float32)


def integral(img: np.ndarray) -> np.ndarray:
    """``cv2.integral`` of a float64 image: (H + 1, W + 1), each row's
    running sum added to the row above, in float64."""
    img = np.asarray(img, np.float64)
    out = np.zeros((img.shape[0] + 1, img.shape[1] + 1), np.float64)
    out[1:, 1:] = np.cumsum(np.cumsum(img, 1), 0)
    return out


# ---------------------------------------------------------------------------
# Tensors: the image work
# ---------------------------------------------------------------------------

CUBIC_A = -0.75


def _taps(n_in: int, n_out: int, interp: str):
    """Source indices (n_out, k) and fp32 weights (n_out, k) of one axis,
    as OpenCV computes them through IPP on x86: the source coordinate
    fx = (i + 0.5) · n_in / n_out − 0.5, its fraction and the weights in
    float64, each weight rounded to fp32; taps clamped to the edge.
    (OpenCV's own path rounds fx to fp32 first: up to 3e-5 apart on
    noise, where these agree with cv2 to 2 ulp.)"""
    fx = (np.arange(n_out) + 0.5) * n_in / n_out - 0.5
    sx = np.floor(fx)
    x = fx - sx
    sx = sx.astype(np.int64)
    if interp == "linear":
        lo = sx < 0
        x[lo], sx[lo] = 0, 0
        hi = sx >= n_in - 1
        x[hi], sx[hi] = 0, n_in - 1
        idx = np.stack([sx, sx + 1], 1)
        w = np.stack([1.0 - x, x], 1)
    elif interp == "cubic":
        a = CUBIC_A
        x1, x2 = x + 1.0, 1.0 - x
        c0 = ((a * x1 - 5 * a) * x1 + 8 * a) * x1 - 4 * a
        c1 = ((a + 2) * x - (a + 3)) * x * x + 1.0
        c2 = ((a + 2) * x2 - (a + 3)) * x2 * x2 + 1.0
        idx = sx[:, None] + np.arange(-1, 3)[None]
        w = np.stack([c0, c1, c2, 1.0 - c0 - c1 - c2], 1)
    else:
        raise ValueError(f"unknown interpolation {interp!r}")
    return np.clip(idx, 0, n_in - 1), w.astype(np.float32)


def _upload(a: np.ndarray, device):
    """A host array as a tensor on ``device``; to the card from pinned
    memory without waiting for the stream (a pageable copy would)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


@functools.lru_cache(maxsize=512)
def _taps_on(n_in: int, n_out: int, interp: str, device: str):
    idx, w = _taps(n_in, n_out, interp)
    return _upload(idx, device), _upload(w, device)


def _resize_axis(x, n_out: int, axis: int, interp: str):
    n_in = x.shape[axis]
    idx, w = _taps_on(n_in, n_out, interp, str(x.device))
    w = w.to(x.dtype)
    shape = [1] * x.ndim
    shape[axis] = n_out
    out = None
    for k in range(idx.shape[1]):
        term = x.index_select(axis, idx[:, k]) * w[:, k].view(shape)
        out = term if out is None else out + term
    return out


def resize(x, hw: Tuple[int, int], interp: str = "cubic"):
    """``cv2.resize(x, (w, h), interpolation=INTER_CUBIC | INTER_LINEAR)``
    of an (H, W) or (H, W, C) tensor: across the width, then down the
    height."""
    h, w = hw
    if tuple(x.shape[:2]) == (h, w):
        return x.clone()
    return _resize_axis(_resize_axis(x, w, 1, interp), h, 0, interp)


def gaussian_kernel(k: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(k, sigma, CV_32F)``: OpenCV's fixed taps
    for odd k ≤ 7 without a sigma, else exp(−x² / 2σ²) normalized in
    float64 (σ = 0.3 · ((k − 1) / 2 − 1) + 0.8 when sigma ≤ 0), as fp32."""
    small = {1: [1.0], 3: [0.25, 0.5, 0.25], 5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
             7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]}
    if k in small and sigma <= 0:
        return np.asarray(small[k], np.float32)
    s = sigma if sigma > 0 else ((k - 1) * 0.5 - 1) * 0.3 + 0.8
    x = np.arange(k, dtype=np.float64) - (k - 1) * 0.5
    g = np.exp(-0.5 / (s * s) * x * x)
    return (g * (1.0 / g.sum())).astype(np.float32)


def reflect101(i: np.ndarray, n: int) -> np.ndarray:
    """BORDER_REFLECT_101 of indices, any distance out."""
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.abs(i) % period
    return np.where(i >= n, period - i, i)


@functools.lru_cache(maxsize=64)
def _blur_tables(n: int, k: int, sigma: float, device: str):
    r = k // 2
    return (_upload(reflect101(np.arange(-r, n + r), n), device),
            _upload(gaussian_kernel(k, sigma), device))


def _blur_axis(x, k: int, sigma: float, axis: int):
    n = x.shape[axis]
    idx, taps = _blur_tables(n, k, sigma, str(x.device))
    xp = x.index_select(axis, idx).movedim(axis, -1)
    lead = xp.shape[:-1]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out = F.conv1d(xp.reshape(-1, 1, xp.shape[-1]), taps.to(x.dtype).view(1, 1, -1))
    return out.reshape(*lead, n).movedim(-1, axis)


def gaussian_blur(x, k: int, sigma: float = 0.0):
    """``cv2.GaussianBlur(x, (k, k), sigma)`` of an (H, W) tensor:
    along the rows, then down the columns, reflect-101 borders."""
    return _blur_axis(_blur_axis(x, k, sigma, 1), k, sigma, 0)


def blurred_box(n: int, k: int, sigma: float) -> np.ndarray:
    """The 1-D box [0.15 n, n − 0.15 n) blurred by the k-tap Gaussian,
    reflect-101, float64."""
    box = np.zeros(n, np.float64)
    box[int(0.15 * n): n - int(0.15 * n)] = 1.0
    r = k // 2
    taps = gaussian_kernel(k, sigma).astype(np.float64)
    idx = reflect101(np.arange(n)[:, None] + np.arange(-r, r + 1)[None], n)
    return box[idx] @ taps


def gaussian_blend_mask(size: Tuple[int, int], device=None):
    """The patch blend mask (``generatemask``): ones over the middle 70%,
    blurred by a k = 2·ceil(2·⌊h/16⌋) + 1 Gaussian of σ = ⌊h/16⌋, then
    min-max normalized; (h, w) fp32 on ``device``."""
    h, w = size
    sigma = int(h / 16)
    k = int(2 * np.ceil(2 * sigma) + 1)
    by = torch.from_numpy(blurred_box(h, k, sigma).astype(np.float32)).to(device)
    bx = torch.from_numpy(blurred_box(w, k, sigma).astype(np.float32)).to(device)
    mask = by[:, None] * bx[None, :]
    lo, hi = mask.min(), mask.max()
    return (mask - lo) / (hi - lo)


def polyfit_map(x, y):
    """``np.polyval(np.polyfit(x, y, 1), x)`` of fp32 tensors, flattened.
    numpy fits fp32 data in fp32 with ``rcond = n · eps32`` on the
    column-scaled [x, 1]: where the smaller singular value falls below
    rcond times the larger, the fit keeps the larger direction only (the
    minimum-norm solution), else it is the least-squares line.  Both, and
    the choice, are computed here in fp64 on the tensors' device.
    Returns fp32 of x's shape."""
    xd, yd = x.double().reshape(-1), y.double().reshape(-1)
    n = xd.numel()
    sx2 = (xd * xd).sum()
    norm_x, root_n = torch.sqrt(sx2), math.sqrt(n)
    dx = xd - xd.mean()
    sxx = (dx * dx).sum()
    # the scaled columns' cosine, and s_min / s_max = sqrt((1 - c) / (1 + c))
    c = xd.sum() / (norm_x * root_n)
    rank1 = torch.sqrt(sxx / sx2) / (1 + c) < n * float(np.finfo(np.float32).eps)
    line = (dx * (yd - yd.mean())).sum() / sxx * dx + yd.mean()
    # minimum norm: both scaled coefficients ((a1 + a2) · y) / (2 (1 + c))
    coef = ((xd * yd).sum() / norm_x + yd.sum() / root_n) / (2 * (1 + c))
    flat = coef / norm_x * xd + coef / root_n
    return torch.where(rank1, flat, line).reshape(x.shape).float()
