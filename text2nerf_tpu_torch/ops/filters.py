"""Depth and RGB image filters (port of ``text2nerf_tpu/ops/filters.py``).

- :func:`sparse_bilateral_filtering`: the iterative discontinuity-aware
  weighted median of depth and RGB.  Two backends: ``native`` (the C++
  library of :mod:`..native`, numpy on the host) and ``device`` (plain
  PyTorch on tensors, the JAX package's device program).  ``auto`` takes
  ``native`` for numpy inputs and ``device`` for tensors;
  ``TEXT2NERF_BILATERAL=native|device`` overrides ``auto``.  A native
  library that does not build raises: ``auto`` never moves to the device
  instead.
- :func:`range_median_filter` and
  :func:`sparse_bilateral_filtering_image_edge`: the spatial × range
  weighted median driven by the grayscale image's edges.
- :func:`hole_fill`: the weighted-neighbourhood hole fill as synchronous
  passes (the expansion runs the raster-order ``native.hole_fill2``).
- :func:`expand_mask_blur`: the mask erosion before inpainting.

The device functions take tensors (or arrays, placed on ``device``,
cuda unless asked) and return tensors on their device.  The weighted
median keeps the JAX program's arithmetic: a stable sort by value, the
sorted weights' sum and their normalized prefix sum accumulated in
float32 in order (the native library's order), so a tie of weights is
decided the same way.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from .. import native
from ..device import resolve_device

BACKENDS = ("auto", "native", "device")


def _on(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def _pad_edge(x, m: int):
    return F.pad(x[None, None], (m, m, m, m), mode="replicate")[0, 0]


def depth_discontinuity(depth, threshold: float = 0.04, mask=None, use_disparity=True):
    """4-direction disparity discontinuity maps (u, b, l, r), each (H, W)
    0/1 with a zero border."""
    disp = 1.0 / depth if use_disparity else depth
    u = (disp[1:, :] - disp[:-1, :])[:-1, 1:-1]
    b = (disp[:-1, :] - disp[1:, :])[1:, 1:-1]
    l = (disp[:, 1:] - disp[:, :-1])[1:-1, :-1]
    r = (disp[:, :-1] - disp[:, 1:])[1:-1, 1:]
    if mask is not None:
        u = u * (mask[1:, :] * mask[:-1, :])[:-1, 1:-1]
        b = b * (mask[:-1, :] * mask[1:, :])[1:, 1:-1]
        l = l * (mask[:, 1:] * mask[:, :-1])[1:-1, :-1]
        r = r * (mask[:, :-1] * mask[:, 1:])[1:-1, 1:]
    return tuple(F.pad((torch.abs(d) > threshold).float(), (1, 1, 1, 1)) for d in (u, b, l, r))


def _window_stack(x, win: int):
    """(H + 2m, W + 2m) → (H, W, win²), window entry dy·win + dx."""
    h, w = x.shape[0] - (win - 1), x.shape[1] - (win - 1)
    return torch.stack([x[dy:dy + h, dx:dx + w] for dy in range(win) for dx in range(win)], -1)


def _weighted_median(vals, coef, window: int):
    """The value where the normalized prefix sum of the weights, in value
    order, passes 0.5 (the reference's digitize rule), accumulated in
    float32 in order."""
    order = torch.argsort(vals, dim=-1, stable=True)
    vals_sorted = torch.gather(vals, -1, order)
    coef_sorted = torch.gather(coef, -1, order)
    k = window * window
    csum = torch.zeros_like(vals[..., 0])
    for i in range(k):
        csum = csum + coef_sorted[..., i]
    csum = torch.clamp(csum, min=1e-30)
    cum = torch.zeros_like(csum)
    idx = torch.zeros(csum.shape, dtype=torch.int64, device=csum.device)
    for i in range(k):
        cum = cum + coef_sorted[..., i] / csum
        idx = idx + (cum <= 0.5).long()
    idx = torch.clamp(idx, max=k - 1)
    return torch.gather(vals_sorted, -1, idx[..., None])[..., 0]


def _ring(values, discontinuity, window):
    """The border ring replaced by its neighbour ring, edge-padded by the
    window's radius: (v, value windows, discontinuity windows)."""
    m = window // 2
    v = _pad_edge(values[1:-1, 1:-1], 1)
    d = _pad_edge(discontinuity[1:-1, 1:-1], 1)
    return v, _window_stack(_pad_edge(v, m), window), _window_stack(_pad_edge(d, m), window)


def discontinuity_median_filter(values, discontinuity, window: int, mask=None):
    """One weighted-median pass of the sparse bilateral filter: pixels
    whose window touches a discontinuity take the median weighted by 1 −
    discontinuity (times the zero-padded mask window when ``mask`` is
    given; mask-0 centres are kept)."""
    v, vals, disc = _ring(values, discontinuity, window)
    coef = 1.0 - disc
    if mask is not None:
        m = window // 2
        coef = coef * _window_stack(F.pad(mask, (m, m, m, m)), window)
    median = _weighted_median(vals, coef, window)
    touched = disc.sum(-1) > 0
    has_coef = coef.amax(-1) > 0
    out = torch.where(touched & has_coef, median, v)
    if mask is not None:
        out = torch.where(mask == 0, v, out)
    return out


def _device_sparse_bilateral(depth, image, mask, threshold, fs, edge: bool):
    depth0 = depth
    vis_depth, vis_image = depth0, image
    for win in fs:
        if edge:
            gray = vis_image[..., 0] * 0.299 + vis_image[..., 1] * 0.587 \
                + vis_image[..., 2] * 0.114
            u, b, l, r = depth_discontinuity(gray, threshold, mask, use_disparity=False)
        else:
            u, b, l, r = depth_discontinuity(vis_depth, threshold, mask)
        disc = torch.clamp(u + b + l + r, 0.0, 1.0)
        disc = torch.where(depth0 == 0, torch.ones_like(disc), disc)
        if mask is not None:
            disc = torch.where(mask == 0, torch.zeros_like(disc), disc)
        if edge:
            def one(x):
                return range_median_filter(x, disc, win)
        else:
            def one(x):
                return discontinuity_median_filter(x, disc, win, mask=mask)
        vis_depth = one(vis_depth)
        vis_image = torch.stack([one(vis_image[..., c]) for c in range(vis_image.shape[-1])], -1)
    return vis_image, vis_depth


def _passes(filter_size, num_iter: int):
    if np.isscalar(filter_size):
        filter_size = (int(filter_size),) * max(num_iter - 1, 0)
    return tuple(int(w) for w in filter_size)[: max(num_iter - 1, 0)]


def _device_call(depth, image, mask, threshold, fs, edge, device):
    """The device program on tensors; numpy inputs go to ``device`` and
    come back as numpy."""
    tensors = isinstance(depth, torch.Tensor) or isinstance(image, torch.Tensor)
    if tensors:
        dev = (depth if isinstance(depth, torch.Tensor) else image).device
    else:
        dev = resolve_device(device)
    m = None if mask is None else _on(mask, dev)
    with torch.no_grad():
        img, d = _device_sparse_bilateral(_on(depth, dev), _on(image, dev), m, float(threshold),
                                          fs, edge)
    if tensors:
        return img, d
    return img.cpu().numpy(), d.cpu().numpy()


def sparse_bilateral_filtering(
    depth,
    image,
    filter_size=(5, 5, 3, 3),
    depth_threshold: float = 0.02,
    num_iter: int = 4,
    mask=None,
    backend: str = "auto",
    device=None,
):
    """Iterative discontinuity-aware median filtering of depth and RGB.

    Keeps the reference's save-before-filter behaviour: the returned state
    has ``num_iter - 1`` filter passes applied, the k-th with window
    ``filter_size[k]`` (a scalar is used for every pass).  ``backend``:
    see the module docstring.  Returns (image', depth'): float32 numpy
    for numpy inputs, tensors on their device for tensors."""
    fs = _passes(filter_size, num_iter)
    if backend == "auto":
        backend = os.environ.get("TEXT2NERF_BILATERAL", "auto")
    if backend not in BACKENDS:
        raise ValueError(f"unknown bilateral backend {backend!r} "
                         "(TEXT2NERF_BILATERAL must be auto|native|device)")
    if backend == "auto":
        tensors = isinstance(depth, torch.Tensor) or isinstance(image, torch.Tensor)
        backend = "device" if tensors else "native"
    if backend == "native":
        if isinstance(depth, torch.Tensor) or isinstance(image, torch.Tensor):
            raise TypeError("the native bilateral backend takes numpy arrays")
        return native.sparse_bilateral(depth, image, fs, depth_threshold, mask=mask)
    return _device_call(depth, image, mask, depth_threshold, fs, False, device)


def range_median_filter(values, discontinuity, window: int, sigma_s: float = 4.0,
                        sigma_r: float = 0.5):
    """The reference's ``bilateral_filter2`` pass: the median weighted by
    spatial × range × (1 − discontinuity), a pixel whose own
    discontinuity flag is set kept."""
    m = window // 2
    v, vals, disc = _ring(values, discontinuity, window)
    center = vals[..., (window * window) // 2]
    ax = torch.arange(-m, m + 1, dtype=torch.float32, device=values.device)
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")
    spatial = torch.exp(-(xx ** 2 + yy ** 2) / (2.0 * sigma_s ** 2)).reshape(-1)
    rng_term = torch.exp(-(vals - center[..., None]) ** 2 / (2.0 * sigma_r ** 2))
    coef = spatial * rng_term * (1.0 - disc)
    median = _weighted_median(vals, coef, window)
    skip = disc[..., (window * window) // 2] == 1
    no_coef = coef.sum(-1) == 0
    return torch.where(skip | no_coef, v, median)


def sparse_bilateral_filtering_image_edge(depth, image, filter_size=(5, 5, 3, 3),
                                          threshold: float = 0.1, num_iter: int = 4,
                                          mask=None, device=None):
    """The image-edge variant (the reference's
    ``sparse_bilateral_filtering_4imgedge``): discontinuities from the
    grayscale image's edges, filtering with :func:`range_median_filter`.
    Device backend only; types as :func:`sparse_bilateral_filtering`."""
    return _device_call(depth, image, mask, threshold, _passes(filter_size, num_iter), True,
                        device)


_W5 = np.array(
    [
        [1, 1, 1.5, 1, 1],
        [1, 1.5, 3, 1.5, 1],
        [1.5, 3, 0, 3, 1.5],
        [1, 1.5, 3, 1.5, 1],
        [1, 1, 1.5, 1, 1],
    ],
    np.float32,
)


@torch.no_grad()
def hole_fill(image, mask, depth=None, threshold: float = 0.65, max_passes: int = 8,
              device=None):
    """Weighted-neighbourhood hole filling (the reference's
    ``dibr_filter_mask2``) as ``max_passes`` synchronous passes: a hole
    pixel of the interior (2 pixels from the border) whose 5x5 weighted
    known fraction exceeds ``threshold`` takes the mask-weighted 3x3 mean
    of its known neighbours.  Tensors stay on their device, arrays go to
    ``device`` (cuda unless asked).  Returns (image, mask, depth) tensors,
    depth None when not given."""
    dev = image.device if isinstance(image, torch.Tensor) else resolve_device(device)
    img, m = _on(image, dev), _on(mask, dev)
    dep = None if depth is None else _on(depth, dev)
    w5 = torch.as_tensor(_W5, device=dev) / float(_W5.sum())
    ones3 = torch.ones((3, 3), dtype=torch.float32, device=dev)

    def conv2(x, k):
        return F.conv2d(x[None, None], k[None, None], padding=k.shape[-1] // 2)[0, 0]

    interior = torch.zeros_like(m, dtype=torch.bool)
    interior[2:-2, 2:-2] = True
    for _ in range(max_passes):
        frac = conv2(m, w5)
        neigh_m = conv2(m, ones3)
        fill = (m == 0) & (frac > threshold) & (neigh_m > 0) & interior
        denom = torch.clamp(neigh_m, min=1e-12)
        img_mean = torch.stack([conv2(img[..., c] * m, ones3) for c in range(img.shape[-1])],
                               -1) / denom[..., None]
        img = torch.where(fill[..., None], img_mean, img)
        if dep is not None:
            dep = torch.where(fill, conv2(dep * m, ones3) / denom, dep)
        m = torch.where(fill, torch.ones_like(m), m)
    return img, m, dep


def expand_mask_blur(mask, ksize: int = 5, thresh: float = 0.99) -> np.ndarray:
    """The mask erosion before inpainting under ``update_known_views``
    (``cv2.blur`` of the mask, reflect-101 borders, kept where the box
    average exceeds ``thresh``): (H, W) float32 numpy in and out, on the
    host, the box sum in the JAX package's order (a conv of the padded
    mask with a 1/k² kernel)."""
    m = torch.as_tensor(np.asarray(mask, np.float32))
    k = torch.full((1, 1, ksize, ksize), 1.0 / (ksize * ksize), dtype=torch.float32)
    p = ksize // 2
    mp = F.pad(m[None, None], (p, p, p, p), mode="reflect")
    blurred = F.conv2d(mp, k)[0, 0]
    return (blurred > thresh).to(torch.float32).numpy()
