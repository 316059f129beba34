"""Depth and RGB image filters (port of ``sparse_bilateral_filtering`` and
``expand_mask_blur`` from ``text2nerf_tpu/ops/filters.py``).

The sparse bilateral filter runs on the host through the native library
(:mod:`..native`), whose numbers the JAX package golden-tests as equal to
its jitted device program.  The device program is not ported: every call
site feeds and reads host numpy.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import native


def sparse_bilateral_filtering(
    depth,
    image,
    filter_size=(5, 5, 3, 3),
    depth_threshold: float = 0.02,
    num_iter: int = 4,
    mask=None,
):
    """Iterative discontinuity-aware median filtering of depth and RGB.

    Keeps the reference's save-before-filter behaviour: the returned state
    has ``num_iter - 1`` filter passes applied, the k-th with window
    ``filter_size[k]`` (a scalar is used for every pass).  Returns
    (image', depth') as float32 numpy."""
    if np.isscalar(filter_size):
        filter_size = (int(filter_size),) * max(num_iter - 1, 0)
    fs = tuple(int(w) for w in filter_size)[: max(num_iter - 1, 0)]
    return native.sparse_bilateral(depth, image, fs, depth_threshold, mask=mask)


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
