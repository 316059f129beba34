"""Depth and RGB image filters (port of ``sparse_bilateral_filtering`` from
``text2nerf_tpu/ops/filters.py``).

The sparse bilateral filter runs on the host through the native library
(:mod:`..native`), whose numbers the JAX package golden-tests as equal to
its jitted device program.  The device program is not ported: every call
site feeds and reads host numpy.
"""

from __future__ import annotations

import numpy as np

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
