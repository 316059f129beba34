"""Kernel A' (the factor features' scatter-add backward) of one launch:
bytes and operations from its samples.  It reads each sample's
coordinates (12 bytes) and output gradients (4 bytes each: one
``d_sigma`` a sample in a density launch, one ``d_app`` a channel in an
app launch, both in a fused one), the table rows its samples touch (each
once, the mode's channels), and adds into the same rows of the gradient
tables (each written once).  The launcher's zeroing of the whole
gradient tables is a memset of its own, outside the kernel's time, and
is not counted.  A channel of a sample takes 28 operations (the
forward's 14, the chain's products and the scatter's adds)."""

from __future__ import annotations

import torch

from ..reference.field import MAT_MODE, VEC_MODE
from .arithmetic import PEAKS, least_s

OPS = 28
KERNEL = "factor_features_bwd"


def _cells(u, size):
    f = (u + 1.0) * 0.5 * (size - 1)
    i0 = torch.clamp(torch.floor(f).long(), 0, size - 1)
    return i0, torch.clamp(i0 + 1, max=size - 1)


def touched_rows(xn, shapes):
    """(plane rows, line rows) the samples ``xn`` (N, 3) touch, per axis."""
    planes, lines = [], []
    for i in range(3):
        h, w = shapes[f"planes.{i}"][:2]
        x0, x1 = _cells(xn[:, MAT_MODE[i][0]], w)
        y0, y1 = _cells(xn[:, MAT_MODE[i][1]], h)
        planes.append(torch.unique(torch.cat([y0 * w + x0, y0 * w + x1,
                                              y1 * w + x0, y1 * w + x1])).numel())
        l0, l1 = _cells(xn[:, VEC_MODE[i]], shapes[f"lines.{i}"][0])
        lines.append(torch.unique(torch.cat([l0, l1])).numel())
    return planes, lines


def launch_least_s(xn, channels, grads, shapes) -> float:
    """``channels``: per axis, the mode's channels (density, app or both);
    ``grads``: the output-gradient floats a sample (1 for density, the
    app channels' sum for app, their sum plus 1 fused)."""
    n = xn.shape[0]
    planes, lines = touched_rows(xn, shapes)
    rows = 4 * sum((p + l) * c for p, l, c in zip(planes, lines, channels))
    return least_s(n * (12 + 4 * grads) + 2 * rows, n * sum(channels) * OPS,
                   PEAKS["fp32_flops"])
