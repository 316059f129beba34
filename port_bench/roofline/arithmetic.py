"""The bound arithmetic: a kernel's least time is the larger of its bytes
over the memory's peak rate and its operations over the peak rate of the
units it runs on; a step's least time is the sum of its parts' least
times.  Peaks are the chip's published ones (``peaks.json``)."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())

#: operations a channel of a factor sample takes: four plane corners and two
#: line rows lerped (3 each), the plane × line product and the density sum
FEATURE_OPS = 14


def least_s(bytes_moved: float, ops: float, peak_ops: float) -> float:
    return max(bytes_moved / PEAKS["hbm_bytes_per_s"], ops / peak_ops)


def head_flops(d_in: int, width: int) -> int:
    """Multiply-adds of the three-layer head, counted as 2 operations, per
    row."""
    return 2 * (d_in * width + width * width + width * 3)


def field_widths(cfg):
    """(density channels, app channels, head input width) of a
    configuration: the sum over the three axes' tables (CP: one set)."""
    nd, na = cfg["n_lamb_sigma"], cfg["n_lamb_sh"]
    if cfg["model_name"] == "cp":
        nd, na = [nd[0]], [na[0]]
    a = cfg["app_dim"]
    d_in = a + 2 * cfg["fea_pe"] * a
    if cfg["shadingMode"] == "MLP_Fea":
        d_in += 3 + 2 * cfg["view_pe"] * 3
    return sum(nd), sum(na), d_in


def sample_least_s(cfg, density_samples: float, app_rows: float, *, backward: bool,
                   basis_peak: float, head_peak: float) -> float:
    """Least time of the arithmetic a render or a train step needs: factor
    features (density on ``density_samples``, appearance on ``app_rows``)
    at the fp32 peak, the basis product on ``app_rows`` at ``basis_peak``
    and the head on them at ``head_peak`` (each the peak of the units its
    products run on); a train step's backward doubles the products (the
    gradients of inputs and of weights) and the feature arithmetic.
    Reads and writes are not counted: the bound is the operations'."""
    nd, na, d_in = field_widths(cfg)
    fc, a = cfg["featureC"], cfg["app_dim"]
    feat = FEATURE_OPS * (nd * density_samples + na * app_rows)
    scale = 3 if backward else 1
    return scale * (feat / PEAKS["fp32_flops"] + 2 * na * a * app_rows / basis_peak
                    + head_flops(d_in, fc) * app_rows / head_peak)
