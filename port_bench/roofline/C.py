"""Kernel C (the TensorCP features) in the eval renders of a run: bytes
and operations from the samples of its launches, as the program counts
them (``cp.sigma_samples``: samples of launches that compute the density;
``cp.app_samples``: of launches that compute the app channels; a fused
launch counts in both).

Bytes: a sample's coordinates (3 floats) read once, counted for the
larger of the two counts (exact where every launch is fused, as at the
render cell's base rungs; where a density launch and an app launch read
the same samples, the second read is left out, so the least time stays a
lower bound), and its outputs written once: 1 float a density sample and
``na`` floats an app sample (the raw channels before the basis product).
The three lines, 3 · L · (nd + na) floats (2.3 MB at 500³ and 96 / 288),
live in L2 and are read once a launch.

Operations, per channel a sample computes: three line lerps (3 each) and
the two multiplies of their product, 11; a density channel adds 1 for the
density sum.  At the fp32 peak: the kernel runs on the CUDA cores."""

from __future__ import annotations

from ..reference.field import components, n_to_reso
from .arithmetic import PEAKS, least_s

KERNEL = "cp_features_walk_kernel"
#: operations a channel of a CP sample takes (three lerps, the product)
CHANNEL_OPS = 11


def line_bytes(cfg) -> int:
    """The three lines' bytes, fp32."""
    nd, na = components(cfg)
    return 4 * sum(n_to_reso(cfg["N_voxel"], cfg["aabb"])) * (nd[0] + na[0])


def least_s_of(cfg, sigma_samples: int, app_samples: int, launches: int) -> float:
    nd, na = components(cfg)
    moved = (12 * max(sigma_samples, app_samples) + 4 * sigma_samples + 4 * na[0] * app_samples
             + launches * line_bytes(cfg))
    ops = (CHANNEL_OPS + 1) * nd[0] * sigma_samples + CHANNEL_OPS * na[0] * app_samples
    return least_s(moved, ops, PEAKS["fp32_flops"])
