"""The least time of one rendered frame, from the live samples its rays
need: each ray's density on its live samples (at most the ladder's top
rung), appearance and head on at most ``app_k`` of them.  The basis
product is cuBLAS's fp32 product on the CUDA cores (TF32 off), counted
at the fp32 peak; the head is kernel B, whose fp32 products run on the
tensor cores as split TF32 operands, counted once at the TF32 peak."""

from __future__ import annotations

import torch

from .arithmetic import PEAKS, sample_least_s


def least_s(cfg, traffic, live_counts: torch.Tensor, scale: float) -> float:
    """``live_counts``: the live samples of a subsample of the frame's rays,
    each standing for ``scale`` rays."""
    r = traffic["render"]
    top = max(r["k_ladder"])
    dens = float(torch.clamp(live_counts, max=top).sum()) * scale
    rows = float(torch.clamp(live_counts, max=min(top, r["app_k"])).sum()) * scale
    return sample_least_s(cfg, dens, rows, backward=False, basis_peak=PEAKS["fp32_flops"],
                          head_peak=PEAKS["tf32_flops"])
