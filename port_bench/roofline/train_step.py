"""The least time of one train step from its shapes: the dense step's
density on every march step of every ray and its appearance and head on
``app_k`` samples a ray; the compacted step's both on its ``compact_k``
samples a ray.  The step runs with TF32 off, so cuBLAS runs the basis
and head products (``x @ w``, forward and backward) as fp32 products on
the CUDA cores: every operation is counted at the fp32 peak."""

from __future__ import annotations

from .arithmetic import PEAKS, sample_least_s


def least_s(cfg, traffic, n_samples: int) -> float:
    tc = traffic["train_config"]
    b = tc["batch_size"]
    if traffic.get("mask") and tc["train_compact_k"] > 0:
        k = (min(tc["train_compact_k"], n_samples) // tc["train_density_group"]) \
            * tc["train_density_group"]
        dens, rows = b * k, b * k
    else:
        dens, rows = b * n_samples, b * min(tc["app_k"], n_samples)
    return sample_least_s(cfg, dens, rows, backward=True, basis_peak=PEAKS["fp32_flops"],
                          head_peak=PEAKS["fp32_flops"])
