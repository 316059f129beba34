"""How the trainer builds its train step (the step-building part of
``text2nerf_tpu/engine/trainer.py``).

:class:`TrainConfig` holds the fields the step is built from, with the
JAX package's defaults; :func:`_resolve_group`, :func:`_initial_loss_weights`
and :func:`_step_kwargs` turn it into ``make_train_step`` keyword
arguments exactly as the JAX trainer does.  The progressive
reconstruction loop, the scene state and the filters are not ported yet.
"""

from __future__ import annotations

import dataclasses

from ..models import tensorf as tf
from . import train_step as ts


@dataclasses.dataclass
class TrainConfig:
    """The train-step fields of the JAX ``TrainConfig`` and their defaults."""

    batch_size: int = 16384
    lr_init: float = 0.02
    lr_basis: float = 1e-3
    lr_decay_iters: int = -1
    lr_decay_target_ratio: float = 0.1
    tv_weight_density: float = 0.1
    tv_weight_app: float = 0.01
    l1_weight: float = 0.0
    ortho_weight: float = 0.0
    app_k: int = 64
    ndc_ray: bool = False
    depth_loss_type: str = "mse"
    # R of the dense step (clamped to a divisor of the batch)
    train_microbatch: int = 32
    # R of the compacted step (mask present); 0/None: train_microbatch
    train_microbatch_compact: int = 1
    # ray-consecutive samples per density group, under the grouping guard
    train_density_group: int = 2
    train_compute_dtype: str = "fp32"
    # compacted train samples per ray once a mask exists (0: always dense)
    train_compact_k: int = 64
    # depth-anchored window: band in march steps behind the supervised depth
    train_depth_cap_band: int = 6
    seed: int = 1024


def _resolve_group(cfg: TrainConfig, aabb, reso, step_ratio):
    """(density_group, density_block) under the grouping_block drift guard."""
    group, block = 1, 4
    if cfg.train_density_group > 1 and not cfg.ndc_ray:
        b = tf.grouping_block(aabb, reso, step_ratio, group=cfg.train_density_group)
        if b:
            group, block = cfg.train_density_group, b
    return group, block


def _initial_loss_weights(cfg: TrainConfig) -> ts.LossWeights:
    return ts.LossWeights(
        tv_density=cfg.tv_weight_density, tv_app=cfg.tv_weight_app,
        l1=cfg.l1_weight, ortho=cfg.ortho_weight,
    )


def _step_kwargs(cfg: TrainConfig, *, n_samples, group, block, white_bg, weights=None):
    """The make_train_step keyword arguments the trainer builds its step
    with."""
    return dict(
        n_samples=n_samples, app_k=cfg.app_k, white_bg=white_bg,
        ndc=cfg.ndc_ray,
        weights=_initial_loss_weights(cfg) if weights is None else weights,
        depth_loss_type=cfg.depth_loss_type,
        density_group=group, density_block=block,
        compute_dtype=cfg.train_compute_dtype,
        compact_k=cfg.train_compact_k,
        depth_cap_band=cfg.train_depth_cap_band,
        runtime_decay=True, lr_init=cfg.lr_init, lr_basis=cfg.lr_basis,
        microbatch=ts.effective_microbatch(cfg.batch_size, cfg.train_microbatch),
        microbatch_compact=(
            ts.effective_microbatch(cfg.batch_size, cfg.train_microbatch_compact)
            if cfg.train_microbatch_compact
            else None
        ),
    )
