"""The trainer (port of ``text2nerf_tpu/engine/trainer.py``): the
progressive fit :func:`reconstruction` and the render-only entry
:func:`render_test`.

:func:`reconstruction` bootstraps the scene (the seed RGBD and its warped
support set), then trains the field in three stages:

- stage 1: ``n_stage1`` epochs over the seed's support pool, dense train
  steps;
- stage 2: for each later trajectory view, expand the scene
  (:func:`.expansion.expand_scene` on the current field), reset the
  optimizer and the LR schedule, then ``n_stage2`` epochs drawing four
  batches of five from the new view's pool and one from the replay pool
  of the earlier views;
- stage 3: ``n_stage3`` epochs over every view's pool, uniformly or
  (``stage3_balance="tail_deficit"``) one view a batch, drawn by
  :func:`stage3_view_weights`.

Past stage 1 the steps are compacted once a stage boundary has built a
mask the group-strided occupancy test may use, the mask stamped with the
supervised depths of the new and the replay pools.  Inside the epochs the
coarse-to-fine milestones (``upsamp_list``) resize the grid and the first
``update_alphamask_list`` milestone shrinks the AABB; every milestone
refilters the pools through a fresh alpha mask.  Stage boundaries rebuild
the mask and evaluate the support views and the generated views, culling
at the scene's supervised z-floor; the end writes the final mask and
checkpoint and the optional train, test and path renders (videos as
uncompressed AVIs where no encoder package is installed), and waits for
the expansion's artifact writes.

Crash-safe resume (``resume``): every stage-2 boundary, and every
``resume_every_epochs`` epochs, writes ``<expname>_resume.npz`` (the
field and the loop state) and ``scene_snapshot.npz`` atomically, in the
JAX package's format, so a run killed in one package resumes in either.
A resumed run skips the bootstrap, rebuilds the pools of the views done
from the snapshot and, mid-stage, the in-flight stage's pools, samplers,
schedule and mask; Adam's moments restart, and the step generator
restarts from ``cfg.seed`` as the JAX trainer's key does.  The sample
count is recomputed from the restored grid, as in the JAX trainer: a run
resumed after the first alpha-mask milestone's shrink marches fewer
samples than the fit did (the reference's behaviour, kept for parity).

Left out, each raising ``NotImplementedError`` before any work:
``checkpoint_backend="orbax"``, ``ndc_ray`` and the bf16 train step.

The JAX trainer overlaps the first train step's XLA compile with the
bootstrap in a warm-up thread that swallows its failures.  PyTorch
compiles nothing ahead of a step (the CUDA kernels are built once per
checkout, at first launch), so there is nothing to overlap: no thread.

Randomness: the initial field draws from a ``torch.Generator`` seeded
with ``cfg.seed``; the steps' jitter and background coins from another,
seeded likewise, on the step's device.  The JAX key stream is not
reproduced; the samplers and the expansion's services (numpy, seeded as
in JAX) give the same ids and candidates.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..data import scene_state as ss
from ..device import as_tensor, resolve_device
from ..models import tensorf as tf
from ..ops import render as render_ops
from ..services.registry import Services, default_services
from . import checkpoints as ckpt
from . import expansion as exp
from . import io_async
from . import renderer as eval_renderer
from . import train_step as ts
from .tracing import MetricsLogger, phase_timer


@dataclasses.dataclass
class TrainConfig:
    """The training-schedule flags, with the JAX package's defaults."""

    expname: str = "exp"
    basedir: str = "./log"
    n_stage1: int = 50
    n_stage2: int = 50
    batch_size: int = 16384
    lr_init: float = 0.02
    lr_basis: float = 1e-3
    lr_decay_iters: int = -1
    lr_decay_target_ratio: float = 0.1
    tv_weight_density: float = 0.1
    tv_weight_app: float = 0.01
    l1_weight: float = 0.0
    ortho_weight: float = 0.0
    n_voxel_init: int = 27_000_000
    n_samples_cap: int = 10 ** 6
    app_k: int = 64
    ndc_ray: bool = False
    eval_every_epochs: int = 50
    ckpt: Optional[str] = None
    render_test: bool = False
    render_path: bool = False
    render_train: bool = False
    n_stage3: int = 10
    n_vis: int = -1
    # boundary preview renders of the support views
    vis_support_views: bool = True
    progress_refresh_rate: int = 50
    # L1 weight after the first alpha-mask update
    l1_weight_rest: float = 0.0
    add_timestamp: bool = False
    depth_loss_type: str = "mse"
    # eval renders: -1 the adaptive compacted renderer once a mask exists,
    # K > 0 a fixed compacted K, 0 dense
    eval_compact_k: int = -1
    # pool dilation of the stage-boundary mask; >= 5 licenses the
    # group-2 strided occupancy test of the compacted train step
    eval_mask_pool: int = 3
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
    # stage-3 sampling: 'uniform', or 'tail_deficit' (one view per batch,
    # drawn by stage3_view_weights)
    stage3_balance: str = "uniform"
    stage3_balance_gamma: float = 1.0
    seed: int = 1024
    model: tf.TensoRFConfig = dataclasses.field(default_factory=tf.TensoRFConfig)
    # coarse-to-fine: global steps at which the grid grows toward
    # n_voxel_final (log-spaced voxel counts) and the alpha mask is rebuilt
    n_voxel_final: int = 27_000_000
    upsamp_list: Tuple[int, ...] = ()
    update_alphamask_list: Tuple[int, ...] = ()
    lr_upsample_reset: bool = True
    resume_every_epochs: int = 0
    resume: bool = False
    checkpoint_backend: str = "npz"


def eval_boundary(epoch: int, n_stage1: int, n_stage2: int, eval_every: int) -> bool:
    """Is the epoch that just finished (0-indexed) an eval boundary: every
    ``eval_every`` epochs, the end of stage 1, and each stage-2 view
    boundary strictly past stage 1 (Python's floored modulo would fire
    the view term mid-stage-1 too)."""
    e1 = epoch + 1
    return (
        e1 % eval_every == 0
        or (n_stage2 > 0 and e1 > n_stage1 and (e1 - n_stage1) % n_stage2 == 0)
        or e1 == n_stage1
    )


def _epoch_iters(n_rays: int, batch: int) -> int:
    return n_rays // batch + int(n_rays % batch > 0)


def stage3_view_weights(cfg: TrainConfig, lengths, iters1: int) -> np.ndarray:
    """Per-view stage-3 sampling weights ∝ (1 / epochs the view's content
    has been trained when stage 3 starts)^gamma: E_0 = n_stage1 +
    (V-1)·n_stage2 + n_stage3 for the seed view, E_u = (V-u)·n_stage2 +
    n_stage3 for generated view u.  ``iters1`` is unused (kept for the
    JAX signature)."""
    del iters1
    lengths = np.asarray(lengths, np.float64)
    v_n = len(lengths)
    epochs = np.zeros(v_n)
    epochs[0] = cfg.n_stage1 + (v_n - 1) * cfg.n_stage2 + cfg.n_stage3
    for u in range(1, v_n):
        epochs[u] = (v_n - u) * cfg.n_stage2 + cfg.n_stage3
    w = np.zeros(v_n)
    ok = (epochs > 0) & (lengths > 0)
    w[ok] = (1.0 / epochs[ok]) ** cfg.stage3_balance_gamma
    if w.sum() <= 0:
        w[lengths > 0] = 1.0
    return w / w.sum()


def _batch_from_pool(pool, ids, device):
    rays, rgbs, depths = pool
    return {
        "rays": as_tensor(rays[ids], device),
        "rgb": as_tensor(rgbs[ids], device),
        "depth": as_tensor(depths[ids], device),
    }


class _WeightedViewSampler:
    """Stage-3 batch source for ``stage3_balance="tail_deficit"``: each
    batch comes from one view's pool, the view drawn ∝ ``weights``;
    within a view, permutation sampling (a pool smaller than a batch is
    drawn with replacement)."""

    def __init__(self, pools, weights, batch: int, seed: int, device):
        self.pools = pools
        self.weights = np.asarray(weights, np.float64)
        self.batch = int(batch)
        self.device = device
        self.samplers = [
            ts.PermutationSampler(len(p[0]), batch, seed + 31 * i)
            if len(p[0]) >= batch else None
            for i, p in enumerate(pools)
        ]
        self._rng = np.random.default_rng(seed)

    def next_batch(self):
        v = int(self._rng.choice(len(self.pools), p=self.weights))
        if self.samplers[v] is not None:
            ids = self.samplers[v].next_ids()
        else:
            ids = self._rng.integers(0, len(self.pools[v][0]), self.batch)
        return _batch_from_pool(self.pools[v], ids, self.device)


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


def stamped_train_mask(eval_mask, pool_new, pool_pre):
    """The train-compaction mask: ``eval_mask`` with every supervised depth
    band of the in-flight view's pool and of the replay pool stamped live
    (tf.stamp_alpha_mask), so compaction never freezes the support where
    some training ray's own depth says content must grow.  Pools are
    ``(rays, rgbs, depths)`` tuples or None."""
    m = eval_mask
    for pool in (pool_new, pool_pre):
        if pool is not None and len(pool[0]) > 0:
            m = tf.stamp_alpha_mask(m, pool[0], pool[2])
    return m


def init_field(cfg: TrainConfig, scene: ss.SceneState, generator=None, device=None):
    """(model cfg, field, aabb, alpha mask or None): the warm start of
    ``cfg.ckpt`` when it exists, else a field at ``n_voxel_init`` over the
    scene box drawn from ``generator`` (a ``torch.Generator`` on
    ``device`` seeded with ``cfg.seed`` when None)."""
    dev = resolve_device(device)
    if cfg.ckpt and os.path.exists(cfg.ckpt):
        mcfg, field, aabb, alpha_mask, _ = ckpt.load_checkpoint(cfg.ckpt, device=dev)
        return mcfg, field, aabb, alpha_mask
    reso = tf.n_to_reso(cfg.n_voxel_init, scene.scene_bbox)
    gen = generator or torch.Generator(device=dev).manual_seed(cfg.seed)
    field = tf.init_params(cfg.model, reso, generator=gen, device=dev)
    return cfg.model, field, as_tensor(scene.scene_bbox, dev), None


def _check_ported(cfg: TrainConfig) -> None:
    if cfg.checkpoint_backend != "npz":
        raise NotImplementedError(
            f"checkpoint_backend={cfg.checkpoint_backend!r}: only 'npz' is ported")
    if cfg.ndc_ray:
        raise NotImplementedError("NDC rays are not ported yet")
    if cfg.train_compute_dtype != "fp32":
        raise NotImplementedError(
            f"train_compute_dtype={cfg.train_compute_dtype!r}: the bf16 backward is not "
            "ported yet")


def log_folder(cfg: TrainConfig, scene_cfg: ss.SceneConfig) -> str:
    """The run's log folder (where a resumed run finds its resume point),
    before ``add_timestamp``'s suffix."""
    return os.path.join(
        cfg.basedir,
        f"{cfg.expname}_{scene_cfg.prompt.replace(' ', '_')}"
        f"_{scene_cfg.angle}_{scene_cfg.trans_range}",
    )


def reconstruction(cfg: TrainConfig, scene_cfg: ss.SceneConfig,
                   services: Optional[Services] = None,
                   expansion_cfg: Optional[exp.ExpansionConfig] = None, *, device=None):
    """The progressive fit (see the module docstring).  Runs on ``device``
    (cuda unless asked); the default services run there too.  Logs to
    ``<logfolder>/metrics.jsonl``.  Returns (model_cfg, field, aabb,
    scene, logfolder)."""
    dev = resolve_device(device)
    expansion_cfg = expansion_cfg or exp.ExpansionConfig(
        prompt=scene_cfg.prompt, push_depth=scene_cfg.push_depth,
        trans_range=scene_cfg.trans_range,
    )
    _check_ported(cfg)
    services = services or default_services(hw=scene_cfg.hw, device=dev)
    logfolder = log_folder(cfg, scene_cfg)
    if cfg.add_timestamp:
        import datetime

        logfolder += datetime.datetime.now().strftime("-%Y%m%d-%H%M%S")
    os.makedirs(logfolder, exist_ok=True)
    with open(os.path.join(logfolder, "args.txt"), "w") as f:
        for k, v in {**dataclasses.asdict(cfg), **dataclasses.asdict(scene_cfg)}.items():
            f.write(f"{k}:{v}\n")
    log = MetricsLogger(os.path.join(logfolder, "metrics.jsonl"))
    try:
        out = _fit(cfg, scene_cfg, services, expansion_cfg, dev, logfolder, log)
    finally:
        log.close()
    # the expansion's artifact writes of this run, on disk before it returns
    io_async.flush(logfolder)
    return out


def _save_resume(cfg, logfolder, scene, field, aabb, loop_state):
    """The resume point: the scene snapshot, then the field with its loop
    state (both atomic; the JAX trainer's file names and keys)."""
    ss.save_scene_snapshot(os.path.join(logfolder, "scene_snapshot.npz"), scene)
    ckpt.save_checkpoint(os.path.join(logfolder, f"{cfg.expname}_resume.npz"), field, aabb,
                         loop_state=loop_state)


def _fit(cfg, scene_cfg, services, expansion_cfg, dev, logfolder, log):
    resume_ckpt = os.path.join(logfolder, f"{cfg.expname}_resume.npz")
    resume_snap = os.path.join(logfolder, "scene_snapshot.npz")
    resume_state = None
    if cfg.resume and os.path.exists(resume_ckpt) and os.path.exists(resume_snap):
        mcfg, field, aabb, _, resume_state = ckpt.load_checkpoint(resume_ckpt, device=dev)
        scene = ss.load_scene_snapshot(
            resume_snap, n_views_pools=resume_state["next_view"],
            trans_range=scene_cfg.trans_range, use_support_set=scene_cfg.use_support_set,
            device=dev,
        )
        log.scalars(0, {"resume_epoch": resume_state["epoch"]})
    else:
        with phase_timer("bootstrap", log, dev):
            scene = ss.bootstrap_scene(
                scene_cfg, "train", text2img=services.text2img,
                estimate_depth=services.estimate_depth, log=log, device=dev,
            )
        mcfg, field, aabb, _ = init_field(cfg, scene, device=dev)
    white_bg = scene.white_bg
    n_samples = tf.default_n_samples(tf.grid_resolution(field), mcfg.step_ratio,
                                     cfg.n_samples_cap)

    # rays that miss the box never train
    keep = render_ops.filter_rays_bbox(aabb, scene.all_rays, device=dev)
    pool_pre = (scene.all_rays[keep], scene.all_rgbs[keep], scene.all_depth[keep])
    sampler_pre = ts.PermutationSampler(len(pool_pre[0]), cfg.batch_size, cfg.seed)
    n_iters_epoch1 = _epoch_iters(len(pool_pre[0]), cfg.batch_size)
    n_iters_stage1 = cfg.n_stage1 * n_iters_epoch1
    decay_iters = (
        cfg.lr_decay_iters if cfg.lr_decay_iters > 0
        else (n_iters_stage1 if n_iters_stage1 > 0 else 1000)
    )
    factor = ts.lr_factor(cfg.lr_decay_target_ratio, decay_iters)
    log.scalars(0, {"pool_rays": len(pool_pre[0]), "iters_per_epoch": n_iters_epoch1,
                    "grid": list(tf.grid_resolution(field))})
    weights = _initial_loss_weights(cfg)
    step_rng = torch.Generator(device=dev).manual_seed(cfg.seed)

    def current_group():
        return _resolve_group(cfg, aabb.cpu(), tf.grid_resolution(state.field),
                              mcfg.step_ratio)

    def make_step(opt):
        group, block = current_group()
        return ts.make_train_step(
            mcfg, opt, device=dev,
            **_step_kwargs(cfg, n_samples=n_samples, group=group, block=block,
                           white_bg=white_bg, weights=weights),
        )

    tm_cache = {}

    def train_mask_arg():
        """The stamped mask for train compaction, or None: compaction off,
        no mask yet, stage 1 (the seed content is still growing), or a
        mask whose dilation cannot license the group-strided occupancy
        test.  Memoized on the identities of the mask, the pools and the
        aabb (every rebuild, pool change or shrink re-stamps)."""
        if cfg.train_compact_k <= 0 or eval_mask is None or epoch < cfg.n_stage1:
            return None
        mkey = (id(eval_mask), id(pool_new), id(pool_pre), id(aabb))
        if mkey not in tm_cache:
            g, _ = current_group()
            ok = g == 1 or render_ops.occupancy_stride_safe(state.field, aabb, eval_mask, g)
            tm_cache.clear()
            tm_cache[mkey] = stamped_train_mask(eval_mask, pool_new, pool_pre) if ok else None
        return tm_cache[mkey]

    def render_mask():
        """The mask for eval and expansion renders: only when eval
        compaction is on."""
        return eval_mask if cfg.eval_compact_k != 0 else None

    def rebuild_eval_mask():
        if cfg.eval_compact_k == 0 and cfg.train_compact_k <= 0:
            return None
        mask_reso = tuple(min(r, 200) for r in tf.grid_resolution(state.field))
        mask, _ = tf.update_alpha_mask(state.field, aabb, mask_reso,
                                       pool=cfg.eval_mask_pool, device=dev)
        return mask

    zf_cache = {}

    def eval_z_floor():
        """The scene's supervised z-floor, recomputed as views are added."""
        k = scene.rgbs_gen_split.shape[0]
        if k not in zf_cache:
            zf_cache[k] = ss.supervised_z_floor(scene)
        return zf_cache[k]

    def build_stage3_sampler(n_views_done: int, seed: int):
        if cfg.stage3_balance != "tail_deficit":
            return None
        pools = [scene.updates["%05d" % v] for v in range(n_views_done)]
        w = stage3_view_weights(cfg, [len(p[0]) for p in pools], n_iters_epoch1)
        log.scalars(0, {"stage3_weight_view%d" % v: float(w[v]) for v in range(len(w))})
        return _WeightedViewSampler(pools, w, cfg.batch_size, seed, dev)

    state, opt = ts.make_train_state(field, cfg.lr_init, cfg.lr_basis, factor,
                                     runtime_decay=True)
    step_fn = make_step(opt)

    n_views = scene.poses_gen.shape[0]
    # n_stage2 = 0: the seed fit alone, no expansion
    n_total = cfg.n_stage1 + cfg.n_stage2 * (n_views - 1)
    tv_decay = 1.0
    lr_decay = 1.0  # factor**steps since the last schedule reset
    view_idx = 0
    eval_mask = None
    pool_new = sampler_new = sampler_s3 = None
    n_iters_epoch = n_iters_epoch1
    global_step = 0
    start_epoch = 0
    stage_step = 0  # steps since the last optimizer and schedule reset
    if resume_state is not None:
        start_epoch = int(resume_state["epoch"])
        view_idx = int(resume_state["next_view"]) - 1
        tv_decay = float(resume_state.get("tv_decay", 1.0))
        global_step = int(resume_state.get("global_step", 0))
        stage_step = int(resume_state.get("stage_step", 0))
        # a boundary resume: the loop's own boundary code rebuilds the
        # pools, the samplers and the schedule
        at_boundary = (cfg.n_stage2 > 0 and start_epoch >= cfg.n_stage1
                       and (start_epoch - cfg.n_stage1) % cfg.n_stage2 == 0
                       and start_epoch < n_total)
        # the L1 switch keys on global_step and does not fire again past
        # the first alpha-mask milestone: apply it before any step rebuild
        l1_switched = bool(cfg.update_alphamask_list
                           and global_step > cfg.update_alphamask_list[0])
        if l1_switched:
            weights = weights._replace(l1=cfg.l1_weight_rest)
        if start_epoch > 0 and not at_boundary:
            # mid-stage: rebuild the in-flight stage's pools and schedule
            stage3_entry = False
            if start_epoch >= n_total:
                # stage 3: every view's pool folded into the replay pool
                allp = [scene.updates["%05d" % v] for v in range(view_idx + 1)]
                pool_pre = tuple(np.concatenate(x, 0) for x in zip(*allp))
                pool_new = sampler_new = None
                sampler_s3 = build_stage3_sampler(view_idx + 1, cfg.seed + start_epoch + 7)
                n_iters_epoch = _epoch_iters(len(pool_pre[0]), cfg.batch_size)
                decay_iters = n_iters_epoch * max(cfg.n_stage3, 1)
                # a save at the last stage-2 epoch resumes at n_total, where
                # the live fold (and its schedule reset) is behind us
                stage3_entry = start_epoch == n_total
            elif start_epoch > cfg.n_stage1 and cfg.n_stage2 > 0:
                # mid-stage 2 of view view_idx
                prev = [scene.updates["%05d" % v] for v in range(view_idx)]
                pool_pre = tuple(np.concatenate(x, 0) for x in zip(*prev))
                pool_new = scene.updates["%05d" % view_idx]
                sampler_new = (
                    ts.PermutationSampler(len(pool_new[0]), cfg.batch_size,
                                          cfg.seed + start_epoch + 1)
                    if len(pool_new[0]) > 0 else None
                )
                n_iters_epoch = _epoch_iters(len(pool_new[0]), cfg.batch_size) + n_iters_epoch1
                decay_iters = n_iters_epoch * cfg.n_stage2
            else:
                # mid-stage 1: the pools stand; the stage-1 decay
                decay_iters = (
                    cfg.lr_decay_iters if cfg.lr_decay_iters > 0
                    else (n_iters_stage1 if n_iters_stage1 > 0 else 1000)
                )
            factor = ts.lr_factor(cfg.lr_decay_target_ratio, decay_iters)
            if l1_switched:
                # the first alpha-mask milestone's pool filtering, again,
                # through a mask of the restored field
                mask_reso = tuple(min(r, 200) for r in tf.grid_resolution(field))
                mask_r, _ = tf.update_alpha_mask(field, aabb, mask_reso, device=dev)
                keep = render_ops.filter_rays_alpha(aabb, pool_pre[0], mask_r, device=dev)
                if keep.any() and not keep.all():
                    pool_pre = tuple(p[keep] for p in pool_pre)
                if pool_new is not None and len(pool_new[0]) > 0:
                    keep = render_ops.filter_rays_alpha(aabb, pool_new[0], mask_r, device=dev)
                    if keep.any() and not keep.all():
                        pool_new = tuple(p[keep] for p in pool_new)
                        sampler_new = ts.PermutationSampler(
                            len(pool_new[0]), cfg.batch_size, cfg.seed + start_epoch + 1)
            sampler_pre = ts.PermutationSampler(len(pool_pre[0]), cfg.batch_size,
                                                cfg.seed + start_epoch)
            state, opt = ts.make_train_state(state.field, cfg.lr_init, cfg.lr_basis, factor,
                                             runtime_decay=True)
            # the decayed LR as saved (Adam restarts with fresh moments)
            if stage3_entry:
                stage_step, lr_decay = 0, 1.0
            else:
                lr_decay = float(resume_state.get("lr_decay", factor ** stage_step))
            step_fn = make_step(opt)
            if start_epoch >= cfg.n_stage1 and (cfg.train_compact_k > 0
                                                or cfg.eval_compact_k != 0):
                # stage 2 or 3: the compacted paths need the mask again
                eval_mask = rebuild_eval_mask()

    def loop_state(epoch_next, next_view):
        return {"epoch": epoch_next, "next_view": next_view, "tv_decay": tv_decay,
                "global_step": global_step, "stage_step": stage_step, "lr_decay": lr_decay}

    for epoch in range(start_epoch, n_total + cfg.n_stage3):
        # --- stage boundary: expand the scene by one view -----------------
        if (cfg.n_stage2 > 0 and epoch >= cfg.n_stage1
                and (epoch - cfg.n_stage1) % cfg.n_stage2 == 0 and epoch < n_total):
            view_idx = (epoch - cfg.n_stage1) // cfg.n_stage2 + 1
            if cfg.resume:
                # the boundary's resume point, before the expansion
                _save_resume(cfg, logfolder, scene, state.field, aabb,
                             loop_state(epoch, view_idx))
            # the field just fitted the earlier views: a fresh mask for the
            # expansion's renders and the next evals
            eval_mask = rebuild_eval_mask()
            with phase_timer(f"expand_view_{view_idx}", log, dev):
                scene = exp.expand_scene(
                    view_idx, state.field, scene, services, expansion_cfg, logfolder,
                    n_samples=n_samples, white_bg=white_bg, seed=cfg.seed + view_idx,
                    alpha_mask=render_mask(), compact_k=cfg.eval_compact_k,
                    eval_z_min=eval_z_floor(), log=log, device=dev,
                )
            # the replay pool: every earlier view's pool
            prev = [scene.updates["%05d" % v] for v in range(view_idx)]
            pool_pre = tuple(np.concatenate(x, 0) for x in zip(*prev))
            sampler_pre = ts.PermutationSampler(len(pool_pre[0]), cfg.batch_size,
                                                cfg.seed + epoch)
            pool_new = scene.updates["%05d" % view_idx]
            sampler_new = (
                ts.PermutationSampler(len(pool_new[0]), cfg.batch_size, cfg.seed + epoch + 1)
                if len(pool_new[0]) > 0 else None
            )
            n_iters_epoch = _epoch_iters(len(pool_new[0]), cfg.batch_size) + n_iters_epoch1
            # optimizer and schedule reset
            decay_iters = n_iters_epoch * cfg.n_stage2
            factor = ts.lr_factor(cfg.lr_decay_target_ratio, decay_iters)
            state, opt = ts.make_train_state(state.field, cfg.lr_init, cfg.lr_basis, factor,
                                             runtime_decay=True)
            step_fn = make_step(opt)
            stage_step, lr_decay = 0, 1.0
            log.scalars(global_step, {"view": view_idx, "pool_new_rays": len(pool_new[0]),
                                      "pool_replay_rays": len(pool_pre[0]),
                                      "iters_per_epoch": n_iters_epoch})
        elif epoch == n_total and pool_new is not None:
            # stage 3: fold the last view's pool into the replay pool
            pool_pre = tuple(np.concatenate([a, b], 0) for a, b in zip(pool_pre, pool_new))
            sampler_pre = ts.PermutationSampler(len(pool_pre[0]), cfg.batch_size,
                                                cfg.seed + epoch)
            pool_new = None
            sampler_s3 = build_stage3_sampler(n_views, cfg.seed + epoch + 7)
            n_iters_epoch = _epoch_iters(len(pool_pre[0]), cfg.batch_size)
            decay_iters = n_iters_epoch * max(cfg.n_stage3, 1)
            factor = ts.lr_factor(cfg.lr_decay_target_ratio, decay_iters)
            state, opt = ts.make_train_state(state.field, cfg.lr_init, cfg.lr_basis, factor,
                                             runtime_decay=True)
            step_fn = make_step(opt)
            stage_step, lr_decay = 0, 1.0

        # --- epoch -----------------------------------------------------------
        for it in range(n_iters_epoch):
            if cfg.upsamp_list and global_step in cfg.upsamp_list:
                # coarse-to-fine: log-spaced voxel counts toward n_voxel_final
                n_voxels = int(np.exp(np.linspace(
                    np.log(cfg.n_voxel_init), np.log(cfg.n_voxel_final),
                    len(cfg.upsamp_list) + 1,
                ))[list(cfg.upsamp_list).index(global_step) + 1])
                reso = tf.n_to_reso(n_voxels, aabb.cpu())
                field_up = tf.upsample_volume_grid(state.field, reso)
                n_samples = tf.default_n_samples(reso, mcfg.step_ratio, cfg.n_samples_cap)
                state, opt = ts.make_train_state(field_up, cfg.lr_init, cfg.lr_basis,
                                                 factor, runtime_decay=True)
                # lr_upsample_reset=False continues at the decayed rate
                lr_decay = 1.0 if cfg.lr_upsample_reset else tv_decay
                step_fn = make_step(opt)
                stage_step = 0
                log.scalars(global_step, {"upsample_grid": list(reso),
                                          "n_samples": n_samples})
            if cfg.update_alphamask_list and global_step in cfg.update_alphamask_list:
                mask_reso = tuple(min(r, 200) for r in tf.grid_resolution(state.field))
                alpha_mask, new_aabb = tf.update_alpha_mask(state.field, aabb, mask_reso,
                                                            device=dev)
                if global_step == cfg.update_alphamask_list[0]:
                    # the first update shrinks the box and resets the optimizer
                    field_sh, aabb, grid = tf.shrink(state.field, aabb, new_aabb)
                    state, opt = ts.make_train_state(field_sh, cfg.lr_init, cfg.lr_basis,
                                                     factor, runtime_decay=True)
                    stage_step, lr_decay = 0, 1.0
                    weights = weights._replace(l1=cfg.l1_weight_rest)
                    step_fn = make_step(opt)
                    log.scalars(global_step, {"shrink_aabb": aabb.cpu().tolist(),
                                              "shrink_grid": list(grid)})
                # rays that never touch occupied space stop training
                keep = render_ops.filter_rays_alpha(aabb, pool_pre[0], alpha_mask, device=dev)
                if keep.any() and not keep.all():
                    pool_pre = tuple(p[keep] for p in pool_pre)
                    sampler_pre = ts.PermutationSampler(
                        len(pool_pre[0]), cfg.batch_size, cfg.seed + global_step)
                if pool_new is not None:
                    keep = render_ops.filter_rays_alpha(aabb, pool_new[0], alpha_mask,
                                                        device=dev)
                    if keep.any() and not keep.all():
                        pool_new = tuple(p[keep] for p in pool_new)
                        sampler_new = ts.PermutationSampler(
                            len(pool_new[0]), cfg.batch_size, cfg.seed + global_step + 1)
                log.scalars(global_step, {"alpha_mask_pool_rays": len(pool_pre[0])})
            # four batches of five from the new view, one from the replay pool
            if view_idx == 0 or it % 5 == 0 or epoch >= n_total or sampler_new is None:
                if sampler_s3 is not None and epoch >= n_total:
                    batch = sampler_s3.next_batch()
                else:
                    batch = _batch_from_pool(pool_pre, sampler_pre.next_ids(), dev)
            else:
                batch = _batch_from_pool(pool_new, sampler_new.next_ids(), dev)
            state, metrics = step_fn(state, aabb, batch, step_rng, tv_decay,
                                     alpha_mask=train_mask_arg(), lr_decay=lr_decay)
            tv_decay *= factor
            lr_decay *= factor
            global_step += 1
            stage_step += 1
            if global_step % max(cfg.progress_refresh_rate, 1) == 0:
                log.scalars(global_step, {m: float(metrics[m])
                                          for m in ("psnr", "mse", "depth_loss")})

        # --- stage-boundary mask and evals -------------------------------
        if eval_boundary(epoch, cfg.n_stage1, cfg.n_stage2, cfg.eval_every_epochs):
            eval_mask = rebuild_eval_mask()
            with phase_timer(f"eval_epoch{epoch + 1:04d}", log, dev):
                kw = dict(
                    n_samples=n_samples, prefix=f"epoch{epoch + 1:04d}_",
                    chunk=cfg.batch_size, app_k=cfg.app_k, white_bg=white_bg,
                    ndc=cfg.ndc_ray, push_depth=scene_cfg.push_depth,
                    near_far=scene.near_far, alpha_mask=render_mask(),
                    compact_k=cfg.eval_compact_k if eval_mask is not None else 0,
                    eval_z_min=eval_z_floor(), n_vis=cfg.n_vis, device=dev,
                )
                if cfg.vis_support_views and len(scene.rays_support_split) > 0:
                    # previews of the support views: no ground truth
                    eval_renderer.evaluation(
                        state.field, aabb, scene.rays_support_split, scene.hw,
                        gt_rgbs=None,
                        save_path=os.path.join(logfolder, "imgs_vis_support_view"), **kw)
                n_gen = scene.rgbs_gen_split.shape[0]
                if n_gen > 0:
                    res = eval_renderer.evaluation(
                        state.field, aabb, scene.rays_gen_split[:n_gen], scene.hw,
                        gt_rgbs=scene.rgbs_gen_split,
                        save_path=os.path.join(logfolder, "imgs_vis_inpaint_view"), **kw)
                    if res["psnr"]:
                        log.scalars(global_step, {"eval_psnr": float(np.mean(res["psnr"]))})

        # --- periodic resume point: a kill inside a long stage loses at
        # most resume_every_epochs epochs
        if (cfg.resume and cfg.resume_every_epochs > 0
                and (epoch + 1) % cfg.resume_every_epochs == 0
                and epoch + 1 < n_total + cfg.n_stage3):
            _save_resume(cfg, logfolder, scene, state.field, aabb,
                         loop_state(epoch + 1, view_idx + 1))

    # final mask: saved into the checkpoint and used by the final renders
    eval_mask = rebuild_eval_mask()
    final = dict(
        n_samples=n_samples, white_bg=white_bg, ndc=cfg.ndc_ray, near_far=scene.near_far,
        alpha_mask=render_mask(),
        compact_k=cfg.eval_compact_k if eval_mask is not None else 0,
        eval_z_min=eval_z_floor(), device=dev,
    )
    ckpt.save_checkpoint(
        os.path.join(logfolder, f"{cfg.expname}_final.npz"), state.field, aabb,
        alpha_mask=render_mask(),
        loop_state={"view_idx": view_idx, "global_step": global_step},
    )
    if cfg.render_train:
        eval_renderer.evaluation(
            state.field, aabb, scene.rays_gen_split[: scene.rgbs_gen_split.shape[0]],
            scene.hw, gt_rgbs=scene.rgbs_gen_split,
            save_path=os.path.join(logfolder, "imgs_train_all"), chunk=cfg.batch_size,
            app_k=cfg.app_k, video=True, push_depth=scene_cfg.push_depth,
            n_vis=cfg.n_vis, **final,
        )
    if cfg.render_test or cfg.render_path:
        test_scene = ss.bootstrap_scene(
            scene_cfg, "test", text2img=services.text2img,
            estimate_depth=services.estimate_depth, device=dev,
        )
        if cfg.render_test:
            eval_renderer.evaluation(
                state.field, aabb, test_scene.rays_gen_split, scene.hw,
                save_path=os.path.join(logfolder, "imgs_test_all"), chunk=cfg.batch_size,
                app_k=cfg.app_k, video=True, push_depth=scene_cfg.push_depth,
                n_vis=cfg.n_vis, **final,
            )
        if cfg.render_path:
            eval_renderer.evaluation_path(
                state.field, aabb, test_scene.render_path, scene.hw, scene.intrinsic,
                save_path=os.path.join(logfolder, "imgs_path_all"), **final,
            )
    return mcfg, state.field, aabb, scene, logfolder


def render_test(cfg: TrainConfig, scene_cfg: ss.SceneConfig, *, device=None):
    """Render-only entry from the checkpoint ``cfg.ckpt``: the test split
    (``cfg.render_test``) and the camera path (``cfg.render_path``).  A
    checkpointed mask routes the renders through the adaptive renderer.
    The eval z-cull is the supervised z-floor of the ``scene_snapshot.npz``
    beside the checkpoint when there is one, else the reference's
    constant 2.0.  Returns {'test': ..., 'path': ...}."""
    dev = resolve_device(device)
    if not (cfg.ckpt and os.path.exists(cfg.ckpt)):
        raise FileNotFoundError(f"render_test needs a checkpoint, got ckpt={cfg.ckpt!r}")
    mcfg, field, aabb, alpha_mask, _ = ckpt.load_checkpoint(cfg.ckpt, device=dev)
    field.requires_grad_(False)
    scene = ss.bootstrap_scene(scene_cfg, "test", device=dev)
    n_samples = tf.default_n_samples(tf.grid_resolution(field), mcfg.step_ratio,
                                     cfg.n_samples_cap)
    logfolder = os.path.dirname(cfg.ckpt)
    z_floor = 2.0
    snap = os.path.join(logfolder, "scene_snapshot.npz")
    if os.path.exists(snap):
        z_floor = ss.supervised_z_floor(ss.load_scene_snapshot(snap))
    kw = dict(n_samples=n_samples, white_bg=scene.white_bg, ndc=cfg.ndc_ray,
              near_far=scene.near_far, alpha_mask=alpha_mask,
              compact_k=-1 if alpha_mask is not None else 0, eval_z_min=z_floor, device=dev)
    out = {}
    if cfg.render_test:
        out["test"] = eval_renderer.evaluation(
            field, aabb, scene.rays_gen_split, scene.hw,
            save_path=os.path.join(logfolder, "imgs_test_all"), chunk=cfg.batch_size,
            app_k=cfg.app_k, video=True, push_depth=scene_cfg.push_depth,
            n_vis=cfg.n_vis, **kw,
        )
    if cfg.render_path:
        out["path"] = eval_renderer.evaluation_path(
            field, aabb, scene.render_path, scene.hw, scene.intrinsic,
            save_path=os.path.join(logfolder, "imgs_path_all"), **kw,
        )
    return out
