"""The TensoRF train step (port of ``text2nerf_tpu/engine/train_step.py``).

- Adam (betas 0.9, 0.99, eps 1e-8) with two parameter groups: the factor
  planes and lines at ``lr_init`` (0.02), the basis and the head at
  ``lr_basis`` (1e-3).
- Per-step exponential decay, lr(t) = lr0 · factor**t, either embedded in
  the optimizer's groups or, with ``runtime_decay``, from the step's
  ``lr_decay`` argument.  A stage boundary rebuilds the state.
- Loss = mse(rgb) + 0.005 · depth term + 1e3 · transmittance-mask loss
  (margin 0.1 before the supervised depth) + decayed TV regularizers.

The field is updated in place (PyTorch parameters), and after a step its
``.grad`` holds the gradient that step applied.  The forward and backward
of the factor features run kernels A and A' (``vm_split``, ``vm``) or C
and C' (``cp``) on CUDA tensors; the rest is plain PyTorch with
autograd.  ``compute_dtype='bf16'`` runs the feature value and lerp math
and its backward in bf16; index math, compositing, losses, params and
Adam stay fp32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import as_tensor, check_on, resolve_device
from ..models import tensorf as tf
from ..ops import losses as L
from ..ops import render as render_ops
from .tracing import span


class TrainState(NamedTuple):
    field: tf.TensoRF
    optimizer: torch.optim.Optimizer
    step: int


class LossWeights(NamedTuple):
    depth: float = 0.005
    transmittance: float = 1e3
    trans_margin: float = 0.1
    tv_density: float = 0.1
    tv_app: float = 0.01
    l1: float = 0.0
    ortho: float = 0.0


def effective_microbatch(batch_size: int, microbatch: int) -> int:
    """Largest divisor of ``batch_size`` that is <= ``microbatch``."""
    mb = max(1, min(int(microbatch), int(batch_size)))
    while batch_size % mb:
        mb -= 1
    return mb


def lr_factor(decay_target_ratio: float, decay_iters: int) -> float:
    """The factor that decays a learning rate to lr·ratio over
    ``decay_iters`` steps."""
    return float(decay_target_ratio) ** (1.0 / max(int(decay_iters), 1))


def make_optimizer(field: tf.TensoRF, lr_init=0.02, lr_basis=1e-3, factor=1.0,
                   runtime_decay=False) -> torch.optim.Adam:
    """Two-group Adam.  Each group is named (``spatial`` / ``network``) and
    keeps its base rate in ``base_lr``; without ``runtime_decay`` it also
    carries ``decay`` = ``factor``, and the train step sets its rate to
    base_lr · factor**step before each update (the embedded schedule).
    With ``runtime_decay`` the train step sets base · ``lr_decay``.  The
    field's parameters are set to require grad."""
    groups = tf.param_groups(field.requires_grad_(True))
    for group in groups:
        group["base_lr"] = group["lr"] = lr_init if group["name"] == "spatial" else lr_basis
        if not runtime_decay:
            group["decay"] = float(factor)
    return torch.optim.Adam(groups, betas=(0.9, 0.99), eps=1e-8)


def make_train_state(field: tf.TensoRF, lr_init=0.02, lr_basis=1e-3, factor=1.0,
                     runtime_decay=False):
    opt = make_optimizer(field, lr_init, lr_basis, factor, runtime_decay)
    return TrainState(field, opt, 0), opt


def make_train_step(
    cfg: tf.TensoRFConfig,
    optimizer: torch.optim.Optimizer,
    *,
    n_samples: int,
    app_k: int = 64,
    white_bg: bool = True,
    ndc: bool = False,
    weights: LossWeights = LossWeights(),
    tv_factor: float = 1.0,
    depth_loss_type: str = "mse",
    density_group: int = 1,
    density_block: int = 4,
    microbatch: int = 1,
    microbatch_compact: Optional[int] = None,
    compute_dtype: str = "fp32",
    compact_k: int = 0,
    depth_cap_band: int = 0,
    runtime_decay: bool = False,
    lr_init: float = 0.02,
    lr_basis: float = 1e-3,
    device=None,
    mesh=None,
):
    """Build the train step, with the JAX package's keyword set.

    ``train_step(state, aabb, batch, rng=None, tv_decay=None,
    alpha_mask=None, lr_decay=1.0, jitter=None, bg_coin=None)`` renders
    ``batch`` (``rays`` (B, 6), ``rgb`` (B, 3), ``depth`` (B,)), takes one
    step of ``optimizer`` (the optimizer of ``state``) and returns
    ``(TrainState, metrics)``, the metrics as 0-d tensors on the device.

    - With ``compact_k`` > 0 and a mask: the compacted render
      (``density_group`` samples per group, occupancy tested every
      group-th sample; with ``depth_cap_band`` > 0 and depth supervision,
      the depth-anchored last-K window); R = ``microbatch_compact``.
    - Otherwise the dense train render; R = ``microbatch``.
    - ``density_block`` (the JAX package's packing of grouped density
      gathers) is accepted and unused: the port gathers per sample.
    - R > 1 averages the gradients of R equal sub-batches; the
      batch-independent regularizers are added once, after the average.
    - ``ndc``: the dense render's NDC sampler, never compacted.
    - ``jitter`` (B, 1; NDC: (B, n_samples)) and ``bg_coin`` (R,) are
      drawn from the ``torch.Generator`` ``rng`` when not given (one
      jitter row per ray: sub-batch i takes rows i·B/R to (i+1)·B/R).
    - ``tv_decay`` None uses ``tv_factor**step``.
    - ``compute_dtype`` 'fp32' or 'bf16' (the factor features and their
      backward in bf16).
    - ``mesh`` (:func:`..parallel.mesh.make_mesh`): the step of one rank
      of a ``(data, model)`` mesh, on its part of the batch
      (``shard_batch``) and its shard of the field (``shard_params``,
      whose basis product is summed over ``model``).  The app TV is
      reduced over ``model`` with the global channel count, the gradients
      are averaged over ``data`` before Adam and the metrics over both
      axes.  A jitter drawn from ``rng`` is the whole batch's, sliced to
      this rank's rays, and so are background coins drawn from it: R
      coins for the one-process step's R sub-batches of the whole batch,
      this rank's rows split along the same boundaries (a rank's rows
      that straddle a boundary raise).  So equally seeded ranks draw what
      one process would.  The orthogonality term takes the whole app
      lines, summed over ``model`` from each rank's channels
      (:func:`..parallel.mesh.model_gather`); every rank computes the same
      term.  Without a mesh the step is unchanged.

    Runs on ``device`` (cuda unless asked)."""
    assert depth_loss_type in ("mse", "ssi", "silog"), depth_loss_type
    if compute_dtype not in ("fp32", "bf16"):
        raise ValueError(f"compute_dtype must be 'fp32' or 'bf16', got {compute_dtype!r}")
    dev = resolve_device(device)
    sharded = mesh is not None and mesh.model > 1
    compact = compact_k > 0 and not ndc
    # the depth-anchored window needs per-ray depth supervision to anchor to
    anchor = compact and depth_cap_band > 0 and weights.depth > 0

    def batch_loss(field, aabb, batch, alpha_mask, jitter, bg_coin):
        """Per-ray loss terms (no batch-independent regularizers)."""
        if alpha_mask is not None:
            out, _ = render_ops._render_rays_train_compact(
                field, aabb, batch["rays"], alpha_mask, n_samples=n_samples,
                compact_k=compact_k, app_k=min(app_k, compact_k), white_bg=white_bg,
                density_group=density_group, occ_stride=max(1, density_group),
                feature_dtype=compute_dtype,
                depth_gt=batch["depth"] if anchor else None,
                cap_band_samples=depth_cap_band if anchor else 0,
                jitter=jitter, bg_coin=bg_coin,
            )
        else:
            out = render_ops.render_rays(
                field, aabb, batch["rays"], n_samples=n_samples, app_k=app_k,
                is_train=True, white_bg=white_bg, ndc=ndc, feature_dtype=compute_dtype,
                jitter=jitter, bg_coin=bg_coin,
            )
        with span("t2n.loss"):
            depth_map = torch.nan_to_num(out.depth)
            loss_rgb = L.mse(out.rgb, batch["rgb"])
            metrics = {}
            if depth_loss_type == "ssi":
                loss_depth, metrics["ssi_s"], metrics["ssi_t"] = (
                    L.scale_shift_invariant_depth_loss(out.z_vals, out.weights, batch["depth"])
                )
            elif depth_loss_type == "silog":
                floor = depth_map.new_tensor(1e-6)
                loss_depth = L.scale_invariant_log_depth_loss(
                    torch.maximum(depth_map, floor), torch.maximum(batch["depth"], floor)
                )
            else:
                loss_depth = L.mse(depth_map, batch["depth"])
            mask = L.depth_front_mask(out.z_vals, batch["depth"], weights.trans_margin)
            # compacted weights cover only the rendered samples; keep the
            # full-S per-ray mean (the culled samples contribute 0)
            loss_trans = L.transmittance_mask_loss(
                out.weights, mask, denom=n_samples if alpha_mask is not None else None,
            )
            total = loss_rgb + weights.depth * loss_depth + weights.transmittance * loss_trans
        metrics.update(mse=loss_rgb, depth_loss=loss_depth, transmit_loss=loss_trans)
        return total, metrics

    def reg_loss(field, step, tv_decay):
        """Batch-independent regularizers (TV decayed per step)."""
        with span("t2n.reg"):
            decay = float(np.float32(tv_factor) ** np.float32(step)) if tv_decay is None \
                else float(np.float32(tv_decay))
            total = torch.zeros((), device=dev)
            metrics = {}
            if weights.tv_density > 0:
                tv_d = tf.tv_loss_density(field) * weights.tv_density * decay
                total = total + tv_d
                metrics["reg_tv_density"] = tv_d
            if weights.tv_app > 0:
                tv_app = tf.tv_loss_app(field)
                if sharded:
                    from ..parallel.mesh import model_mean

                    tv_app = model_mean(tv_app, mesh)
                tv_a = tv_app * weights.tv_app * decay
                total = total + tv_a
                metrics["reg_tv_app"] = tv_a
            if weights.l1 > 0:
                total = total + weights.l1 * tf.density_l1(field)
            if weights.ortho > 0:
                app_lines = None
                if sharded:
                    from ..parallel.mesh import model_gather

                    app_lines = tuple(model_gather(line, mesh) for line in field.app_lines())
                total = total + weights.ortho * tf.vector_comp_diffs(field, app_lines)
            return total, metrics

    def _set_rates(step, lr_decay):
        for group in optimizer.param_groups:
            if runtime_decay:
                name = group.get("name")
                if name not in ("spatial", "network"):
                    raise ValueError("runtime_decay needs optimizer groups named "
                                     "'spatial' / 'network' (tensorf.param_groups)")
                base = lr_init if name == "spatial" else lr_basis
                group["lr"] = base * float(np.float32(lr_decay))
            elif "decay" in group:
                group["lr"] = group["base_lr"] * group["decay"] ** step

    def train_step(state: TrainState, aabb, batch, rng: Optional[torch.Generator] = None,
                   tv_decay=None, alpha_mask=None, lr_decay=1.0, jitter=None, bg_coin=None):
        with span("t2n.step"):
            field = state.field
            if state.optimizer is not optimizer:
                raise ValueError("the state's optimizer is not the one this step was built with")
            check_on(dev, field)
            aabb = as_tensor(aabb, dev)
            batch = {k: as_tensor(v, dev) for k, v in batch.items()}
            mb = microbatch
            if compact and alpha_mask is not None:
                # strided occupancy is licensed only by the mask's pool dilation
                if density_group > 1 and not render_ops.occupancy_stride_safe(
                    field, aabb, alpha_mask, density_group
                ):
                    raise ValueError(
                        "density_group=%d needs a mask pool dilation licensing stride-%d "
                        "occupancy tests (update_alpha_mask(pool>=%d))"
                        % (density_group, density_group, 2 * density_group + 1)
                    )
                if microbatch_compact:
                    mb = microbatch_compact
            else:
                alpha_mask = None
            b = batch["rays"].shape[0]
            r = effective_microbatch(b, mb)
            width = n_samples if ndc else 1
            if jitter is None and mesh is not None:
                rows = torch.rand((b * mesh.data, width), generator=rng, device=dev)
                jitter = rows[mesh.data_index * b:(mesh.data_index + 1) * b]
            elif jitter is None:
                jitter = torch.rand((b, width), generator=rng, device=dev)
            jitter = as_tensor(jitter, dev).reshape(b, width)
            if not white_bg and bg_coin is None and mesh is not None:
                r, r_all, first = _rank_subbatches(b, mb, mesh)
                bg_coin = torch.rand((r_all,), generator=rng, device=dev)[first:first + r]
            elif not white_bg and bg_coin is None:
                bg_coin = torch.rand((r,), generator=rng, device=dev)
            coins = [None] * r if bg_coin is None else as_tensor(bg_coin, dev).reshape(r)

            optimizer.zero_grad(set_to_none=True)
            if r == 1:
                # one backward serves the batch and the regularizers
                with span("t2n.subbatch"):
                    total, metrics = batch_loss(field, aabb, batch, alpha_mask, jitter, coins[0])
                    reg, reg_metrics = reg_loss(field, state.step, tv_decay)
                    (total + reg).backward()
            else:
                sb = b // r
                subs = []
                for i in range(r):
                    sl = slice(i * sb, (i + 1) * sb)
                    with span("t2n.subbatch"):
                        loss_i, m_i = batch_loss(field, aabb, {k: v[sl] for k, v in batch.items()},
                                                 alpha_mask, jitter[sl], coins[i])
                        loss_i.backward()
                    subs.append({k: v.detach() for k, v in m_i.items()})
                params = [p for g in optimizer.param_groups for p in g["params"]]
                with torch.no_grad():
                    for p in params:
                        if p.grad is not None:
                            p.grad.div_(r)
                reg, reg_metrics = reg_loss(field, state.step, tv_decay)
                if reg.requires_grad:
                    reg.backward()
                metrics = {k: torch.mean(torch.stack([m[k] for m in subs])) for k in subs[0]}
            metrics.update(reg_metrics)
            metrics = {k: v.detach() for k, v in metrics.items()}
            if mesh is not None:
                metrics = _mesh_reduce(optimizer, metrics, mesh)
            metrics["psnr"] = L.mse2psnr(metrics["mse"])
            _set_rates(state.step, lr_decay)
            optimizer.step()
            return TrainState(field, optimizer, state.step + 1), metrics

    return train_step


def _rank_subbatches(b: int, microbatch: int, mesh):
    """(r, r_all, first): of the one-process step's ``r_all`` sub-batches
    of the whole batch (b · data rays), the ``r`` that hold this rank's b
    rows, starting at global sub-batch ``first``.  A rank holds whole
    sub-batches, or lies inside one (r = 1); its rows straddling a
    boundary raise."""
    whole = b * mesh.data
    r_all = effective_microbatch(whole, microbatch)
    sb = whole // r_all
    first = mesh.data_index * b // sb
    if b % sb == 0:
        return b // sb, r_all, first
    if sb % b == 0:
        return 1, r_all, first
    raise ValueError(
        f"data={mesh.data} and R={r_all} do not fit together: a rank's {b} rays straddle "
        f"the one-process step's sub-batches of {sb} rays, so its background coins "
        "cannot be the one-process step's")


def _mesh_reduce(optimizer, metrics: dict, mesh) -> dict:
    """Average every gradient over ``data`` (in place) and the metrics
    over the whole mesh; returns the metrics."""
    import torch.distributed as dist

    if mesh.data_group is not None:
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                dist.all_reduce(p.grad, group=mesh.data_group)
                p.grad.div_(mesh.data)
    names = sorted(metrics)
    flat = torch.stack([metrics[k].float().reshape(()) for k in names])
    if mesh.data * mesh.model > 1:
        dist.all_reduce(flat)
        flat = flat / (mesh.data * mesh.model)
    return dict(zip(names, flat.unbind()))


class PermutationSampler:
    """Random-permutation batch sampler; reshuffles when the next batch
    would run past the pool.  Host-side."""

    def __init__(self, total: int, batch: int, seed: int = 0):
        self.total = int(total)
        self.batch = int(batch)
        self.curr = self.total
        self.ids = None
        self._rng = np.random.default_rng(seed)

    def next_ids(self):
        self.curr += self.batch
        if self.curr + self.batch > self.total:
            self.ids = self._rng.permutation(self.total)
            self.curr = 0
        return self.ids[self.curr : self.curr + self.batch]
