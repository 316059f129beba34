"""The train cells: the trainer's own step (``make_train_step`` built with
the trainer's ``_step_kwargs``) fed by the trainer's own batch source
(``PermutationSampler`` over host pools, ``_batch_from_pool``), with the
trainer's learning-rate and TV decay, as ``engine/trainer.py`` steps a
stage.

Set-up builds one step with its field and optimizer and drives it through
its first ``check_steps`` steps, which warm every shape up; the window
goes on with the same objects.  After the window the reference follows
those first steps from the same weights, batches and jitter.
"""

from __future__ import annotations

import gc
import math
import statistics
import time

import numpy as np
import torch

from ..reference import field as F
from ..reference import train as RT
from . import inputs
from . import program as P

BETA1 = RT.BETAS[0]


def recipe(traffic) -> dict:
    """The training settings both sides take from the traffic file."""
    tc, loss = traffic["train_config"], traffic["loss"]
    return {
        "lr_init": tc["lr_init"], "lr_basis": tc["lr_basis"],
        "tv_weight_density": tc["tv_weight_density"], "tv_weight_app": tc["tv_weight_app"],
        "app_k": tc["app_k"], "train_compact_k": tc["train_compact_k"],
        "density_group": tc["train_density_group"],
        "train_depth_cap_band": tc["train_depth_cap_band"],
        "depth_weight": loss["depth_weight"], "trans_weight": loss["trans_weight"],
        "trans_margin": loss["trans_margin"],
    }


class TrainCell:
    def __init__(self, cell, seed: int, device, sync):
        from text2nerf_tpu_torch.engine import train_step as ts
        from text2nerf_tpu_torch.engine import trainer as TR

        self.cfg, self.traffic, self.dev, self.sync = cell["config"], cell["traffic"], device, sync
        self.TR = TR
        cfg, tc = self.cfg, self.traffic["train_config"]
        self.aabb = torch.tensor(cfg["aabb"], dtype=torch.float32, device=device)
        self.reso = F.n_to_reso(cfg["N_voxel"], cfg["aabb"])
        self.n = F.n_samples_for(self.reso, cfg["step_ratio"])
        self.weights = inputs.make_weights(cfg, self.reso, seed, device)
        self.pools = inputs.train_pools(self.traffic, seed, device)
        self.mask = None
        spec = self.traffic.get("mask")
        if spec:
            res = tuple(min(r, spec["res_cap"]) for r in self.reso)
            self.mask = F.alpha_mask(cfg, self.weights, self.aabb, self.reso, res, spec["pool"])
            if spec.get("stamp"):
                self.mask = F.stamp_mask(self.mask, self.pools[0], self.pools[2])
        self.field = P.field(cfg, self.reso, self.weights, device)
        self.train_cfg = TR.TrainConfig(**tc)
        group, block = TR._resolve_group(self.train_cfg, np.asarray(cfg["aabb"], np.float32),
                                         self.reso, cfg["step_ratio"])
        kw = TR._step_kwargs(self.train_cfg, n_samples=self.n, group=group, block=block,
                             white_bg=True)
        n_rays = len(self.pools[0])
        iters = math.ceil(n_rays / self.train_cfg.batch_size)
        self.factor = ts.lr_factor(self.train_cfg.lr_decay_target_ratio,
                                   self.train_cfg.n_stage1 * iters)
        self.state, self.opt = ts.make_train_state(
            self.field, self.train_cfg.lr_init, self.train_cfg.lr_basis, self.factor,
            runtime_decay=True)
        self.step_fn = ts.make_train_step(P.model_cfg(cfg), self.opt, device=device, **kw)
        self.sampler = ts.PermutationSampler(n_rays, self.train_cfg.batch_size,
                                             seed=inputs.derived_seed(seed, 3))
        self.gen = torch.Generator(device=device).manual_seed(inputs.derived_seed(seed, 4))
        self.tv_decay = self.lr_decay = 1.0
        self.batch_s = []
        self.checks = []
        # the checked steps run as the window's do: the host reads nothing
        # of theirs until the last has been issued
        steps = []
        for i in range(self.traffic["check_steps"]):
            steps.append(self.step(record=True))
            if i == 0:
                grad = self.adam_first_grad()
        sync()
        for check in self.checks:
            check["jitter"] = check["jitter"].cpu()
        self.program = {"loss": [self.total_loss(m) for m in steps],
                        "grad": {k: float(g) for k, g in grad.items()},
                        "change": self.change()}

    # -- one step of the trainer's loop -------------------------------------

    def step(self, record=False):
        b = self.train_cfg.batch_size
        t0 = time.perf_counter()
        ids = self.sampler.next_ids()
        batch = self.TR._batch_from_pool(self.pools, ids, self.dev)
        self.batch_s.append(time.perf_counter() - t0)
        jitter = torch.rand((b, 1), generator=self.gen, device=self.dev)
        if record:
            self.checks.append({"ids": np.array(ids), "jitter": jitter.clone(),
                                "tv_decay": self.tv_decay, "lr_decay": self.lr_decay})
        self.state, metrics = self.step_fn(self.state, self.aabb, batch, None, self.tv_decay,
                                           alpha_mask=self.mask, lr_decay=self.lr_decay,
                                           jitter=jitter)
        self.tv_decay *= self.factor
        self.lr_decay *= self.factor
        return metrics

    def total_loss(self, m) -> float:
        loss = self.traffic["loss"]
        return (float(m["mse"]) + loss["depth_weight"] * float(m["depth_loss"])
                + loss["trans_weight"] * float(m["transmit_loss"])
                + float(m.get("reg_tv_density", 0.0)) + float(m.get("reg_tv_app", 0.0)))

    def adam_first_grad(self) -> dict:
        """Each leaf's first gradient's norm as the optimizer got it, from
        Adam's first moment after one step, m1 = (1 - beta1) g: tensors on
        the device, taken in stream order before the next step."""
        return {k: torch.linalg.vector_norm(self.opt.state[p]["exp_avg"]) / (1 - BETA1)
                for k, p in P.leaves(self.field)}

    def change(self) -> dict:
        with torch.no_grad():
            return {k: float(torch.linalg.vector_norm(p - self.weights[k]))
                    for k, p in P.leaves(self.field)}

    # -- the window ----------------------------------------------------------

    def window(self, seconds: float):
        """Steps for ``seconds``, reading the step's metrics every
        ``progress_refresh_rate`` steps as the trainer logs them.  Returns
        (steps, failed, seconds the window took)."""
        every = max(self.train_cfg.progress_refresh_rate, 1)
        self.batch_s = []
        steps = failed = 0
        self.sync()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            metrics = self.step()
            steps += 1
            if steps % every == 0:
                failed += not _finite(metrics)
        if steps % every:
            failed += not _finite(metrics)
        self.sync()
        return steps, failed, time.perf_counter() - t0

    def traced(self, count: int):
        for _ in range(count):
            self.step()

    def rays_per_step(self) -> int:
        return self.train_cfg.batch_size

    # -- after the window ----------------------------------------------------

    def release(self):
        """Drops the program's objects, so the reference has the memory."""
        for name in ("state", "opt", "step_fn", "field"):
            setattr(self, name, None)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision="fp32", keep=1.0, probe=None):
        return RT.run(self.cfg, self.weights, self.aabb, self.reso, self.pools, self.checks,
                      self.n, recipe(self.traffic), precision=precision,
                      block=self.traffic["reference_block"], mask=self.mask, keep=keep,
                      probe=probe)


def _finite(metrics) -> bool:
    """The values the trainer logs (psnr, mse, depth loss) are numbers."""
    return all(math.isfinite(float(metrics[k])) for k in ("psnr", "mse", "depth_loss"))


def detail(program: dict, ref: dict) -> dict:
    """For the record: each step's loss gap, and each leaf's gradient and
    change gaps (as in :func:`numbers`)."""
    med_g = statistics.median(ref["grad"].values())
    moved = [k for k, g in ref["grad"].items() if g >= 1e-3 * med_g]
    med_c = statistics.median(ref["change"][k] for k in moved)
    return {
        "loss": [abs(a - b) / abs(b) for a, b in zip(program["loss"], ref["loss"])],
        "grad": {k: abs(program["grad"][k] - g) / max(g, med_g) for k, g in ref["grad"].items()},
        "change": {k: abs(program["change"][k] - ref["change"][k]) / max(ref["change"][k], med_c)
                   for k in moved},
        "ref_grad": ref["grad"], "ref_change": ref["change"],
    }


def numbers(program: dict, ref: dict) -> dict:
    """The compared numbers: each step's loss as a share of the
    reference's; by the worst leaf, the gap between the program's norm of
    its first gradient and the reference's, and the same of the change
    over the steps, each against the larger of the leaf's reference norm
    and the median leaf's; and the gaps between the norms of the whole
    field's first gradient and of its change (its leaves together).  The
    change leaves out leaves whose reference gradient is under a
    thousandth of the median leaf's (they move by round-off alone).  A
    cell's limits file names the numbers it compares."""
    loss_gap = worst(abs(a - b) / abs(b) for a, b in zip(program["loss"], ref["loss"]))
    med_g = statistics.median(ref["grad"].values())
    grad_gap = worst(abs(program["grad"][k] - g) / max(g, med_g) for k, g in ref["grad"].items())
    moved = [k for k, g in ref["grad"].items() if g >= 1e-3 * med_g]
    med_c = statistics.median(ref["change"][k] for k in moved)
    change_gap = worst(abs(program["change"][k] - ref["change"][k]) / max(ref["change"][k], med_c)
                       for k in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "field_grad_gap": _pooled_gap(program["grad"], ref["grad"], list(ref["grad"])),
            "field_change_gap": _pooled_gap(program["change"], ref["change"], moved)}


def _pooled_gap(program: dict, ref: dict, keys) -> float:
    """The gap between the two sides' norms of the leaves ``keys`` taken
    together, as a share of the reference's."""
    pooled = [math.sqrt(sum(side[k] ** 2 for k in keys)) for side in (program, ref)]
    return worst([abs(pooled[0] - pooled[1]) / pooled[1]])


def worst(values) -> float:
    """The largest value; infinite when any is not a number."""
    values = list(values)
    return math.inf if any(not math.isfinite(v) for v in values) else max(values)
