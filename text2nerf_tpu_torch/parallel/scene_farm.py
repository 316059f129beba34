"""Multi-scene farm: many prompts, each through the whole pipeline (port
of ``text2nerf_tpu/parallel/scene_farm.py``).

The reference's only scale-out is a thread pool that shells one process
per (GPU, experiment) with mkdir locks (``extra/auto_run_paramsets.py``).
Here:

- :func:`run_farm` runs one scene per prompt; with ``distributed`` the
  prompts are strided by ``torch.distributed``'s rank over its world
  size, so each process of a group runs its share.
- :func:`run_farm_parallel` runs one worker thread per device; a worker
  runs its scenes inside ``torch.cuda.device(dev)``, so the kernels'
  ctypes launches, which use the thread's current CUDA device, reach the
  scene's card.  A device may be named twice (two workers on one card).
- :func:`claim_and_run` makes each scene idempotent with a
  ``FARM_DONE.json`` marker, and records its wall and its host-side
  (device-idle) phase seconds from the scene's ``metrics.jsonl``.
- :func:`fit_scenes_mesh` fits S independent fields, scene i on
  ``devices[i % n]``, each with its own optimizer, sampler and
  generator, stepped in turn (the JAX package vmaps the step; the
  kernels' ctypes launches have no batching rule).  Across devices the
  launches overlap, since they are asynchronous.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass
class FarmJob:
    prompt: str
    datadir: str
    logdir: str


def _marker(job: FarmJob) -> str:
    return os.path.join(job.logdir, "FARM_DONE.json")


#: phase-timer names (suffix match) whose time is host-side work during
#: which the scene's device sits idle: the seed bootstrap family
#: (bilateral filters, support warp pools, image IO), the native DIBR
#: hole fill and the host-numpy support ray pools.  The render, inpaint,
#: depth and merge phases are device work and are left out.
HOST_PHASE_SUFFIXES = (
    "bootstrap", "bootstrap_seed_image", "bootstrap_depth",
    "bootstrap_bilateral", "bootstrap_support_pool", "warmup_join",
    "dibr_holefill", "support_pool",
)


def collect_phase_times(logdir: str) -> dict:
    """Sum every ``phase/*_s`` scalar under ``logdir``'s metrics JSONLs.

    Returns {phase_name: seconds}: the engine's phase timers
    (:func:`..engine.tracing.phase_timer`) write ``phase/<name>_s``
    scalars into each scene's metrics.jsonl."""
    phases: dict = {}
    for root, _, files in os.walk(logdir):
        for fn in files:
            if fn != "metrics.jsonl":
                continue
            with open(os.path.join(root, fn)) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    for k, v in rec.items():
                        if k.startswith("phase/") and k.endswith("_s"):
                            name = k[len("phase/"):-2]
                            phases[name] = phases.get(name, 0.0) + float(v)
    return phases


def device_idle_seconds(phases: dict) -> float:
    """Host-side share of a scene's wall: seconds summed over the phases
    in HOST_PHASE_SUFFIXES (suffix match, so per-view tags such as
    'view003_' are ignored).  An upper bound of the scene's device idle
    time.

    The aggregate 'bootstrap' timer wraps the bootstrap_* timers (the
    tracer nests them); when those are present the parent is skipped so
    its children are not counted twice (logs without them count the
    parent)."""
    has_boot_subs = any(
        k.endswith(HOST_PHASE_SUFFIXES) and "bootstrap_" in k for k in phases
    )
    total = 0.0
    for name, secs in phases.items():
        if not name.endswith(HOST_PHASE_SUFFIXES):
            continue
        if name.endswith("bootstrap") and has_boot_subs:
            continue
        total += secs
    return total


def claim_and_run(
    job: FarmJob, run: Callable[[FarmJob], dict], force: bool = False
) -> Optional[dict]:
    """Run one job unless its completion marker exists (then return the
    marker's result): the lock-file role of the reference's
    ``getFolderLocker``.  The result gains ``t_start``, ``t_end``,
    ``wall_s``, ``prompt`` and, when the scene logged phase timers,
    ``device_idle_s`` and ``phase_s``."""
    os.makedirs(job.logdir, exist_ok=True)
    if os.path.exists(_marker(job)) and not force:
        with open(_marker(job)) as f:
            return json.load(f)
    t0 = time.time()
    result = run(job)
    result = dict(result or {})
    result["t_start"], result["t_end"] = t0, time.time()
    result["wall_s"] = result["t_end"] - t0
    result["prompt"] = job.prompt
    phases = collect_phase_times(job.logdir)
    if phases:
        result["device_idle_s"] = round(device_idle_seconds(phases), 3)
        result["phase_s"] = {k: round(v, 3) for k, v in phases.items()}
    with open(_marker(job), "w") as f:
        json.dump(result, f)
    return result


def _job(i: int, prompt: str, base_datadir: str, base_logdir: str) -> FarmJob:
    tag = f"scene{i:03d}_{prompt.replace(' ', '_')[:48]}"
    return FarmJob(prompt=prompt, datadir=os.path.join(base_datadir, tag),
                   logdir=os.path.join(base_logdir, tag))


def run_farm(
    prompts: Sequence[str],
    base_datadir: str,
    base_logdir: str,
    run: Callable[[FarmJob], dict],
    distributed: bool = False,
) -> List[dict]:
    """Run one scene per prompt, in order.

    ``run`` receives a :class:`FarmJob` and runs the scene (for example
    :func:`progressive_runner`'s).  With ``distributed`` and an
    initialized process group of more than one process, prompt i runs on
    the rank i % world_size."""
    idx, count = 0, 1
    if distributed and torch.distributed.is_available() and torch.distributed.is_initialized():
        idx, count = torch.distributed.get_rank(), torch.distributed.get_world_size()

    results = []
    for i, prompt in enumerate(prompts):
        if i % count != idx:
            continue
        results.append(claim_and_run(_job(i, prompt, base_datadir, base_logdir), run))
    return results


_WORKER = threading.local()


def worker_device() -> Optional[torch.device]:
    """The device of the :func:`run_farm_parallel` worker running in this
    thread, or None outside one."""
    return getattr(_WORKER, "device", None)


def _concrete(dev) -> torch.device:
    """``dev`` resolved, a bare ``cuda`` given the current device's index."""
    dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _load_lazy_libraries(devices) -> None:
    """Load, from this thread, the CUDA library PyTorch loads at the first
    ``torch.linalg`` call: that load is not thread-safe, and two workers'
    first pose inversions would race ("lazy wrapper should be called at
    most once")."""
    for dev in dict.fromkeys(d for d in devices if d.type == "cuda"):
        torch.linalg.inv(torch.eye(2, device=dev))


def run_farm_parallel(
    prompts: Sequence[str],
    base_datadir: str,
    base_logdir: str,
    run: Callable[[FarmJob], dict],
    devices=None,
    force: bool = False,
) -> List[dict]:
    """One worker thread per entry of ``devices`` (default: every CUDA
    device), draining one queue of scenes.

    A worker runs each scene inside ``torch.cuda.device(dev)`` and
    publishes ``dev`` through :func:`worker_device`, so ``run`` (see
    :func:`progressive_runner`) can pass it on explicitly.  ``run`` must
    be thread-reentrant: stateful services are built inside it, per job.

    One scene's failure does not stop the others: the workers drain the
    queue, then the first failure is raised with ``farm_failed`` (the
    (index, prompt) of every failure) and ``farm_results`` attached; the
    completed scenes keep their markers, so a rerun runs only the
    failures.  Returns the results in prompt order, each with its
    ``device``."""
    import queue

    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            resolve_device(None)  # raises: no CUDA device
    devices = [_concrete(d) for d in devices]
    _load_lazy_libraries(devices)
    jobq: "queue.Queue" = queue.Queue()
    for i, prompt in enumerate(prompts):
        jobq.put((i, prompt))
    results: List[Optional[dict]] = [None] * len(prompts)
    errors: List[tuple] = []  # (index, prompt, exception)

    def worker(dev):
        _WORKER.device = dev
        ctx = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        with ctx:
            while True:
                try:
                    i, prompt = jobq.get_nowait()
                except queue.Empty:
                    return
                job = _job(i, prompt, base_datadir, base_logdir)
                try:
                    out = dict(claim_and_run(job, run, force=force) or {})
                    out["device"] = str(dev)
                    results[i] = out
                except BaseException as e:  # noqa: BLE001 — raised after the drain
                    errors.append((i, prompt, e))

    threads = [
        threading.Thread(target=worker, args=(d,), daemon=True)
        for d in devices[: max(1, min(len(devices), len(prompts)))]
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        i0, p0, e0 = errors[0]
        for i_, p_, e_ in errors[1:]:
            logging.getLogger(__name__).error("farm scene %d (%r) also failed: %r", i_, p_, e_)
        e0.farm_failed = [(i_, p_) for i_, p_, _ in errors]
        e0.farm_results = results
        raise e0
    return [r for r in results if r is not None]


def progressive_runner(train_cfg, scene_cfg, services, exp_cfg,
                       eval_views: bool = True, services_factory=None, device=None):
    """A ``run(job)`` for the farm that runs the whole progressive
    pipeline (:func:`..engine.trainer.reconstruction`: seed image, depth,
    expansion, the three-stage schedule) with the job's prompt, datadir
    and logdir substituted into the configs, then evaluates every
    generated view (:func:`..engine.renderer.evaluation`, culled at
    :func:`..data.scene_state.supervised_z_floor`).  The marker gets
    ``logfolder``, ``views`` and ``per_view_psnr``.

    The scene runs on the :func:`run_farm_parallel` worker's device, else
    on ``device`` (cuda unless asked), passed explicitly to the fit and
    the evaluation.  ``services_factory(device)`` builds a fresh services
    bundle per job (needed when scenes run concurrently: the merge net
    keeps finetune state); else ``services`` is shared."""

    def run(job: FarmJob) -> dict:
        from ..data import scene_state as ss
        from ..engine import renderer, trainer
        from ..models import tensorf as tf

        dev = worker_device() or _concrete(device)
        job_services = services_factory(dev) if services_factory is not None else services
        s_cfg = dataclasses.replace(scene_cfg, prompt=job.prompt, datadir=job.datadir)
        t_cfg = dataclasses.replace(train_cfg, basedir=job.logdir)
        e_cfg = dataclasses.replace(exp_cfg, prompt=job.prompt)
        _, field, aabb, scene, logfolder = trainer.reconstruction(
            t_cfg, s_cfg, job_services, e_cfg, device=dev
        )
        out = {"logfolder": logfolder, "views": int(scene.poses_gen.shape[0])}
        if eval_views:
            res = renderer.evaluation(
                field, aabb, scene.rays_gen_split, scene.hw,
                n_samples=tf.default_n_samples(tf.grid_resolution(field),
                                               field.cfg.step_ratio),
                gt_rgbs=scene.rgbs_gen_split, chunk=t_cfg.batch_size,
                app_k=t_cfg.app_k, eval_z_min=ss.supervised_z_floor(scene),
                device=dev,
            )
            out["per_view_psnr"] = [round(float(p), 2) for p in res["psnr"]]
        return out

    return run


def fit_scenes_mesh(
    cfg,
    fields,
    aabbs,
    pools,
    *,
    n_steps: int,
    batch_size: int,
    n_samples: int,
    devices=None,
    app_k: int = 16,
    white_bg: bool = True,
    lr_init: float = 0.02,
    lr_basis: float = 1e-3,
    factor: float = 1.0,
    seed: int = 0,
    draws: Optional[Callable] = None,
):
    """Fit S independent scenes, scene i on ``devices[i % n]`` (default:
    every CUDA device).

    Args:
      fields: S fields of ``cfg`` (a farm's stacked JAX params convert
        with ``checkpoints.params_from_jax(..., stacked=True)``); each is
        moved to its device and trained in place.
      aabbs: (S, 2, 3) scene bounds.
      pools: S (rays, rgbs, depth) numpy pools.
      draws: optional ``draws(step, scene) -> (jitter, bg_coin)`` to
        inject a step's randomness; by default each scene draws from its
        own ``torch.Generator`` seeded ``seed + i``.

    Each scene has its own two-group Adam, ``PermutationSampler(len,
    batch_size, seed + i)`` and train step, with ``microbatch =
    effective_microbatch(batch_size, 32)`` as in the JAX package.
    Returns (fields, metrics dict of (n_steps, S) numpy arrays)."""
    from ..engine import train_step as ts

    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            resolve_device(None)  # raises: no CUDA device
    devices = [_concrete(d) for d in devices]
    n_scenes = len(fields)
    if len(pools) != n_scenes or len(aabbs) != n_scenes:
        raise ValueError(f"{n_scenes} fields, {len(pools)} pools, {len(aabbs)} aabbs")
    mb = ts.effective_microbatch(batch_size, 32)
    scenes = []
    for i, field in enumerate(fields):
        dev = devices[i % len(devices)]
        field = field.to(dev)
        opt = ts.make_optimizer(field, lr_init, lr_basis, factor)
        step_fn = ts.make_train_step(cfg, opt, n_samples=n_samples, app_k=app_k,
                                     white_bg=white_bg, microbatch=mb, device=dev)
        rays, rgbs, depth = pools[i]
        scenes.append(dict(
            dev=dev, step=step_fn, state=ts.TrainState(field, opt, 0),
            aabb=torch.as_tensor(np.asarray(aabbs[i], np.float32), device=dev),
            pool={name: torch.as_tensor(np.array(a, np.float32), device=dev)
                  for name, a in (("rays", rays), ("rgb", rgbs), ("depth", depth))},
            sampler=ts.PermutationSampler(len(rays), batch_size, seed + i),
            gen=torch.Generator(device=dev).manual_seed(seed + i),
        ))
    history = []
    for t in range(n_steps):
        picks = [s["sampler"].next_ids() for s in scenes]
        row = []
        for i, s in enumerate(scenes):
            ids = torch.as_tensor(picks[i], device=s["dev"])
            batch = {k: v[ids] for k, v in s["pool"].items()}
            jitter, coin = draws(t, i) if draws is not None else (None, None)
            ctx = torch.cuda.device(s["dev"]) if s["dev"].type == "cuda" \
                else contextlib.nullcontext()
            with ctx:
                s["state"], metrics = s["step"](s["state"], s["aabb"], batch, rng=s["gen"],
                                                jitter=jitter, bg_coin=coin)
            row.append(metrics)
        history.append(row)
    metrics = {
        k: np.stack([[float(m[k]) for m in row] for row in history])
        for k in history[0][0]
    } if history else {}
    return [s["state"].field for s in scenes], metrics


def param_grid(**axes) -> List[dict]:
    """Cartesian-product experiment combos (the reference's
    ``get_param_list``)."""
    import itertools

    keys = list(axes)
    return [dict(zip(keys, values)) for values in itertools.product(*(axes[k] for k in keys))]
