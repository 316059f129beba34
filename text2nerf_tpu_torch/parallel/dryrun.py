"""Multi-rank dry run on the CPU (the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``), and the launcher it uses.

:func:`dryrun_multichip` starts n processes, one rank each, joined by a
gloo process group over ``tcp://127.0.0.1:<free port>``, on a mesh of
data n/2 × model 2 (data n × model 1 for odd n).  Every rank runs, on its
part of the batch and its shard of a tiny field:

- the dense train step (R = 2 sub-batches, density_group 2);
- the compacted train step (K 8, depth band 2) under an all-live pool-5
  alpha mask;
- ``render_chunked_adaptive`` with the field sharded (rung ladder 4, 8,
  16);
- a diffusion candidate batch through the tiny pipeline, one candidate
  per rank (rank r denoises row r of the batch's initial latents);
- one ``expand_scene`` at 32² with the field sharded.

:func:`launch` runs ``module:function(rank, world, workdir)`` on each of
``world`` ranks the same way (``python -m
text2nerf_tpu_torch.parallel.dryrun --run module:function ...``); each
rank's returned dict is written to ``workdir/rank<r>.json`` and the list
is returned.  A rank that fails, or a run past ``timeout``, raises with
the ranks' output; every process is stopped before it returns.
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(target: str, world: int, workdir, timeout: float = 600.0, env=None,
           threads: int = 1) -> list:
    """Run ``target`` ('module:function') on ``world`` gloo ranks; returns
    the ranks' dicts in rank order."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    port = free_port()
    penv = dict(os.environ if env is None else env)
    paths = [str(ROOT), *[p for p in penv.get("PYTHONPATH", "").split(os.pathsep) if p]]
    penv["PYTHONPATH"] = os.pathsep.join(paths)
    penv["OMP_NUM_THREADS"] = str(threads)
    procs, logs = [], []
    try:
        for r in range(world):
            log = open(workdir / f"rank{r}.log", "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "text2nerf_tpu_torch.parallel.dryrun", "--run", target,
                 "--rank", str(r), "--world", str(world), "--port", str(port),
                 "--workdir", str(workdir), "--threads", str(threads)],
                cwd=str(ROOT), env=penv, stdout=log, stderr=subprocess.STDOUT,
            ))
        # the first rank to fail (or the time limit) ends the run: its
        # peers would wait in a collective for it
        deadline = time.monotonic() + timeout
        failed = []
        while not failed and any(p.poll() is None for p in procs):
            failed = [(r, p.returncode) for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if time.monotonic() > deadline:
                failed = failed or [(r, "timeout") for r, p in enumerate(procs)
                                    if p.poll() is None]
            time.sleep(0.05)
        failed = failed or [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
        if failed:
            text = []
            for r, log in enumerate(logs):
                log.flush()
                log.seek(0)
                text.append(f"--- rank {r} ---\n{log.read()[-4000:]}")
            raise RuntimeError(f"{target}: rank {failed[0][0]} ended with {failed[0][1]}\n"
                               + "\n".join(text))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    return [json.loads((workdir / f"rank{r}.json").read_text()) for r in range(world)]


def _rank_main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    torch.set_num_threads(args.threads)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args.port}",
                            rank=args.rank, world_size=args.world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mod_name, fn_name = args.run.split(":")
        out = getattr(importlib.import_module(mod_name), fn_name)(
            args.rank, args.world, args.workdir)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    path = Path(args.workdir) / f"rank{args.rank}.json"
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(out or {}))
    os.replace(tmp, path)
    return 0


def dryrun_multichip(n_devices: int, timeout: float = 600.0) -> list:
    """The dry run on ``n_devices`` CPU ranks (see the module docstring);
    returns each rank's report."""
    with tempfile.TemporaryDirectory(prefix="t2n_dryrun_") as work:
        return launch("text2nerf_tpu_torch.parallel.dryrun:_dryrun_rank", n_devices, work,
                      timeout=timeout)


def _dryrun_rank(rank: int, world: int, workdir: str) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..data import scene_state as ss
    from ..engine import expansion as exp
    from ..engine import io_async
    from ..engine import train_step as ts
    from ..models import tensorf as tf
    from ..ops import render as render_ops
    from ..services import fallbacks
    from ..services.diffusion_service import DiffusionPipeline
    from ..services.merge import DepthMergeService
    from ..services.registry import Services
    from . import mesh as pmesh

    dev = torch.device("cpu")
    model_axis = 2 if world % 2 == 0 else 1
    mesh = pmesh.make_mesh(data=world // model_axis, model=model_axis)

    cfg = tf.TensoRFConfig(density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8), app_dim=12,
                           fea_pe=2, feature_c=32)
    grid = (16, 16, 16)
    aabb = torch.tensor([[-8.0] * 3, [8.0] * 3])
    field = tf.init_params(cfg, grid, generator=torch.Generator().manual_seed(0), device=dev)
    shard = pmesh.shard_params(field, mesh)
    state, opt = ts.make_train_state(shard, factor=ts.lr_factor(0.1, 100))
    assert tf.grouping_block(aabb.numpy(), grid, cfg.step_ratio) == 3
    step = ts.make_train_step(shard.cfg, opt, n_samples=16, app_k=8, microbatch=2,
                              density_group=2, density_block=3, device=dev, mesh=mesh)

    b = 16 * world
    rng = np.random.default_rng(0)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([np.zeros((b, 3), np.float32), d], -1)
    batch = pmesh.shard_batch({
        "rays": torch.from_numpy(rays),
        "rgb": torch.from_numpy(rng.uniform(0, 1, (b, 3)).astype(np.float32)),
        "depth": torch.full((b,), 4.0),
    }, mesh)
    state, metrics = step(state, aabb, batch, torch.Generator().manual_seed(1))
    assert np.isfinite(float(metrics["mse"]))

    mask = {"volume": torch.ones(16, 16, 16), "aabb": aabb, "pool": 5}
    step_c = ts.make_train_step(shard.cfg, opt, n_samples=16, app_k=8, microbatch=2,
                                microbatch_compact=1, density_group=2, density_block=3,
                                compact_k=8, depth_cap_band=2, device=dev, mesh=mesh)
    state, metrics_c = step_c(state, aabb, batch, torch.Generator().manual_seed(2),
                              alpha_mask=mask)
    assert np.isfinite(float(metrics_c["mse"]))

    with torch.no_grad():
        out_a, ks_a = render_ops.render_chunked_adaptive(
            state.field, aabb, torch.from_numpy(rays), mask, n_samples=16, chunk=16,
            app_k=8, k_ladder=(4, 8, 16), device=dev,
        )
    assert torch.isfinite(out_a.rgb).all()
    assert len(ks_a) == b // 16 and all(k in (4, 8, 16) for k in ks_a), ks_a

    # a diffusion candidate batch, one candidate per rank
    pipe = DiffusionPipeline("", inpaint=False, hw=(32, 32), tiny=True, num_steps=2,
                             dtype=torch.float32, device=dev)
    f = pipe.latent_factor
    latents = torch.randn((world, pipe.vae_cfg.latent_channels, 32 // f, 32 // f),
                          generator=torch.Generator().manual_seed(0))
    img = pipe.generate("multichip dryrun", num_images=1, latents=latents[rank:rank + 1])[0]
    cands = [torch.zeros(img.shape) for _ in range(world)]
    dist.all_gather(cands, torch.from_numpy(np.ascontiguousarray(img, np.float32)))
    assert len(cands) == world and all(torch.isfinite(c).all() for c in cands)

    # one expansion step with the field sharded
    hw = (32, 32)
    root = os.path.join(workdir, f"expansion_rank{rank}")
    scene_cfg = ss.SceneConfig(datadir=root + "/data", prompt="multichip dryrun scene",
                               pose_traj="circle0_30", num_training=2, hw=hw,
                               num_filter_iter=2, filter_size=(3, 3))
    services = Services(
        text2img=lambda p, n="": fallbacks.procedural_text2img(p, n, hw=hw),
        inpaint=lambda *a, **k: fallbacks.diffusion_fill_inpaint(*a, device=dev, **k),
        estimate_depth=fallbacks.procedural_depth, rank=fallbacks.histogram_rank,
        merge=DepthMergeService(net_size=64, num_downs=4, device=dev),
    )
    scene = ss.bootstrap_scene(scene_cfg, "train", services.text2img, services.estimate_depth,
                               device=dev)
    exp_cfg = exp.ExpansionConfig(prompt=scene_cfg.prompt, n_candidates=2,
                                  candidates_per_round=2, merge_iters=2, chunk=256, app_k=8)
    state.field.requires_grad_(False)
    scene2 = exp.expand_scene(1, state.field, scene, services, exp_cfg, root + "/log",
                              n_samples=16, seed=0, device=dev)
    io_async.flush(root + "/log")
    assert "00001" in scene2.updates
    assert np.isfinite(scene2.rgbs_gen_split[1]).all()
    assert np.isfinite(scene2.depth_gen_split[1]).all()
    return {
        "rank": rank, "mesh": mesh.shape, "data_index": mesh.data_index,
        "model_index": mesh.model_index, "mse": float(metrics["mse"]),
        "mse_compact": float(metrics_c["mse"]), "ks": [int(k) for k in ks_a],
        "rgb_sum": float(out_a.rgb.sum()), "candidate_mean": float(cands[rank].mean()),
    }


if __name__ == "__main__":
    raise SystemExit(_rank_main())
