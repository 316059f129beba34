"""Rank bodies for tests/test_torch_mesh.py, run on gloo ranks by
``text2nerf_tpu_torch.parallel.dryrun.launch`` (imports no JAX).  The
module holds no test of its own.

Each returns a dict of measured errors; the test holds them to its
tolerances.  The field is tests/test_torch_train_step.py's tiny
configuration on a 16³ grid with its density factors set to a wall slab
at z in (3, 5), so the dense step's top-k selection has structure.
"""

import copy
import os

import numpy as np
import torch
import torch.distributed as dist

from text2nerf_tpu_torch.engine import train_step as ts
from text2nerf_tpu_torch.models import monodepth as md
from text2nerf_tpu_torch.models import tensorf as tf
from text2nerf_tpu_torch.parallel import mesh as pmesh
from text2nerf_tpu_torch.parallel import scene_farm

CFG = tf.TensoRFConfig(density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8), app_dim=12,
                       fea_pe=2, feature_c=32)
GRID = (16, 16, 16)
AABB = torch.tensor([[-8.0] * 3, [8.0] * 3])
STEP_KW = dict(n_samples=24, app_k=8, microbatch=1, device="cpu")


def wall_field():
    field = tf.init_params(CFG, GRID, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    zs = np.linspace(-8, 8, GRID[2])
    line = torch.tensor(np.where((zs > 3.0) & (zs < 5.0), 2.0, -2.0), dtype=torch.float32)
    with torch.no_grad():
        field.lines[0][:, :4] = line[:, None]
        field.planes[0][..., :4] = field.planes[0][..., :4].abs() + 1.0
    return field


def batch(b):
    rng = np.random.default_rng(0)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return {"rays": torch.from_numpy(np.concatenate([np.zeros((b, 3), np.float32), d], -1)),
            "rgb": torch.from_numpy(rng.uniform(0, 1, (b, 3)).astype(np.float32)),
            "depth": torch.full((b,), 4.0)}


def _grads(field):
    return [p.grad.detach().clone() for p in (*field.planes, *field.lines, field.basis)], \
        {k: field.mlp[k].grad.detach().clone() for k in ("w1", "b1", "w2", "b2", "w3", "b3")}


def _rel(a, b):
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def step_against_one_process(data, model, b=64, seed=3):
    """One mesh step against the one-process step over the whole batch:
    {'mse_rel', 'grad_rel' (the worst leaf's max error over its largest
    reference value)}."""
    mesh = pmesh.make_mesh(data=data, model=model)
    field0 = wall_field()
    ref = copy.deepcopy(field0)
    opt = ts.make_optimizer(ref)
    step = ts.make_train_step(CFG, opt, **STEP_KW)
    full = batch(b)
    _, m_ref = step(ts.TrainState(ref, opt, 0), AABB, full, torch.Generator().manual_seed(seed))

    shard = pmesh.shard_params(field0, mesh)
    opt_s = ts.make_optimizer(shard)
    step_s = ts.make_train_step(shard.cfg, opt_s, mesh=mesh, **STEP_KW)
    _, m = step_s(ts.TrainState(shard, opt_s, 0), AABB, pmesh.shard_batch(full, mesh),
                  torch.Generator().manual_seed(seed))

    (tables, basis), mlp = (lambda g: ((g[0][:-1], g[0][-1]), g[1]))(_grads(ref))
    want_tables, want_basis = pmesh.shard_tensors(ref, mesh, tables, basis)
    got, got_mlp = _grads(shard)
    errs = [_rel(g, w) for g, w in zip(got, [*want_tables, want_basis])]
    errs += [_rel(got_mlp[k], mlp[k]) for k in mlp]
    return {"mse_rel": abs(float(m["mse"]) - float(m_ref["mse"])) / float(m_ref["mse"]),
            "tv_app_rel": abs(float(m["reg_tv_app"]) - float(m_ref["reg_tv_app"]))
            / float(m_ref["reg_tv_app"]),
            "grad_rel": max(errs)}


def sync_bn_against_one_process(world):
    """sync_batch_norm with the batch split over the ranks against the
    one-process call: forward and the input's gradient, max abs error."""
    rank = dist.get_rank()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4 * world, 3, 5, 4))
                         .astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(x.shape).astype(np.float32))
    xr = x.clone().requires_grad_(True)
    ref = md.sync_batch_norm(xr)
    (ref * w).sum().backward()
    part = slice(4 * rank, 4 * (rank + 1))
    xl = x[part].clone().requires_grad_(True)
    out = md.sync_batch_norm(xl, group=dist.group.WORLD)
    (out * w[part]).sum().backward()
    bn = md.SyncBatchNorm(3, group=dist.group.WORLD)
    with torch.no_grad():
        bn.scale.copy_(torch.tensor([0.5, 1.0, 2.0]))
        bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
    layer = bn(x[part], use_running_average=False)
    want_layer = ref.detach()[part] * bn.scale.reshape(1, -1, 1, 1) + bn.bias.reshape(1, -1, 1, 1)
    return {"fwd": float((out - ref[part]).abs().max()),
            "bwd": float((xl.grad - xr.grad[part]).abs().max()),
            "layer": float((layer - want_layer).abs().max())}


def two_ranks(rank, world, workdir):
    torch.set_num_threads(1)
    out = {"dp": step_against_one_process(world, 1), "mp": step_against_one_process(1, world),
           "bn": sync_bn_against_one_process(world)}
    return out


def four_ranks(rank, world, workdir):
    torch.set_num_threads(1)
    return {"dp_mp": step_against_one_process(2, 2), "bn": sync_bn_against_one_process(world)}


def distributed_farm(rank, world, workdir):
    """tests/multihost_worker.py's checks: prompts strided by rank, then
    one data-parallel step whose gradient reduction crosses the process
    boundary."""
    prompts = [f"scene prompt {i}" for i in range(5)]
    ran = []

    def run(job):
        ran.append(job.prompt)
        return {"proc": dist.get_rank()}

    results = scene_farm.run_farm(prompts, os.path.join(workdir, "data"),
                                  os.path.join(workdir, f"log_p{rank}"), run, distributed=True)
    dp = step_against_one_process(world, 1, b=8 * world)
    mesh = pmesh.make_mesh(data=world, model=1)
    field = pmesh.shard_params(wall_field(), mesh)
    opt = ts.make_optimizer(field)
    step = ts.make_train_step(CFG, opt, mesh=mesh, **STEP_KW)
    _, m = step(ts.TrainState(field, opt, 0), AABB, pmesh.shard_batch(batch(8 * world), mesh),
                torch.Generator().manual_seed(1))
    return {"scenes": sorted(ran), "result_procs": sorted({r["proc"] for r in results}),
            "mse": float(m["mse"]), "dp": dp,
            "basis_grad_sum": float(field.basis.grad.sum())}
