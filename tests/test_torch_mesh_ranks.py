"""Rank bodies for tests/test_torch_mesh.py and
tests/test_torch_orbax_checkpoint.py, run on gloo ranks by
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

from text2nerf_tpu_torch.engine import checkpoints as ckpt
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


def batch(b, away=False):
    """b rays from the origin toward the wall; with ``away`` every other
    ray points away from it and sees the background."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.5
    if away:
        d[1::2, 2] *= -1
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return {"rays": torch.from_numpy(np.concatenate([np.zeros((b, 3), np.float32), d], -1)),
            "rgb": torch.from_numpy(rng.uniform(0, 1, (b, 3)).astype(np.float32)),
            "depth": torch.full((b,), 4.0)}


def _grads(field):
    return [p.grad.detach().clone() for p in (*field.planes, *field.lines, field.basis)], \
        {k: field.mlp[k].grad.detach().clone() for k in ("w1", "b1", "w2", "b2", "w3", "b3")}


def _rel(a, b):
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def step_against_one_process(data, model, b=64, seed=3, away=False, **step_kw):
    """One mesh step against the one-process step over the whole batch
    (``step_kw`` over STEP_KW on both sides): {'mse_rel', 'grad_rel' (the
    worst leaf's max error over its largest reference value)}."""
    mesh = pmesh.make_mesh(data=data, model=model)
    field0 = wall_field()
    ref = copy.deepcopy(field0)
    opt = ts.make_optimizer(ref)
    kw = {**STEP_KW, **step_kw}
    step = ts.make_train_step(CFG, opt, **kw)
    full = batch(b, away)
    _, m_ref = step(ts.TrainState(ref, opt, 0), AABB, full, torch.Generator().manual_seed(seed))

    shard = pmesh.shard_params(field0, mesh)
    opt_s = ts.make_optimizer(shard)
    step_s = ts.make_train_step(shard.cfg, opt_s, mesh=mesh, **kw)
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


ORTHO = dict(weights=ts.LossWeights(ortho=0.5))
RANDOM_BG = dict(white_bg=False, microbatch=4, away=True)


def reference_coins(b=64, seed=3, r=4):
    """The one-process step's coins: drawn after the whole batch's jitter."""
    g = torch.Generator().manual_seed(seed)
    torch.rand((b, 1), generator=g)
    return torch.rand((r,), generator=g).tolist()


def straddling_coins_raise(world):
    """data=world with R = 3 over 66 rays: a rank's 33 rows straddle the
    sub-batches of 22; the step raises (its message)."""
    mesh = pmesh.make_mesh(data=world, model=1)
    field = pmesh.shard_params(wall_field(), mesh)
    opt = ts.make_optimizer(field)
    step = ts.make_train_step(CFG, opt, mesh=mesh, **{**STEP_KW, "white_bg": False,
                                                       "microbatch": 3})
    try:
        step(ts.TrainState(field, opt, 0), AABB, pmesh.shard_batch(batch(66), mesh),
             torch.Generator().manual_seed(1))
    except ValueError as e:
        return str(e)
    return None


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
           "mp_ortho": step_against_one_process(1, world, **ORTHO),
           "dp_random_bg": step_against_one_process(world, 1, **RANDOM_BG),
           "straddle": straddling_coins_raise(world), "coins": reference_coins(),
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


ORBAX_MODELS = ("vm_split", "cp", "vm")


def orbax_field(name):
    """A tiny seeded field; vm_split's axes of unequal widths."""
    nd, na = ((2, 3, 1), (4, 6, 2)) if name == "vm_split" else ((2,) * 3, (4,) * 3)
    cfg = tf.TensoRFConfig(model_name=name, density_n_comp=nd, app_n_comp=na, app_dim=6,
                           fea_pe=2, feature_c=16)
    return tf.init_params(cfg, (5, 6, 7), generator=torch.Generator().manual_seed(0),
                          device="cpu")


def _same(a, b):
    """Bit-equal parameters (names, shapes, values) and config."""
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    return (a.cfg.to_dict() == b.cfg.to_dict() and pa.keys() == pb.keys()
            and all(torch.equal(pa[k], pb[k]) for k in pa))


def _distcp_bytes(path):
    return {n: os.path.getsize(os.path.join(path, n)) for n in sorted(os.listdir(path))
            if n.endswith(".distcp")}


def orbax_ranks(rank, world, workdir):
    """Sharded saves and restores of each decomposition, at model 2 and at
    data 2 (two ranks): each rank's restored shard against
    ``shard_params(whole)``, the one-process restore against the whole
    field, and the bytes each rank wrote."""
    torch.set_num_threads(1)
    meshes = {"model2": pmesh.make_mesh(data=1, model=world),
              "data2": pmesh.make_mesh(data=world, model=1)}
    aabb = torch.tensor([[-1.0] * 3, [1.0] * 3])
    out = {}
    for name in ORBAX_MODELS:
        whole = orbax_field(name)
        one = os.path.join(workdir, f"{name}_one")
        if rank == 0:
            ckpt.save_orbax(one, whole, aabb, loop_state={"epoch": 1})
        dist.barrier()
        for tag, mesh in meshes.items():
            path = os.path.join(workdir, f"{name}_{tag}")
            shard = pmesh.shard_params(whole, mesh)
            ckpt.save_orbax(path, shard, aabb, loop_state={"epoch": 1}, mesh=mesh)
            cfg, got, got_aabb, loop = ckpt.load_orbax(path, mesh=mesh, device="cpu")
            res = {"shard_equal": _same(got, shard),
                   "reduce": (got.app_reduce is None) == (shard.app_reduce is None),
                   "cfg_whole": cfg.to_dict() == whole.cfg.to_dict(),
                   "aabb": torch.equal(got_aabb, aabb), "loop": loop,
                   "files": sorted(os.listdir(path)), "distcp": _distcp_bytes(path),
                   "one_distcp": _distcp_bytes(one)}
            dist.barrier()
            if rank == 0:
                cfg1, got1, aabb1, loop1 = ckpt.load_orbax(path, device="cpu")
                res.update(whole_equal=_same(got1, whole), whole_aabb=torch.equal(aabb1, aabb),
                           whole_loop=loop1)
            out[f"{name}_{tag}"] = res
    return out
