"""The port's mesh (``parallel/mesh.py``), its train step, sync batch
norm and the multi-rank dry run, on gloo ranks on the CPU.

Each world size is one launch of spawned processes (module-scoped
fixtures; the rank bodies are in tests/test_torch_mesh_ranks.py), and each
check of its report is a test of its own:

- data 2 × model 1: the data-parallel step against the one-process step
  over the whole batch, gradients within 1e-6 of each leaf's largest;
- data 1 × model 2 (and 2 × 2 on four ranks): the sharded step against
  the unsharded one, the mse and the app TV within 1e-6 relative,
  gradients within 1e-5 of each leaf's largest (each shard against its
  slice of the whole field's gradient);
- ``sync_batch_norm`` with the batch split over the ranks against the
  one-process call, forward and backward within 1e-6, and the
  one-process call against JAX's ``sync_batch_norm`` within 1e-6;
- tests/test_multihost.py's counterpart: two processes run
  ``run_farm(distributed=True)`` (prompts strided by rank) and one
  data-parallel step whose gradient all-reduce crosses the processes;
- ``dryrun_multichip(4)`` completes on a 2 × 2 mesh;
- in this process: ``shard_params`` gives each parameter the shape and
  values of ``param_sharding_spec`` for every decomposition.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2nerf_tpu.models import monodepth as JMD
from text2nerf_tpu_torch.models import monodepth as MD
from text2nerf_tpu_torch.parallel import dryrun

TESTS = os.path.dirname(os.path.abspath(__file__))


def _launch(target, world, tmp_path_factory):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([TESTS, env.get("PYTHONPATH", "")])
    work = tmp_path_factory.mktemp(target)
    return dryrun.launch(f"test_torch_mesh_ranks:{target}", world, work, timeout=300, env=env)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _launch("two_ranks", 2, tmp_path_factory)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _launch("four_ranks", 4, tmp_path_factory)


@pytest.mark.parametrize("rank", [0, 1])
def test_data_parallel_step_equals_the_whole_batch_step(two, rank):
    r = two[rank]["dp"]
    assert r["grad_rel"] <= 1e-6, r
    assert r["mse_rel"] <= 1e-6, r


@pytest.mark.parametrize("rank", [0, 1])
def test_model_sharded_step_equals_the_unsharded_step(two, rank):
    r = two[rank]["mp"]
    assert r["mse_rel"] <= 1e-6 and r["tv_app_rel"] <= 1e-6, r
    assert r["grad_rel"] <= 1e-5, r


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_data_and_model_sharded_step_on_four_ranks(four, rank):
    r = four[rank]["dp_mp"]
    assert r["mse_rel"] <= 1e-6 and r["tv_app_rel"] <= 1e-6, r
    assert r["grad_rel"] <= 1e-5, r


@pytest.mark.parametrize("world", [2, 4])
def test_sync_batch_norm_split_over_ranks(two, four, world):
    for r in (two if world == 2 else four):
        assert r["bn"]["fwd"] <= 1e-6 and r["bn"]["bwd"] <= 1e-6, r["bn"]
        assert r["bn"]["layer"] <= 1e-6, r["bn"]


def test_sync_batch_norm_matches_jax():
    x = np.random.default_rng(0).standard_normal((6, 5, 4, 3)).astype(np.float32)  # NHWC
    want = np.asarray(JMD.sync_batch_norm(jnp.asarray(x)))
    got = MD.sync_batch_norm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_sync_batch_norm_layer_running_average_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 4, 4, 3)).astype(np.float32)
    layer = JMD.SyncBatchNorm()
    stats = {"mean": jnp.asarray([0.1, -0.2, 0.3]), "var": jnp.asarray([0.5, 2.0, 1.5])}
    params = {"scale": jnp.asarray([0.5, 1.0, 2.0]), "bias": jnp.asarray([0.1, 0.0, -0.1])}
    want_run = layer.apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    want_batch = layer.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                             use_running_average=False)
    bn = MD.SyncBatchNorm(3)
    with torch.no_grad():
        for name, v in (*params.items(), *stats.items()):
            getattr(bn, name).copy_(torch.from_numpy(np.array(v)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for got, want in ((bn(xt), want_run), (bn(xt, use_running_average=False), want_batch)):
        np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("model_name", ["vm_split", "vm", "cp"])
@pytest.mark.parametrize("model", [1, 2])
def test_shard_params_follows_the_sharding_spec(model_name, model):
    """Each rank's shard field holds, for every parameter, the shape and
    the values that ``param_sharding_spec`` gives it; the density
    channels are whole on every rank, and the ranks' app slices and basis
    rows put back together are the whole field's (bit for bit)."""
    import dataclasses

    from text2nerf_tpu_torch.models import tensorf as tf
    from text2nerf_tpu_torch.parallel import mesh as pmesh

    cfg = dataclasses.replace(tf.TensoRFConfig(), model_name=model_name,
                              density_n_comp=(2, 3, 1), app_n_comp=(4, 6, 2))
    field = tf.TensoRF(cfg, (5, 6, 7), device="cpu")
    with torch.no_grad():
        g = torch.Generator().manual_seed(0)
        for p in field.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    nd, na = tf.component_counts(cfg)
    whole = dict(field.named_parameters())
    shards = []
    for rank in range(model):
        mesh = pmesh.Mesh(data=1, model=model, rank=rank, data_group=None, model_group=None)
        specs = pmesh.param_sharding_spec(field, mesh)
        shard = pmesh.shard_params(field, mesh)
        got = dict(shard.named_parameters())
        assert got.keys() == whole.keys() == specs.keys()
        for name, p in whole.items():
            assert tuple(got[name].shape) == specs[name].shard_shape(p.shape, mesh), name
            assert torch.equal(got[name], specs[name].take(p, mesh)), name
            split = name.startswith(("planes.", "lines.", "basis")) and model > 1
            assert (specs[name].dim is not None) == split, name
        shards.append(got)
    for kind, tables in (("planes", field.planes), ("lines", field.lines)):
        for i, t in enumerate(tables):
            name = f"{kind}.{i}"
            for s in shards:
                assert torch.equal(s[name][..., :nd[i]], t[..., :nd[i]]), name
            app = torch.cat([s[name][..., nd[i]:] for s in shards], -1)
            assert torch.equal(app, t[..., nd[i]:]), name
    blocks = na[:1] if field.is_cp else na
    off = np.concatenate([[0], np.cumsum(blocks)]).tolist()
    rows = [torch.cat([s["basis"][off[i] // model:off[i + 1] // model] for s in shards])
            for i in range(len(blocks))]
    assert torch.equal(torch.cat(rows), field.basis)


def test_two_process_distributed_farm(tmp_path_factory):
    reports = _launch("distributed_farm", 2, tmp_path_factory)
    s0, s1 = set(reports[0]["scenes"]), set(reports[1]["scenes"])
    assert s0 == {"scene prompt 0", "scene prompt 2", "scene prompt 4"}
    assert s1 == {"scene prompt 1", "scene prompt 3"}
    assert reports[0]["result_procs"] == [0] and reports[1]["result_procs"] == [1]
    # the cross-process step: one loss and one averaged gradient on both ranks
    assert np.isfinite(reports[0]["mse"]) and reports[0]["mse"] == reports[1]["mse"]
    assert reports[0]["basis_grad_sum"] == reports[1]["basis_grad_sum"]
    for r in reports:
        assert r["dp"]["grad_rel"] <= 1e-6, r["dp"]


def test_dryrun_multichip_four_ranks():
    reports = dryrun.dryrun_multichip(4, timeout=300)
    assert [r["rank"] for r in reports] == [0, 1, 2, 3]
    assert all(r["mesh"] == {"data": 2, "model": 2} for r in reports)
    # the loss is reduced over the whole mesh, the renders over "model"
    assert len({r["mse"] for r in reports}) == 1 and np.isfinite(reports[0]["mse"])
    assert len({r["rgb_sum"] for r in reports}) == 1
