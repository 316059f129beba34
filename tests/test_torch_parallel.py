"""The port's scene farm (``parallel/scene_farm.py``) against the JAX
package's, on the CPU.

- The bookkeeping: ``collect_phase_times``, ``device_idle_seconds`` and
  ``param_grid`` equal JAX's on seeded ``metrics.jsonl`` trees (exact:
  the same float sums in the same order); ``claim_and_run`` is
  idempotent.
- The farm end to end: ``run_farm`` + ``progressive_runner`` run two
  prompts at tests/test_scene_farm.py's sizes (40², 32³, batch 512,
  1/1/1 epochs, merge net 64 / 6 downs); the second pass is served from
  the markers with equal ``wall_s``.
- ``run_farm_parallel`` on ``["cpu", "cpu"]`` with one failed scene: the
  roster and the markers as JAX's test expects them.
- ``fit_scenes_mesh``: S = 2 at tests/test_scene_farm.py's config, JAX's
  jitter drawn with jax.random and injected; after 3 steps each scene's
  params are within 1e-5 of each leaf's largest of JAX's, and over 40
  steps every scene's PSNR rises by more than 1 dB.
- ``params_from_jax(stacked=True)`` / ``params_to_jax([...])`` carry a
  farm's stacked params bit for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2nerf_tpu.engine import train_step as jts
from text2nerf_tpu.engine.checkpoints import _flatten
from text2nerf_tpu.models import tensorf as jtf
from text2nerf_tpu.ops import rays as JR
from text2nerf_tpu.parallel import scene_farm as jfarm
from text2nerf_tpu_torch.data import scene_state as pss
from text2nerf_tpu_torch.engine import checkpoints as PC
from text2nerf_tpu_torch.engine import expansion as pexp
from text2nerf_tpu_torch.engine import trainer as ptrainer
from text2nerf_tpu_torch.models import tensorf as ptf
from text2nerf_tpu_torch.parallel import scene_farm as farm
from text2nerf_tpu_torch.services import fallbacks as pfb
from text2nerf_tpu_torch.services import registry as preg
from text2nerf_tpu_torch.services.merge import DepthMergeService

torch.set_num_threads(2)

PHASES = ("bootstrap", "bootstrap_seed_image", "bootstrap_depth", "bootstrap_bilateral",
          "view003_dibr_holefill", "expand1_support_pool", "expand1_render", "stage1",
          "warmup_join", "expand2_inpaint")


def _metrics_tree(root, seed, with_subs=True):
    """A scene log tree of seeded metrics.jsonl files: phase scalars
    (with or without the bootstrap sub-phases), other scalars and a
    corrupt line."""
    rng = np.random.default_rng(seed)
    names = [p for p in PHASES if with_subs or not p.startswith("bootstrap_")]
    for sub in ("", "stage2", "stage2/deeper"):
        d = os.path.join(root, sub)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "metrics.jsonl"), "w") as f:
            for _ in range(6):
                rec = {f"phase/{rng.choice(names)}_s": float(rng.uniform(0, 3)),
                       "mse": float(rng.uniform()), "step": int(rng.integers(100))}
                f.write(json.dumps(rec) + "\n")
            f.write("{not json\n")
        with open(os.path.join(d, "other.jsonl"), "w") as f:
            f.write(json.dumps({"phase/bootstrap_s": 99.0}) + "\n")


@pytest.mark.parametrize("seed,with_subs", [(0, True), (1, True), (2, False)])
def test_phase_times_and_idle_match_jax(tmp_path, seed, with_subs):
    _metrics_tree(str(tmp_path), seed, with_subs)
    got = farm.collect_phase_times(str(tmp_path))
    want = jfarm.collect_phase_times(str(tmp_path))
    assert got == want and got
    assert farm.device_idle_seconds(got) == jfarm.device_idle_seconds(want)
    if not with_subs:  # the parent timer counts when it has no children
        assert farm.device_idle_seconds(got) >= got.get("bootstrap", 0.0)


def test_param_grid_matches_jax():
    axes = dict(lr=[0.1, 0.2], bs=[4, 8, 16], mode=["a"])
    assert farm.param_grid(**axes) == jfarm.param_grid(**axes)
    assert len(farm.param_grid(**axes)) == 6


def test_claim_and_run_is_idempotent(tmp_path):
    calls = []

    def run(job):
        calls.append(job.prompt)
        return {"psnr": 30.0}

    job = farm.FarmJob("a cat", str(tmp_path / "d"), str(tmp_path / "l"))
    first = farm.claim_and_run(job, run)
    again = farm.claim_and_run(job, run)
    assert calls == ["a cat"] and again == first
    assert os.path.exists(tmp_path / "l" / "FARM_DONE.json")
    assert set(first) >= {"psnr", "t_start", "t_end", "wall_s", "prompt"}
    farm.claim_and_run(job, run, force=True)
    assert calls == ["a cat", "a cat"]


def _progressive_configs(hw, prefix, **train_kw):
    scene_cfg = pss.SceneConfig(datadir="", prompt="", pose_traj="circle0_60", num_training=2,
                                hw=hw)
    train_cfg = ptrainer.TrainConfig(expname=prefix, basedir="", n_stage1=1, n_stage2=1,
                                     n_stage3=1, eval_every_epochs=10 ** 6, train_microbatch=4,
                                     **train_kw)
    return scene_cfg, train_cfg


def _services(hw, device):
    return preg.Services(
        text2img=lambda p, n="": pfb.procedural_text2img(p, n, hw=hw),
        inpaint=lambda *a, **k: pfb.diffusion_fill_inpaint(*a, device=device, **k),
        estimate_depth=pfb.procedural_depth, rank=pfb.histogram_rank,
        merge=DepthMergeService(net_size=64, num_downs=6, device=device),
    )


def test_progressive_runner_farms_full_scenes(tmp_path):
    hw = (40, 40)
    scene_cfg, train_cfg = _progressive_configs(hw, "farm", batch_size=512,
                                                n_voxel_init=32 ** 3, app_k=16, seed=3)
    exp_cfg = pexp.ExpansionConfig(prompt="", n_candidates=2, candidates_per_round=2,
                                   merge_iters=10, chunk=512, app_k=16)
    run = farm.progressive_runner(train_cfg, scene_cfg, _services(hw, "cpu"), exp_cfg,
                                  device="cpu")
    prompts = ["a tiny red room", "a tiny blue room"]
    r = farm.run_farm(prompts, str(tmp_path / "d"), str(tmp_path / "l"), run)
    assert len(r) == 2
    for res in r:
        assert res["views"] == 2 and len(res["per_view_psnr"]) == 2
        assert all(np.isfinite(p) for p in res["per_view_psnr"])
        assert os.path.exists(os.path.join(res["logfolder"], "metrics.jsonl"))
        assert res["device_idle_s"] >= 0 and res["phase_s"].get("bootstrap", 0) > 0
    r2 = farm.run_farm(prompts, str(tmp_path / "d"), str(tmp_path / "l"), run)
    assert [x["wall_s"] for x in r2] == [x["wall_s"] for x in r]


def test_run_farm_parallel_survives_one_failed_scene(tmp_path):
    seen = []

    def run(job):
        seen.append((job.prompt, str(farm.worker_device())))
        if "bad" in job.prompt:
            raise RuntimeError("boom")
        return {"ok": True}

    with pytest.raises(RuntimeError, match="boom") as ei:
        farm.run_farm_parallel(["a good scene", "a bad scene", "another good scene"],
                               str(tmp_path / "d"), str(tmp_path / "l"), run,
                               devices=["cpu", "cpu"])
    assert ei.value.farm_failed == [(1, "a bad scene")]
    done = [r for r in ei.value.farm_results if r]
    assert len(done) == 2 and all(r["ok"] and r["device"] == "cpu" for r in done)
    assert ei.value.farm_results[1] is None
    assert sorted(p for p, _ in seen) == sorted(["a good scene", "a bad scene",
                                                 "another good scene"])
    assert {d for _, d in seen} == {"cpu"}
    markers = [f for _, _, fs in os.walk(tmp_path / "l") for f in fs if f == "FARM_DONE.json"]
    assert len(markers) == 2
    # a rerun runs only the failure
    seen.clear()
    with pytest.raises(RuntimeError):
        farm.run_farm_parallel(["a good scene", "a bad scene", "another good scene"],
                               str(tmp_path / "d"), str(tmp_path / "l"), run,
                               devices=["cpu"])
    assert [p for p, _ in seen] == ["a bad scene"]


# ---------------------------------------------------------------------------
# fit_scenes_mesh against JAX
# ---------------------------------------------------------------------------

MESH_CFG = jtf.TensoRFConfig(density_n_comp=(2, 2, 2), app_n_comp=(4, 4, 4), app_dim=6,
                             fea_pe=2, feature_c=16)
MESH_KW = dict(batch_size=128, n_samples=48, app_k=16, factor=1.0, seed=0)


def _mesh_scenes(n_scenes):
    """tests/test_scene_farm.py's scenes: a 16x16 forward view per scene,
    a coloured wall whose colour and depth differ per scene."""
    aabb = np.array([[-8.0] * 3, [8.0] * 3], np.float32)
    params = [jtf.init_params(jax.random.PRNGKey(i), MESH_CFG, (24, 24, 24))
              for i in range(n_scenes)]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *params)
    h = w = 16
    fx, fy, cx, cy = JR.default_intrinsics(h, w)
    dirs = JR.ray_directions(h, w, (fx, fy), (cx, cy))
    o, d = JR.rays_from_pose(jnp.asarray(dirs), jnp.eye(4))
    rays = np.asarray(jnp.concatenate([o, d], -1)).reshape(-1, 6)
    uv = np.asarray(dirs).reshape(-1, 3)[:, :2]
    pools = []
    for i in range(n_scenes):
        base = (i + 1) / (n_scenes + 1)
        rgb = np.stack([base + 0.3 * uv[:, 0], 0.5 + 0.4 * uv[:, 1],
                        1.0 - base + 0 * uv[:, 0]], -1).astype(np.float32)
        pools.append((rays, rgb, np.full((h * w,), 4.0 + 0.2 * i, np.float32)))
    return stacked, np.repeat(aabb[None], n_scenes, 0), pools


def _jax_draws(n_scenes, n_steps, seed, b, r):
    """The jitter each scene's step draws in JAX's fit_scenes_mesh: the
    step keys split from PRNGKey(seed), then tests/test_torch_train_step.py's
    _step_draws."""
    from test_torch_train_step import _step_draws

    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_steps):
        key, *ks = jax.random.split(key, n_scenes + 1)
        out.append([_step_draws(k, b, r, True) for k in ks])
    return out


def test_fit_scenes_mesh_matches_jax():
    n_scenes, n_steps = 2, 3
    stacked, aabbs, pools = _mesh_scenes(n_scenes)
    fields = PC.params_from_jax(_flatten(stacked), MESH_CFG, device="cpu", stacked=True)
    want, _ = jfarm.fit_scenes_mesh(MESH_CFG, stacked, aabbs, pools, n_steps=n_steps,
                                    **MESH_KW)
    r = jts.effective_microbatch(MESH_KW["batch_size"], 32)
    draws = _jax_draws(n_scenes, n_steps, MESH_KW["seed"], MESH_KW["batch_size"], r)
    got, metrics = farm.fit_scenes_mesh(
        MESH_CFG, fields, aabbs, pools, n_steps=n_steps, devices=["cpu"],
        draws=lambda t, i: draws[t][i], **MESH_KW)
    assert metrics["psnr"].shape == (n_steps, n_scenes)
    want_flat = _flatten(jax.tree.map(np.asarray, want))
    got_flat = PC.params_to_jax(got)
    assert set(got_flat) == set(want_flat)
    for k, w in want_flat.items():
        err = np.abs(got_flat[k] - w).max() / np.abs(w).max()
        assert err <= 1e-5, (k, err)


def test_fit_scenes_mesh_psnr_rises():
    n_scenes = 2
    stacked, aabbs, pools = _mesh_scenes(n_scenes)
    fields = PC.params_from_jax(_flatten(stacked), MESH_CFG, device="cpu", stacked=True)
    _, metrics = farm.fit_scenes_mesh(MESH_CFG, fields, aabbs, pools, n_steps=40,
                                      devices=["cpu", "cpu"], **MESH_KW)
    psnr = metrics["psnr"]
    assert psnr.shape == (40, n_scenes)
    assert (psnr[-1] > psnr[0] + 1.0).all(), (psnr[0], psnr[-1])


def test_stacked_params_round_trip_bit_for_bit():
    stacked, _, _ = _mesh_scenes(3)
    flat = {k: np.asarray(v) for k, v in _flatten(stacked).items()}
    fields = PC.params_from_jax(flat, MESH_CFG, device="cpu", stacked=True)
    assert len(fields) == 3 and all(isinstance(f, ptf.TensoRF) for f in fields)
    back = PC.params_to_jax(fields)
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    one = PC.params_to_jax(fields[1])
    for k, v in flat.items():
        assert np.array_equal(one[k], v[1]), k
