"""The port's product tools (``text2nerf_tpu_torch/tools/``) against the
JAX package's (``tools/``), on the CPU:

- ``run_full_schedule`` at hw 32 on a 16³ grid, 3 views, stages 1 1 1, through
  ``main(..., device="cpu")`` (the field, the batch and the merge net cut
  to test size by wrapping its ``configs`` and the registry): its JSON
  line has every key of the JAX tool's, and ``tools/analyze_schedule_run.py``
  reads its ``metrics.jsonl``;
- on that run: ``report_phases`` prints what JAX's prints on the same log,
  ``compute_metrics`` gives JAX's PSNR and SSIM (1e-6) on its renders (and
  on a pair of another size, which both resize bilinearly), and
  ``rebuild_scene_snapshot`` rebuilds the snapshot JAX's tool rebuilds
  from the same artifact tree (within 1e-5), and the run's own within the
  PNGs' quantization;
- ``smoke_real_weights`` with no weights tree exits 0, every service
  falling back.
"""

import dataclasses
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from text2nerf_tpu_torch.data import scene_state as PSS
from text2nerf_tpu_torch.models import tensorf as ptf
from text2nerf_tpu_torch.services import registry as PREG
from text2nerf_tpu_torch.tools import compute_metrics as PCM
from text2nerf_tpu_torch.tools import rebuild_scene_snapshot as PRB
from text2nerf_tpu_torch.tools import report_phases as PRP
from text2nerf_tpu_torch.tools import run_full_schedule as PFS
from text2nerf_tpu_torch.tools import smoke_real_weights as PSW
from text2nerf_tpu_torch.utils.png import read_png, write_png

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

JAX_KEYS = ("status", "schedule", "hw", "grid", "views", "grid_init", "upsamp",
            "stage3_balance", "stage3_gamma", "wall_min_this_attempt", "per_view_psnr",
            "per_view_ssim", "mean_psnr", "mean_ssim", "logfolder")
TINY = ptf.TensoRFConfig(density_n_comp=(2, 2, 2), app_n_comp=(4, 4, 4), app_dim=6,
                         fea_pe=2, feature_c=16)


def _small_services(monkeypatch):
    real = PREG.default_services

    def small(*a, **kw):
        kw.update(merge_net_size=32, merge_num_downs=5)
        return real(*a, **kw)

    monkeypatch.setattr(PREG, "default_services", small)


def _last_json(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")][-1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One tiny run of the port's tool: (summary, log folder, stdout)."""
    out = tmp_path_factory.mktemp("fullsched")
    mp = pytest.MonkeyPatch()
    _small_services(mp)
    configs = PFS.configs

    def small_configs(args):
        train, scene, exp = configs(args)
        train = dataclasses.replace(train, batch_size=1024, train_microbatch=1, app_k=8,
                                    model=TINY, progress_refresh_rate=1)
        scene = dataclasses.replace(scene, num_filter_iter=2, filter_size=(3, 3))
        exp = dataclasses.replace(exp, merge_iters=2, chunk=256, app_k=8)
        return train, scene, exp

    mp.setattr(PFS, "configs", small_configs)
    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = PFS.main(["--out", str(out), "--hw", "32", "--grid", "16", "--grid_init", "12",
                       "--upsamp", "2", "4", "--stages", "1", "1", "1", "--views", "3",
                       "--candidates", "1",
                       "--report", str(out / "report.jsonl")], device="cpu")
    mp.undo()
    assert rc == 0
    summary = _last_json(buf.getvalue())
    return summary, summary["logfolder"], str(out)


def test_run_full_schedule_writes_every_key(run, capsys):
    summary, logfolder, out = run
    assert tuple(summary) == JAX_KEYS
    assert summary["status"] == "ok" and summary["grid_init"] == 12 and summary["upsamp"] == [2, 4]
    assert len(summary["per_view_psnr"]) == len(summary["per_view_ssim"]) == 3
    assert all(np.isfinite(summary["per_view_psnr"]))
    assert json.loads(open(os.path.join(out, "report.jsonl")).read()) == summary
    from tools.analyze_schedule_run import main as analyze

    assert analyze([os.path.join(out, "log"), "--milestones", "2", "4"]) == 0
    got = _last_json(capsys.readouterr().out)
    assert got["total_steps"] > 4 and got["seg_rates"] and "wall_min" in got


def test_report_phases_matches_jax(run, capsys):
    from tools.report_phases import main as jax_main

    logdir = os.path.join(run[2], "log")
    assert jax_main([logdir]) == 0
    want = _last_json(capsys.readouterr().out)
    assert PRP.main([logdir]) == 0
    got = _last_json(capsys.readouterr().out)
    assert got == want and got["expand_views_s"]


@pytest.mark.parametrize("pairs", ["renders", "resized"])
def test_compute_metrics_matches_jax(run, tmp_path, pairs):
    from tools.compute_metrics import main as jax_main

    final = os.path.join(run[1], "imgs_final")
    pred, gt = os.path.join(final, "rgbs"), os.path.join(final, "gt")
    if pairs == "resized":
        # predictions at another size: each tool resizes them bilinearly
        pred = str(tmp_path / "pred")
        os.makedirs(pred)
        rng = np.random.default_rng(0)
        for i in range(2):
            write_png(os.path.join(pred, f"{i:03d}.png"),
                      rng.integers(0, 256, (24, 40, 3), dtype=np.uint8))
    want_path, got_path = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    assert jax_main(["--pred", pred, "--gt", gt, "--out", want_path]) == 0
    assert PCM.main(["--pred", pred, "--gt", gt, "--out", got_path], device="cpu") == 0
    want, got = json.load(open(want_path)), json.load(open(got_path))
    assert got.keys() == want.keys()
    assert got["n_images"] == want["n_images"] == (3 if pairs == "renders" else 2)
    for key in ("psnr_per_image", "ssim_per_image"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6)


def test_rebuild_scene_snapshot_matches_jax(run, tmp_path):
    from tools.rebuild_scene_snapshot import main as jax_main

    logfolder = run[1]
    trees = {}
    for name, rebuild in (("jax", lambda lf: jax_main(["--logfolder", lf])),
                          ("port", lambda lf: PRB.main(["--logfolder", lf], device="cpu"))):
        lf = str(tmp_path / name)
        shutil.copytree(logfolder, lf)
        os.remove(os.path.join(lf, "scene_snapshot.npz"))
        assert rebuild(lf) == 0
        trees[name] = lf
    want = PSS.load_scene_snapshot(os.path.join(trees["jax"], "scene_snapshot.npz"))
    got = PSS.load_scene_snapshot(os.path.join(trees["port"], "scene_snapshot.npz"))
    assert got.rgbs_gen_split.shape == want.rgbs_gen_split.shape == (2, 32, 32, 3)
    for key in ("rgbs_gen_split", "depth_gen_split", "masks_gen_split", "poses_gen"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key), rtol=0, atol=1e-5,
                                   err_msg=key)
    # and both are the run's own snapshot (its last resume point, before
    # view 2's expansion, so view 1 came from the DIBR tree) within the
    # PNG quantization: one uint8 level of rgb, two steps of the uint16
    # depth PNG (1 / 12000 each)
    orig = PSS.load_scene_snapshot(os.path.join(logfolder, "scene_snapshot.npz"))
    assert orig.rgbs_gen_split.shape == got.rgbs_gen_split.shape
    assert np.abs(got.rgbs_gen_split - orig.rgbs_gen_split).max() < 5e-3
    assert np.abs(got.depth_gen_split - orig.depth_gen_split).max() <= 2.0 / 12000
    assert read_png(os.path.join(logfolder, "DIBR", "mask", "00001.png")).ndim == 2


def test_smoke_real_weights_without_weights(tmp_path, monkeypatch, capsys):
    _small_services(monkeypatch)
    configs = PSW.configs

    def small_configs(args, resolution):
        train, scene, exp = configs(args, resolution)
        train = dataclasses.replace(train, batch_size=1024, train_microbatch=1, app_k=8,
                                    model=TINY)
        scene = dataclasses.replace(scene, num_filter_iter=2, filter_size=(3, 3))
        return train, scene, dataclasses.replace(exp, merge_iters=2, chunk=256, app_k=8)

    monkeypatch.setattr(PSW, "configs", small_configs)
    rc = PSW.main(["--weights", str(tmp_path / "absent"), "--out", str(tmp_path / "run"),
                   "--hw", "24", "--views", "1", "--grid", "16", "--stages", "1", "0", "0"],
                  device="cpu")
    assert rc == 0
    summary = _last_json(capsys.readouterr().out)
    assert summary["status"] == "ok" and set(summary) == {
        "status", "services", "wall_min", "per_view_psnr", "logfolder"}
    assert set(summary["services"].values()) == {"fallback", "init"}
    assert PSW.service_resolution(str(tmp_path / "absent")) == summary["services"]
