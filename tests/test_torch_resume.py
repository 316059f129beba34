"""The port's crash-safe resume against the JAX package's, on the CPU, at
tiny size (hw 32, ``circle0_30``, 2 views; 1 stage-1 epoch, 2 stage-2
epochs, 2 stage-3 epochs; batch 512; grid 12³ → 20³ at step 3, the alpha
mask, the shrink and the L1 switch at step 6; a pool-5 mask, so stages 2
and 3 train compacted; ``resume_every_epochs = 1``).  Every resume point
a run writes is kept: epoch 1 is the stage-2 boundary, epoch 2 mid-stage
2, epoch 3 the entry of stage 3.  Both fits start from one slab field
written by the JAX package.

Held, with the tolerances stated (the worst seen in brackets):
- the snapshots of both packages hold the same keys; the pools the
  port's ``load_scene_snapshot(n_views_pools=2)`` rebuilds from a
  snapshot of either package equal JAX's: rays equal, rgb within 1e-6
  (equal), depth within 1e-6 of its largest (3 fp32 ulps at depth 5:
  2.7e-7 of 5.3);
- both packages resumed from the JAX run's files, at the boundary,
  mid-stage 2 and at the entry of stage 3, with the JAX trainer's jitter
  injected into the port's steps (as in test_torch_expansion.py): the
  sampler ids and the step count equal, the per-step mse within 1e-5
  relative (6e-7), ``resume_epoch`` logged, no bootstrap;
- the other direction: the JAX trainer resumes mid-stage 2 from the
  port's files and tracks the port resumed from them, held the same way
  (both recompute the sample count from the restored grid);
- crash and resume: on a schedule whose alpha-mask milestone falls after
  the resume point (the reference's crash test has none), a port run
  whose inpaint dies at the expansion (after the boundary's save), rerun,
  trains at the fit's sample count and reaches its uninterrupted
  control's per-view PSNRs within 0.5 dB (the JAX test's bound).  A
  resume after the shrink marches the shrunk grid's count in both
  packages (10 samples here against the fit's 34; ROADMAP §3), which the
  cross-package cases above hold;
- fast-forward: a 3-view run resumes at the last stage-2 boundary with
  3 views, as tests/test_resume.py::test_resume_fast_forwards;
- ``main --resume 1 --resume_every_epochs 2`` hands both to the trainer.
"""

import contextlib
import dataclasses
import functools
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_expansion import (MODEL, PROMPT, _expansion_cfg, _no_warmup, _scene_cfg,
                                  _services)
from test_torch_scene import slab_params
from test_torch_trainer import _jax_key_stream, _Recorder, _rows
from text2nerf_tpu.data import scene_state as ss
from text2nerf_tpu.engine import checkpoints as JC
from text2nerf_tpu.engine import expansion as JE
from text2nerf_tpu.engine import train_step as JTS
from text2nerf_tpu.engine import trainer as JT
from text2nerf_tpu.models import tensorf as tf
from text2nerf_tpu_torch import main as PMAIN
from text2nerf_tpu_torch.data import scene_state as pss
from text2nerf_tpu_torch.engine import checkpoints as PC
from text2nerf_tpu_torch.engine import expansion as PE
from text2nerf_tpu_torch.engine import renderer as PER
from text2nerf_tpu_torch.engine import train_step as PTS
from text2nerf_tpu_torch.engine import trainer as PT
from text2nerf_tpu_torch.models import tensorf as ptf

torch.set_num_threads(2)

SCHEDULE = dict(n_stage1=1, n_stage2=2, n_stage3=2, batch_size=512, n_voxel_init=12 ** 3,
                n_voxel_final=20 ** 3, upsamp_list=(3,), update_alphamask_list=(6,), app_k=8,
                eval_every_epochs=10, seed=3, train_microbatch=4, eval_mask_pool=5,
                progress_refresh_rate=1, vis_support_views=False, eval_compact_k=0,
                resume=True, resume_every_epochs=1)
EXPNAME = "r"


def _logfolder(basedir):
    return os.path.join(str(basedir), f"{EXPNAME}_{PROMPT.replace(' ', '_')}_0.2_0.2")


@contextlib.contextmanager
def _kept_resume_points(module, dest):
    """Copy every resume point the trainer writes (``module`` is the
    checkpoints module its trainer saves through) to ``dest/<epoch>/``."""
    save0 = module.save_checkpoint

    def save(path, *args, loop_state=None, **kw):
        save0(path, *args, loop_state=loop_state, **kw)
        if path.endswith("_resume.npz"):
            d = os.path.join(dest, str(loop_state["epoch"]))
            os.makedirs(d, exist_ok=True)
            shutil.copy(path, os.path.join(d, "resume.npz"))
            shutil.copy(os.path.join(os.path.dirname(path), "scene_snapshot.npz"),
                        os.path.join(d, "scene_snapshot.npz"))

    module.save_checkpoint = save
    try:
        yield
    finally:
        module.save_checkpoint = save0


def _init(root):
    reso = tf.n_to_reso(SCHEDULE["n_voxel_init"], np.array([[-8.0] * 3, [8.0] * 3]))
    path = str(root / "init.npz")
    if not os.path.exists(path):
        JC.save_checkpoint(path, tf.TensoRFConfig(**MODEL), slab_params(reso),
                           jnp.asarray([[-8.0] * 3, [8.0] * 3]))
    return path


def _jax_fit(root, basedir, services=None):
    """The JAX trainer's fit under ``basedir``: (result, sampler ids)."""
    js = services or _services()[0]
    with _no_warmup(), _Recorder(JTS.PermutationSampler) as rec:
        res = JT.reconstruction(
            JT.TrainConfig(expname=EXPNAME, basedir=str(basedir), ckpt=_init(root),
                           model=tf.TensoRFConfig(**MODEL), **SCHEDULE),
            _scene_cfg(ss.SceneConfig, root / "jd"), js, _expansion_cfg(JE.ExpansionConfig))
    return res, rec.ids


def _port_fit(root, basedir, services=None, jitter=True, schedule=SCHEDULE):
    """The port's fit under ``basedir``, the JAX trainer's jitter injected
    unless ``jitter`` is False: (result, sampler ids, compacted steps)."""
    ps = services or _services()[1]
    kinds = []
    stream = _jax_key_stream(schedule["seed"], kinds) if jitter else contextlib.nullcontext()
    with _Recorder(PTS.PermutationSampler) as rec, stream:
        res = PT.reconstruction(
            PT.TrainConfig(expname=EXPNAME, basedir=str(basedir), ckpt=_init(root),
                           model=ptf.TensoRFConfig(**MODEL), **schedule),
            _scene_cfg(pss.SceneConfig, root / "pd"), ps, _expansion_cfg(PE.ExpansionConfig),
            device="cpu")
    return res, rec.ids, kinds


def _plant(point, basedir):
    """A log folder under ``basedir`` holding the resume point ``point``."""
    folder = _logfolder(basedir)
    os.makedirs(folder)
    shutil.copy(os.path.join(point, "resume.npz"), os.path.join(folder, f"{EXPNAME}_resume.npz"))
    shutil.copy(os.path.join(point, "scene_snapshot.npz"),
                os.path.join(folder, "scene_snapshot.npz"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The uninterrupted fit of each package, every resume point kept."""
    root = tmp_path_factory.mktemp("resume")
    with _kept_resume_points(JC, str(root / "jax_points")):
        jres, _ = _jax_fit(root, root / "jl")
    with _kept_resume_points(PC, str(root / "port_points")):
        pres, _, _ = _port_fit(root, root / "pl", jitter=False)
    return root, pres


def test_resume_points_are_kept_at_every_epoch(runs):
    root = runs[0]
    for side in ("jax_points", "port_points"):
        assert sorted(os.listdir(root / side)) == ["1", "2", "3", "4"]
    loop = PC.load_checkpoint(str(root / "jax_points" / "2" / "resume.npz"), device="cpu")[-1]
    assert loop["epoch"] == 2 and loop["next_view"] == 2 and loop["global_step"] > 6


@pytest.mark.parametrize("side", ["jax_points", "port_points"])
def test_snapshot_pools_match_jax(runs, side):
    root = runs[0]
    path = str(root / side / "2" / "scene_snapshot.npz")
    with np.load(str(root / "jax_points" / "2" / "scene_snapshot.npz")) as a, \
            np.load(str(root / "port_points" / "2" / "scene_snapshot.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    want = ss.load_scene_snapshot(path, n_views_pools=2, trans_range=0.2, use_support_set=True)
    got = pss.load_scene_snapshot(path, n_views_pools=2, trans_range=0.2, use_support_set=True,
                                  device="cpu")
    assert set(got.updates) == set(want.updates) == {"00000", "00001"}
    for v in ("00000", "00001"):
        (gr, gc, gd), (wr, wc, wd) = got.updates[v], want.updates[v]
        assert 0 < len(gr) == len(wr)
        np.testing.assert_array_equal(gr, wr)
        assert np.abs(gc - wc).max() <= 1e-6
        assert np.abs(gd - wd).max() <= 1e-6 * np.abs(wd).max()
    np.testing.assert_array_equal(got.all_rays, want.all_rays)
    np.testing.assert_array_equal(got.rays_gen_split, want.rays_gen_split)
    # the one-argument read: no pool
    bare = pss.load_scene_snapshot(path)
    assert bare.updates == {} and len(bare.all_rays) == 0
    assert pss.supervised_z_floor(bare) == ss.supervised_z_floor(want)


def _resume_both(root, point, tag):
    """Both packages resumed from ``point``: the two results, their
    sampler ids and metrics rows."""
    _plant(point, root / tag / "jl")
    _plant(point, root / tag / "pl")
    jres, jids = _jax_fit(root, root / tag / "jl")
    pres, pids, kinds = _port_fit(root, root / tag / "pl")
    return jres, pres, jids, pids, kinds


def _assert_resumed_alike(jres, pres, jids, pids, kinds, epoch):
    assert len(jids) == len(pids) == len(kinds) > 0
    for a, b in zip(jids, pids):
        np.testing.assert_array_equal(b, a)
    jrows, prows = _rows(jres[4]), _rows(pres[4])
    mj = np.array([r["mse"] for r in jrows if "mse" in r])
    mp = np.array([r["mse"] for r in prows if "mse" in r])
    assert len(mj) == len(mp) == len(kinds)
    assert float(np.abs(mp / mj - 1).max()) <= 1e-5
    for rows in (jrows, prows):
        assert [r["resume_epoch"] for r in rows if "resume_epoch" in r] == [epoch]
        assert not any(k.startswith("phase/bootstrap") for r in rows for k in r)
    assert pres[3].rgbs_gen_split.shape[0] == jres[3].rgbs_gen_split.shape[0] == 2


@pytest.mark.parametrize("epoch", [1, 2, 3], ids=["boundary", "mid_stage2", "stage3_entry"])
def test_port_resumes_a_jax_run_as_jax_does(runs, epoch):
    root = runs[0]
    point = str(root / "jax_points" / str(epoch))
    jres, pres, jids, pids, kinds = _resume_both(root, point, f"from_jax_{epoch}")
    _assert_resumed_alike(jres, pres, jids, pids, kinds, epoch)
    # stages 2 and 3 train compacted on a mask rebuilt from the resumed field
    assert all(kinds)
    if epoch == 1:  # the boundary resume expands view 1 again
        assert os.path.exists(os.path.join(pres[4], "DIBR", "rgbs", "00001.png"))


def test_jax_resumes_a_port_run_as_the_port_does(runs):
    root = runs[0]
    point = str(root / "port_points" / "2")
    jres, pres, jids, pids, kinds = _resume_both(root, point, "from_port_2")
    _assert_resumed_alike(jres, pres, jids, pids, kinds, 2)


def _final_psnrs(res):
    _, field, aabb, scene, _ = res
    out = PER.evaluation(field.requires_grad_(False), aabb, scene.rays_gen_split, scene.hw,
                         n_samples=24, gt_rgbs=scene.rgbs_gen_split, chunk=256, app_k=8,
                         device="cpu")
    return np.array(out["psnr"])


def test_crash_and_resume_matches_the_uninterrupted_run(runs, tmp_path):
    # the alpha-mask milestone one step after the stage-2 boundary's
    # resume point: the rerun restores the upsampled, unshrunk grid and
    # shrinks at the milestone itself, as its control does
    root = runs[0]
    boundary = PC.load_checkpoint(str(root / "port_points" / "1" / "resume.npz"),
                                  device="cpu")[-1]
    schedule = dict(SCHEDULE, update_alphamask_list=(boundary["global_step"] + 1,))
    control, _, _ = _port_fit(root, tmp_path / "control", jitter=False, schedule=schedule)
    ps = _services()[1]
    inpaint = ps.inpaint

    def dying_inpaint(*args, **kw):
        raise RuntimeError("simulated crash mid-expansion")

    ps.inpaint = dying_inpaint
    with pytest.raises(RuntimeError, match="simulated crash"):
        _port_fit(root, tmp_path / "crash", services=ps, jitter=False, schedule=schedule)
    loop = PC.load_checkpoint(os.path.join(_logfolder(tmp_path / "crash"),
                                           f"{EXPNAME}_resume.npz"), device="cpu")[-1]
    assert loop["epoch"] == 1 and loop["next_view"] == 1  # the boundary's save
    assert loop["global_step"] == boundary["global_step"]
    ps.inpaint = inpaint
    counts = []
    make0 = PTS.make_train_step

    def make_train_step(*args, **kw):
        counts.append(kw["n_samples"])
        return make0(*args, **kw)

    PTS.make_train_step = make_train_step
    try:
        resumed, _, _ = _port_fit(root, tmp_path / "crash", services=ps, jitter=False,
                                  schedule=schedule)
    finally:
        PTS.make_train_step = make0
    rows = _rows(resumed[4])
    assert [r["resume_epoch"] for r in rows if "resume_epoch" in r] == [1]
    assert any("shrink_aabb" in r for r in rows)  # the rerun shrinks at the milestone
    assert set(counts) == {tf.default_n_samples((20, 20, 20), MODEL["step_ratio"])}
    p_control, p_resumed = _final_psnrs(control), _final_psnrs(resumed)
    assert p_resumed.shape == p_control.shape == (2,)
    np.testing.assert_allclose(p_resumed, p_control, atol=0.5)


def test_resume_fast_forwards(tmp_path):
    """tests/test_resume.py::test_resume_fast_forwards on the port: 3
    views, 1 / 1 / 0 epochs; the rerun resumes at the last boundary."""
    sched = dict(SCHEDULE, n_stage3=0, resume_every_epochs=0, upsamp_list=(),
                 update_alphamask_list=())
    ps = _services()[1]
    scene_cfg = dataclasses.replace(_scene_cfg(pss.SceneConfig, tmp_path / "d"), num_training=3,
                                    pose_traj="circle0_20")
    cfg = PT.TrainConfig(expname=EXPNAME, basedir=str(tmp_path / "log"), ckpt=_init(tmp_path),
                         model=ptf.TensoRFConfig(**MODEL), **dict(sched, n_stage2=1))
    run = functools.partial(PT.reconstruction, cfg, scene_cfg, ps,
                            _expansion_cfg(PE.ExpansionConfig), device="cpu")
    first = run()
    folder = first[4]
    assert os.path.exists(os.path.join(folder, f"{EXPNAME}_resume.npz"))
    assert os.path.exists(os.path.join(folder, "scene_snapshot.npz"))
    assert first[3].rgbs_gen_split.shape[0] == 3
    n_rows = len(_rows(folder))
    second = run()
    rows = _rows(folder)[n_rows:]
    assert [r["resume_epoch"] for r in rows if "resume_epoch" in r] == [2]
    assert not any(k.startswith("phase/bootstrap") for r in rows for k in r)
    assert second[3].rgbs_gen_split.shape[0] == 3
    assert [r["view"] for r in rows if "view" in r] == [2]  # view 1 is not expanded again


def test_main_hands_the_resume_flags_to_the_trainer(tmp_path, monkeypatch):
    got = {}

    def reconstruction(cfg, scene_cfg, services, expansion_cfg, **kw):
        got["cfg"] = cfg
        return None, None, None, None, str(tmp_path)

    monkeypatch.setattr(PT, "reconstruction", reconstruction)
    config = os.path.join(os.path.dirname(__file__), os.pardir, "configs",
                          "text2nerf_scenes.txt")
    argv = ["--config", config, "--datadir", str(tmp_path / "scene"),
            "--weights_dir", str(tmp_path / "none"), "--resume", "1",
            "--resume_every_epochs", "2"]
    assert PMAIN.main(argv, device="cpu") == 0
    assert got["cfg"].resume is True and got["cfg"].resume_every_epochs == 2
