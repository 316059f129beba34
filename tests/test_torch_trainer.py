"""The port's seed fit (trainer.reconstruction) against the JAX package's,
on the CPU, at tiny size.

Both fits run from one initial field: a random field whose density is a
box (|x|, |y| < 1.5, z in (2.5, 6)), written by the JAX package's
save_checkpoint and loaded by both init_fields through ``cfg.ckpt``.  The
scene: the procedural services at hw 32, local_fixed (the seed view and 8
warped support views).  The schedule: 2 stage-1 epochs, 1 stage-3 epoch,
batch 256 (27 steps an epoch), grid 12³ → 20³ at step 3, the alpha mask
and the AABB shrink at step 6, a pool-5 eval mask (stage 3 trains
compacted), 2/2/2 and 4/4/4 components, step_ratio 0.5.  The JAX trainer's
per-step jitter is drawn from its own key stream (PRNGKey(seed), split
per step) and handed to the port's step by a wrapper around
make_train_step; the JAX warm-up thread (an XLA compile overlap that
changes no number) is replaced by a finished one.

Held, with the tolerances measured on this configuration (worst seen in
brackets):
- sampler ids at every step, the step count, the milestone steps, the
  final grid and aabb: equal;
- the per-step mse: within 1e-5 relative (7.3e-7);
- the eval PSNR at both stage boundaries: within 1e-4 dB (2e-6);
- the final checkpoints: mask bits equal, every leaf within 1e-4 of its
  largest magnitude (3.4e-6; Adam divides by the gradient's running rms,
  so a rounding-level gradient difference moves a parameter further than
  the gradient moved);
- render_test from each final checkpoint: uint8 frames within one level
  (equal); and from one checkpoint with a scene snapshot beside it (the
  JAX package's save_scene_snapshot): equal frames, culled at the
  snapshot's supervised z-floor.

Videos where neither imageio nor PIL can be imported: uncompressed RGB
AVIs, parsed here and equal to the frames bit for bit.
"""

import contextlib
import dataclasses
import json
import os
import shutil
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_scene import slab_params
from test_torch_train_step import _step_draws
from text2nerf_tpu.data import scene_state as ss
from text2nerf_tpu.engine import checkpoints as JC
from text2nerf_tpu.engine import train_step as JTS
from text2nerf_tpu.engine import trainer as JT
from text2nerf_tpu.models import tensorf as tf
from text2nerf_tpu.services import fallbacks as jfb
from text2nerf_tpu.services.registry import Services
from text2nerf_tpu_torch.data import scene_state as pss
from text2nerf_tpu_torch.engine import renderer as PER
from text2nerf_tpu_torch.engine import train_step as PTS
from text2nerf_tpu_torch.engine import trainer as PT
from text2nerf_tpu_torch.models import tensorf as ptf
from text2nerf_tpu_torch.utils.png import read_png

torch.set_num_threads(2)

HW = (32, 32)
MODEL = dict(density_n_comp=(2, 2, 2), app_n_comp=(4, 4, 4), app_dim=6, fea_pe=2,
             feature_c=16, step_ratio=0.5)
SCHEDULE = dict(n_stage1=2, n_stage2=0, n_stage3=1, batch_size=256, n_voxel_init=12 ** 3,
                n_voxel_final=20 ** 3, upsamp_list=(3,), update_alphamask_list=(6,), app_k=8,
                eval_every_epochs=3, seed=3, train_microbatch=4, eval_mask_pool=5,
                progress_refresh_rate=1, vis_support_views=False)
STEPS = 81


def _scene(cls, datadir, hw=HW):
    return cls(datadir=str(datadir), prompt="a tiny garden", pose_traj="local_fixed",
               num_training=1, hw=hw, num_filter_iter=2, filter_size=(3, 3))


class _Recorder:
    """Collects each PermutationSampler's ids."""

    def __init__(self, cls):
        self.cls, self.next_ids, self.ids = cls, cls.next_ids, []

    def __enter__(self):
        def next_ids(sampler):
            out = self.next_ids(sampler)
            self.ids.append(np.array(out))
            return out

        self.cls.next_ids = next_ids
        return self

    def __exit__(self, *exc):
        self.cls.next_ids = self.next_ids


@contextlib.contextmanager
def _jax_key_stream(seed, kinds):
    """Wrap the port's make_train_step so every step takes the jitter (and
    background coins) the JAX trainer's step draws from its key stream;
    ``kinds`` collects whether each step ran compacted."""
    make0 = PTS.make_train_step
    key = [jax.random.PRNGKey(seed)]

    def make_train_step(cfg, opt, **kw):
        step = make0(cfg, opt, **kw)

        def stepped(state, aabb, batch, rng=None, tv_decay=None, alpha_mask=None,
                    lr_decay=1.0):
            key[0], k = jax.random.split(key[0])
            compact = kw["compact_k"] > 0 and alpha_mask is not None
            r = kw["microbatch_compact"] if compact and kw["microbatch_compact"] \
                else kw["microbatch"]
            b = batch["rays"].shape[0]
            jitter, coins = _step_draws(k, b, PTS.effective_microbatch(b, r), kw["white_bg"])
            kinds.append(compact)
            return step(state, aabb, batch, rng, tv_decay, alpha_mask=alpha_mask,
                        lr_decay=lr_decay, jitter=jitter, bg_coin=coins)

        return stepped

    PTS.make_train_step = make_train_step
    try:
        yield
    finally:
        PTS.make_train_step = make0


def _rows(logfolder):
    with open(os.path.join(logfolder, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def run_fits(root, hw=HW, model=MODEL, schedule=SCHEDULE, init_params=slab_params):
    """Both seed fits under ``root``, warm-started from ``init_params(reso)``:
    (root, JAX result, port result, JAX sampler ids, port sampler ids, the
    port's compacted-step flags)."""
    reso = tf.n_to_reso(schedule["n_voxel_init"], np.array([[-8.0] * 3, [8.0] * 3]))
    params = init_params(reso)
    init = str(root / "init.npz")
    JC.save_checkpoint(init, tf.TensoRFConfig(**model), params,
                       jnp.asarray([[-8.0] * 3, [8.0] * 3]))
    done = threading.Thread(target=lambda: None)
    done.start()
    done.join()
    warmup, JT._start_train_step_warmup = JT._start_train_step_warmup, lambda *a: done
    try:
        with _Recorder(JTS.PermutationSampler) as jids:
            services = Services(
                text2img=lambda p, n="": jfb.procedural_text2img(p, n, hw=hw),
                inpaint=None, estimate_depth=jfb.procedural_depth, rank=None, merge=None)
            jres = JT.reconstruction(
                JT.TrainConfig(expname="j", basedir=str(root / "jl"), ckpt=init,
                               model=tf.TensoRFConfig(**model), **schedule),
                _scene(ss.SceneConfig, root / "jd", hw), services)
    finally:
        JT._start_train_step_warmup = warmup
    kinds = []
    with _Recorder(PTS.PermutationSampler) as pids, _jax_key_stream(schedule["seed"], kinds):
        pres = PT.reconstruction(
            PT.TrainConfig(expname="p", basedir=str(root / "pl"), ckpt=init,
                           model=ptf.TensoRFConfig(**model), **schedule),
            _scene(pss.SceneConfig, root / "pd", hw), device="cpu")
    return root, jres, pres, jids.ids, pids.ids, kinds


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    return run_fits(tmp_path_factory.mktemp("fits"))


def test_seed_fit_follows_jax(fits):
    _, jres, pres, jids, pids, kinds = fits
    assert len(jids) == len(pids) == len(kinds) == STEPS
    for a, b in zip(jids, pids):
        np.testing.assert_array_equal(b, a)
    # stage 1 dense, stage 3 compacted on the stamped pool-5 mask
    assert kinds == [False] * 54 + [True] * 27

    jrows, prows = _rows(jres[4]), _rows(pres[4])
    mj = np.array([r["mse"] for r in jrows if "mse" in r])
    mp = np.array([r["mse"] for r in prows if "mse" in r])
    assert len(mj) == len(mp) == STEPS
    assert float(np.abs(mp / mj - 1).max()) <= 1e-5
    ej = [(r["step"], r["eval_psnr"]) for r in jrows if "eval_psnr" in r]
    ep = [(r["step"], r["eval_psnr"]) for r in prows if "eval_psnr" in r]
    assert [s for s, _ in ep] == [s for s, _ in ej] == [54, 81]
    for (_, a), (_, b) in zip(ej, ep):
        assert abs(a - b) <= 1e-4

    # the milestones, where the schedule put them
    logged = {k: (r["step"], v) for r in prows for k, v in r.items()}
    assert logged["upsample_grid"] == (3, [20, 20, 20])
    assert logged["shrink_aabb"][0] == 6
    grid = tf.grid_resolution(jres[0], jres[1])
    assert ptf.grid_resolution(pres[1]) == grid == tuple(logged["shrink_grid"][1])
    assert min(grid) < 20  # the box shrank
    np.testing.assert_array_equal(pres[2].numpy(), np.asarray(jres[2]))


def test_final_checkpoints_agree(fits):
    _, jres, pres, _, _, _ = fits
    _, jp, jaabb, jmask, jloop = JC.load_checkpoint(os.path.join(jres[4], "j_final.npz"))
    _, pp, paabb, pmask, ploop = JC.load_checkpoint(os.path.join(pres[4], "p_final.npz"))
    assert jloop == ploop == {"view_idx": 0, "global_step": STEPS}
    np.testing.assert_array_equal(np.asarray(paabb), np.asarray(jaabb))
    assert pmask["pool"] == jmask["pool"] == 5
    np.testing.assert_array_equal(np.asarray(pmask["volume"]), np.asarray(jmask["volume"]))
    from text2nerf_tpu.engine.checkpoints import _flatten

    want, got = _flatten(jp), _flatten(pp)
    assert set(want) == set(got)
    for k in want:
        scale = float(np.abs(want[k]).max())
        assert float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max()) <= 1e-4 * scale, k


def test_render_test_matches_jax_from_the_final_checkpoints(fits):
    root, jres, pres, _, _, _ = fits
    common = dict(render_test=True, n_vis=3, batch_size=256, app_k=8)
    want = JT.render_test(JT.TrainConfig(ckpt=os.path.join(jres[4], "j_final.npz"), **common),
                          _scene(ss.SceneConfig, root / "jd"))["test"]
    got = PT.render_test(PT.TrainConfig(ckpt=os.path.join(pres[4], "p_final.npz"), **common),
                         _scene(pss.SceneConfig, root / "jd"), device="cpu")["test"]
    assert len(got["rgb"]) == len(want["rgb"]) == 3
    for g, w in zip(got["rgb"], want["rgb"]):
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
    assert os.listdir(os.path.join(pres[4], "imgs_test_all", "rgbs"))


def read_rgb_avi(path):
    """The frames of an uncompressed RGB AVI, parsed here from the RIFF
    layout: (frames (N, H, W, 3) uint8, fps)."""
    import struct

    data = open(path, "rb").read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert struct.unpack("<I", data[4:8])[0] + 8 == len(data)
    a = data.find(b"avih") + 8
    usec, _, _, flags, n, _, streams, _, w, h = struct.unpack("<10I", data[a:a + 40])
    assert streams == 1 and flags & 0x10
    s = data.find(b"strh") + 8
    assert data[s:s + 8] == b"vidsDIB "
    f = data.find(b"strf") + 8
    size, fw, fh, planes, bits, comp = struct.unpack("<IiiHHI", data[f:f + 20])
    assert (size, fw, fh, planes, bits, comp) == (40, w, h, 1, 24, 0)
    stride = (3 * w + 3) & ~3
    frames, pos = [], data.find(b"movi") + 4
    while data[pos:pos + 4] == b"00db":
        length = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        assert length == stride * h
        rows = np.frombuffer(data, np.uint8, length, pos + 8).reshape(h, stride)
        frames.append(rows[::-1, : 3 * w].reshape(h, w, 3)[..., ::-1])
        pos += 8 + length + length % 2
    assert len(frames) == n and data[pos:pos + 4] == b"idx1"
    return np.stack(frames), round(1e6 / usec)


@pytest.mark.parametrize("w", [24, 13])  # a row of 39 bytes is padded to 40
def test_uncompressed_avi_reads_back_bit_equal(tmp_path, monkeypatch, w):
    for name in ("imageio", "imageio.v2", "PIL", "PIL.Image", "cv2"):
        monkeypatch.setitem(sys.modules, name, None)
    frames = [np.random.default_rng(i).integers(0, 256, (7, w, 3), dtype=np.uint8)
              for i in range(3)]
    path = PER.write_video(str(tmp_path / "v.mp4"), frames, fps=12)
    assert path == str(tmp_path / "v.avi")
    back, fps = read_rgb_avi(path)
    np.testing.assert_array_equal(back, np.stack(frames))
    assert fps == 12


def test_seed_fit_needs_no_imageio_pil_or_cv2(tmp_path, monkeypatch):
    for name in ("imageio", "imageio.v2", "PIL", "PIL.Image", "cv2"):
        monkeypatch.setitem(sys.modules, name, None)
    cfg = PT.TrainConfig(expname="n", basedir=str(tmp_path / "log"),
                         model=ptf.TensoRFConfig(**MODEL),
                         **dict(SCHEDULE, batch_size=1024, vis_support_views=True))
    mcfg, field, aabb, scene, logfolder = PT.reconstruction(
        cfg, _scene(pss.SceneConfig, tmp_path / "d"), device="cpu")
    assert os.listdir(os.path.join(logfolder, "imgs_vis_support_view", "rgbs"))
    assert os.path.exists(os.path.join(logfolder, "n_final.npz"))
    # a second bootstrap reads the seed image and depth back from its PNGs
    again = pss.bootstrap_scene(_scene(pss.SceneConfig, tmp_path / "d"), device="cpu")
    np.testing.assert_array_equal(again.all_rays, scene.all_rays)
    # videos: an uncompressed AVI of the same frames
    frames = [np.zeros((8, 8, 3), np.uint8), np.full((8, 8, 3), 200, np.uint8)]
    back, _ = read_rgb_avi(PER.write_video(str(tmp_path / "v.mp4"), frames))
    np.testing.assert_array_equal(back, np.stack(frames))


@pytest.mark.parametrize("flag", ["render_train", "render_test", "render_path"])
def test_video_runs_without_an_encoder_raise_before_any_work(tmp_path, monkeypatch, flag):
    # without imageio and PIL such runs raised before any work; now their
    # videos are uncompressed AVIs of the frames the run also writes as PNGs
    for name in ("imageio", "imageio.v2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)
    cfg = PT.TrainConfig(expname="v", basedir=str(tmp_path / "log"),
                         model=ptf.TensoRFConfig(**MODEL), n_vis=2, **{flag: True},
                         **dict(SCHEDULE, n_stage1=1, n_stage3=0, batch_size=2048,
                                upsamp_list=(), update_alphamask_list=()))
    logfolder = PT.reconstruction(cfg, _scene(pss.SceneConfig, tmp_path / "d", (16, 16)),
                                  device="cpu")[4]
    folder = os.path.join(logfolder, {"render_train": "imgs_train_all",
                                      "render_test": "imgs_test_all",
                                      "render_path": "imgs_path_all"}[flag])
    frames, _ = read_rgb_avi(os.path.join(folder, "video.avi"))
    first = os.path.join(folder, "000.png" if flag == "render_path" else "rgbs/000_rgb.png")
    np.testing.assert_array_equal(frames[0], read_png(first))
    assert read_rgb_avi(os.path.join(folder, "depthvideo.avi"))[0].shape == frames.shape


def test_write_video_falls_back_to_mjpeg_avi(tmp_path):
    from text2nerf_tpu.utils.mjpeg_avi import read_mjpeg_avi

    frames = [np.full((16, 24, 3), 40 * i, np.uint8) for i in range(3)]
    path = PER.write_video(str(tmp_path / "v.mp4"), frames)
    if path.endswith(".avi"):  # no ffmpeg for imageio here
        back = read_mjpeg_avi(path)
        assert len(back) == 3 and back[0].shape == (16, 24, 3)
    assert os.path.getsize(path) > 0


def test_unported_options_raise_before_any_work(tmp_path):
    scene = _scene(pss.SceneConfig, tmp_path / "d")
    for kw, what in ((dict(checkpoint_backend="orbax"), "orbax"),
                     (dict(train_compute_dtype="bf16"), "bf16"),
                     (dict(ndc_ray=True), "NDC")):
        cfg = PT.TrainConfig(basedir=str(tmp_path / "log"), **kw)
        with pytest.raises(NotImplementedError, match=what):
            PT.reconstruction(cfg, scene, device="cpu")
    assert not os.path.exists(tmp_path / "log") and not os.path.exists(tmp_path / "d")


def test_render_test_reads_the_snapshot_z_floor(fits):
    """With a scene_snapshot.npz beside the checkpoint (written by the JAX
    package's save_scene_snapshot), render_test culls at its supervised
    z-floor, as the JAX package does: equal uint8 frames, and not those of
    the constant 2.0 cull."""
    root, jres, _, _, _, _ = fits
    folder = root / "snap"
    folder.mkdir()
    ckpt = str(folder / "f.npz")
    # the slab of test_torch_scene.py, reaching down to z = 0.8
    reso = (16, 16, 16)
    params = slab_params(reso)
    zs = np.linspace(-8, 8, reso[2])
    line = np.where((zs > 0.8) & (zs < 6.0), 3.0, 0.0).astype(np.float32)
    params["density_lines"] = (jnp.asarray(np.repeat(line[:, None], 2, -1)),
                               *params["density_lines"][1:])
    JC.save_checkpoint(ckpt, tf.TensoRFConfig(**MODEL), params,
                       jnp.asarray([[-8.0] * 3, [8.0] * 3]))
    scene = jres[3]
    # supervised depths that reach below z = 2 (the floor drops to ~0.9)
    low = dataclasses.replace(scene, depth_gen_split=scene.depth_gen_split * 0.35)
    floor = ss.supervised_z_floor(low)
    assert 0.05 < floor < 1.5
    common = dict(ckpt=ckpt, render_test=True, n_vis=3, batch_size=256, app_k=8)
    before = PT.render_test(PT.TrainConfig(**common), _scene(pss.SceneConfig, root / "jd"),
                            device="cpu")["test"]
    ss.save_scene_snapshot(str(folder / "scene_snapshot.npz"), low)
    assert pss.supervised_z_floor(pss.load_scene_snapshot(str(folder / "scene_snapshot.npz"))) \
        == floor
    want = JT.render_test(JT.TrainConfig(**common), _scene(ss.SceneConfig, root / "jd"))["test"]
    got = PT.render_test(PT.TrainConfig(**common), _scene(pss.SceneConfig, root / "jd"),
                         device="cpu")["test"]
    for g, w in zip(got["rgb"], want["rgb"]):
        np.testing.assert_array_equal(g, w)
    assert any(not np.array_equal(g, b) for g, b in zip(got["rgb"], before["rgb"]))


def main() -> None:
    """The stage-3 collapse of a short seed fit, in both trainers, on the
    CPU: ``PYTHONPATH=. python tests/test_torch_trainer.py`` from the repo
    root (about 9 minutes).  hw 48, the full model width at step_ratio 0.5
    (so the pool-5 mask licenses the group-2 occupancy test and stage 3
    compacts), a random initial field, 48³ after step 4, the mask and
    shrink at step 10, 6 stage-1 and 3 stage-3 epochs of batch 2048, an
    eval every epoch.  Prints each trainer's eval PSNRs and per-step
    mse."""
    import tempfile
    from pathlib import Path

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    schedule = dict(n_stage1=6, n_stage2=0, n_stage3=3, batch_size=2048,
                    n_voxel_init=24 ** 3, n_voxel_final=48 ** 3, upsamp_list=(4,),
                    update_alphamask_list=(10,), eval_every_epochs=1, seed=11,
                    eval_mask_pool=5, progress_refresh_rate=1, vis_support_views=False)
    with tempfile.TemporaryDirectory() as root:
        _, jres, pres, _, _, kinds = run_fits(
            Path(root), hw=(48, 48), model=dict(step_ratio=0.5), schedule=schedule,
            init_params=lambda reso: tf.init_params(jax.random.PRNGKey(0),
                                                    tf.TensoRFConfig(), reso))
        print(f"{len(kinds)} steps, {sum(kinds)} compacted (from step {kinds.index(True)})")
        for name, res in (("jax", jres), ("port", pres)):
            rows = _rows(res[4])
            print(name, "eval PSNR by step",
                  [(r["step"], round(r["eval_psnr"], 3)) for r in rows if "eval_psnr" in r])
            print(name, "mse", [round(r["mse"], 5) for r in rows if "mse" in r])


if __name__ == "__main__":
    main()
