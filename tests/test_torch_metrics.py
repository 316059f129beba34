"""The port's quality metrics against the JAX package, on the CPU, with the
tolerances stated (the worst seen in brackets):

- ``ssim`` (float64 on the device) against the JAX package's scipy
  version on random image pairs: within 1e-6 (2e-16);
- LPIPS alex and vgg (fp32) with parameters carried from a random flax
  tree through ``lpips_state_from_flax``, and from the JAX package's
  converted ``lpips_<net>.npz``: within 1e-5 of JAX's (1.2e-6);
- the same nets loaded from torch-layout state dicts the test writes
  (torchvision's ``alexnet-owt-*.pth`` / ``vgg16-*.pth`` ``features.*``
  and lpips' ``alex.pth`` / ``vgg.pth`` heads), against JAX's model
  converted from the same dicts: within 1e-5;
- ``evaluation(compute_extra_metrics=True)`` on a tiny field: the psnr,
  ssim and lpips_alex lists within 1e-4 dB, 1e-6 and 1e-5 of JAX's;
- without weights: one warning, no lpips key, as in the JAX package;
- a missing file raises FileNotFoundError naming the path.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2nerf_tpu.data import trajectories as traj
from text2nerf_tpu.engine import metrics as JM
from text2nerf_tpu.engine import renderer as JR
from text2nerf_tpu.engine.checkpoints import _flatten
from text2nerf_tpu.models import lpips as JL
from text2nerf_tpu.models import tensorf as tf
from text2nerf_tpu.services import weight_convert as WC
from text2nerf_tpu_torch.data import scene_state as pss
from text2nerf_tpu_torch.engine import metrics as PM
from text2nerf_tpu_torch.engine import renderer as PER
from text2nerf_tpu_torch.engine.checkpoints import params_from_jax
from text2nerf_tpu_torch.models import lpips as PL
from text2nerf_tpu_torch.services import weights as W

torch.set_num_threads(2)

SIZES = {"alex": 64, "vgg": 32}


def _pair(seed, hw=(40, 48)):
    rng = np.random.default_rng(seed)
    a = rng.random((*hw, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ssim_matches_jax(seed):
    a, b = _pair(seed, hw=(40 + seed, 48))
    assert abs(PM.ssim(a, b, device="cpu") - JM.ssim(a, b)) <= 1e-6
    np.testing.assert_allclose(PM.ssim(a, b, return_map=True, device="cpu"),
                               JM.ssim(a, b, return_map=True), rtol=0, atol=1e-6)
    assert PM.ssim(a, a, device="cpu") == pytest.approx(1.0)


def _flax_lpips(net, seed=0):
    """(flax features tree, heads (C,) each) at random init."""
    module = JL.AlexFeatures() if net == "alex" else JL.VGG16Features()
    params = module.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)))["params"]
    rng = np.random.default_rng(seed)
    lins = [np.abs(rng.standard_normal(c)).astype(np.float32) for c in PL.CHANNELS[net]]
    return jax.tree.map(np.asarray, params), lins


def _images(net, seed=3):
    rng = np.random.default_rng(seed)
    n = SIZES[net]
    return rng.random((n, n, 3)).astype(np.float32), rng.random((n, n, 3)).astype(np.float32)


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_from_the_flax_bridge_matches_jax(net):
    feats, lins = _flax_lpips(net)
    want_model = JL.LPIPSModel(net, feats, lins)
    model = PL.LPIPSModel(net)
    model.load_state_dict(W.lpips_state_from_flax({"features": feats,
                                                   "lins": dict(enumerate(lins))}, net))
    model.eval()
    x, y = _images(net)
    assert abs(model.distance(x, y) - want_model(x, y)) <= 1e-5
    assert model.distance(x, x) < 1e-6


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_from_the_converted_npz_matches_jax(tmp_path, net):
    feats, lins = _flax_lpips(net, seed=1)
    # the JAX converter's layout: heads as (1, 1, C, 1)
    tree = {"features": feats, "lins": {str(i): w.reshape(1, 1, -1, 1)
                                        for i, w in enumerate(lins)}}
    WC.save_converted(str(tmp_path / f"lpips_{net}.npz"), tree)
    want = JL.LPIPSModel.create(net, str(tmp_path))
    got = W.load_lpips(net, str(tmp_path), device="cpu")
    x, y = _images(net, seed=4)
    assert abs(got.distance(x, y) - want(x, y)) <= 1e-5
    assert abs(PM.lpips(x, y, net, str(tmp_path), device="cpu") - want(x, y)) <= 1e-5


def _torch_state(net, seed=2):
    """The torch originals' entries at random init: torchvision's
    ``features.*`` and lpips' ``lin<i>.model.1.weight`` (1, C, 1, 1)."""
    torch.manual_seed(seed)
    feats = PL.alex_features() if net == "alex" else PL.vgg16_features()
    backbone = {f"features.{k}": v.clone() for k, v in feats.state_dict().items()}
    heads = {f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1)
             for i, c in enumerate(PL.CHANNELS[net])}
    return backbone, heads


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_from_torch_layout_files_matches_jax(tmp_path, net):
    backbone, heads = _torch_state(net)
    name = "alexnet-owt-7be5be79.pth" if net == "alex" else "vgg16-397923af.pth"
    os.makedirs(tmp_path / "torchvision")
    os.makedirs(tmp_path / "lpips" / "v0.1")
    torch.save(backbone, tmp_path / "torchvision" / name)
    torch.save(heads, tmp_path / "lpips" / "v0.1" / f"{net}.pth")
    got = W.load_lpips(net, str(tmp_path), device="cpu")
    state = {k: v.numpy() for k, v in {**backbone, **heads}.items()}
    name_map = WC.lpips_alex_name_map() if net == "alex" else WC.lpips_vgg_name_map()
    assert W.lpips_name_map(net) == name_map
    tree = WC.convert_torch_state_dict(state, name_map)
    want = JL.LPIPSModel(net, tree["features"],
                         [np.asarray(tree["lins"][str(i)]).reshape(-1) for i in range(5)])
    x, y = _images(net, seed=5)
    assert abs(got.distance(x, y) - want(x, y)) <= 1e-5


def test_missing_lpips_weights_raise_with_the_path(tmp_path):
    with pytest.raises(FileNotFoundError, match="lpips_alex"):
        W.load_lpips("alex", str(tmp_path / "none"), device="cpu")
    torch.save(_torch_state("alex")[0], tmp_path / "alexnet-owt.pth")  # no heads
    with pytest.raises(FileNotFoundError, match=str(tmp_path)):
        W.load_lpips("alex", str(tmp_path), device="cpu")


def _eval_setup(hw=(32, 32)):
    cfg = tf.TensoRFConfig(density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8))
    aabb = jnp.array([[-8.0] * 3, [8.0] * 3])
    reso = tf.n_to_reso(16 ** 3, aabb)
    params = tf.init_params(jax.random.PRNGKey(0), cfg, reso)
    params["density_planes"] = jax.tree.map(lambda x: jnp.abs(x) + 0.5,
                                            params["density_planes"])
    field = params_from_jax(_flatten(params), cfg, device="cpu").requires_grad_(False)
    poses = traj.training_trajectory("circle0_30", 2, 0.2, 0.2)
    h, w = hw
    rays = pss.test_ray_split(poses, (float(w), float(w), w / 2.0, h / 2.0), h, w)
    gt = np.random.default_rng(0).random((2, h, w, 3)).astype(np.float32)
    return cfg, params, field, aabb, rays, gt


def test_evaluation_extra_metrics_match_jax(tmp_path):
    feats, lins = _flax_lpips("alex", seed=6)
    WC.save_converted(str(tmp_path / "lpips_alex.npz"),
                      {"features": feats, "lins": {str(i): w for i, w in enumerate(lins)}})
    cfg, params, field, aabb, rays, gt = _eval_setup()
    kw = dict(n_samples=48, gt_rgbs=gt, chunk=512, app_k=16, compute_extra_metrics=True,
              lpips_weights_dir=str(tmp_path))
    want = JR.evaluation(cfg, params, aabb, rays, (32, 32), **kw)
    got = PER.evaluation(field, torch.as_tensor(np.asarray(aabb)), rays, (32, 32),
                         device="cpu", **kw)
    assert len(got["ssim"]) == len(want["ssim"]) == 2
    assert len(got["lpips_alex"]) == len(want["lpips_alex"]) == 2
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["ssim"], want["ssim"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["lpips_alex"], want["lpips_alex"], rtol=0, atol=1e-5)


def test_absent_lpips_weights_warn_once(tmp_path, monkeypatch):
    monkeypatch.setattr(PER, "_lpips_warned", False)
    img = np.zeros((32, 32, 3), np.float32)
    missing = str(tmp_path / "no_lpips_weights")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert PER._lpips_or_warn(img, img, "alex", missing, "cpu") is None
        assert PER._lpips_or_warn(img, img, "alex", missing, "cpu") is None
        cfg, params, field, aabb, rays, gt = _eval_setup((16, 16))
        out = PER.evaluation(field, torch.as_tensor(np.asarray(aabb)), rays[:, :256], (16, 16),
                             n_samples=32, gt_rgbs=gt[:, :16, :16], chunk=256, app_k=8,
                             compute_extra_metrics=True, lpips_weights_dir=missing,
                             device="cpu")
    msgs = [w for w in caught if "LPIPS unavailable" in str(w.message)]
    assert len(msgs) == 1
    assert "lpips_alex" not in out and len(out["ssim"]) == 2


def test_lpips_faults_other_than_missing_weights_propagate(monkeypatch):
    # only absent weights mean "no metric": a device or shape fault raises
    monkeypatch.setattr(PER, "_lpips_warned", False)

    def broken(*args, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(PER.M, "lpips", broken)
    img = np.zeros((8, 8, 3), np.float32)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        PER._lpips_or_warn(img, img, "alex", None, "cpu")
    assert PER._lpips_warned is False
