"""The port's scene layer against the JAX package, on the CPU, at tiny size.

- bootstrap_scene on the procedural services (hw 32): the same poses,
  support poses and per-view rays (≤ 1e-6), identical pool masks (the
  same rays in the same order), rgbs within 1/255 (the warped image is
  rounded to uint8 levels, so a sum in another order may move one level)
  and depths within 1e-5 relative; the test split likewise; and the port
  reading a scene directory the JAX package wrote.
- sparse_bilateral_filtering (native) bit-equal to the JAX package's
  backend="device" program.
- The milestone ops on a slab field: filter_rays_bbox and
  filter_rays_alpha give identical keeps; upsample_volume_grid and shrink
  within 1e-6 relative (an absolute floor of 1e-6 near zero; equal bit
  for bit at these sizes, but at larger ones XLA rounds the align-corners
  coordinates differently, by an ulp), stamp_alpha_mask with identical
  mask bits, the same aabb and grid.
- The trainer's helpers, the trajectories, the rays and the services give
  equal results.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2nerf_tpu.data import scene_state as ss
from text2nerf_tpu.data import trajectories as jtraj
from text2nerf_tpu.engine import trainer as JT
from text2nerf_tpu.engine.checkpoints import _flatten
from text2nerf_tpu.models import tensorf as tf
from text2nerf_tpu.ops import filters as jfilters
from text2nerf_tpu.ops import rays as JR
from text2nerf_tpu.ops import render as JRd
from text2nerf_tpu.services import fallbacks as jfb
from text2nerf_tpu_torch.data import scene_state as pss
from text2nerf_tpu_torch.data import trajectories as ptraj
from text2nerf_tpu_torch.engine import checkpoints as PC
from text2nerf_tpu_torch.engine import trainer as PT
from text2nerf_tpu_torch.models import tensorf as ptf
from text2nerf_tpu_torch.ops import filters as pfilters
from text2nerf_tpu_torch.ops import rays as PR
from text2nerf_tpu_torch.ops import render as PRd
from text2nerf_tpu_torch.services import fallbacks as pfb
from text2nerf_tpu_torch.services import registry as preg

torch.set_num_threads(1)

HW = (32, 32)


def _scene_cfg(cls, datadir, **kw):
    return cls(datadir=str(datadir), prompt="a tiny test garden", pose_traj="local_fixed",
               num_training=1, hw=HW, num_filter_iter=2, filter_size=(3, 3), **kw)


def _services_kw():
    return dict(text2img=lambda p, n="": jfb.procedural_text2img(p, n, hw=HW),
                estimate_depth=jfb.procedural_depth)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    want = ss.bootstrap_scene(_scene_cfg(ss.SceneConfig, root / "j"), "train", **_services_kw())
    svc = preg.default_services(hw=HW)
    got = pss.bootstrap_scene(_scene_cfg(pss.SceneConfig, root / "p"), "train",
                              text2img=svc.text2img, estimate_depth=svc.estimate_depth,
                              device="cpu")
    return root, want, got


def _assert_scene_close(got, want, exact_pools=True):
    assert got.hw == want.hw and got.intrinsic == want.intrinsic
    assert got.near_far == want.near_far and got.white_bg == want.white_bg
    np.testing.assert_array_equal(got.scene_bbox, want.scene_bbox)
    np.testing.assert_array_equal(got.poses_gen, want.poses_gen)
    np.testing.assert_array_equal(got.poses_support, want.poses_support)
    np.testing.assert_allclose(got.rays_gen_split, want.rays_gen_split, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.rays_support_split, want.rays_support_split, rtol=0,
                               atol=1e-6)
    # identical pool masks: the same rays, in the same order
    np.testing.assert_array_equal(got.all_rays, want.all_rays)
    np.testing.assert_allclose(got.all_rgbs, want.all_rgbs, rtol=0, atol=1.0 / 255 + 1e-6)
    np.testing.assert_allclose(got.all_depth, want.all_depth, rtol=1e-5, atol=0)
    np.testing.assert_array_equal(got.rgbs_gen_split, want.rgbs_gen_split)
    np.testing.assert_array_equal(got.depth_gen_split, want.depth_gen_split)
    np.testing.assert_array_equal(got.masks_gen_split, want.masks_gen_split)
    assert set(got.updates) == set(want.updates) == {"00000"}


def test_bootstrap_matches_jax(scenes):
    _, want, got = scenes
    _assert_scene_close(got, want)
    # the support warp left holes: the masks are not trivially full
    assert 0.5 * 9 * HW[0] * HW[1] < len(want.all_rays) < 9 * HW[0] * HW[1]


def test_bootstrap_reads_a_scene_the_jax_package_wrote(scenes):
    # no services: the seed image and depth come from the JAX package's
    # PNGs (imageio's encoder) through the port's codec
    root, _, _ = scenes
    want = ss.bootstrap_scene(_scene_cfg(ss.SceneConfig, root / "j"), "train")
    got = pss.bootstrap_scene(_scene_cfg(pss.SceneConfig, root / "j"), "train", device="cpu")
    _assert_scene_close(got, want)


def test_test_split_matches_jax(scenes):
    root, _, _ = scenes
    want = ss.bootstrap_scene(_scene_cfg(ss.SceneConfig, root / "j"), "test")
    got = pss.bootstrap_scene(_scene_cfg(pss.SceneConfig, root / "j"), "test", device="cpu")
    np.testing.assert_array_equal(got.render_path, want.render_path)
    np.testing.assert_array_equal(got.poses_gen, want.poses_gen)
    np.testing.assert_allclose(got.rays_gen_split, want.rays_gen_split, rtol=0, atol=1e-6)
    assert got.all_rgbs.shape == want.all_rgbs.shape == (0, 3)


def test_bootstrap_without_a_support_set_matches_jax(tmp_path):
    want = ss.bootstrap_scene(_scene_cfg(ss.SceneConfig, tmp_path / "j", use_support_set=False),
                              "train", **_services_kw())
    got = pss.bootstrap_scene(_scene_cfg(pss.SceneConfig, tmp_path / "p",
                                         use_support_set=False), "train", **_services_kw(),
                              device="cpu")
    _assert_scene_close(got, want)
    assert len(got.all_rays) == HW[0] * HW[1]


def test_supervised_z_floor_matches_jax(scenes):
    _, want, got = scenes
    assert pss.supervised_z_floor(got) == ss.supervised_z_floor(want)
    low = dataclasses.replace(want, depth_gen_split=want.depth_gen_split * 0.1)
    assert pss.supervised_z_floor(low) == ss.supervised_z_floor(low) < 2.0


@pytest.mark.parametrize("sizes,n_iter,masked", [((5, 5, 3, 3), 4, False), ((3, 3), 2, False),
                                                ((5, 3), 3, True)])
def test_sparse_bilateral_bit_equal_to_jax_device_program(sizes, n_iter, masked):
    rng = np.random.default_rng(n_iter)
    img = jfb.procedural_text2img("filter test", hw=(40, 36))
    depth = 2.0 + 3.0 * rng.random((40, 36)).astype(np.float32) ** 4
    depth[5:20, 8:30] += 1.5
    depth[30:34, 2:6] = 0.0  # zero depth forces discontinuities
    mask = (rng.random((40, 36)) > 0.2).astype(np.float32) if masked else None
    want = jfilters.sparse_bilateral_filtering(depth, img, filter_size=sizes, num_iter=n_iter,
                                               mask=mask, backend="device")
    got = pfilters.sparse_bilateral_filtering(depth, img, filter_size=sizes, num_iter=n_iter,
                                              mask=mask)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(w))
    assert not np.array_equal(got[1], depth)  # the filter did something


@pytest.mark.parametrize("src,dst", [((32, 32), (48, 48)), ((37, 23), (16, 50)),
                                     ((512, 512), (256, 256)), ((3, 5), (7, 9))])
def test_nearest_resize_matches_cv2(src, dst):
    cv2 = pytest.importorskip("cv2")
    a = np.random.default_rng(0).random((*src, 3)).astype(np.float32)
    want = cv2.resize(a, dst[::-1], interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(pss.resize_nearest(a, dst[1], dst[0]), want)
    np.testing.assert_array_equal(pss.resize_nearest(a[..., 0], dst[1], dst[0]),
                                  cv2.resize(a[..., 0], dst[::-1],
                                             interpolation=cv2.INTER_NEAREST))


def test_procedural_services_match_jax(tmp_path):
    for hw in ((32, 32), (20, 28)):
        want = jfb.procedural_text2img("a garden", "neg", hw=hw)
        got = preg.default_services(hw=hw).text2img("a garden", "neg")
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(pfb.procedural_depth(got), jfb.procedural_depth(want))
    (tmp_path / "leres").mkdir()
    with pytest.raises(NotImplementedError, match="leres"):
        preg.default_services(weights_dir=str(tmp_path))
    svc = preg.default_services(weights_dir=str(tmp_path / "empty"), device="cpu")
    assert svc.inpaint.func is pfb.diffusion_fill_inpaint and svc.rank is pfb.histogram_rank
    assert svc.resolution == {"text2img": "fallback", "inpaint": "fallback",
                              "depth": "fallback", "rank": "fallback", "merge": "init"}
    assert (svc.merge.net_size, svc.merge.num_downs) == (1024, 10)


@pytest.mark.parametrize("pose_traj", ["local_fixed", "local_double", "local_circle",
                                       "local_r2l", "circle0_30", "circle", "rectangle"])
def test_trajectories_and_rays_match_jax(pose_traj):
    want = jtraj.training_trajectory(pose_traj, 6, 0.2, 0.2)
    got = ptraj.training_trajectory(pose_traj, 6, 0.2, 0.2)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ptraj.test_trajectory(pose_traj, got[0], 0.2, 0.2),
                                  jtraj.test_trajectory(pose_traj, want[0], 0.2, 0.2))
    np.testing.assert_array_equal(ptraj.local_orbit_poses(got[-1]),
                                  jtraj.local_orbit_poses(want[-1]))
    intr = JR.default_intrinsics(12, 10)
    np.testing.assert_array_equal(PR.rays_split_np(got[:3], intr, 12, 10),
                                  JR.rays_split_np(want[:3], intr, 12, 10))


# ---------------------------------------------------------------------------
# milestone ops on a slab field
# ---------------------------------------------------------------------------

CFG = tf.TensoRFConfig(density_n_comp=(2, 2, 2), app_n_comp=(4, 4, 4), app_dim=6, fea_pe=2,
                       feature_c=16)
AABB = np.array([[-8.0] * 3, [8.0] * 3], np.float32)


def slab_params(reso, seed=5):
    """Random factors, with the density of axis 0 set so that only the box
    |x|, |y| < 1.5, z in (2.5, 6) is occupied."""
    params = tf.init_params(jax.random.PRNGKey(seed), CFG, reso)

    def axis(n, lo, hi, a, b):
        xs = np.linspace(-8, 8, n)
        return np.where((xs > lo) & (xs < hi), a, b).astype(np.float32)

    plane = 1.5 * np.minimum(axis(reso[0], -1.5, 1.5, 1.0, -1.0)[None, :],
                             axis(reso[1], -1.5, 1.5, 1.0, -1.0)[:, None])
    line = axis(reso[2], 2.5, 6.0, 3.0, 0.0)
    nd = CFG.density_n_comp[0]
    params["density_planes"] = (jnp.asarray(np.repeat(plane[..., None], nd, -1)),
                                *params["density_planes"][1:])
    params["density_lines"] = (jnp.asarray(np.repeat(line[:, None], nd, -1)),
                               *params["density_lines"][1:])
    return params


@pytest.fixture(scope="module")
def slab():
    params = slab_params((14, 12, 16))
    field = PC.params_from_jax(_flatten(params), CFG, device="cpu").requires_grad_(False)
    mask, new_aabb = tf.update_alpha_mask(CFG, params, jnp.asarray(AABB), (14, 12, 16))
    pmask, pnew = ptf.update_alpha_mask(field, torch.tensor(AABB), (14, 12, 16), device="cpu")
    np.testing.assert_array_equal(pmask["volume"].numpy(), np.asarray(mask["volume"]))
    np.testing.assert_array_equal(pnew.numpy(), np.asarray(new_aabb))
    assert 0.005 < float(pmask["volume"].mean()) < 0.2
    # rays: the support views of the origin camera, plus rays that miss
    # the box or point away from the slab
    poses = jtraj.local_fixed_poses(np.eye(4), angle=0.2, range_center=0.2)
    rays = JR.rays_split_np(poses, JR.default_intrinsics(24, 24), 24, 24).reshape(-1, 6)
    away = rays[:300].copy()
    away[:, 3:] *= -1
    miss = rays[:200].copy()
    miss[:, :3] = [20.0, 0.0, 0.0]
    miss[:, 3:] = [0.0, 1.0, 0.0]
    rays = np.concatenate([rays, away, miss]).astype(np.float32)
    return params, field, mask, pmask, np.asarray(new_aabb), rays


def test_ray_filters_match_jax(slab):
    params, field, mask, pmask, _, rays = slab
    want = np.asarray(JRd.filter_rays_bbox(jnp.asarray(AABB), jnp.asarray(rays)))
    got = PRd.filter_rays_bbox(torch.tensor(AABB), rays, device="cpu", chunk=1000)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)
    want = np.asarray(JRd.filter_rays_alpha(jnp.asarray(AABB), rays, mask, chunk=4096))
    got = PRd.filter_rays_alpha(torch.tensor(AABB), rays, pmask, device="cpu", chunk=1500)
    np.testing.assert_array_equal(got, want)
    assert 0.05 * len(got) < got.sum() < 0.95 * len(got)


def test_upsample_shrink_and_stamp_match_jax(slab):
    params, field, mask, pmask, new_aabb, rays = slab
    res = tf.n_to_reso(20 ** 3, AABB)
    up_j = tf.upsample_volume_grid(CFG, params, res)
    up_p = ptf.upsample_volume_grid(field, res)
    assert ptf.grid_resolution(up_p) == tf.grid_resolution(CFG, up_j) == res
    want, got = _flatten(up_j), PC.params_to_jax(up_p)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6, atol=1e-6, err_msg=k)

    sh_j, aabb_j, gs_j = tf.shrink(CFG, up_j, AABB, new_aabb)
    sh_p, aabb_p, gs_p = ptf.shrink(up_p, torch.tensor(AABB), torch.tensor(new_aabb))
    assert gs_p == gs_j and ptf.grid_resolution(sh_p) == gs_j
    assert min(gs_j) < min(res)  # the box shrank
    np.testing.assert_array_equal(aabb_p.numpy(), np.asarray(aabb_j))
    want, got = _flatten(sh_j), PC.params_to_jax(sh_p)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6, atol=1e-6, err_msg=k)

    # stamping: a pool-5 mask of the upsampled field, with supervised depths
    mask5, _ = tf.update_alpha_mask(CFG, up_j, jnp.asarray(AABB), res, pool=5)
    pmask5, _ = ptf.update_alpha_mask(up_p.requires_grad_(False), torch.tensor(AABB), res,
                                      pool=5, device="cpu")
    np.testing.assert_array_equal(pmask5["volume"].numpy(), np.asarray(mask5["volume"]))
    depth = np.random.default_rng(1).uniform(2.0, 7.0, len(rays)).astype(np.float32)
    want = tf.stamp_alpha_mask(mask5, rays, depth)
    got = ptf.stamp_alpha_mask(pmask5, rays, depth)
    np.testing.assert_array_equal(got["volume"].numpy(), np.asarray(want["volume"]))
    assert float(pmask5["volume"].sum()) < float(got["volume"].sum()) < got["volume"].numel()
    assert got["pool"] == 5 and got["aabb"] is pmask5["aabb"]
    tm = PT.stamped_train_mask(pmask5, None, (rays, None, depth))
    np.testing.assert_array_equal(
        tm["volume"].numpy(),
        np.asarray(JT.stamped_train_mask(mask5, None, (rays, None, depth))["volume"]))


# ---------------------------------------------------------------------------
# the trainer's helpers
# ---------------------------------------------------------------------------


def test_eval_boundary_and_epoch_iters_match_jax():
    for n1, n2, every in ((50, 20, 10 ** 6), (2, 0, 3), (3, 1, 2), (50, 0, 25)):
        for e in range(80):
            assert PT.eval_boundary(e, n1, n2, every) == JT.eval_boundary(e, n1, n2, every)
    for n, b in ((0, 4), (1, 4), (16384, 16384), (16385, 16384)):
        assert PT._epoch_iters(n, b) == JT._epoch_iters(n, b)


@pytest.mark.parametrize("kw", [dict(), dict(n_stage2=5, n_stage3=2, stage3_balance_gamma=2.0),
                                dict(n_stage1=0, n_stage2=0, n_stage3=0)])
def test_stage3_view_weights_match_jax(kw):
    for lengths in ((100, 50, 0, 20), (5,), (0, 0), (40, 7, 25)):
        want = JT.stage3_view_weights(JT.TrainConfig(**kw), lengths, 7)
        got = PT.stage3_view_weights(PT.TrainConfig(**kw), lengths, 7)
        np.testing.assert_array_equal(got, want)
