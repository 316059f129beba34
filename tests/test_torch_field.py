"""The port's field bookkeeping, alpha mask, rays, trajectory and metrics
against the JAX package, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2nerf_tpu.data import trajectories as traj
from text2nerf_tpu.engine import metrics as M
from text2nerf_tpu.engine.checkpoints import _flatten
from text2nerf_tpu.models import tensorf as tf
from text2nerf_tpu.ops import rays as R
from text2nerf_tpu_torch.data import trajectories as ptraj
from text2nerf_tpu_torch.engine import metrics as PM
from text2nerf_tpu_torch.engine.checkpoints import params_from_jax, params_to_jax
from text2nerf_tpu_torch.models import tensorf as ptf
from text2nerf_tpu_torch.ops import rays as PR

torch.set_num_threads(1)

AABB = [[-8.0, -8.0, -8.0], [8.0, 8.0, 8.0]]


@pytest.mark.parametrize("n_voxels", [27_000_000, 64 ** 3, 48 ** 3, 30 ** 3, 1000])
def test_grid_bookkeeping_matches_jax(n_voxels):
    reso = ptf.n_to_reso(n_voxels, AABB)
    assert reso == tf.n_to_reso(n_voxels, jnp.asarray(AABB))
    assert ptf.default_n_samples(reso, 1.0) == tf.default_n_samples(reso, 1.0)
    assert ptf.cal_n_samples(reso) == tf.cal_n_samples(reso)
    step = ptf.step_size(torch.tensor(AABB), reso, 1.0)
    assert float(step) == float(tf.step_size(jnp.asarray(AABB), reso, 1.0))


def test_full_width_config():
    cfg = ptf.TensoRFConfig()
    reso = ptf.n_to_reso(27_000_000, AABB)
    assert reso == (300, 300, 300)
    assert ptf.default_n_samples(reso, cfg.step_ratio) == 259
    assert cfg.to_dict() == tf.TensoRFConfig().to_dict()
    assert ptf.TensoRFConfig.from_dict(cfg.to_dict()) == cfg
    # TensorCP at TensoRF's published widths: the port's parameters carry
    # the JAX init's keys and shapes
    cp = ptf.TensoRFConfig(model_name="cp", density_n_comp=(96,), app_n_comp=(288,))
    want = _flatten(tf.init_params(jax.random.PRNGKey(0), tf.TensoRFConfig(**cp.to_dict()),
                                   (8, 9, 10)))
    got = params_to_jax(ptf.TensoRF(cp, (8, 9, 10)))
    assert {k: v.shape for k, v in got.items()} == {k: np.shape(v) for k, v in want.items()}


@pytest.mark.parametrize("pool", [3, 5])
def test_update_alpha_mask_matches_jax(pool):
    cfg = tf.TensoRFConfig(density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8))
    reso = (24, 20, 28)
    params = tf.init_params(jax.random.PRNGKey(5), cfg, reso)
    # density factors scaled so alpha crosses the 1e-4 threshold in part of
    # the volume (24% occupied at pool 3, 63% at pool 5)
    for k in ("density_planes", "density_lines"):
        params[k] = jax.tree.map(lambda x: 5.0 * x, params[k])
    mask, new_aabb = tf.update_alpha_mask(cfg, params, jnp.asarray(AABB), (18, 16, 14), pool=pool)
    field = params_from_jax(_flatten(params), cfg, device="cpu")
    pmask, pnew = ptf.update_alpha_mask(field, AABB, (18, 16, 14), pool=pool, device="cpu")
    vol = np.asarray(mask["volume"])
    assert 0.05 < vol.mean() < 0.95
    np.testing.assert_array_equal(pmask["volume"].numpy(), vol)
    assert pmask["pool"] == mask["pool"] == pool
    np.testing.assert_allclose(pnew.numpy(), np.asarray(new_aabb), atol=1e-6)
    np.testing.assert_array_equal(pmask["aabb"].numpy(), np.asarray(mask["aabb"]))


def test_ray_directions_and_poses_match_jax():
    h, w = 12, 20
    intr = R.default_intrinsics(h, w)
    assert PR.default_intrinsics(h, w) == intr
    dirs = R.ray_directions(h, w, intr[:2], intr[2:])
    pdirs = PR.ray_directions(h, w, intr[:2], intr[2:], device="cpu")
    np.testing.assert_allclose(pdirs.numpy(), np.asarray(dirs), atol=1e-6)
    raw = R.ray_directions(h, w, (30.0, 25.0), normalize=False)
    praw = PR.ray_directions(h, w, (30.0, 25.0), normalize=False, device="cpu")
    np.testing.assert_allclose(praw.numpy(), np.asarray(raw), atol=1e-6)

    poses = traj.test_trajectory("circle0", np.eye(4), angle=0.2, trans_range=0.2)[:5]
    for c2w in poses:
        o, d = R.rays_from_pose(dirs, jnp.asarray(c2w, jnp.float32))
        po, pd = PR.rays_from_pose(pdirs, c2w)
        np.testing.assert_allclose(po.numpy(), np.asarray(o), atol=1e-6)
        np.testing.assert_allclose(pd.numpy(), np.asarray(d), atol=1e-6)
    batched = R.rays_from_poses(dirs, jnp.asarray(poses, jnp.float32))
    pbatched = PR.rays_from_poses(pdirs, poses)
    np.testing.assert_allclose(pbatched.numpy(), np.asarray(batched), atol=1e-6)


def test_aabb_slab_matches_jax():
    rng = np.random.default_rng(2)
    o = rng.uniform(-10, 10, (500, 3)).astype(np.float32)
    d = rng.standard_normal((500, 3)).astype(np.float32)
    d[:20, 0] = 0.0  # the 1e-6 substitution
    d[20:30, :2] = 0.0
    aabb = np.asarray([[-8, -7, -6], [8, 7, 6]], np.float32)
    t = R.aabb_slab_entry(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb), 0.5, 8.0)
    pt = PR.aabb_slab_entry(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(aabb), 0.5, 8.0)
    np.testing.assert_allclose(pt.numpy(), np.asarray(t), rtol=1e-6, atol=1e-6)
    lo, hi = R.aabb_slab_interval(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb))
    plo, phi = PR.aabb_slab_interval(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(aabb))
    finite = np.isfinite(np.asarray(lo)) & (np.abs(np.asarray(lo)) < 1e5)
    np.testing.assert_allclose(plo.numpy()[finite], np.asarray(lo)[finite], rtol=1e-6, atol=1e-6)
    finite = np.isfinite(np.asarray(hi)) & (np.abs(np.asarray(hi)) < 1e5)
    np.testing.assert_allclose(phi.numpy()[finite], np.asarray(hi)[finite], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["circle0", "circle0_30", "circle_45", "rectangle", "line_10_20_1.5"])
def test_trajectory_matches_jax(kind):
    ref = np.eye(4)
    ref[:3, 3] = [0.1, -0.2, 0.3]
    if kind.startswith("circle0"):
        want = traj.test_trajectory(kind, ref, angle=0.2, trans_range=0.2)
        got = ptraj.test_trajectory(kind, ref, angle=0.2, trans_range=0.2)
    else:
        want = traj.camera_trajectory(40, kind, radius=0.3, pose_ref=ref)
        got = ptraj.camera_trajectory(40, kind, radius=0.3, pose_ref=ref)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)
    # the local trajectories are ported too (slice 5)
    np.testing.assert_array_equal(
        ptraj.test_trajectory("local_fixed", ref, angle=0.2, trans_range=0.2),
        traj.test_trajectory("local_fixed", ref, angle=0.2, trans_range=0.2))


def test_metrics_match_jax():
    rng = np.random.default_rng(4)
    a, b = rng.random((16, 16, 3)), rng.random((16, 16, 3))
    assert PM.psnr(a, b) == M.psnr(a, b)
    assert PM.psnr(a, a) == float("inf")
    depth = rng.uniform(0.0, 9.0, (40, 40))
    for minmax in (None, (0.5, 8.0)):
        got, got_mm = PM.visualize_depth(depth, minmax)
        want, want_mm = M.visualize_depth(depth, minmax)
        assert got_mm == want_mm and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_room_shell_field_and_mask_match_jax():
    # the port's room shell (data/synthetic.py) applies bench.py's density
    # construction; on the JAX shell's own params the port's mask agrees
    # except where alpha sits within fp32 rounding of the 1e-4 threshold
    import bench
    from text2nerf_tpu_torch.data.synthetic import room_shell_field

    cfg = tf.TensoRFConfig()
    reso = tf.n_to_reso(27_000_000, jnp.asarray(AABB))  # full width; a 40^3 mask
    shell = bench.build_scene_field(cfg, reso)
    field = params_from_jax(_flatten(shell), ptf.TensoRFConfig(), device="cpu")
    mask, _ = tf.update_alpha_mask(cfg, shell, jnp.asarray(AABB), (40,) * 3, pool=5)
    pmask, _ = ptf.update_alpha_mask(field, AABB, (40,) * 3, pool=5, device="cpu")
    vol = np.asarray(mask["volume"])
    assert 0.05 < vol.mean() < 0.98
    assert np.mean(pmask["volume"].numpy() != vol) <= 1e-4

    port = room_shell_field(ptf.TensoRFConfig(), reso, generator=torch.Generator().manual_seed(0),
                            device="cpu").requires_grad_(False)
    nd = cfg.density_n_comp
    np.testing.assert_array_equal(port.lines[0][:, : nd[0]].numpy(),
                                  np.asarray(shell["density_lines"][0]))
    for i in range(3):
        assert float(port.planes[i][..., : nd[i]].min()) >= 1.0
    for i in (1, 2):
        assert float(port.lines[i][:, : nd[i]].min()) >= 1.0
