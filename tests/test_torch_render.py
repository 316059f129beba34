"""The port's eval renderers against the JAX package, on the CPU (the plain
versions of both kernels): the dense render in the ``entry()``
configuration, the compacted render with its per-ray escalation targets,
the adaptive chunked renderer with its base-rung memo, and
evaluation_path.  fp32 features: rgb/depth/acc ≤ 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2nerf_tpu.data import trajectories as traj
from text2nerf_tpu.engine import renderer as ER
from text2nerf_tpu.engine.checkpoints import _flatten
from text2nerf_tpu.models import tensorf as tf
from text2nerf_tpu.ops import rays as R
from text2nerf_tpu.ops import render as Rd
from text2nerf_tpu_torch.engine import renderer as PER
from text2nerf_tpu_torch.engine.checkpoints import params_from_jax
from text2nerf_tpu_torch.models import tensorf as ptf
from text2nerf_tpu_torch.ops import render as PRd

torch.set_num_threads(1)

AABB = jnp.array([[-8.0, -8.0, -8.0], [8.0, 8.0, 8.0]])
AABB_T = torch.tensor(np.asarray(AABB))
HW = 20
FIELDS = ("rgb", "depth", "acc", "weights", "z_vals")


def _close(got, want, atol=1e-5, names=FIELDS):
    for name in names:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol, err_msg=name)


def _field(distance_scale, grid=24 ** 3, seed=0):
    """A solid blob whose per-sample alpha is set by distance_scale (25:
    opaque; 0.005: fog that never saturates), as tests/test_adaptive_eval
    builds it, and its port."""
    cfg = tf.TensoRFConfig(density_n_comp=(8, 8, 8), app_n_comp=(16, 16, 16),
                           distance_scale=distance_scale)
    reso = tf.n_to_reso(grid, AABB)
    params = tf.init_params(jax.random.PRNGKey(seed), cfg, reso)
    for k in ("density_planes", "density_lines"):
        params[k] = jax.tree.map(lambda x: jnp.abs(x) + 1.0, params[k])
    field = params_from_jax(_flatten(params), cfg, device="cpu").requires_grad_(False)
    return cfg, params, field, int(tf.default_n_samples(reso, 1.0))


def _masks(cfg, params, field, pool):
    mask, _ = tf.update_alpha_mask(cfg, params, AABB, (16, 16, 16), pool=pool)
    pmask, _ = ptf.update_alpha_mask(field, AABB_T, (16, 16, 16), pool=pool, device="cpu")
    np.testing.assert_array_equal(pmask["volume"].numpy(), np.asarray(mask["volume"]))
    return mask, pmask


def _rays(hw=HW):
    intr = R.default_intrinsics(hw, hw)
    dirs = R.ray_directions(hw, hw, intr[:2], intr[2:])
    poses = traj.training_trajectory("local_fixed", 24, angle=0.2, trans_range=0.2)
    return R.rays_from_poses(dirs, jnp.asarray(poses))[0]


@pytest.mark.parametrize("masked", [False, True])
def test_render_rays_entry_config_matches_jax(masked):
    # __graft_entry__.entry(): n_samples 55, app_k 16, (8,8,8)/(16,16,16),
    # random rays from the origin; the grid cut from 64^3 to 32^3
    cfg = tf.TensoRFConfig(density_n_comp=(8, 8, 8), app_n_comp=(16, 16, 16), app_dim=27)
    params = tf.init_params(jax.random.PRNGKey(0), cfg, (32, 32, 32))
    # a denser field than the near-empty init, so appearance matters
    for k in ("density_planes", "density_lines"):
        params[k] = jax.tree.map(lambda x: 8.0 * x, params[k])
    field = params_from_jax(_flatten(params), cfg, device="cpu").requires_grad_(False)
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(256, 3)).astype(np.float32)
    dirs[:, 2] = np.abs(dirs[:, 2]) + 0.5
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays = np.concatenate([np.zeros((256, 3), np.float32), dirs], -1)
    mask = pmask = None
    if masked:
        mask, pmask = _masks(cfg, params, field, 3)
    want = Rd.render_rays(cfg, params, AABB, jnp.asarray(rays), n_samples=55, app_k=16,
                          white_bg=True, alpha_mask=mask)
    got = PRd.render_rays(field, AABB_T, torch.from_numpy(rays), n_samples=55, app_k=16,
                          white_bg=True, alpha_mask=pmask)
    _close(got, want, names=("rgb", "acc", "weights", "z_vals"))
    # depth sums 55 weighted z values of up to 8 world units: the density
    # sums' fp32 reassociation reaches 1e-5 relative there
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth), rtol=1e-5, atol=1e-5)
    assert float(np.asarray(want.acc).max()) > 0.4


def test_render_rays_compact_need_matches_jax():
    cfg, params, field, n_s = _field(0.01)
    mask, pmask = _masks(cfg, params, field, 5)  # stride-2 occupancy
    rays = _rays()
    kw = dict(n_samples=n_s, compact_k=8, app_k=8, k_ladder=(8, 16, 32),
              feature_dtype="fp32")
    want, need = Rd.render_rays_compact_need(cfg, params, AABB, rays, mask, **kw)
    got, pneed = PRd.render_rays_compact_need(field, AABB_T, torch.from_numpy(np.array(rays)),
                                              pmask, **kw)
    _close(got, want)
    assert pneed.dtype == torch.int8
    np.testing.assert_array_equal(pneed.numpy(), np.asarray(need))
    assert len(np.unique(np.asarray(need))) >= 2  # some rays escalate, some not


@pytest.mark.parametrize("distance_scale", [0.005, 0.02])
def test_render_chunked_adaptive_matches_jax(distance_scale):
    # fog (0.005) escalates every ray and moves the memoized base rung up;
    # 0.02 escalates some rays only
    cfg, params, field, n_s = _field(distance_scale)
    mask, pmask = _masks(cfg, params, field, 3)
    rays = _rays()
    Rd._ADAPTIVE_PROBE_CACHE.clear()
    PRd._ADAPTIVE_PROBE_CACHE.clear()
    kw = dict(n_samples=n_s, chunk=128, app_k=16, k_ladder=(4, 8, 16),
              feature_dtype="fp32")
    for _ in range(2):  # the second call starts at the memoized base rung
        want, ks = Rd.render_chunked_adaptive(cfg, params, AABB, rays, mask, **kw)
        got, pks = PRd.render_chunked_adaptive(field, AABB_T, np.asarray(rays), pmask,
                                               device="cpu", **kw)
        assert pks == ks
        _close(got, want, names=("rgb", "depth", "acc"))
    assert max(ks) > 4
    assert list(PRd._ADAPTIVE_PROBE_CACHE.values()) == list(Rd._ADAPTIVE_PROBE_CACHE.values())


def test_render_chunked_fixed_k_and_dense_match_jax():
    cfg, params, field, n_s = _field(0.02)
    mask, pmask = _masks(cfg, params, field, 5)
    rays = np.asarray(_rays())[:300]
    for kw in (dict(alpha_mask=(mask, pmask), compact_k=12, app_k=8),
               dict(alpha_mask=(None, None), compact_k=0, app_k=8)):
        m, pm = kw.pop("alpha_mask")
        want = Rd.render_chunked(cfg, params, AABB, jnp.asarray(rays), n_samples=n_s,
                                 chunk=128, alpha_mask=m, feature_dtype="fp32", **kw)
        got = PRd.render_chunked(field, AABB_T, rays, n_samples=n_s, chunk=128,
                                 alpha_mask=pm, feature_dtype="fp32", device="cpu", **kw)
        _close(got, want, names=("rgb", "depth", "acc"))


def test_evaluation_path_matches_jax():
    cfg, params, field, n_s = _field(0.02)
    mask, pmask = _masks(cfg, params, field, 5)
    hw = (32, 32)
    intr = R.default_intrinsics(*hw)
    poses = traj.test_trajectory("circle0", np.eye(4), angle=0.2, trans_range=0.2)[:2]
    Rd._ADAPTIVE_PROBE_CACHE.clear()
    PRd._ADAPTIVE_PROBE_CACHE.clear()
    kw = dict(n_samples=n_s, alpha_mask=None, compact_k=-1, chunk=512, app_k=16,
              white_bg=True)
    want_rgb, want_depth = ER.evaluation_path(cfg, params, AABB, poses, hw, intr,
                                              **dict(kw, alpha_mask=mask))
    got_rgb, got_depth = PER.evaluation_path(field, AABB_T, poses, hw, intr, device="cpu",
                                             **dict(kw, alpha_mask=pmask))
    assert len(got_rgb) == len(want_rgb) == 2
    for g, w in zip(got_rgb, want_rgb):
        assert g.shape == w.shape == (32, 32, 3) and g.dtype == np.uint8
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
    for g, w in zip(got_depth, want_depth):
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 2
    assert any(len(np.unique(w)) > 8 for w in want_rgb)


def test_select_impl_and_bad_options_raise():
    # an unknown lowering raises; the three JAX lowerings resolve
    with pytest.raises(ValueError):
        PRd._resolve_select_impl("nativ")
    assert [PRd._resolve_select_impl(i) for i in ("sort", "topk", "rank")] == \
        ["sort", "topk", "rank"]
    assert PRd._resolve_select_impl(None) == "sort"
    live = torch.from_numpy(np.random.default_rng(7).random((16, 41)) < 0.3)
    live[0] = False
    live[1] = True
    idx, sel = PRd.first_k_live(live, 8)
    want_idx, want_sel = Rd.first_k_live(jnp.asarray(live.numpy()), 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(want_sel))
    assert PRd.adaptive_compact_k(17) == Rd.adaptive_compact_k(17) == 32
    # NDC rays: the dense renderer's NDC sampler, as JAX renders them
    cfg, params, field, n_s = _field(0.02)
    rays = _rays()[:64]
    want = Rd.render_rays(cfg, params, AABB, rays, n_samples=24, app_k=8, ndc=True)
    got = PRd.render_rays(field, AABB_T, torch.from_numpy(np.array(rays)), n_samples=24,
                          app_k=8, ndc=True)
    _close(got, want)
