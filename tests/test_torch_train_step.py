"""The port's train step against the JAX package's, on the CPU (kernel A
and kernel A' run their plain versions there).

The tiny configuration of tests/test_train_step.py ((4,4,4)/(8,8,8)
components, app_dim 12, fea_pe 2, feature_c 32, a 32³ grid, 48 samples,
the wall scene of 256 rays), with the density factors set to a wall slab
at z in (3, 5) so the mask, the live selection and the weights have
structure.  JAX's per-ray jitter and background coins are drawn with
jax.random exactly as its step draws them and handed to the port.

- Gradients through the whole step: both sides take one step with SGD at
  lr 1 (optax.sgd(1.0); torch.optim.SGD(lr=1.0)).  The JAX side chains a
  pass-through transformation in front of the SGD that keeps the
  gradient in its state, and the port's step leaves it in ``.grad``, so
  each leaf's gradient is compared as computed, not as a parameter
  delta rounded against the parameter:
  max|g_port - g_jax| <= 1e-5·max|g_jax| + 1e-8.  Compacted branch
  (pool-5 mask, density_group 2, compact_k 16, band 6 and band 0, the
  selected member indices equal as integers) and dense branch (R = 1;
  R = 4 with the random background).
- Adam with runtime decay: a JAX state after 2 steps, carried across by
  train_state_from_jax (and back by train_state_to_jax bit for bit), then
  3 more steps on each side with lr_decay falling: params within rtol
  2e-5, atol 2e-6, the bounds of test_runtime_decay_matches_embedded_schedule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from text2nerf_tpu.engine import train_step as ts
from text2nerf_tpu.engine.checkpoints import _flatten
from text2nerf_tpu.models import tensorf as tf
from text2nerf_tpu.ops import rays as R
from text2nerf_tpu.ops import render as Rd
from text2nerf_tpu_torch.engine import checkpoints as PC
from text2nerf_tpu_torch.engine import train_step as pts
from text2nerf_tpu_torch.models import tensorf as ptf
from text2nerf_tpu_torch.ops import render as PRd

torch.set_num_threads(1)

CFG = tf.TensoRFConfig(
    density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8), app_dim=12,
    shading_mode="MLP_Fea_noview", fea_pe=2, feature_c=32,
)
GRID = (32, 32, 32)
AABB = jnp.array([[-8.0, -8.0, -8.0], [8.0, 8.0, 8.0]])
AABB_T = torch.tensor(np.asarray(AABB))
N_SAMPLES = 48
COMPACT = dict(compact_k=16, density_group=2, density_block=3)


def _wall_params(seed=0):
    params = tf.init_params(jax.random.PRNGKey(seed), CFG, GRID)
    zs = np.linspace(-8, 8, GRID[2])
    line = np.where((zs > 3.0) & (zs < 5.0), 2.0, -2.0).astype(np.float32)
    params["density_lines"] = (
        jnp.asarray(np.repeat(line[:, None], CFG.density_n_comp[0], 1)),
        *params["density_lines"][1:],
    )
    params["density_planes"] = (
        jnp.abs(params["density_planes"][0]) + 1.0, *params["density_planes"][1:],
    )
    return params


def _scene_batch():
    """tests/test_train_step.py's wall scene: 256 forward rays, a smooth
    colour target, depth 4."""
    h = w = 16
    fx, fy, cx, cy = R.default_intrinsics(h, w)
    dirs = np.asarray(R.ray_directions(h, w, (fx, fy), (cx, cy)))
    o, d = R.rays_from_pose(jnp.asarray(dirs), jnp.eye(4))
    uv = dirs.reshape(-1, 3)[:, :2]
    rgb = np.stack([0.5 + 0.4 * uv[:, 0], 0.5 + 0.4 * uv[:, 1], 0.3 + 0 * uv[:, 0]], -1)
    return {"rays": np.asarray(jnp.concatenate([o, d], -1)),
            "rgb": rgb.astype(np.float32), "depth": np.full((h * w,), 4.0, np.float32)}


def _draws(key, b, white_bg):
    """The jitter (b, 1) and coin a JAX train render draws from ``key``."""
    key, k_jit = jax.random.split(key)
    jitter = np.asarray(jax.random.uniform(k_jit, (b, 1)))
    coin = None
    if not white_bg:
        _, k_bg = jax.random.split(key)
        coin = float(jax.random.uniform(k_bg, ()))
    return jitter, coin


def _step_draws(key, b, r, white_bg):
    """The jitter (b, 1) and coins (r,) of one JAX train step."""
    keys = [key] if r == 1 else list(jax.random.split(key, r))
    parts = [_draws(k, b // r, white_bg) for k in keys]
    coins = None if white_bg else np.asarray([c for _, c in parts], np.float32)
    return np.concatenate([j for j, _ in parts]), coins


def _capture():
    """A pass-through transformation that keeps the gradient in its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates),
    )


@pytest.fixture(scope="module")
def scene():
    params = _wall_params()
    field = PC.params_from_jax(_flatten(params), CFG, device="cpu")
    mask, _ = tf.update_alpha_mask(CFG, params, AABB, (16, 16, 16), pool=5)
    pmask, _ = ptf.update_alpha_mask(field.requires_grad_(False), AABB_T, (16, 16, 16),
                                     pool=5, device="cpu")
    np.testing.assert_array_equal(pmask["volume"].numpy(), np.asarray(mask["volume"]))
    occ = float(pmask["volume"].mean())
    assert 0.05 < occ < 0.6, occ
    return params, mask, pmask, _scene_batch()


CASES = {
    "compact_anchored": dict(COMPACT, depth_cap_band=6, masked=True, white_bg=True, r=1),
    "compact_first_k": dict(COMPACT, depth_cap_band=0, masked=True, white_bg=True, r=1),
    "dense_r1": dict(density_group=2, density_block=3, masked=False, white_bg=True, r=1),
    "dense_r4_coin": dict(density_group=2, density_block=3, masked=False, white_bg=False,
                          r=4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sgd_step_gradients_match_jax(scene, case):
    params, mask, pmask, batch = scene
    kw = dict(CASES[case])
    masked, white_bg, r = kw.pop("masked"), kw.pop("white_bg"), kw.pop("r")
    step_kw = dict(n_samples=N_SAMPLES, app_k=16, white_bg=white_bg, microbatch=r,
                   microbatch_compact=r, **kw)
    key = jax.random.PRNGKey(7)

    tx = optax.chain(_capture(), optax.sgd(1.0))
    state = ts.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    step = ts.make_train_step(CFG, tx, **step_kw)
    batch_j = {k: jnp.asarray(v) for k, v in batch.items()}
    new_state, m = step(state, AABB, batch_j, key, alpha_mask=mask if masked else None)
    g_jax = _flatten(new_state.opt_state[0])

    field = PC.params_from_jax(_flatten(params), CFG, device="cpu")
    before = PC.params_to_jax(field)
    opt = torch.optim.SGD(ptf.param_groups(field), lr=1.0)
    pstep = pts.make_train_step(CFG, opt, device="cpu", **step_kw)
    jitter, coins = _step_draws(key, batch["rays"].shape[0], r, white_bg)
    _, pm = pstep(pts.TrainState(field, opt, 0), AABB_T, batch,
                  alpha_mask=pmask if masked else None, jitter=jitter, bg_coin=coins)
    g_port = PC.grads_to_jax(field)
    after = PC.params_to_jax(field)

    np.testing.assert_allclose(float(pm["mse"]), float(m["mse"]), rtol=1e-5)
    np.testing.assert_allclose(float(pm["psnr"]), float(m["psnr"]), rtol=1e-5)
    assert set(g_port) == set(g_jax)
    for name, want in g_jax.items():
        scale = float(np.abs(want).max())
        err = float(np.abs(g_port[name] - want).max())
        assert err <= 1e-5 * scale + 1e-8, (name, err, scale)
        # SGD at lr 1: the parameter moved by its gradient
        np.testing.assert_array_equal(after[name], (before[name] - g_port[name]))
    # the step is not a no-op: every group of leaves has a gradient
    assert float(np.abs(g_jax["density_planes/0"]).max()) > 1e-5
    assert float(np.abs(g_jax["app_planes/0"]).max()) > 1e-7
    assert float(np.abs(g_jax["mlp/w1"]).max()) > 1e-6


@pytest.mark.parametrize("band", [6, 0])
def test_compact_selection_matches_jax(scene, band):
    params, mask, pmask, batch = scene
    rays = batch["rays"]
    jitter, _ = _draws(jax.random.PRNGKey(3), rays.shape[0], True)
    anchored = band > 0
    kw = dict(n_samples=N_SAMPLES, compact_k=16, app_k=16, white_bg=True,
              density_group=2, occ_stride=2, feature_dtype="fp32",
              cap_band_samples=band)
    # JAX's render from the key whose jitter was drawn above
    want = Rd._render_rays_train_compact(
        CFG, params, AABB, jnp.asarray(rays), Rd._strip_pool(mask), jax.random.PRNGKey(3),
        density_block=3, depth_gt=jnp.asarray(batch["depth"]) if anchored else None, **kw)
    field = PC.params_from_jax(_flatten(params), CFG, device="cpu")
    got, midx = PRd._render_rays_train_compact(
        field, AABB_T, torch.tensor(rays), pmask, jitter=torch.tensor(jitter),
        depth_gt=torch.from_numpy(batch["depth"]) if anchored else None, **kw)
    # the member indices JAX selected, read back from its sample depths
    step = float(ptf.step_size(AABB_T, GRID, 1.0))
    t_min = PRd.aabb_slab_entry(torch.from_numpy(rays[:, :3]), torch.from_numpy(rays[:, 3:]),
                                AABB_T, CFG.near, CFG.far).numpy()
    want_idx = np.rint((np.asarray(want.z_vals) - t_min[:, None]) / step - jitter).astype(int)
    np.testing.assert_array_equal(midx.numpy(), want_idx)
    for name in ("rgb", "depth", "acc", "weights", "z_vals"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)), rtol=0, atol=1e-5,
                                   err_msg=name)
    assert float(np.asarray(want.acc).max()) > 0.5


def test_adam_runtime_decay_resumes_a_jax_state(scene):
    params, mask, pmask, batch = scene
    lr_init, lr_basis, factor = 0.02, 1e-3, ts.lr_factor(0.1, 50)
    kw = dict(n_samples=32, app_k=8, white_bg=True, runtime_decay=True,
              lr_init=lr_init, lr_basis=lr_basis)
    state, tx = ts.make_train_state(params, lr_init, lr_basis, factor, runtime_decay=True)
    step = ts.make_train_step(CFG, tx, **kw)
    batch_j = {k: jnp.asarray(v) for k, v in batch.items()}
    lr_decay = 1.0
    for i in range(2):
        state, _ = step(state, AABB, batch_j, jax.random.PRNGKey(100 + i), lr_decay=lr_decay)
        lr_decay *= factor

    pstate = PC.train_state_from_jax(_flatten(state.params), state.opt_state, CFG,
                                     step=int(state.step), runtime_decay=True, device="cpu")
    back = PC.train_state_to_jax(pstate)
    adam = state.opt_state[0]
    assert int(back["count"]) == int(adam.count) == 2 and int(back["step"]) == 2
    for tree, flat in ((state.params, back["params"]), (adam.mu, back["mu"]),
                       (adam.nu, back["nu"])):
        want = _flatten(tree)
        assert set(flat) == set(want)
        for k in want:
            np.testing.assert_array_equal(flat[k], want[k])

    pstep = pts.make_train_step(CFG, pstate.optimizer, device="cpu", **kw)
    for i in range(2, 5):
        key = jax.random.PRNGKey(100 + i)
        state, m = step(state, AABB, batch_j, key, lr_decay=lr_decay)
        jitter, _ = _draws(key, batch["rays"].shape[0], True)
        pstate, pm = pstep(pstate, AABB_T, batch, lr_decay=lr_decay, jitter=jitter)
        lr_decay *= factor
    np.testing.assert_allclose(float(pm["mse"]), float(m["mse"]), rtol=1e-5)
    assert pstate.step == int(state.step) == 5
    got = PC.params_to_jax(pstate.field)
    for k, want in _flatten(state.params).items():
        np.testing.assert_allclose(got[k], want, rtol=2e-5, atol=2e-6, err_msg=k)
