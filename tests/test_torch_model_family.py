"""The TensoRF family's other configurations in the port against the JAX
package, on the CPU, at tiny size: the ``cp`` and ``vm`` decompositions,
every shading mode, the NDC sampler and the bf16 train step.  Inputs are
made from seeds with numpy (or drawn with jax.random and handed to the
port); kernels A, A', C and C' run their plain versions.  Tolerances
(the worst seen on these inputs in brackets):

- ``eval_sh_bases`` (degrees 0..4) and ``shade`` in every mode: within
  1e-6 (2.4e-7).  ``MLP_PE``'s head is 3 inputs narrower than the JAX
  package's ``mlp_input_dim`` (which counts raw positions its head never
  concatenates, so JAX cannot shade an MLP_PE field); both heads are fed
  the same weights here;
- the features of cp, vm and vm_split (density, app, fused; fp32) and
  their gradients through CPFeatures / FactorFeatures: within 1e-5 of
  each output's and each leaf's largest magnitude (3.5e-7).  In bf16 the
  features equal JAX's eager ones; the gradients are within 3e-2 of each
  leaf's largest (1.9e-2) of JAX's bf16 gradient, whose XLA scatter-add
  sums in bf16, and no further from the fp32 gradient than JAX's own
  bf16 gradient is (the port's kernels accumulate in fp32: 0.97e-2
  against JAX's 1.9e-2);
- the regularizers of cp and vm (TV, L1, orthogonality), values and
  gradients: within 1e-6 relative; vm's orthogonality raises in both;
- upsample (cp, vm) within 1e-6 of each leaf's largest (2.6e-7: XLA's
  linspace rounds some coordinates by an ulp); cp's shrink equal, vm's
  refused in both;
- the npz checkpoints of cp and vm: written by either package, loaded by
  the other, every leaf equal;
- ``ndc_rays`` (both conventions), ``ndc_bbox``, ``depth2dist``,
  ``ndc2dist``: within 1e-6 relative;
- the dense NDC render (train with JAX's per-sample jitter injected, and
  eval) and the renders of cp and vm in the shading modes (dense, and
  compacted through a mask): rgb, depth, acc, weights within 1e-5;
- one bf16 train step of the compacted and the dense branch, vm_split
  and cp.  Inside its jit XLA keeps some bf16 chains in fp32 (excess
  precision) where the port rounds every op, as JAX's eager functions
  do, and XLA's scatter sums in bf16: the loss within 2e-3 relative
  (4.9e-4), each leaf's gradient within 0.12 of its largest of JAX's
  (8.9e-2; cp 0.2, 0.149: JAX's bf16 scatter-add into cp's short
  lines strays 0.13 from the fp32 gradient), and within 3e-2 of the
  fp32 step's gradient (2.0e-2; cp 9.4e-3), no further than JAX's bf16
  gradient is from it (9.5e-2; cp 0.13);
- a 2-view progressive fit (stage 1, one expansion, stage 2) of cp
  (through upsample and the shrink), vm (upsample, no shrink) and of
  vm_split with ``ndc_ray``, JAX's per-step jitter injected: sampler ids
  and step counts equal, the per-step mse within 1e-5 relative plus 1e-8
  (stage 2 fits the new view, the expansion's own render, to an mse of
  ~8e-5: the view may differ from JAX's by a uint8 level on a few pixels,
  ~1e-8 of a batch's mse each; 3.0e-9 seen), the final grid, box and
  config equal.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_expansion import _expansion_cfg, _no_warmup, _scene_cfg, _services
from test_torch_train_step import _capture
from test_torch_trainer import _Recorder, _rows
from text2nerf_tpu.data import scene_state as ss
from text2nerf_tpu.engine import checkpoints as JC
from text2nerf_tpu.engine import expansion as JE
from text2nerf_tpu.engine import train_step as JTS
from text2nerf_tpu.engine import trainer as JT
from text2nerf_tpu.engine.checkpoints import _flatten
from text2nerf_tpu.models import mlp as jmlp
from text2nerf_tpu.models import sh as jsh
from text2nerf_tpu.models import tensorf as tf
from text2nerf_tpu.ops import rays as R
from text2nerf_tpu.ops import render as Rd
from text2nerf_tpu_torch.data import scene_state as pss
from text2nerf_tpu_torch.engine import checkpoints as PC
from text2nerf_tpu_torch.engine import expansion as PE
from text2nerf_tpu_torch.engine import train_step as PTS
from text2nerf_tpu_torch.engine import trainer as PT
from text2nerf_tpu_torch.models import mlp as pmlp
from text2nerf_tpu_torch.models import sh as psh
from text2nerf_tpu_torch.models import tensorf as ptf
from text2nerf_tpu_torch.ops import rays as PR
from text2nerf_tpu_torch.ops import render as PRd

torch.set_num_threads(2)

AABB = np.array([[-8.0] * 3, [8.0] * 3], np.float32)
AABB_T = torch.tensor(AABB)
GRID = (10, 12, 14)
WIDTHS = {  # (density, app) components of each decomposition
    "cp": ((3,), (5,)),
    "vm": ((2, 2, 2), (3, 3, 3)),
    "vm_split": ((2, 3, 2), (3, 4, 5)),
}
MODES = ("MLP_Fea_noview", "MLP_Fea", "MLP_PE", "MLP", "SH", "RGB")


def _cfg(name, mode="MLP_Fea_noview", **kw):
    nd, na = WIDTHS[name]
    app_dim = {"SH": 27, "RGB": 3}.get(mode, 12)
    base = dict(model_name=name, density_n_comp=nd, app_n_comp=na, app_dim=app_dim,
                shading_mode=mode, fea_pe=2, view_pe=2, pos_pe=2, feature_c=16)
    return tf.TensoRFConfig(**{**base, **kw})


def _params(cfg, reso=GRID, seed=0):
    return tf.init_params(jax.random.PRNGKey(seed), cfg, reso)


def _port(cfg, params):
    return PC.params_from_jax(_flatten(params), cfg, device="cpu")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _leaf_errs(got, want):
    assert set(got) == set(want)
    return {k: _rel(got[k], want[k]) for k in want if float(np.abs(want[k]).max()) > 0}


# ---------------------------------------------------------------------------
# SH and the shading heads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_bases_matches_jax(deg):
    d = np.random.default_rng(deg).standard_normal((97, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = np.asarray(jsh.eval_sh_bases(deg, jnp.asarray(d)))
    got = psh.eval_sh_bases(deg, torch.from_numpy(d)).numpy()
    assert got.shape == want.shape == (97, (deg + 1) ** 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    coeffs = np.random.default_rng(9).standard_normal((97, 3, (deg + 1) ** 2)).astype(np.float32)
    np.testing.assert_allclose(
        psh.eval_sh(deg, torch.from_numpy(coeffs), torch.from_numpy(d)).numpy(),
        np.asarray(jsh.eval_sh(deg, jnp.asarray(coeffs), jnp.asarray(d))), rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_shade_matches_jax(mode):
    cfg = _cfg("vm_split", mode)
    rng = np.random.default_rng(3)
    n = 75
    feats = rng.standard_normal((n, cfg.app_dim)).astype(np.float32)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    mlp = None
    if mode.startswith("MLP"):
        in_dim = pmlp.mlp_input_dim(mode, cfg.app_dim, cfg.view_pe, cfg.fea_pe, cfg.pos_pe)
        # MLP_PE: the JAX package counts 3 raw position channels its head
        # never concatenates (so a JAX MLP_PE field cannot shade); the port
        # sizes the head to the input both heads build
        extra = 3 if mode == "MLP_PE" else 0
        assert jmlp.mlp_input_dim(mode, cfg.app_dim, cfg.view_pe, cfg.fea_pe, cfg.pos_pe) \
            == in_dim + extra
        mlp = jmlp.init_mlp(jax.random.PRNGKey(1), in_dim, cfg.feature_c)
    want = np.asarray(jmlp.shade(mode, mlp, jnp.asarray(pts), jnp.asarray(dirs),
                                 jnp.asarray(feats), view_pe=2, fea_pe=2, pos_pe=2))
    pm = None if mlp is None else {k: torch.from_numpy(np.array(v)) for k, v in mlp.items()}
    got = pmlp.shade(mode, pm, torch.from_numpy(pts), torch.from_numpy(dirs),
                     torch.from_numpy(feats), view_pe=2, fea_pe=2, pos_pe=2).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# Features, their gradients, regularizers, resizing, checkpoints
# ---------------------------------------------------------------------------


def _xn(n=600, seed=0):
    xn = np.random.default_rng(seed).uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    xn[:8] = [[1, 1, 1], [-1, -1, -1], [1, -1, 1], [-1, 1, -1], [1, 0.3, -0.2],
              [0.1, 1, 0.4], [-0.6, 0.2, 1], [1, 1, -1]]  # the edges: clamped rows
    return xn


def _jax_features(cfg, params, xn, mode, dtype, d_sigma, d_app):
    """(outputs, gradients) of <d_sigma, sigma> + <d_app, app> in JAX."""
    xn = jnp.asarray(xn)

    def f(p):
        if mode == "fused":
            s, a = tf.compute_fused_features_packed(cfg, tf.pack_params_fused(cfg, p), xn,
                                                    dtype=dtype)
        elif mode == "density":
            s, a = tf.compute_density_feature_packed(cfg, tf.pack_params(cfg, p), xn,
                                                     dtype=dtype), None
        else:
            s, a = None, tf.compute_app_feature_packed(cfg, tf.pack_params(cfg, p), xn,
                                                       dtype=dtype)
        loss = 0.0
        if s is not None:
            loss = loss + jnp.sum(s * d_sigma)
        if a is not None:
            loss = loss + jnp.sum(a * d_app)
        return loss, (s, a)

    (_, out), g = jax.value_and_grad(f, has_aux=True)(params)
    return out, _flatten(g)


def _port_features(field, xn, mode, dtype, d_sigma, d_app):
    x = torch.from_numpy(xn)
    if mode == "fused":
        s, a = field.fused_features(x, dtype)
    elif mode == "density":
        s, a = field.density_feature(x, dtype), None
    else:
        s, a = None, field.app_feature(x, dtype)
    loss = 0.0
    if s is not None:
        loss = loss + (s * torch.from_numpy(d_sigma)).sum()
    if a is not None:
        loss = loss + (a * torch.from_numpy(d_app)).sum()
    loss.backward()
    return (s, a), PC.grads_to_jax(field)


@pytest.mark.parametrize("mode", ["fused", "density", "app"])
@pytest.mark.parametrize("name", ["cp", "vm", "vm_split"])
def test_features_and_gradients_match_jax(name, mode):
    cfg = _cfg(name)
    params = _params(cfg)
    xn = _xn()
    rng = np.random.default_rng(2)
    d_sigma = rng.standard_normal(len(xn)).astype(np.float32)
    d_app = rng.standard_normal((len(xn), cfg.app_dim)).astype(np.float32)
    (ws, wa), wg = _jax_features(cfg, params, xn, mode, None, d_sigma, d_app)
    (gs, ga), gg = _port_features(_port(cfg, params), xn, mode, None, d_sigma, d_app)
    for got, want in ((gs, ws), (ga, wa)):
        if want is not None:
            assert _rel(got.detach().numpy(), want) <= 1e-5
    errs = _leaf_errs(gg, wg)
    assert max(errs.values()) <= 1e-5, errs
    # the tables the mode reads have a gradient
    assert ("lines" if name == "vm" else "density_lines/0") in errs or mode == "app"
    assert "basis" in errs or mode == "density"


@pytest.mark.parametrize("name", ["cp", "vm", "vm_split"])
def test_bf16_features_and_gradients_match_jax(name):
    cfg = _cfg(name)
    params = _params(cfg)
    xn = _xn()
    rng = np.random.default_rng(2)
    d_sigma = rng.standard_normal(len(xn)).astype(np.float32)
    d_app = rng.standard_normal((len(xn), cfg.app_dim)).astype(np.float32)
    (ws, wa), wg = _jax_features(cfg, params, xn, "fused", jnp.bfloat16, d_sigma, d_app)
    _, w32 = _jax_features(cfg, params, xn, "fused", None, d_sigma, d_app)
    (gs, ga), gg = _port_features(_port(cfg, params), xn, "fused", torch.bfloat16,
                                  d_sigma, d_app)
    np.testing.assert_array_equal(gs.detach().numpy(), np.asarray(ws))
    np.testing.assert_array_equal(ga.detach().numpy(), np.asarray(wa))
    errs = _leaf_errs(gg, wg)
    assert max(errs.values()) <= 3e-2, errs
    # fp32 accumulation: no further from the fp32 gradient than JAX's bf16
    port_off, jax_off = _leaf_errs(gg, w32), _leaf_errs(wg, w32)
    assert max(port_off.values()) <= max(jax_off.values()), (port_off, jax_off)


REGULARIZERS = {
    "tv_density": (tf.tv_loss_density, ptf.tv_loss_density),
    "tv_app": (tf.tv_loss_app, ptf.tv_loss_app),
    "l1": (tf.density_l1, ptf.density_l1),
    "ortho": (tf.vector_comp_diffs, ptf.vector_comp_diffs),
}


@pytest.mark.parametrize("reg", list(REGULARIZERS))
@pytest.mark.parametrize("name", ["cp", "vm"])
def test_regularizers_match_jax(name, reg):
    cfg = _cfg(name)
    params = _params(cfg)
    jfn, pfn = REGULARIZERS[reg]
    field = _port(cfg, params)
    if name == "vm" and reg == "ortho":
        # the fused stack has no separate density and app lines
        with pytest.raises(KeyError):
            jfn(cfg, params)
        with pytest.raises(ValueError, match="vm"):
            pfn(field)
        return
    want, want_g = jax.value_and_grad(lambda p: jfn(cfg, p))(params)
    got = pfn(field)
    got.backward()
    assert _rel(got.detach().numpy(), want) <= 1e-6
    errs = _leaf_errs(PC.grads_to_jax(field), _flatten(want_g))
    assert errs and max(errs.values()) <= 1e-6, errs


@pytest.mark.parametrize("name", ["cp", "vm"])
def test_upsample_and_shrink_match_jax(name):
    cfg = _cfg(name)
    params = _params(cfg)
    field = _port(cfg, params)
    target = (16, 18, 20)
    up = PC.params_to_jax(ptf.upsample_volume_grid(field, target))
    want = _flatten(tf.upsample_volume_grid(cfg, params, target))
    for k in want:
        assert up[k].shape == np.asarray(want[k]).shape, k
        assert _rel(up[k], want[k]) <= 1e-6, k
    new_aabb = np.array([[-5.0, -3.3, -6.1], [4.2, 7.0, 2.5]], np.float32)
    if name == "vm":
        with pytest.raises(AssertionError):
            tf.shrink(cfg, params, AABB, new_aabb)
        with pytest.raises(ValueError, match="vm"):
            ptf.shrink(field, AABB, new_aabb)
        return
    jp, jaabb, jgrid = tf.shrink(cfg, params, AABB, new_aabb)
    pf, paabb, pgrid = ptf.shrink(field, AABB, new_aabb)
    assert pgrid == jgrid == ptf.grid_resolution(pf)
    np.testing.assert_array_equal(paabb.numpy(), np.asarray(jaabb))
    got = PC.params_to_jax(pf)
    for k, v in _flatten(jp).items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


@pytest.mark.parametrize("name", ["cp", "vm"])
def test_checkpoints_load_in_both_packages(tmp_path, name):
    cfg = _cfg(name, "SH" if name == "vm" else "MLP_Fea")
    params = _params(cfg, seed=4)
    JC.save_checkpoint(str(tmp_path / "j.npz"), cfg, params, jnp.asarray(AABB))
    pcfg, field, aabb, _, _ = PC.load_checkpoint(str(tmp_path / "j.npz"), device="cpu")
    assert pcfg.to_dict() == cfg.to_dict()
    assert ptf.grid_resolution(field) == tf.grid_resolution(cfg, params)
    assert (field.mlp is None) == (cfg.shading_mode == "SH")
    PC.save_checkpoint(str(tmp_path / "p.npz"), field, aabb)
    jcfg, back, _, _, _ = JC.load_checkpoint(str(tmp_path / "p.npz"))
    assert jcfg == cfg
    want, got = _flatten(params), _flatten(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    # the widths read back from the shapes alone
    inferred = PC._infer_cfg(_flatten(params))
    assert inferred.model_name == name
    assert ptf.component_counts(inferred) == ptf.component_counts(pcfg)


# ---------------------------------------------------------------------------
# NDC
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("blender", [False, True])
def test_ndc_helpers_match_jax(blender):
    rng = np.random.default_rng(int(blender))
    o = rng.uniform(-0.5, 0.5, (64, 3)).astype(np.float32)
    o[:, 2] -= 3.0 if blender else -3.0
    d = rng.standard_normal((64, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5 if blender else np.abs(d[:, 2]) + 0.5
    want = R.ndc_rays(24, 32, 30.0, 1.0, jnp.asarray(o), jnp.asarray(d), blender=blender)
    got = PR.ndc_rays(24, 32, 30.0, 1.0, torch.from_numpy(o), torch.from_numpy(d),
                      blender=blender)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= 1e-6
    rays = np.concatenate([np.asarray(want[0]), np.asarray(want[1])], -1)
    np.testing.assert_array_equal(PR.ndc_bbox(torch.from_numpy(rays)).numpy(),
                                  np.asarray(R.ndc_bbox(jnp.asarray(rays))))
    z = np.sort(rng.uniform(0.5, 8.0, (16, 9)), -1).astype(np.float32)
    cos = rng.uniform(0.5, 1.0, 16).astype(np.float32)
    assert _rel(PR.depth2dist(torch.from_numpy(z), torch.from_numpy(cos)).numpy(),
                R.depth2dist(jnp.asarray(z), jnp.asarray(cos))) <= 1e-6
    pts = rng.standard_normal((16, 9, 3)).astype(np.float32)
    assert _rel(PR.ndc2dist(torch.from_numpy(pts), torch.from_numpy(cos)).numpy(),
                R.ndc2dist(jnp.asarray(pts), jnp.asarray(cos))) <= 1e-6


def _blob_params(cfg, reso=GRID, seed=0):
    """Random factors whose density is a blob filling the box."""
    params = _params(cfg, reso, seed)
    if cfg.model_name == "vm":
        nd = cfg.density_n_comp[0]
        params["planes"] = params["planes"].at[..., -nd:].set(
            jnp.abs(params["planes"][..., -nd:]) + 1.0)
        params["lines"] = params["lines"].at[..., -nd:].set(
            jnp.abs(params["lines"][..., -nd:]) + 1.0)
        return params
    keys = ("density_lines",) if cfg.model_name == "cp" else ("density_planes", "density_lines")
    for k in keys:
        params[k] = jax.tree.map(lambda x: jnp.abs(x) + 1.0, params[k])
    return params


def _rays(hw=12):
    intr = R.default_intrinsics(hw, hw)
    dirs = R.ray_directions(hw, hw, intr[:2], intr[2:])
    o, d = R.rays_from_pose(dirs, jnp.eye(4))
    return np.array(jnp.concatenate([o, d], -1))


FIELDS = ("rgb", "depth", "acc", "weights", "z_vals")


def _close_out(got, want, atol=1e-5):
    for name in FIELDS:
        g, w = getattr(got, name).detach().numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("is_train", [False, True])
@pytest.mark.parametrize("mode", ["MLP_Fea", "SH"])
def test_ndc_dense_render_matches_jax(mode, is_train):
    cfg = _cfg("vm_split", mode, distance_scale=0.5)
    params = _blob_params(cfg)
    field = _port(cfg, params).requires_grad_(is_train)
    rays = _rays()
    n_s, key = 40, jax.random.PRNGKey(11)
    want = Rd.render_rays(cfg, params, jnp.asarray(AABB), jnp.asarray(rays), key,
                          n_samples=n_s, app_k=12, is_train=is_train, white_bg=False,
                          ndc=True)
    kw = {}
    if is_train:
        # the per-sample jitter and the coin JAX's render drew from its key
        rng, k_jit = jax.random.split(key)
        kw = dict(jitter=torch.from_numpy(np.asarray(jax.random.uniform(k_jit, (len(rays), n_s)))),
                  bg_coin=float(jax.random.uniform(jax.random.split(rng)[1], ())))
    got = PRd.render_rays(field, AABB_T, torch.from_numpy(rays), n_samples=n_s, app_k=12,
                          is_train=is_train, white_bg=False, ndc=True, **kw)
    _close_out(got, want)
    assert float(np.asarray(want.acc).max()) > 0.2


@pytest.mark.parametrize("case", [("cp", "MLP_Fea"), ("cp", "RGB"), ("vm", "SH"),
                                  ("vm", "MLP_PE"), ("vm_split", "MLP")])
def test_renders_of_the_family_match_jax(case):
    name, mode = case
    cfg = _cfg(name, mode, distance_scale=2.0)
    params = _blob_params(cfg)
    if mode == "MLP_PE":  # the head the input fits (see test_shade_matches_jax)
        in_dim = pmlp.mlp_input_dim(mode, cfg.app_dim, cfg.view_pe, cfg.fea_pe, cfg.pos_pe)
        params["mlp"] = dict(params["mlp"], w1=params["mlp"]["w1"][:in_dim])
    field = _port(cfg, params).requires_grad_(False)
    rays = _rays()
    want = Rd.render_rays(cfg, params, jnp.asarray(AABB), jnp.asarray(rays), n_samples=40,
                          app_k=12)
    got = PRd.render_rays(field, AABB_T, torch.from_numpy(rays), n_samples=40, app_k=12)
    _close_out(got, want)
    # the compacted renderer through a mask: fused (shade-all) and top-K
    mask, _ = tf.update_alpha_mask(cfg, params, jnp.asarray(AABB), (10, 10, 10), pool=3)
    pmask, _ = ptf.update_alpha_mask(field, AABB_T, (10, 10, 10), pool=3, device="cpu")
    np.testing.assert_array_equal(pmask["volume"].numpy(), np.asarray(mask["volume"]))
    for app_k in (16, 6):
        want = Rd.render_rays_compact(cfg, params, jnp.asarray(AABB), jnp.asarray(rays), mask,
                                      n_samples=40, compact_k=16, app_k=app_k,
                                      feature_dtype="fp32")
        got = PRd.render_rays_compact(field, AABB_T, torch.from_numpy(rays), pmask,
                                      n_samples=40, compact_k=16, app_k=app_k,
                                      feature_dtype="fp32")
        _close_out(got, want)
    assert float(np.asarray(want.acc).max()) > 0.1


# ---------------------------------------------------------------------------
# The bf16 train step
# ---------------------------------------------------------------------------


# each decomposition's bound on the gradient against JAX's bf16 one
# (module docstring)
BF16_STEP_GRAD_TOL = {"vm_split": 0.12, "cp": 0.2}


@pytest.mark.parametrize("name,compact", [
    pytest.param("vm_split", False, id="False"), pytest.param("vm_split", True, id="True"),
    pytest.param("cp", False, id="cp-False"), pytest.param("cp", True, id="cp-True")])
def test_bf16_train_step_matches_jax(name, compact):
    cfg = _cfg(name, distance_scale=2.0)
    params = _blob_params(cfg, (16, 16, 16))
    rays = _rays(16)
    rgb = np.random.default_rng(0).uniform(0.2, 0.8, (len(rays), 3)).astype(np.float32)
    batch = {"rays": rays, "rgb": rgb, "depth": np.full(len(rays), 4.0, np.float32)}
    kw = dict(n_samples=32, app_k=16, white_bg=True, compute_dtype="bf16", microbatch=1)
    mask = pmask = None
    if compact:
        kw.update(compact_k=16, depth_cap_band=0)
        mask, _ = tf.update_alpha_mask(cfg, params, jnp.asarray(AABB), (12, 12, 12), pool=3)
    key = jax.random.PRNGKey(5)
    tx = optax.chain(_capture(), optax.sgd(1.0))
    state = JTS.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    jstep = JTS.make_train_step(cfg, tx, **kw)
    new_state, m = jstep(state, jnp.asarray(AABB), {k: jnp.asarray(v) for k, v in batch.items()},
                         key, alpha_mask=mask)
    want = _flatten(new_state.opt_state[0])

    field = _port(cfg, params)
    if compact:
        pmask, _ = ptf.update_alpha_mask(field.requires_grad_(False), AABB_T, (12, 12, 12),
                                         pool=3, device="cpu")
    opt = torch.optim.SGD(ptf.param_groups(field.requires_grad_(True)), lr=1.0)
    pstep = PTS.make_train_step(cfg, opt, device="cpu", **kw)
    _, k_jit = jax.random.split(key)
    jitter = np.asarray(jax.random.uniform(k_jit, (len(rays), 1)))
    _, pm = pstep(PTS.TrainState(field, opt, 0), AABB_T, batch, alpha_mask=pmask,
                  jitter=jitter)
    assert abs(float(pm["mse"]) / float(m["mse"]) - 1) <= 2e-3
    got = PC.grads_to_jax(field)
    errs = _leaf_errs(got, want)
    assert max(errs.values()) <= BF16_STEP_GRAD_TOL[name], errs
    # the fp32 step's gradient: the port's bf16 one stays closer to it
    # than JAX's bf16 one does
    tx = optax.chain(_capture(), optax.sgd(1.0))
    j32 = JTS.make_train_step(cfg, tx, **{**kw, "compute_dtype": "fp32"})
    new_state, _ = j32(JTS.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32)),
                       jnp.asarray(AABB), {k: jnp.asarray(v) for k, v in batch.items()}, key,
                       alpha_mask=mask)
    want32 = _flatten(new_state.opt_state[0])
    port_off = max(_leaf_errs(got, want32).values())
    assert port_off <= 3e-2 and port_off <= max(_leaf_errs(want, want32).values())
    first = "density_lines/0" if name == "cp" else "density_planes/0"
    assert float(np.abs(want[first]).max()) > 1e-6


# ---------------------------------------------------------------------------
# 2-view progressive fits
# ---------------------------------------------------------------------------

FIT_MODEL = dict(app_dim=6, fea_pe=2, view_pe=2, feature_c=16, step_ratio=0.5)
FIT_SCHEDULE = dict(n_stage1=1, n_stage2=1, n_stage3=0, batch_size=512, n_voxel_init=12 ** 3,
                    n_voxel_final=16 ** 3, upsamp_list=(3,), update_alphamask_list=(6,),
                    app_k=8, eval_every_epochs=10, seed=3, train_microbatch=4,
                    eval_mask_pool=5, progress_refresh_rate=1, vis_support_views=False,
                    eval_compact_k=0)
FITS = {
    "cp": (dict(model_name="cp", density_n_comp=(2,), app_n_comp=(4,),
                shading_mode="MLP_Fea"), {}),
    "vm": (dict(model_name="vm", density_n_comp=(2, 2, 2), app_n_comp=(9, 9, 9),
                shading_mode="SH", app_dim=27), {}),
    "ndc": (dict(model_name="vm_split", density_n_comp=(2, 2, 2), app_n_comp=(4, 4, 4)),
            dict(ndc_ray=True)),
}


def _slab(cfg, reso):
    """The box |x|, |y| < 1.5, z in (2.5, 6) as the decomposition's density
    (the other factors random)."""
    params = _params(cfg, reso, seed=5)

    def axis(n, lo, hi, a, b):
        xs = np.linspace(-8, 8, n)
        return np.where((xs > lo) & (xs < hi), a, b).astype(np.float32)

    nd = cfg.density_n_comp[0]
    line_z = np.repeat(axis(reso[2], 2.5, 6.0, 3.0, 0.0)[:, None], nd, -1)
    if cfg.model_name == "cp":
        lines = (jnp.asarray(line_z),
                 jnp.asarray(np.repeat(axis(reso[1], -1.5, 1.5, 1.5, 0.0)[:, None], nd, -1)),
                 jnp.asarray(np.repeat(axis(reso[0], -1.5, 1.5, 1.5, 0.0)[:, None], nd, -1)))
        params["density_lines"] = lines
        return params
    plane = 1.5 * np.minimum(axis(reso[0], -1.5, 1.5, 1.0, -1.0)[None, :],
                             axis(reso[1], -1.5, 1.5, 1.0, -1.0)[:, None])
    plane = np.repeat(plane[..., None], nd, -1)
    if cfg.model_name == "vm":
        params["planes"] = params["planes"].at[0, ..., -nd:].set(plane)
        params["lines"] = params["lines"].at[0, :, -nd:].set(line_z)
        return params
    params["density_planes"] = (jnp.asarray(plane), *params["density_planes"][1:])
    params["density_lines"] = (jnp.asarray(line_z), *params["density_lines"][1:])
    return params


@contextlib.contextmanager
def _jax_key_stream(seed, kinds):
    """Wrap the port's make_train_step so every step takes the jitter and
    coins the JAX trainer's step draws from its key stream: one per ray,
    or one per sample for NDC."""
    make0 = PTS.make_train_step
    key = [jax.random.PRNGKey(seed)]

    def make_train_step(cfg, opt, **kw):
        step = make0(cfg, opt, **kw)
        width = kw["n_samples"] if kw["ndc"] else 1

        def stepped(state, aabb, batch, rng=None, tv_decay=None, alpha_mask=None,
                    lr_decay=1.0):
            key[0], k = jax.random.split(key[0])
            compact = kw["compact_k"] > 0 and alpha_mask is not None and not kw["ndc"]
            r = kw["microbatch_compact"] if compact and kw["microbatch_compact"] \
                else kw["microbatch"]
            b = batch["rays"].shape[0]
            r = PTS.effective_microbatch(b, r)
            keys = [k] if r == 1 else list(jax.random.split(k, r))
            parts, coins = [], []
            for kk in keys:
                rest, k_jit = jax.random.split(kk)
                parts.append(np.asarray(jax.random.uniform(k_jit, (b // r, width))))
                coins.append(float(jax.random.uniform(jax.random.split(rest)[1], ())))
            kinds.append(compact)
            return step(state, aabb, batch, rng, tv_decay, alpha_mask=alpha_mask,
                        lr_decay=lr_decay, jitter=np.concatenate(parts),
                        bg_coin=None if kw["white_bg"] else np.asarray(coins, np.float32))

        return stepped

    PTS.make_train_step = make_train_step
    try:
        yield
    finally:
        PTS.make_train_step = make0


@pytest.mark.parametrize("fit", list(FITS))
def test_progressive_fit_of_the_family_follows_jax(tmp_path, fit):
    model, extra = FITS[fit]
    model = {**FIT_MODEL, **model}
    sched = {**FIT_SCHEDULE, **extra}
    jcfg = tf.TensoRFConfig(**model)
    reso = tf.n_to_reso(sched["n_voxel_init"], AABB)
    init = str(tmp_path / "init.npz")
    JC.save_checkpoint(init, jcfg, _slab(jcfg, reso), jnp.asarray(AABB))
    js, ps = _services()
    with _no_warmup(), _Recorder(JTS.PermutationSampler) as jids:
        jres = JT.reconstruction(
            JT.TrainConfig(expname="j", basedir=str(tmp_path / "jl"), ckpt=init, model=jcfg,
                           **sched),
            _scene_cfg(ss.SceneConfig, tmp_path / "jd"), js, _expansion_cfg(JE.ExpansionConfig))
    kinds = []
    with _Recorder(PTS.PermutationSampler) as pids, _jax_key_stream(sched["seed"], kinds):
        pres = PT.reconstruction(
            PT.TrainConfig(expname="p", basedir=str(tmp_path / "pl"), ckpt=init,
                           model=ptf.TensoRFConfig(**model), **sched),
            _scene_cfg(pss.SceneConfig, tmp_path / "pd"), ps, _expansion_cfg(PE.ExpansionConfig),
            device="cpu")
    jids, pids = jids.ids, pids.ids
    assert len(jids) == len(pids) == len(kinds) > 20
    for a, b in zip(jids, pids):
        np.testing.assert_array_equal(b, a)
    mj = np.array([r["mse"] for r in _rows(jres[4]) if "mse" in r])
    mp = np.array([r["mse"] for r in _rows(pres[4]) if "mse" in r])
    assert len(mj) == len(mp) == len(kinds)
    # the new view's targets are the expansion's renders, which may differ
    # by a uint8 level on a few pixels: ~1e-8 of a 512-ray batch's mse each
    assert np.all(np.abs(mp - mj) <= 1e-5 * mj + 1e-8), np.abs(mp / mj - 1).max()
    logged = {k: v for r in _rows(pres[4]) for k, v in r.items()}
    n_up = int(np.exp(np.linspace(np.log(sched["n_voxel_init"]),
                                  np.log(sched["n_voxel_final"]), 2))[1])
    assert logged["upsample_grid"] == list(tf.n_to_reso(n_up, AABB))
    assert ("shrink_aabb" in logged) == (fit != "vm")  # vm has no shrink
    assert any(kinds) == (fit != "ndc")  # NDC steps stay dense
    assert ptf.grid_resolution(pres[1]) == tf.grid_resolution(jres[0], jres[1])
    np.testing.assert_array_equal(pres[2].numpy(), np.asarray(jres[2]))
    assert dataclasses.asdict(pres[0]) == dataclasses.asdict(jres[0])
