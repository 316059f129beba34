"""The train step's parts against the JAX package, on the CPU.

- Losses: values and gradients within 1e-6 relative, each on seeded
  inputs; the rgb clip at a tie (exactly 1.0) passes half the gradient on
  both sides.
- Regularizers on the fused tables' density and app channel slices (TV
  divides by each group's own channel count): values and gradients.
- Kernel A''s plain version, through ``FactorFeatures`` (the autograd
  Function the field trains through), against ``jax.vjp`` of
  compute_fused_features_packed on pack_params_fused and of the
  density-only and app-only packed features, with samples on the grid's
  upper edge (clamped corners) in three orders, a run of samples inside
  one cell, and all-zero output gradients mixed in.  Gradients within
  1e-5 of each leaf's largest.
- ``last_k_live`` on random masks, rows with fewer than k live included.
- The trainer's step bookkeeping (TrainConfig defaults, the group guard,
  the step keyword arguments), the optimizer groups, the sampler.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2nerf_tpu.engine import train_step as ts
from text2nerf_tpu.engine import trainer as TR
from text2nerf_tpu.engine.checkpoints import _flatten
from text2nerf_tpu.models import tensorf as tf
from text2nerf_tpu.ops import losses as L
from text2nerf_tpu.ops import render as Rd
from text2nerf_tpu_torch.engine import checkpoints as PC
from text2nerf_tpu_torch.engine import train_step as pts
from text2nerf_tpu_torch.engine import trainer as PTR
from text2nerf_tpu_torch.models import tensorf as ptf
from text2nerf_tpu_torch.ops import losses as PL
from text2nerf_tpu_torch.ops import render as PRd
from text2nerf_tpu_torch.ops.kernels import factor_features as ff

torch.set_num_threads(1)

CFG = tf.TensoRFConfig(density_n_comp=(4, 5, 6), app_n_comp=(8, 7, 9), app_dim=12)
GRID = (20, 17, 23)


def _close(got, want, rtol, what):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


def _loss_inputs(seed=0, b=64, s=24):
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(1.0, 8.0, (b, s)), axis=1).astype(np.float32)
    w = rng.dirichlet(np.ones(s), b).astype(np.float32) * rng.uniform(0.2, 1.0, (b, 1))
    gt = rng.uniform(2.0, 6.0, b).astype(np.float32)
    return {
        "pred": rng.uniform(0, 1, (b, 3)).astype(np.float32),
        "target": rng.uniform(0, 1, (b, 3)).astype(np.float32),
        "z": z, "w": w.astype(np.float32),
        "depth": rng.uniform(2.0, 6.0, b).astype(np.float32),
        "gt": gt,
        # sample depths spread around each ray's target: the scale/shift
        # fit has a slope to find (with a slope near 0 its numerator
        # cancels and any summation order moves s by ~5e-5 relative)
        "z_fit": (gt[:, None] * np.sort(rng.uniform(0.7, 1.3, (b, s)), axis=1)
                  + 0.3).astype(np.float32),
    }


# name -> (JAX loss of the differentiated arrays, port loss, the arrays'
# keys); a tuple-valued loss differentiates its first element
LOSSES = {
    "mse": (lambda a, b: L.mse(a, b), lambda a, b: PL.mse(a, b), ("pred", "target")),
    "psnr": (lambda a, b: L.mse2psnr(L.mse(a, b)), lambda a, b: PL.mse2psnr(PL.mse(a, b)),
             ("pred", "target")),
    "charbonnier": (L.charbonnier, PL.charbonnier, ("pred", "target")),
    "transmittance_mask": (
        lambda w, z, gt: L.transmittance_mask_loss(w, L.depth_front_mask(z, gt, 0.1)),
        lambda w, z, gt: PL.transmittance_mask_loss(w, PL.depth_front_mask(z, gt, 0.1)),
        ("w", "z", "gt")),
    "transmittance_mask_denom": (
        lambda w, z, gt: L.transmittance_mask_loss(w, L.depth_front_mask(z, gt), denom=259),
        lambda w, z, gt: PL.transmittance_mask_loss(w, PL.depth_front_mask(z, gt), denom=259),
        ("w", "z", "gt")),
    "transmittance_const": (L.transmittance_const_loss, PL.transmittance_const_loss, ("w",)),
    "gaussian_nll": (L.gaussian_nll_depth_loss, PL.gaussian_nll_depth_loss,
                     ("depth", "z", "w", "gt")),
    "silog": (L.scale_invariant_log_depth_loss, PL.scale_invariant_log_depth_loss,
              ("depth", "gt")),
    "ssi": (L.scale_shift_invariant_depth_loss, PL.scale_shift_invariant_depth_loss,
            ("z_fit", "w", "gt")),
}


# ssi: s and t are quotients of sums that cancel (the normal equations'
# determinant and numerators), so summing in another order moves them by
# up to 1.8e-6 relative, and the gradient w·(s·z + t - target), whose
# residual cancels again, by up to 2.9e-6 of its largest (measured on
# these inputs)
GRAD_RTOL = {"ssi": 1e-5}


@pytest.mark.parametrize("name", list(LOSSES))
def test_losses_match_jax(name):
    jfn, pfn, keys = LOSSES[name]
    inp = _loss_inputs()
    args = [inp[k] for k in keys]

    def first(out):
        return out[0] if isinstance(out, tuple) else out

    want, want_g = jax.jit(jax.value_and_grad(lambda *a: first(jfn(*a)),
                                              argnums=tuple(range(len(args)))))(
        *[jnp.asarray(a) for a in args])
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    out = pfn(*targs)
    got = first(out)
    got.backward()
    _close(got.detach().numpy(), want, 1e-6, name)
    for k, t, g in zip(keys, targs, want_g):
        if np.abs(np.asarray(g)).max() == 0:
            assert t.grad is None or float(t.grad.abs().max()) == 0, (name, k)
            continue
        _close(t.grad.numpy(), g, GRAD_RTOL.get(name, 1e-6), f"{name} d/d{k}")
    if name == "ssi":  # the fitted scale and shift ride along
        jout = jfn(*[jnp.asarray(a) for a in args])
        for g, w in zip(out[1:], jout[1:]):
            _close(g.detach().numpy(), w, GRAD_RTOL[name], "ssi s/t")


def test_rgb_clip_tie_passes_half_the_gradient():
    # a white-background ray lands exactly on 1.0: jnp.clip splits the
    # gradient at the tie, and so must the port's train clip
    x = np.array([0.5, 1.0, 0.0, 1.5, -0.5], np.float32)
    want = jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.0, 1.0)))(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    PRd.clip01(t).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
    assert float(t.grad[1]) == 0.5 == float(want[1])


@pytest.fixture(scope="module")
def fields():
    params = tf.init_params(jax.random.PRNGKey(3), CFG, GRID)
    for k, scale in (("density_planes", 2.5), ("density_lines", 2.5),
                     ("app_planes", 4.0), ("app_lines", 4.0)):
        params[k] = jax.tree.map(lambda x: scale * x, params[k])
    return params


def _port(params, cfg=CFG):
    return PC.params_from_jax(_flatten(params), cfg, device="cpu")


def _grads(field):
    return PC.grads_to_jax(field)


REGULARIZERS = {
    "tv_density": (tf.tv_loss_density, ptf.tv_loss_density),
    "tv_app": (tf.tv_loss_app, ptf.tv_loss_app),
    "density_l1": (tf.density_l1, ptf.density_l1),
    "ortho": (tf.vector_comp_diffs, ptf.vector_comp_diffs),
}


@pytest.mark.parametrize("name", list(REGULARIZERS))
def test_regularizers_match_jax(fields, name):
    jfn, pfn = REGULARIZERS[name]
    want, want_g = jax.jit(jax.value_and_grad(lambda p: jfn(CFG, p)))(fields)
    field = _port(fields)
    got = pfn(field)
    got.backward()
    _close(got.detach().numpy(), want, 1e-6, name)
    g_port = _grads(field)
    for key, g in _flatten(want_g).items():
        _close(g_port[key], g, 1e-6, f"{name} {key}")
    assert float(want) > 0


def _edge_xn(n=600, seed=0):
    xn = np.random.default_rng(seed).uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    # the upper edge of every axis (the clamped corner rows), the lower
    # edge, the corners
    xn[:8] = [[1, 1, 1], [-1, -1, -1], [1, -1, 1], [-1, 1, -1], [1, 0.3, -0.2],
              [0.1, 1, 0.4], [-0.6, 0.2, 1], [1, 1, -1]]
    xn[8:40, 0] = 1.0
    xn[40:72, 1] = 1.0
    xn[72:104, 2] = 1.0
    return xn


@functools.partial(jax.jit, static_argnames=("mode",))
def _jax_grads(params, xn, mode, d_sigma, d_app):
    """JAX gradients of <d_sigma, sigma> + <d_app, app>."""
    def f(p):
        if mode == "fused":
            s, a = tf.compute_fused_features_packed(CFG, tf.pack_params_fused(CFG, p), xn)
            return jnp.sum(s * d_sigma) + jnp.sum(a * d_app)
        if mode == "density":
            return jnp.sum(tf.compute_density_feature_packed(CFG, tf.pack_params(CFG, p), xn)
                           * d_sigma)
        return jnp.sum(tf.compute_app_feature_packed(CFG, tf.pack_params(CFG, p), xn) * d_app)

    return jax.grad(f)(params)


@pytest.mark.parametrize("case", ["given", "reversed", "shuffled", "one_cell", "zero_rows",
                                  "corner_run", "short_rays"])
@pytest.mark.parametrize("mode", ["fused", "density", "app"])
def test_kernel_a_backward_plain_matches_jax_grad(fields, mode, case):
    # the edge samples in three orders; 64 samples inside one cell of every
    # plane and line (a whole run of kernel A''s walk adds into the same
    # rows); all-zero output gradients mixed in (the walk skips those
    # samples), and samples whose d_sigma alone is zero; a run of 64
    # samples on the upper corner (every corner and line row coincides);
    # rays of 5 one-voxel steps, 41 of them (runs cross rays, n not a
    # multiple of 32)
    xn = _edge_xn()
    if case == "reversed":
        xn = xn[::-1].copy()
    elif case == "shuffled":
        xn = xn[np.random.default_rng(1).permutation(len(xn))]
    elif case == "one_cell":
        xn = (0.1 + 1e-3 * np.random.default_rng(3).random((64, 3))).astype(np.float32)
    elif case == "corner_run":
        xn[200:264] = 1.0
    elif case == "short_rays":
        rng = np.random.default_rng(4)
        o = rng.uniform(-0.8, 0.8, (41, 1, 3))
        d = rng.standard_normal((41, 1, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        steps = np.arange(5)[None, :, None] * (2.0 / (min(GRID) - 1))
        xn = np.clip(o + d * steps, -1, 1).reshape(-1, 3).astype(np.float32)
    rng = np.random.default_rng(2)
    d_sigma = rng.standard_normal(len(xn)).astype(np.float32)
    d_app = rng.standard_normal((len(xn), CFG.app_dim)).astype(np.float32)
    if case == "zero_rows":
        coin = rng.random(len(xn))
        d_sigma[coin < 0.4] = 0.0
        d_app[coin < 0.3] = 0.0
    want = _flatten(_jax_grads(fields, jnp.asarray(xn), mode, jnp.asarray(d_sigma),
                               jnp.asarray(d_app)))

    field = _port(fields)
    x = torch.from_numpy(xn)
    if mode == "fused":
        s, a = field.fused_features(x)
        loss = (s * torch.from_numpy(d_sigma)).sum() + (a * torch.from_numpy(d_app)).sum()
    elif mode == "density":
        loss = (field.density_feature(x) * torch.from_numpy(d_sigma)).sum()
    else:
        loss = (field.app_feature(x) * torch.from_numpy(d_app)).sum()
    loss.backward()
    got = _grads(field)
    for key in ("density_planes", "density_lines", "app_planes", "app_lines"):
        for i in range(3):
            k = f"{key}/{i}"
            w = want[k]
            if (mode == "density" and key.startswith("app")) or (
                mode == "app" and key.startswith("density")
            ):
                # the mode does not read these channels: no gradient on either side
                assert float(np.abs(w).max()) == 0 and float(np.abs(got[k]).max()) == 0, k
                continue
            scale = float(np.abs(w).max())
            assert scale > 0, k
            assert float(np.abs(got[k] - w).max()) <= 1e-5 * scale, k
    if mode != "density":
        _close(got["basis"], want["basis"], 1e-5, "basis")


def test_factor_features_backward_wrapper(fields):
    # the plain backward behind the wrapper: accumulation into given
    # tables, shape checks, no gradient for xn, the bf16 backward
    field = _port(fields)
    planes, lines, nd = tuple(field.planes), tuple(field.lines), field.nd
    xn = torch.from_numpy(_edge_xn(200, seed=4))
    rng = np.random.default_rng(5)
    d_sigma = torch.from_numpy(rng.standard_normal(200).astype(np.float32))
    d_app = torch.from_numpy(rng.standard_normal((200, sum(CFG.app_n_comp))).astype(np.float32))
    with torch.no_grad():
        once = ff.factor_features_backward(xn, planes, lines, nd, d_sigma, d_app)
        out = (tuple(torch.zeros_like(p) for p in planes),
               tuple(torch.zeros_like(l) for l in lines))
        for _ in range(2):
            ff.factor_features_backward(xn, planes, lines, nd, d_sigma, d_app, out=out)
    for a, b in zip((*once[0], *once[1]), (*out[0], *out[1])):
        torch.testing.assert_close(b, 2 * a, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="d_sigma"):
        ff.factor_features_backward(xn, planes, lines, nd, d_sigma[:-1], None)
    with pytest.raises(ValueError, match="ask for sigma"):
        ff.factor_features_backward(xn, planes, lines, nd, None, None)
    x = xn.clone().requires_grad_(True)
    s, _ = field.fused_features(x)
    s.sum().backward()
    assert x.grad is None and field.planes[0].grad is not None
    # bf16: the forward equals JAX's eager bf16 features; the backward (bf16
    # products, fp32 sums) is within 3e-2 of each leaf's largest of JAX's
    # gradient, whose scatter-add sums in bf16 (1.4e-2 seen)
    d_sig, d_ap = d_sigma[:200].numpy(), d_app[:200, :CFG.app_dim].numpy()

    def jloss(p):
        s_, a_ = tf.compute_fused_features_packed(CFG, tf.pack_params_fused(CFG, p),
                                                  jnp.asarray(xn.numpy()), dtype=jnp.bfloat16)
        return jnp.sum(s_ * d_sig) + jnp.sum(a_ * d_ap), (s_, a_)

    (_, (ws, wa)), wg = jax.value_and_grad(jloss, has_aux=True)(fields)
    field = _port(fields)
    s, a = field.fused_features(xn, torch.bfloat16)
    np.testing.assert_array_equal(s.detach().numpy(), np.asarray(ws))
    np.testing.assert_array_equal(a.detach().numpy(), np.asarray(wa))
    ((s * torch.from_numpy(d_sig)).sum() + (a * torch.from_numpy(d_ap)).sum()).backward()
    got = _grads(field)
    for key, g in _flatten(wg).items():
        _close(got[key], g, 3e-2, f"bf16 {key}")
    pts.make_train_step(field.cfg, torch.optim.SGD(field.parameters(), lr=1.0),
                        n_samples=8, compute_dtype="bf16", device="cpu")


@pytest.mark.parametrize("k", [1, 5, 16])
def test_last_k_live_matches_jax(k):
    rng = np.random.default_rng(k)
    live = rng.random((40, 33)) < rng.uniform(0.02, 0.6, (40, 1))
    live[0] = False
    live[1] = True
    live[2, :] = False
    live[2, -1] = True  # one live entry, at the end
    want_idx, want_sel = Rd.last_k_live(jnp.asarray(live), k)
    idx, sel = PRd.last_k_live(torch.from_numpy(live), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(want_sel))
    assert (live.sum(1) < k).any()


def test_trainer_step_bookkeeping_matches_jax():
    want, got = TR.TrainConfig(), PTR.TrainConfig()
    assert {f.name for f in dataclasses.fields(got)} == {f.name for f in dataclasses.fields(want)}
    for f in dataclasses.fields(got):
        if f.name == "model":  # each package's own TensoRFConfig class
            assert got.model.to_dict() == want.model.to_dict()
        else:
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    aabb = np.array([[-8.0] * 3, [8.0] * 3], np.float32)
    for reso, ratio in (((300, 300, 300), 1.0), ((32, 32, 32), 1.0), ((64, 40, 90), 1.0),
                        ((150, 150, 150), 2.0), ((300, 300, 300), 3.5)):
        assert PTR._resolve_group(got, aabb, reso, ratio) == TR._resolve_group(
            want, jnp.asarray(aabb), reso, ratio), reso
        for block in (3, 4, 5):
            assert ptf.grouping_safe(aabb, reso, ratio, 2, block) == bool(
                tf.grouping_safe(jnp.asarray(aabb), reso, ratio, 2, block))
    for cfg_kw in ({}, {"train_microbatch": 7, "train_microbatch_compact": 0},
                   {"train_density_group": 1, "depth_loss_type": "ssi"}):
        w, g = TR.TrainConfig(**cfg_kw), PTR.TrainConfig(**cfg_kw)
        kw_w = TR._step_kwargs(w, n_samples=259, group=2, block=3, white_bg=True)
        kw_g = PTR._step_kwargs(g, n_samples=259, group=2, block=3, white_bg=True)
        assert kw_g.keys() == kw_w.keys()
        for k in kw_w:
            assert tuple(kw_g[k]) == tuple(kw_w[k]) if k == "weights" else kw_g[k] == kw_w[k], k
    assert pts.effective_microbatch(16384, 32) == ts.effective_microbatch(16384, 32) == 32
    assert pts.effective_microbatch(1000, 32) == ts.effective_microbatch(1000, 32)
    assert pts.lr_factor(0.1, 1000) == ts.lr_factor(0.1, 1000)
    a, b = pts.PermutationSampler(100, 32, seed=3), ts.PermutationSampler(100, 32, seed=3)
    for _ in range(7):
        np.testing.assert_array_equal(a.next_ids(), b.next_ids())


def test_param_groups_match_the_jax_labels(fields):
    field = _port(fields)
    labels = _flatten(tf.param_group_labels(fields))
    groups = {g["name"]: {id(p) for p in g["params"]} for g in ptf.param_groups(field)}
    owner = {}
    for p, keys in PC._jax_leaves(field):
        for key, _ in keys:
            owner[key] = next(n for n, ids in groups.items() if id(p) in ids)
    assert owner == {k: str(v) for k, v in labels.items()}
    opt = pts.make_optimizer(field, 0.02, 1e-3, 0.5)
    assert [(g["name"], g["lr"], g["decay"]) for g in opt.param_groups] == [
        ("spatial", 0.02, 0.5), ("network", 1e-3, 0.5)]
    assert opt.defaults["betas"] == (0.9, 0.99) and opt.defaults["eps"] == 1e-8
