"""The bf16 modes of kernels C and C' (TensorCP's line gather and its
scatter-add) on the CPU, where each wrapper runs its plain version.  In
bf16 kernel C returns ``app_raw`` as bf16 and kernel C' takes a bf16
``d_app_raw``; both read the lines' bf16 copy.  Held here, every
comparison exact (tolerance 0):

- plain C in bf16, in fused, density and app modes: ``app_raw`` is bf16
  and, cast to fp32, equals the fp32-held ``app_raw`` of the design
  before (``tools/kernel_baselines/cp_features_v2.py``) bit for bit;
  ``sigma_feat`` stays fp32 and equal; fp32 mode is unchanged; and both
  equal JAX's eager ``compute_*_feature_packed(..., dtype=jnp.bfloat16)``
  for ``model_name="cp"`` with an identity basis, which hands
  ``app_raw``'s values through the basis product unchanged;
- plain C' in bf16 gives the same lines from a bf16 ``d_app_raw`` as from
  the same values in fp32, and refuses a bf16 one in fp32 mode;
- ``CPFeatures`` gives the same line gradients as the design before, in
  both compute types, and in bf16 ``app_raw`` and its gradient travel as
  bf16 through autograd;
- ``TensoRF._basis`` gives a TensorCP field's bf16 ``app_raw`` the same
  output as the same values held in fp32, with no cast on the field's
  path.

tests/test_torch_cuda.py holds the kernels' bf16 modes against these
plain versions on the card.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2nerf_tpu.engine.checkpoints import _flatten
from text2nerf_tpu.models import tensorf as tf
from text2nerf_tpu_torch.engine.checkpoints import params_from_jax
from text2nerf_tpu_torch.ops.kernels import cp_features as cpk

torch.set_num_threads(1)

CFG = tf.TensoRFConfig(model_name="cp", density_n_comp=(4,), app_n_comp=(12,), app_dim=9)
GRID = (20, 17, 23)
ND, NA = CFG.density_n_comp[0], CFG.app_n_comp[0]
BF = torch.bfloat16
MODES = {"fused": (True, True), "density": (True, False), "app": (False, True)}
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def params():
    p = tf.init_params(jax.random.PRNGKey(4), CFG, GRID)
    # products of three line values of order 0.1-0.5
    for k in ("density_lines", "app_lines"):
        p[k] = jax.tree.map(lambda x: 4.0 * x, p[k])
    return p


def _field(params):
    with torch.no_grad():
        return params_from_jax(_flatten(params), CFG, device="cpu")


@pytest.fixture(scope="module")
def v2():
    """The wrapper of the design before the bf16 redesign of kernels C and
    C', imported as a module of the package (its relative imports resolve
    there)."""
    name = "text2nerf_tpu_torch.ops.kernels._cp_features_v2"
    spec = importlib.util.spec_from_file_location(
        name, REPO / "tools" / "kernel_baselines" / "cp_features_v2.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _xn(n=777, seed=0):
    xn = np.random.default_rng(seed).uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    xn[:6] = [[-1, -1, -1], [1, 1, 1], [1, -1, 0], [0, 1, -1], [-1, 0, 1], [0, 0, 0]]
    return xn


def _lines(field):
    return tuple(t.detach() for t in field.lines)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", MODES)
def test_plain_app_raw_dtype_and_bits_against_the_design_before(params, v2, mode, dtype):
    sig, app = MODES[mode]
    tdt = BF if dtype == "bf16" else None
    lines = _lines(_field(params))
    xn = torch.from_numpy(_xn())
    got = cpk.cp_features_plain(xn, lines, ND, sigma=sig, app=app, dtype=tdt)
    old = v2.cp_features_plain(xn, lines, ND, sigma=sig, app=app, dtype=tdt)
    if sig:
        assert got[0].dtype == torch.float32 and torch.equal(got[0], old[0])
    if app:
        assert got[1].dtype == (BF if tdt else torch.float32)
        assert old[1].dtype == torch.float32
        assert torch.equal(got[1].float(), old[1])
    assert (got[0] is None) != sig and (got[1] is None) != app


@pytest.mark.parametrize("mode", MODES)
def test_plain_bf16_equals_eager_jax_before_the_basis(params, mode):
    sig, app = MODES[mode]
    xn = _xn()
    eye = jnp.eye(NA, dtype=jnp.float32)
    if mode == "fused":
        packed = dict(tf.pack_params_fused(CFG, params), basis=eye)
        want = tf.compute_fused_features_packed(CFG, packed, jnp.asarray(xn), dtype=jnp.bfloat16)
    elif mode == "density":
        want = (tf.compute_density_feature_packed(CFG, tf.pack_params(CFG, params),
                                                  jnp.asarray(xn), dtype=jnp.bfloat16), None)
    else:
        packed = dict(tf.pack_params(CFG, params), basis=eye)
        want = (None, tf.compute_app_feature_packed(CFG, packed, jnp.asarray(xn),
                                                    dtype=jnp.bfloat16))
    got = cpk.cp_features(torch.from_numpy(xn), _lines(_field(params)), ND, sigma=sig, app=app,
                          dtype=BF)
    if sig:
        assert got[0].dtype == torch.float32
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    if app:
        assert got[1].dtype == BF
        np.testing.assert_array_equal(got[1].float().numpy(), np.asarray(want[1]))
    assert float(np.abs(np.asarray(want[0 if sig else 1])).max()) > 0.1


@pytest.mark.parametrize("mode", ["fused", "app"])
def test_plain_backward_bf16_same_lines_from_bf16_or_fp32_d_app(params, mode):
    lines = _lines(_field(params))
    n = 600
    xn = torch.from_numpy(_xn(n, seed=4))
    rng = np.random.default_rng(5)
    d_sig = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    d_app = torch.from_numpy(rng.standard_normal((n, NA)).astype(np.float32)).to(BF)
    ds = d_sig if mode == "fused" else None
    from_bf = cpk.cp_features_backward(xn, lines, ND, ds, d_app, dtype=BF)
    from_fp = cpk.cp_features_backward(xn, lines, ND, ds, d_app.float(), dtype=BF)
    plain = cpk.cp_features_backward_plain(xn, lines, ND, ds, d_app, BF)
    for a, b, c in zip(from_bf, from_fp, plain):
        assert a.dtype == torch.float32 and torch.equal(a, b) and torch.equal(a, c)
    assert all(float(t.abs().max()) > 0 for t in from_bf)
    with pytest.raises(ValueError, match="d_app_raw"):
        cpk.cp_features_backward(xn, lines, ND, ds, d_app)


def _grads_through(fn_apply, field, xn, mode, tdt, d_sig, d_out):
    """Line gradients of d_sig·sigma + d_out·(app_raw @ basis) in the basis
    product's compute type (TensoRF._basis' arithmetic)."""
    sig, app = MODES[mode]
    for t in field.lines:
        t.grad = None
    s, a = fn_apply(xn, ND, sig, app, tdt, *field.lines)
    loss = 0.0
    if sig:
        loss = loss + (s * d_sig).sum()
    if app:
        basis = field.basis.detach()
        out = a @ basis if tdt is None else (a.to(tdt) @ basis.to(tdt)).float()
        loss = loss + (out * d_out).sum()
    loss.backward()
    return [t.grad.clone() for t in field.lines], (None if a is None else a.dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", MODES)
def test_cp_features_function_gradients_as_the_design_before(params, v2, mode, dtype):
    tdt = BF if dtype == "bf16" else None
    n = 500
    xn = torch.from_numpy(_xn(n, seed=7))
    rng = np.random.default_rng(8)
    d_sig = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    d_out = torch.from_numpy(rng.standard_normal((n, CFG.app_dim)).astype(np.float32))
    field = _field(params)
    got, app_dtype = _grads_through(cpk.CPFeatures.apply, field, xn, mode, tdt, d_sig, d_out)
    want, _ = _grads_through(v2.CPFeatures.apply, field, xn, mode, tdt, d_sig, d_out)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert all(float(g.abs().max()) > 0 for g in got)
    if MODES[mode][1]:
        assert app_dtype == (BF if tdt else torch.float32)


@pytest.mark.parametrize("mode", ["fused", "app"])
def test_bf16_app_raw_and_its_gradient_travel_as_bf16(params, mode, monkeypatch):
    field = _field(params)
    seen = []
    backward = cpk.cp_features_backward

    def spy(xn, lines, nd, d_sigma=None, d_app_raw=None, **kw):
        seen.append((d_app_raw.dtype, kw.get("dtype")))
        return backward(xn, lines, nd, d_sigma, d_app_raw, **kw)

    monkeypatch.setattr(cpk, "cp_features_backward", spy)
    xn = torch.from_numpy(_xn(300, seed=9))
    sig, app = MODES[mode]
    s, app_raw = field._factors(xn, sig, app, BF)
    assert app_raw.dtype == BF and (s is None) != sig
    feats = field._basis(app_raw, BF)
    assert feats.dtype == torch.float32
    (feats.sum() + (s.sum() if sig else 0.0)).backward()
    assert seen == [(BF, BF)]
    assert all(t.grad.dtype == torch.float32 for t in field.lines)


def test_basis_gives_cp_app_raw_the_same_output_without_a_cast(params, monkeypatch):
    field = _field(params).requires_grad_(False)
    xn = torch.from_numpy(_xn(257, seed=2))
    _, app_raw = field._factors(xn, False, True, BF)
    assert app_raw.dtype == BF
    casts = []
    to = torch.Tensor.to

    def spy(self, *args, **kw):
        if self is app_raw:
            casts.append(args)
        return to(self, *args, **kw)

    monkeypatch.setattr(torch.Tensor, "to", spy)
    got = field._basis(app_raw, BF)
    assert casts == []
    held = field._basis(app_raw.float(), BF)
    monkeypatch.undo()
    assert got.dtype == torch.float32 and torch.equal(got, held)
    assert torch.equal(got, field.app_feature(xn, BF))
