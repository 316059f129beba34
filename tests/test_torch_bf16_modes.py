"""The bf16 modes of kernels A and A' on the CPU, where each wrapper runs
its plain version.  In bf16 kernel A returns ``app_raw`` as bf16 and
kernel A' takes a bf16 ``d_app_raw``; both read the tables' bf16 copy.
Held here, every comparison exact (tolerance 0) unless stated:

- plain A in bf16, in fused, density and app modes: ``app_raw`` is bf16
  and, cast to fp32, equals the fp32-held ``app_raw`` of the design
  before (``tools/kernel_baselines/factor_features_v1.py``) bit for bit;
  ``sigma_feat`` stays fp32 and equal; and both equal JAX's eager
  ``compute_*_feature_packed(..., dtype=jnp.bfloat16)`` with an identity
  basis, which hands ``app_raw``'s values through the basis product
  unchanged (each output is one product by 1);
- plain A' in bf16 gives the same tables from a bf16 ``d_app_raw`` as from
  the same values in fp32, and refuses a bf16 one in fp32 mode;
- ``FactorFeatures`` gives the same table gradients as the design before,
  in both compute types, and in bf16 ``app_raw`` and its gradient travel
  as bf16;
- ``TensoRF._basis`` gives equal outputs for a bf16 ``app_raw`` and the
  same values held in fp32;
- ``bf16_tables``: one copy per table and parameter version (refreshed
  after an in-place update, an optimizer step, a ``copy_``), equal to
  ``table.to(bf16)``.

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
from text2nerf_tpu_torch.ops.kernels import factor_features as ff

torch.set_num_threads(1)

CFG = tf.TensoRFConfig(density_n_comp=(4, 5, 6), app_n_comp=(8, 7, 9))
GRID = (20, 17, 23)
BF = torch.bfloat16
MODES = {"fused": (True, True), "density": (True, False), "app": (False, True)}
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def params():
    p = tf.init_params(jax.random.PRNGKey(3), CFG, GRID)
    # features of order 0.1-0.5 (tests/test_torch_kernels.py's scaling)
    for k, scale in (("density_planes", 2.5), ("density_lines", 2.5),
                     ("app_planes", 4.0), ("app_lines", 4.0)):
        p[k] = jax.tree.map(lambda x: scale * x, p[k])
    return p


def _field(params, cfg=CFG):
    with torch.no_grad():
        return params_from_jax(_flatten(params), cfg, device="cpu")


@pytest.fixture(scope="module")
def v1():
    """The wrapper of the design before the bf16 redesign, imported as a
    module of the package (its relative imports resolve there)."""
    name = "text2nerf_tpu_torch.ops.kernels._factor_features_v1"
    spec = importlib.util.spec_from_file_location(
        name, REPO / "tools" / "kernel_baselines" / "factor_features_v1.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _xn(n=777, seed=0):
    xn = np.random.default_rng(seed).uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    xn[:6] = [[-1, -1, -1], [1, 1, 1], [1, -1, 0], [0, 1, -1], [-1, 0, 1], [0, 0, 0]]
    return xn


def _tables(field):
    return tuple(t.detach() for t in field.planes), tuple(t.detach() for t in field.lines)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", MODES)
def test_plain_app_raw_dtype_and_bits_against_the_design_before(params, v1, mode, dtype):
    sig, app = MODES[mode]
    tdt = BF if dtype == "bf16" else None
    planes, lines = _tables(_field(params))
    xn = torch.from_numpy(_xn())
    got = ff.factor_features_plain(xn, planes, lines, CFG.density_n_comp, sigma=sig, app=app,
                                   dtype=tdt)
    old = v1.factor_features_plain(xn, planes, lines, CFG.density_n_comp, sigma=sig, app=app,
                                   dtype=tdt)
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
    na = sum(CFG.app_n_comp)
    eye = jnp.eye(na, dtype=jnp.float32)
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
    planes, lines = _tables(_field(params))
    got = ff.factor_features(torch.from_numpy(xn), planes, lines, CFG.density_n_comp,
                             sigma=sig, app=app, dtype=BF)
    if sig:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    if app:
        assert got[1].dtype == BF
        np.testing.assert_array_equal(got[1].float().numpy(), np.asarray(want[1]))
    assert float(np.abs(np.asarray(want[0 if sig else 1])).max()) > 0.1


@pytest.mark.parametrize("mode", ["fused", "app"])
def test_plain_backward_bf16_same_tables_from_bf16_or_fp32_d_app(params, mode):
    planes, lines = _tables(_field(params))
    n = 600
    xn = torch.from_numpy(_xn(n, seed=4))
    rng = np.random.default_rng(5)
    d_sig = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    d_app = torch.from_numpy(rng.standard_normal((n, sum(CFG.app_n_comp))).astype(np.float32))
    d_app = d_app.to(BF)
    ds = d_sig if mode == "fused" else None
    nd = CFG.density_n_comp
    from_bf = ff.factor_features_backward(xn, planes, lines, nd, ds, d_app, dtype=BF)
    from_fp = ff.factor_features_backward(xn, planes, lines, nd, ds, d_app.float(), dtype=BF)
    plain = ff.factor_features_backward_plain(xn, planes, lines, nd, ds, d_app, BF)
    for a, b, c in zip((*from_bf[0], *from_bf[1]), (*from_fp[0], *from_fp[1]),
                       (*plain[0], *plain[1])):
        assert a.dtype == torch.float32 and torch.equal(a, b) and torch.equal(a, c)
    assert any(float(t.abs().max()) > 0 for t in from_bf[0])
    with pytest.raises(ValueError, match="d_app_raw"):
        ff.factor_features_backward(xn, planes, lines, nd, ds, d_app)


def _grads_through(fn_apply, field, xn, mode, tdt, d_sig, d_out):
    """Table gradients of d_sig·sigma + d_out·(app_raw @ basis) in the
    basis product's compute type (TensoRF._basis' arithmetic)."""
    sig, app = MODES[mode]
    tables = (*field.planes, *field.lines)
    for t in tables:
        t.grad = None
    s, a = fn_apply(xn, field.nd, sig, app, tdt, *tables)
    loss = 0.0
    if sig:
        loss = loss + (s * d_sig).sum()
    if app:
        basis = field.basis.detach()
        out = a @ basis if tdt is None else (a.to(tdt) @ basis.to(tdt)).float()
        loss = loss + (out * d_out).sum()
    loss.backward()
    return [t.grad.clone() for t in tables], (None if a is None else a.dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", MODES)
def test_factor_features_function_gradients_as_the_design_before(params, v1, mode, dtype):
    tdt = BF if dtype == "bf16" else None
    n = 500
    xn = torch.from_numpy(_xn(n, seed=7))
    rng = np.random.default_rng(8)
    d_sig = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    d_out = torch.from_numpy(rng.standard_normal((n, CFG.app_dim)).astype(np.float32))
    field = _field(params)
    got, app_dtype = _grads_through(ff.FactorFeatures.apply, field, xn, mode, tdt, d_sig, d_out)
    want, _ = _grads_through(v1.FactorFeatures.apply, field, xn, mode, tdt, d_sig, d_out)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert any(float(g.abs().max()) > 0 for g in got)
    if MODES[mode][1]:
        assert app_dtype == (BF if tdt else torch.float32)


@pytest.mark.parametrize("mode", ["fused", "app"])
def test_bf16_app_raw_and_its_gradient_travel_as_bf16(params, mode, monkeypatch):
    field = _field(params)
    seen = []
    backward = ff.factor_features_backward

    def spy(xn, planes, lines, nd, d_sigma=None, d_app_raw=None, **kw):
        seen.append((d_app_raw.dtype, kw.get("dtype")))
        return backward(xn, planes, lines, nd, d_sigma, d_app_raw, **kw)

    monkeypatch.setattr(ff, "factor_features_backward", spy)
    xn = torch.from_numpy(_xn(300, seed=9))
    sig, app = MODES[mode]
    s, app_raw = field._factors(xn, sig, app, BF)
    assert app_raw.dtype == BF and (s is None) != sig
    feats = field._basis(app_raw, BF)
    assert feats.dtype == torch.float32
    (feats.sum() + (s.sum() if sig else 0.0)).backward()
    assert seen == [(BF, BF)]
    assert field.planes[0].grad.dtype == torch.float32


@pytest.mark.parametrize("model", ["vm_split", "vm"])
def test_basis_equal_for_bf16_and_fp32_held_app_raw(model):
    cfg = tf.TensoRFConfig(model_name=model, density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8),
                           app_dim=12)
    from text2nerf_tpu_torch.models import tensorf as ptf

    field = ptf.init_params(cfg, (12, 10, 14), generator=torch.Generator().manual_seed(1),
                            device="cpu")
    rng = np.random.default_rng(2)
    app_raw = torch.from_numpy(rng.standard_normal((257, 24)).astype(np.float32)).to(BF)
    with torch.no_grad():
        got = field._basis(app_raw, BF)
        held = field._basis(app_raw.float(), BF)
    assert got.dtype == torch.float32 and torch.equal(got, held)


def _update_adam(t):
    opt = torch.optim.Adam([t], lr=1e-2)
    t.grad = torch.ones_like(t)
    opt.step()


UPDATES = {
    "add_": lambda t: t.add_(0.25),
    "adam step": _update_adam,
    "copy_": lambda t: t.copy_(torch.full_like(t, 0.5)),
    "mul_ of a view": lambda t: t[..., :1].mul_(3.0),
}


@pytest.mark.parametrize("update", UPDATES)
def test_bf16_tables_one_copy_per_parameter_version(update):
    g = torch.Generator().manual_seed(3)
    tables = (torch.nn.Parameter(torch.randn(6, 5, 4, generator=g)),
              torch.nn.Parameter(torch.randn(7, 4, generator=g)))
    before = ff.BF16_COPIES
    first = ff.bf16_tables(tables)
    again = ff.bf16_tables(tables)
    assert all(a is b for a, b in zip(first, again)) and ff.BF16_COPIES == before + 2
    for t, c in zip(tables, first):
        assert c.dtype == BF and c.is_contiguous() and torch.equal(c, t.detach().to(BF))
    with torch.no_grad():
        UPDATES[update](tables[0])
    after = ff.bf16_tables(tables)
    assert after[0] is not first[0] and after[1] is first[1]
    assert torch.equal(after[0], tables[0].detach().to(BF))
    assert ff.BF16_COPIES == before + 3
