"""The CUDA kernels against their plain versions, on the card, and the
train step, the metrics and the pools of a resume on the card against the
CPU.  Kernel A' also on adversarial
inputs: a run inside one cell, every upper edge, runs that cross rays, a
ragged n, zero gradients, accumulation, and both of its routes, in fp32
and bf16 (kernels A and A' in bf16 on the tables' bf16 copy, with bf16
app_raw and d_app_raw); kernels C and C' (TensorCP) at the published, odd
and 1-component widths, both compute types, both of C''s routes (in bf16
on the lines' bf16 copy with bf16 app_raw and d_app_raw, C bit for bit,
on the packed walks, the one-channel ones and the generic route); the
eval prepass kernel against the plain select, element for element, at K
16 to n_samples, n_samples 259, 433 and under 32, occupancy stride 1 and 2,
with and without a ladder, and the compacted renders through either
route, with no host sync or copy inside a warm chunk's select or
composite; kernel B's view-dependent mode (the eval ``MLP_Fea`` head) at
TensoRF's CP head and other widths, 1 to 64 rows a ray, and a TensorCP
frame through it against the plain head.

These skip without an NVIDIA GPU.  The module imports no JAX, so on a
machine with a card and no JAX it runs with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from text2nerf_tpu_torch.engine.checkpoints import params_from_jax, params_to_jax
from text2nerf_tpu_torch.models import tensorf as ptf
from text2nerf_tpu_torch.ops import rays as PR
from text2nerf_tpu_torch.ops import render as PRd
from text2nerf_tpu_torch.ops.kernels import cp_features as cpk
from text2nerf_tpu_torch.ops.kernels import eval_prepass as ep
from text2nerf_tpu_torch.ops.kernels import factor_features as ff
from text2nerf_tpu_torch.ops.kernels import shading_mlp as sm
from test_torch_eval_prepass import (K_CASES, LADDER, assert_same_select, prepass_scene,
                                     select_kwargs)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _field(cfg, reso, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return ptf.init_params(cfg, reso, generator=gen, device=device).requires_grad_(False)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("widths", [((4, 5, 6), (8, 7, 9)), ((16, 16, 16), (48, 48, 48))])
def test_factor_features_kernel_matches_plain(cuda, widths, dtype):
    cfg = ptf.TensoRFConfig(density_n_comp=widths[0], app_n_comp=widths[1])
    field = _field(cfg, (21, 17, 30), cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    xn = torch.rand(5001, 3, generator=gen, device=cuda) * 2 - 1
    xn[:4] = torch.tensor([[-1.0, -1, -1], [1, 1, 1], [1, -1, 0], [0, 0, 0]])
    tdt = torch.bfloat16 if dtype == "bf16" else None
    planes, lines = tuple(field.planes), tuple(field.lines)
    for sig, app in ((True, True), (True, False), (False, True)):
        before = ff.LAUNCHES
        got = ff.factor_features(xn, planes, lines, field.nd, sigma=sig, app=app, dtype=tdt)
        assert ff.LAUNCHES == before + 1
        ref = ff.factor_features_plain(xn, planes, lines, field.nd, sigma=sig, app=app,
                                       dtype=tdt)
        # the same operations in the same order, the density sums exact:
        # bit for bit equal in both compute types (app_raw bf16 in bf16)
        for g, r in zip(got, ref):
            assert (g is None) == (r is None)
            if r is not None:
                assert g.shape == r.shape and g.dtype == r.dtype
                assert torch.equal(g, r), float((g.float() - r.float()).abs().max())


def _ray_major(n_rays, k, reso, gen, device):
    """xn of n_rays rays, k consecutive one-voxel steps each (ray-major, as
    the renderer's compacted samples), from seeded origins and directions."""
    o = torch.rand(n_rays, 1, 3, generator=gen, device=device) * 1.6 - 0.8
    d = torch.randn(n_rays, 1, 3, generator=gen, device=device)
    d = d / d.norm(dim=-1, keepdim=True)
    steps = torch.arange(k, device=device, dtype=torch.float32)[None, :, None]
    return torch.clamp(o + d * steps * (2.0 / (reso - 1)), -1, 1).reshape(-1, 3)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("k", [1, 16, 128])
def test_factor_features_walk_matches_plain_in_any_order(cuda, k, dtype):
    # the main path's widths (64 channels per axis: the walk kernel), rays
    # of k samples, ray-major, reversed and shuffled, with a ragged tail
    cfg = ptf.TensoRFConfig()
    field = _field(cfg, (48, 40, 56), cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    xn = _ray_major(5120 // k, k, 48, gen, cuda)[:-5].contiguous()
    tdt = torch.bfloat16 if dtype == "bf16" else None
    planes, lines = tuple(field.planes), tuple(field.lines)
    orders = {"ray-major": xn, "reversed": xn.flip(0).contiguous(),
              "shuffled": xn[torch.randperm(xn.shape[0], generator=gen, device=cuda)]}
    for name, x in orders.items():
        for sig, app in ((True, True), (True, False), (False, True)):
            before = ff.LAUNCHES
            got = ff.factor_features(x, planes, lines, field.nd, sigma=sig, app=app,
                                     dtype=tdt)
            assert ff.LAUNCHES == before + 1
            ref = ff.factor_features_plain(x, planes, lines, field.nd, sigma=sig, app=app,
                                           dtype=tdt)
            for g, r in zip(got, ref):
                assert (g is None) == (r is None)
                if r is not None:
                    assert g.dtype == r.dtype
                    assert torch.equal(g, r), (name, float((g.float() - r.float()).abs().max()))


@pytest.mark.parametrize("app_dim,fea_pe", [(27, 6), (12, 2)])
@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 4097, 2 ** 20 + 3])
def test_shading_kernel_matches_plain(cuda, app_dim, fea_pe, n):
    cfg = ptf.TensoRFConfig(app_dim=app_dim, fea_pe=fea_pe)
    head = _field(cfg, (4, 4, 4), cuda).mlp
    gen = torch.Generator(device=cuda).manual_seed(2)
    feats = 2.0 * torch.randn(n, app_dim, generator=gen, device=cuda)
    before = sm.LAUNCHES
    got = sm.shade_fea_noview(head, feats, fea_pe)
    torch.cuda.synchronize()
    assert sm.LAUNCHES == before + (n > 0)
    ref = sm.shade_fea_noview_plain(head, feats, fea_pe)
    assert got.shape == (n, 3)
    if n:
        assert float((got - ref).abs().max()) <= 1e-4


def test_shading_kernel_is_fp32_faithful_at_full_width(cuda):
    # 3xTF32 keeps the full-width head within ~3e-7 of its plain version;
    # one TF32 product per term gives ~3.5e-5, which the 1e-4 above lets
    # pass: a build that dropped the lo products fails here
    cfg = ptf.TensoRFConfig()
    head = _field(cfg, (4, 4, 4), cuda).mlp
    gen = torch.Generator(device=cuda).manual_seed(2)
    feats = 2.0 * torch.randn(2 ** 20 + 3, cfg.app_dim, generator=gen, device=cuda)
    got = sm.shade_fea_noview(head, feats, cfg.fea_pe)
    ref = sm.shade_fea_noview_plain(head, feats, cfg.fea_pe)
    assert float((got - ref).abs().max()) <= 3e-6


def test_shading_kernel_past_the_fast_trig_range(cuda):
    # arguments 2^k * f beyond 105615 take sincosf instead of the
    # branch-free sine and cosine
    cfg = ptf.TensoRFConfig()
    head = _field(cfg, (4, 4, 4), cuda).mlp
    gen = torch.Generator(device=cuda).manual_seed(6)
    feats = torch.randn(3000, cfg.app_dim, generator=gen, device=cuda)
    feats[::7] *= 20000.0
    assert float((feats.abs() * 2 ** (cfg.fea_pe - 1)).max()) > 105615
    got = sm.shade_fea_noview(head, feats, cfg.fea_pe)
    ref = sm.shade_fea_noview_plain(head, feats, cfg.fea_pe)
    assert float((got - ref).abs().max()) <= 1e-4


def test_shading_weight_cache_follows_the_weights(cuda):
    cfg = ptf.TensoRFConfig()
    head = _field(cfg, (4, 4, 4), cuda).mlp
    gen = torch.Generator(device=cuda).manual_seed(4)
    feats = 2.0 * torch.randn(5000, cfg.app_dim, generator=gen, device=cuda)
    first = sm.shade_fea_noview(head, feats, cfg.fea_pe)
    with torch.no_grad():
        head["w1"].mul_(-0.5)  # in place: same storage, new version
    edited = sm.shade_fea_noview(head, feats, cfg.fea_pe)
    assert float((edited - sm.shade_fea_noview_plain(head, feats, cfg.fea_pe)).abs().max()) <= 1e-4
    assert float((edited - first).abs().max()) > 1e-2
    other = _field(cfg, (4, 4, 4), cuda, seed=9).mlp  # a second field
    got = sm.shade_fea_noview(other, feats, cfg.fea_pe)
    assert float((got - sm.shade_fea_noview_plain(other, feats, cfg.fea_pe)).abs().max()) <= 1e-4
    again = sm.shade_fea_noview(head, feats, cfg.fea_pe)
    assert torch.equal(again, edited)


#: kernel B's view mode: (app_dim, fea_pe, view_pe, k rows a ray, rays):
#: TensoRF's CP head at k 1, 32 and 64 over odd row counts, either PE off,
#: other widths, no rows
VIEW_CASES = {
    "published_k1": (27, 2, 2, 1, 4097),
    "published_k32": (27, 2, 2, 32, 33),
    "published_k64": (27, 2, 2, 64, 2 ** 14 + 1),
    "fea_pe_0": (27, 0, 2, 32, 65),
    "view_pe_0": (27, 2, 0, 64, 65),
    "narrow": (12, 1, 3, 1, 63),
    "widest": (32, 2, 2, 3, 1001),
    "no_rows": (27, 2, 2, 32, 0),
}


def _view_inputs(case, device, seed=2):
    c, fea_pe, view_pe, k, n_rays = VIEW_CASES[case]
    cfg = ptf.TensoRFConfig(model_name="cp", density_n_comp=(2,), app_n_comp=(4,), app_dim=c,
                            shading_mode="MLP_Fea", fea_pe=fea_pe, view_pe=view_pe)
    head = _field(cfg, (4, 4, 4), device).mlp
    gen = torch.Generator(device=device).manual_seed(seed)
    feats = 2.0 * torch.randn(n_rays * k, c, generator=gen, device=device)
    rays = torch.randn(n_rays, 6, generator=gen, device=device)
    rays[::3, 3:6] *= -40.0  # negative and large components
    dirs = rays[:, 3:6]  # rays 6 floats apart: the wrapper copies them
    return head, feats, dirs, k, fea_pe, view_pe


@pytest.mark.parametrize("case", list(VIEW_CASES))
def test_view_shading_kernel_matches_plain(cuda, case):
    head, feats, dirs, k, fea_pe, view_pe = _view_inputs(case, cuda)
    before = sm.MODES["view"]
    got = sm.shade_fea(head, feats, dirs, k, fea_pe, view_pe)
    torch.cuda.synchronize()
    assert sm.MODES["view"] == before + (feats.shape[0] > 0)
    ref = sm.shade_fea_plain(head, feats, dirs, k, fea_pe, view_pe)
    assert got.shape == (feats.shape[0], 3)
    if feats.shape[0]:
        assert float((got - ref).abs().max()) <= 1e-4


def test_view_shading_kernel_is_fp32_faithful_at_full_width(cuda):
    # as the noview mode: ~3e-7 from the plain head at TensoRF's CP head
    # (27 / 2 / 2 / 128), where one TF32 product per term gives ~3.5e-5
    head, feats, dirs, k, fea_pe, view_pe = _view_inputs("published_k32", cuda)
    gen = torch.Generator(device=cuda).manual_seed(7)
    feats = 2.0 * torch.randn(2 ** 20, feats.shape[1], generator=gen, device=cuda)
    dirs = torch.nn.functional.normalize(torch.randn(2 ** 15, 3, generator=gen, device=cuda))
    got = sm.shade_fea(head, feats, dirs, k, fea_pe, view_pe)
    ref = sm.shade_fea_plain(head, feats, dirs, k, fea_pe, view_pe)
    assert float((got - ref).abs().max()) <= 3e-6


def test_view_shading_kernel_past_the_fast_trig_range(cuda):
    # direction components whose 2^j multiples pass 105615 take sincosf
    head, feats, dirs, k, fea_pe, view_pe = _view_inputs("published_k1", cuda, seed=6)
    dirs = torch.nn.functional.normalize(dirs)
    dirs[::11] = torch.tensor([0.9, -0.95, 0.3], device=cuda) * 6e4
    assert float((dirs.abs() * 2 ** (view_pe - 1)).max()) > 105615
    got = sm.shade_fea(head, feats, dirs, k, fea_pe, view_pe)
    ref = sm.shade_fea_plain(head, feats, dirs, k, fea_pe, view_pe)
    assert float((got - ref).abs().max()) <= 1e-4


def _cp_shell(device, reso=(32, 32, 32)):
    """A TensorCP field at TensoRF's head (27 / 2 / 2) whose density is a
    far-wall slab: density line 0 (world z) +2 in z (2.5, 4), -2 elsewhere,
    the other density lines |init| + 1."""
    cfg = ptf.TensoRFConfig(model_name="cp", density_n_comp=(8,), app_n_comp=(24,),
                            shading_mode="MLP_Fea", fea_pe=2, view_pe=2, distance_scale=1.0)
    field = _field(cfg, reso, device)
    zs = torch.linspace(-8, 8, reso[2], device=device)
    with torch.no_grad():
        field.lines[0][:, :8] = torch.where((zs > 2.5) & (zs < 4.0), 2.0, -2.0)[:, None]
        for i in (1, 2):
            field.lines[i][:, :8] = field.lines[i][:, :8].abs() + 1.0
    return field


def test_cp_render_view_through_the_view_mode_matches_the_plain_head(cuda, monkeypatch):
    # a TensorCP frame through render_view: kernel C and the view mode
    # against the same path with the plain head, every rung of the ladder;
    # under the profiler the head makes no matrix product and no
    # per-row direction tensor
    from torch.profiler import ProfilerActivity, profile

    from text2nerf_tpu_torch.engine import renderer, tracing

    field = _cp_shell(cuda)
    aabb = torch.tensor([[-8.0] * 3, [8.0] * 3], device=cuda)
    mask, _ = ptf.update_alpha_mask(field, aabb, (24, 24, 24), pool=3, device=cuda)
    hw = (48, 40)
    intr = PR.default_intrinsics(*hw)
    dirs = PR.ray_directions(*hw, intr[:2], intr[2:], device=cuda)
    rays = torch.cat(PR.rays_from_pose(dirs, np.eye(4)), -1)
    kw = dict(n_samples=ptf.default_n_samples((32, 32, 32), 1.0), chunk=512, app_k=16,
              alpha_mask=mask, compact_k=-1, eval_z_min=2.0, feature_dtype="fp32",
              k_ladder=(8, 16, 32), device=cuda)
    monkeypatch.setattr(PRd, "_ADAPTIVE_PROBE_CACHE", {})
    renderer.render_view(field, aabb, rays, hw, **kw)  # the head's weights laid out
    views, c0 = sm.MODES["view"], cpk.LAUNCHES
    tracing.reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = renderer.render_view(field, aabb, rays, hw, **kw)
    counts = tracing.counts()
    tracing.reset_counts()
    assert sm.MODES["view"] > views and cpk.LAUNCHES > c0
    assert counts["head.view_samples"] > 0 and "head.samples" not in counts
    assert counts["cp.sigma_samples"] >= counts["cp.app_samples"] > 0
    events = prof.events()
    heads = [e.time_range for e in events if e.name == "t2n.head"]
    assert heads
    inside = [e.name for e in events if e.name.startswith("aten::") and any(
        r.start <= e.time_range.start and e.time_range.end <= r.end for r in heads)]
    for op in ("aten::mm", "aten::addmm", "aten::matmul", "aten::repeat_interleave",
               "aten::expand", "aten::cat", "aten::sin"):
        assert op not in inside, (op, sorted(set(inside)))
    with monkeypatch.context() as m:
        m.setattr(PRd, "_ADAPTIVE_PROBE_CACHE", {})
        m.setattr(PRd.shading_mlp, "shade_fea", sm.shade_fea_plain)
        want = renderer.render_view(field, aabb, rays, hw, **kw)
    assert np.abs(got[0] - want[0]).max() <= 1e-4
    assert np.array_equal(got[1], want[1])
    assert got[0].min() < 0.9  # the wall is in the frame


def test_kernels_refuse_grad_inputs(cuda):
    # the forward kernels refuse tables that need grad outside
    # FactorFeatures, which trains the field through kernel A'
    cfg = ptf.TensoRFConfig(density_n_comp=(2, 2, 2), app_n_comp=(4, 4, 4))
    field = _field(cfg, (6, 6, 6), cuda).requires_grad_(True)
    xn = torch.zeros(8, 3, device=cuda)
    with pytest.raises(RuntimeError, match="no_grad"):
        ff.factor_features(xn, tuple(field.planes), tuple(field.lines), field.nd)
    with pytest.raises(RuntimeError, match="no_grad"):
        sm.shade_fea_noview(field.mlp, torch.zeros(8, cfg.app_dim, device=cuda), cfg.fea_pe)
    before = ff.BWD_LAUNCHES
    sig, app = field.fused_features(xn)
    (sig.sum() + app.sum()).backward()
    assert ff.BWD_LAUNCHES == before + 1 and field.planes[0].grad is not None


def _edge_samples(n, gen, device):
    xn = torch.rand(n, 3, generator=gen, device=device) * 2 - 1
    if n >= 40:
        xn[:8] = torch.tensor([[1.0, 1, 1], [-1, -1, -1], [1, -1, 1], [-1, 1, -1],
                               [1, 0.3, -0.2], [0.1, 1, 0.4], [-0.6, 0.2, 1], [1, 1, -1]])
        xn[8:16, 0] = 1.0
        xn[16:24, 1] = 1.0
        xn[24:32, 2] = 1.0
    return xn


def _rel_err(got, ref):
    """Largest |got - ref| over each table's largest |ref| (0 where both
    are 0)."""
    err = 0.0
    for g, r in zip((*got[0], *got[1]), (*ref[0], *ref[1])):
        scale = float(r.abs().max())
        diff = float((g - r).abs().max())
        err = max(err, diff / scale if scale > 0 else diff)
    return err


# kernel A' against its plain version: both add fp32 terms with atomics
# in an order that changes from run to run, so they are held relative to
# each table's largest gradient
BWD_TOL = 1e-4


@pytest.mark.parametrize("widths", [((16, 16, 16), (48, 48, 48)), ((4, 4, 4), (8, 8, 8))])
@pytest.mark.parametrize("n", [0, 1, 33, 2 ** 20 + 3])
def test_factor_features_backward_kernel_matches_plain(cuda, widths, n):
    # 64-wide tables take the walk kernel, 12-wide the generic one
    cfg = ptf.TensoRFConfig(density_n_comp=widths[0], app_n_comp=widths[1])
    field = _field(cfg, (21, 17, 30), cuda)
    gen = torch.Generator(device=cuda).manual_seed(7)
    xn = _edge_samples(n, gen, cuda)
    planes, lines, nd = tuple(field.planes), tuple(field.lines), field.nd
    na = sum(widths[1])
    d_sig = torch.randn(n, generator=gen, device=cuda)
    d_app = torch.randn(n, na, generator=gen, device=cuda)
    for ds, da in ((d_sig, d_app), (d_sig, None), (None, d_app)):
        before = ff.BWD_LAUNCHES
        got = ff.factor_features_backward(xn, planes, lines, nd, ds, da)
        torch.cuda.synchronize()
        assert ff.BWD_LAUNCHES == before + (n > 0)
        ref = ff.factor_features_backward_plain(xn, planes, lines, nd, ds, da)
        for g, r in zip((*got[0], *got[1]), (*ref[0], *ref[1])):
            assert g.shape == r.shape and g.dtype == torch.float32
        assert _rel_err(got, ref) <= BWD_TOL
        if ds is None:  # app-only: the density channels get nothing
            assert all(float(g[..., :d].abs().max()) == 0 for g, d in zip(got[0], nd))


def test_factor_features_backward_kernel_accumulates(cuda):
    # gradients summed twice into one zeroed set of tables
    cfg = ptf.TensoRFConfig()
    field = _field(cfg, (48, 40, 56), cuda)
    gen = torch.Generator(device=cuda).manual_seed(8)
    xn = _ray_major(4096 // 16, 16, 48, gen, cuda).contiguous()
    planes, lines, nd = tuple(field.planes), tuple(field.lines), field.nd
    d_sig = torch.randn(xn.shape[0], generator=gen, device=cuda)
    d_app = torch.randn(xn.shape[0], 144, generator=gen, device=cuda)
    out = (tuple(torch.zeros_like(p) for p in planes), tuple(torch.zeros_like(l) for l in lines))
    for _ in range(2):
        ff.factor_features_backward(xn, planes, lines, nd, d_sig, d_app, out=out)
    ref = ff.factor_features_backward_plain(xn, planes, lines, nd, d_sig, d_app)
    twice = (tuple(2 * r for r in ref[0]), tuple(2 * r for r in ref[1]))
    assert _rel_err(out, twice) <= BWD_TOL


@pytest.mark.parametrize("widths", [((16, 16, 16), (48, 48, 48)), ((4, 5, 6), (8, 7, 9))])
@pytest.mark.parametrize("n", [1, 4099])
def test_factor_features_backward_kernel_bf16_matches_plain(cuda, widths, n):
    # the bf16 mode on both routes: the same bf16-rounded terms, fp32 sums
    # in another order
    cfg = ptf.TensoRFConfig(density_n_comp=widths[0], app_n_comp=widths[1])
    field = _field(cfg, (21, 17, 30), cuda)
    gen = torch.Generator(device=cuda).manual_seed(17)
    xn = _edge_samples(n, gen, cuda)
    planes, lines, nd = tuple(field.planes), tuple(field.lines), field.nd
    d_sig = torch.randn(n, generator=gen, device=cuda)
    d_app = torch.randn(n, sum(widths[1]), generator=gen, device=cuda)
    for ds, da in ((d_sig, d_app), (d_sig, None), (None, d_app)):
        before = ff.BWD_DTYPES["bf16"]
        got = ff.factor_features_backward(xn, planes, lines, nd, ds, da, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert ff.BWD_DTYPES["bf16"] == before + 1
        ref = ff.factor_features_backward_plain(xn, planes, lines, nd, ds, da, torch.bfloat16)
        assert _rel_err(got, ref) <= BWD_TOL


def _cp_lines(nd, na, reso, device, seed=0):
    cfg = ptf.TensoRFConfig(model_name="cp", density_n_comp=(nd,), app_n_comp=(na,))
    return tuple(_field(cfg, reso, device, seed).lines)


CP_WIDTHS = [(96, 288), (5, 13), (1, 1)]  # published, odd, 1-component


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("widths", CP_WIDTHS)
def test_cp_features_kernel_matches_plain(cuda, widths, dtype):
    nd, na = widths
    lines = _cp_lines(nd, na, (21, 17, 30), cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    xn = _edge_samples(5001, gen, cuda)
    for sig, app in ((True, True), (True, False), (False, True)):
        before = cpk.LAUNCHES
        got = cpk.cp_features(xn, lines, nd, sigma=sig, app=app, dtype=dtype)
        assert cpk.LAUNCHES == before + 1
        ref = cpk.cp_features_plain(xn, lines, nd, sigma=sig, app=app, dtype=dtype)
        for g, r in zip(got, ref):
            assert (g is None) == (r is None)
            if g is not None:
                # the same operations in the same order; the density sum
                # exact in fp64 unless its terms span more than 2^29
                assert g.shape == r.shape
                assert float((g - r).abs().max()) <= 1e-6 * float(r.abs().max())


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("widths", CP_WIDTHS)
@pytest.mark.parametrize("n", [1, 4099])
def test_cp_features_backward_kernel_matches_plain(cuda, widths, n, dtype):
    nd, na = widths
    lines = _cp_lines(nd, na, (21, 17, 30), cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    xn = _edge_samples(n, gen, cuda)
    d_sig = torch.randn(n, generator=gen, device=cuda)
    d_app = torch.randn(n, na, generator=gen, device=cuda)
    for ds, da in ((d_sig, d_app), (d_sig, None), (None, d_app)):
        before = cpk.BWD_LAUNCHES
        got = cpk.cp_features_backward(xn, lines, nd, ds, da, dtype=dtype)
        torch.cuda.synchronize()
        assert cpk.BWD_LAUNCHES == before + 1 and cpk.BWD_LAST_GRID[0] == "shared"
        ref = cpk.cp_features_backward_plain(xn, lines, nd, ds, da, dtype)
        assert _rel_err((got, ()), (ref, ())) <= BWD_TOL
        if ds is None:  # app-only: the density channels get nothing
            assert all(float(g[:, :nd].abs().max()) == 0 for g in got)


def test_cp_features_backward_generic_route_and_accumulation(cuda):
    # three 700-row lines do not fit a block's shared memory at 32 channels
    lines = _cp_lines(3, 29, (700, 700, 700), cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    xn = _edge_samples(3001, gen, cuda)
    d_sig = torch.randn(3001, generator=gen, device=cuda)
    d_app = torch.randn(3001, 29, generator=gen, device=cuda)
    out = tuple(torch.zeros_like(l) for l in lines)
    for _ in range(2):
        cpk.cp_features_backward(xn, lines, 3, d_sig, d_app, out=out)
    assert cpk.BWD_LAST_GRID[0] == "generic"
    ref = cpk.cp_features_backward_plain(xn, lines, 3, d_sig, d_app)
    assert _rel_err((out, ()), (tuple(2 * r for r in ref), ())) <= BWD_TOL


def _cp_step_like(layout, n_rays, k, reso, gen, device):
    """A dense step's CP samples at small size: n_rays rays of k half-voxel
    march steps, ray-major (the density-only launches), every fourth ray
    moved to start near the box's upper corner, so it runs out of the box
    and its clamped samples take the edge-clamped rows; "weight": each
    ray's samples in a random order (the app-only launches' top-weight
    order)."""
    x = _ray_major(n_rays, k, 2 * reso, gen, device).view(n_rays, k, 3)
    x[::4] = torch.clamp(x[::4] - x[::4, :1] + 0.9, -1.0, 1.0)
    if layout == "weight":
        perm = torch.argsort(torch.rand(n_rays, k, generator=gen, device=device), dim=1)
        x = torch.gather(x, 1, perm[..., None].expand(-1, -1, 3))
    return x.reshape(-1, 3).contiguous()


# kernels C and C' on step-like samples: (widths, grid, rays, steps a ray);
# 23 x 259 = 5957 samples, odd, so the last run is partial and rays and
# the warps' spans end mid-run; 3 x 700-row lines take C''s generic route
CP_STEP_CASES = {
    "published": ((96, 288), (40, 44, 48), 23, 259, "shared"),
    "odd widths": ((5, 13), (40, 44, 48), 23, 259, "shared"),
    "generic route": ((3, 29), (700, 700, 700), 9, 259, "generic"),
}


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("layout", ["ray", "weight"])
@pytest.mark.parametrize("case", list(CP_STEP_CASES))
def test_cp_kernels_on_step_like_samples(cuda, case, layout, dtype, accumulate):
    (nd, na), reso, n_rays, k, route = CP_STEP_CASES[case]
    lines = _cp_lines(nd, na, reso, cuda)
    gen = torch.Generator(device=cuda).manual_seed(7)
    xn = _cp_step_like(layout, n_rays, k, reso[0], gen, cuda)
    n = xn.shape[0]
    d_sig = torch.randn(n, generator=gen, device=cuda)
    d_app = torch.randn(n, na, generator=gen, device=cuda)
    for lo, hi in ((64, 96), (1000, 1100), (n - 37, n)):  # a whole run, a stretch, the tail
        d_sig[lo:hi] = 0.0
        d_app[lo:hi] = 0.0
    for sig, app in ((True, True), (True, False), (False, True)):
        got = cpk.cp_features(xn, lines, nd, sigma=sig, app=app, dtype=dtype)
        ref = cpk.cp_features_plain(xn, lines, nd, sigma=sig, app=app, dtype=dtype)
        for g, r in zip(got, ref):
            if r is not None:
                # the plain version's operations in its order; the density
                # sum in fp64
                assert torch.equal(g, r), float((g - r).abs().max())
        ds, da = (d_sig if sig else None), (d_app if app else None)
        ref = cpk.cp_features_backward_plain(xn, lines, nd, ds, da, dtype)
        if accumulate:
            out = tuple(0.5 * r for r in ref)
            for _ in range(2):
                cpk.cp_features_backward(xn, lines, nd, ds, da, dtype=dtype, out=out)
            ref = tuple(2.5 * r for r in ref)
        else:
            out = cpk.cp_features_backward(xn, lines, nd, ds, da, dtype=dtype)
        torch.cuda.synchronize()
        assert cpk.BWD_LAST_GRID[0] == route
        assert _rel_err((out, ()), (ref, ())) <= BWD_TOL


def test_cp_backward_kernel_with_no_gradient(cuda):
    # every gradient zero: the tables come out zero, or as they were
    lines = _cp_lines(96, 288, (40, 44, 48), cuda)
    gen = torch.Generator(device=cuda).manual_seed(8)
    xn = _cp_step_like("ray", 23, 259, 40, gen, cuda)
    zero_sig = torch.zeros(xn.shape[0], device=cuda)
    zero_app = torch.zeros(xn.shape[0], 288, device=cuda)
    for ds, da in ((zero_sig, zero_app), (zero_sig, None), (None, zero_app)):
        got = cpk.cp_features_backward(xn, lines, 96, ds, da)
        assert all(not g.any() for g in got)
        out = tuple(torch.ones_like(l) for l in lines)
        cpk.cp_features_backward(xn, lines, 96, ds, da, out=out)
        assert all(bool((t == 1).all()) for t in out)


def test_cp_field_trains_through_kernels_c(cuda):
    # the field's features with a gradient: kernel C forward, C' backward
    cfg = ptf.TensoRFConfig(model_name="cp", density_n_comp=(8,), app_n_comp=(24,),
                            shading_mode="MLP_Fea", fea_pe=2)
    field = _field(cfg, (21, 17, 30), cuda).requires_grad_(True)
    gen = torch.Generator(device=cuda).manual_seed(6)
    xn = _edge_samples(777, gen, cuda)
    a0, b0 = cpk.LAUNCHES, cpk.BWD_LAUNCHES
    s, a = field.fused_features(xn)
    (s.sum() + a.square().sum()).backward()
    assert cpk.LAUNCHES == a0 + 1 and cpk.BWD_LAUNCHES == b0 + 1
    cpu = params_from_jax(params_to_jax(field), cfg, device="cpu")
    s2, a2 = cpu.fused_features(xn.cpu())
    (s2.sum() + a2.square().sum()).backward()
    for g, r in zip(field.lines, cpu.lines):
        assert float((g.grad.cpu() - r.grad).abs().max()) <= BWD_TOL * float(r.grad.abs().max())


# kernels C and C' in bf16 on their own inputs: (widths, grid, C''s route).
# 96 / 288 takes the packed walks (6 channel pairs a lane fused and app, 2
# density), 8 / 24 2 pairs a lane, 5 / 13 and 1 / 1 one channel a lane;
# 4 / 28 on 3 x 400 rows is too long for the packed C''s 64-channel slices
# and takes the one-channel walk; 3 / 29 on 3 x 700 rows the generic route
CP_BF16_CASES = {
    "published": ((96, 288), (21, 17, 30), "shared"),
    "8/24": ((8, 24), (21, 17, 30), "shared"),
    "odd widths": ((5, 13), (21, 17, 30), "shared"),
    "1-component": ((1, 1), (21, 17, 30), "shared"),
    "long lines": ((4, 28), (400, 400, 400), "shared"),
    "generic route": ((3, 29), (700, 700, 700), "generic"),
}


@pytest.mark.parametrize("case", list(CP_BF16_CASES))
def test_cp_features_kernel_bf16_bit_equal_with_bf16_app_raw(cuda, case):
    (nd, na), reso, _ = CP_BF16_CASES[case]
    lines = _cp_lines(nd, na, reso, cuda)
    gen = torch.Generator(device=cuda).manual_seed(23)
    xn = torch.cat([_edge_samples(2001, gen, cuda),
                    _cp_step_like("ray", 13, 259, reso[0], gen, cuda)]).contiguous()
    bf = torch.bfloat16
    for sig, app in ((True, True), (True, False), (False, True)):
        before = cpk.DTYPES["bf16"]
        got = cpk.cp_features(xn, lines, nd, sigma=sig, app=app, dtype=bf)
        assert cpk.DTYPES["bf16"] == before + 1
        ref = cpk.cp_features_plain(xn, lines, nd, sigma=sig, app=app, dtype=bf)
        if app:
            assert got[1].dtype == bf and ref[1].dtype == bf
        if sig:
            assert got[0].dtype == torch.float32
        for g, r in zip(got, ref):
            if r is not None:
                assert torch.equal(g, r), float((g.float() - r.float()).abs().max())


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("case", list(CP_BF16_CASES))
def test_cp_features_backward_kernel_bf16_from_bf16_d_app(cuda, case, accumulate):
    (nd, na), reso, route = CP_BF16_CASES[case]
    lines = _cp_lines(nd, na, reso, cuda)
    gen = torch.Generator(device=cuda).manual_seed(24)
    xn = _cp_step_like("weight", 17, 259, reso[0], gen, cuda)
    n = xn.shape[0]
    bf = torch.bfloat16
    d_sig = torch.randn(n, generator=gen, device=cuda)
    d_app = torch.randn(n, na, generator=gen, device=cuda).to(bf)
    d_sig[64:96] = 0.0  # a whole run with no gradient
    d_app[64:96] = 0.0
    for ds, da in ((d_sig, d_app), (d_sig, None), (None, d_app)):
        ref = cpk.cp_features_backward_plain(xn, lines, nd, ds, da, bf)
        for d_in in ((da,) if da is None else (da, da.float())):
            before = cpk.BWD_DTYPES["bf16"]
            if accumulate:
                got = tuple(0.5 * r for r in ref)
                for _ in range(2):
                    cpk.cp_features_backward(xn, lines, nd, ds, d_in, dtype=bf, out=got)
                want = tuple(2.5 * r for r in ref)
            else:
                got, want = cpk.cp_features_backward(xn, lines, nd, ds, d_in, dtype=bf), ref
            torch.cuda.synchronize()
            assert cpk.BWD_DTYPES["bf16"] == before + 1 + accumulate
            assert cpk.BWD_LAST_GRID[0] == route
            assert _rel_err((got, ()), (want, ())) <= BWD_TOL
            if ds is None:  # app-only: the density channels get nothing
                assert all(float((g[:, :nd] - w[:, :nd]).abs().max()) == 0
                           for g, w in zip(got, want))


def test_cp_bf16_train_path_copies_the_lines_once_per_version(cuda):
    # CPFeatures in bf16 on the card: kernel C's app_raw and the gradient
    # autograd hands kernel C' are bf16, the two kernels (a density and an
    # app launch each) share one bf16 copy of each line, and an optimizer
    # step makes the next copy
    cfg = ptf.TensoRFConfig(model_name="cp", density_n_comp=(96,), app_n_comp=(288,),
                            shading_mode="MLP_Fea", fea_pe=2)
    field = _field(cfg, (48, 40, 56), cuda).requires_grad_(True)
    opt = torch.optim.Adam(field.parameters(), lr=1e-3)
    gen = torch.Generator(device=cuda).manual_seed(25)
    xn = _ray_major(256, 16, 48, gen, cuda).contiguous()
    seen = []
    launch = cpk._launch_backward

    def spy(xn_, lines, nd, d_sigma, d_app_raw, bf16, out):
        seen.append((None if d_app_raw is None else d_app_raw.dtype, bf16))
        return launch(xn_, lines, nd, d_sigma, d_app_raw, bf16, out)

    cpk._launch_backward = spy
    try:
        for _ in range(2):
            copies = ff.BF16_COPIES
            sigma = field.density_feature(xn, torch.bfloat16)
            app = field.app_feature(xn[::2].contiguous(), torch.bfloat16)
            (sigma.sum() + app.square().sum()).backward()
            torch.cuda.synchronize()
            assert ff.BF16_COPIES == copies + 3
            opt.step()
            opt.zero_grad()
    finally:
        cpk._launch_backward = launch
    assert sorted(seen, key=str) == sorted([(None, True), (torch.bfloat16, True)] * 2, key=str)


def _bwd_case(case, gen, device):
    """(field widths, grid, xn, zero-gradient mask or None, route) of an
    adversarial kernel A' input."""
    wide = ((16, 16, 16), (48, 48, 48))
    if case == "one_cell":  # a run of 64 samples inside one cell of every table
        xn = 0.1 + 1e-3 * torch.rand(64, 3, generator=gen, device=device)
        return wide, (48, 40, 56), xn, None, "shared"
    if case == "upper_edges":  # coincident corner and line rows, a run on the corner
        xn = _edge_samples(4096, gen, device)
        xn[200:264] = 1.0
        return wide, (48, 40, 56), xn, None, "shared"
    if case == "runs_cross_rays":  # rays of 5 samples, n = 32 * 156 + 20
        return wide, (48, 40, 56), _ray_major(1000, 5, 48, gen, device), None, "shared"
    if case == "zero_gradients":  # whole samples, and three whole runs
        xn = _ray_major(128, 64, 48, gen, device)
        zero = torch.rand(xn.shape[0], generator=gen, device=device) < 0.4
        zero[2048:2048 + 96] = True
        return wide, (48, 40, 56), xn, zero, "shared"
    if case == "long_line":  # a line of 1000 x 64 fp32 is more than a block's shared memory
        return wide, (24, 20, 1000), _ray_major(64, 64, 1000, gen, device), None, "generic"
    assert case == "generic_route"  # 12-wide tables
    return ((4, 4, 4), (8, 8, 8)), (21, 17, 30), _ray_major(64, 40, 30, gen, device), None, \
        "generic"


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("case", ["one_cell", "upper_edges", "runs_cross_rays",
                                  "zero_gradients", "long_line", "generic_route"])
def test_factor_features_backward_kernel_adversarial(cuda, case, accumulate):
    gen = torch.Generator(device=cuda).manual_seed(9)
    widths, reso, xn, zero, route = _bwd_case(case, gen, cuda)
    cfg = ptf.TensoRFConfig(density_n_comp=widths[0], app_n_comp=widths[1])
    field = _field(cfg, reso, cuda)
    planes, lines, nd = tuple(field.planes), tuple(field.lines), field.nd
    xn = xn.contiguous()
    n = xn.shape[0]
    d_sig = torch.randn(n, generator=gen, device=cuda)
    d_app = torch.randn(n, sum(widths[1]), generator=gen, device=cuda)
    if zero is not None:
        d_sig[zero] = 0.0
        d_app[zero] = 0.0
        d_app[~zero & (torch.arange(n, device=cuda) % 3 == 0), 48:96] = 0.0  # axis 1 only
    for ds, da in ((d_sig, d_app), (d_sig, None), (None, d_app)):
        ref = ff.factor_features_backward_plain(xn, planes, lines, nd, ds, da)
        if accumulate:
            base = tuple(tuple(0.5 * t for t in part) for part in ref)
            got = tuple(tuple(t.clone() for t in part) for part in base)
            for _ in range(2):
                ff.factor_features_backward(xn, planes, lines, nd, ds, da, out=got)
            ref = tuple(tuple(b + 2 * r for b, r in zip(bp, rp)) for bp, rp in zip(base, ref))
        else:
            got = ff.factor_features_backward(xn, planes, lines, nd, ds, da)
        torch.cuda.synchronize()
        assert ff.BWD_LAST_GRID[0] == route
        assert _rel_err(got, ref) <= BWD_TOL
        for g, r in zip((*got[0], *got[1]), (*ref[0], *ref[1])):
            if float(r.abs().max()) == 0:  # no gradient: exactly none
                assert float(g.abs().max()) == 0


@pytest.mark.parametrize("case", ["one_cell", "upper_edges", "runs_cross_rays",
                                  "zero_gradients", "long_line", "generic_route"])
def test_factor_features_bf16_kernels_with_bf16_io(cuda, case):
    # the bf16 modes on their own inputs: kernel A reads the tables' bf16
    # copy and returns a bf16 app_raw, bit for bit its plain version's;
    # kernel A' takes a bf16 d_app_raw (or fp32, rounded by the wrapper)
    # on the route the case asks for, within BWD_TOL of its plain version
    gen = torch.Generator(device=cuda).manual_seed(19)
    widths, reso, xn, zero, route = _bwd_case(case, gen, cuda)
    cfg = ptf.TensoRFConfig(density_n_comp=widths[0], app_n_comp=widths[1])
    field = _field(cfg, reso, cuda)
    planes, lines, nd = tuple(field.planes), tuple(field.lines), field.nd
    xn = xn.contiguous()
    n = xn.shape[0]
    bf = torch.bfloat16
    for sig, app in ((True, True), (True, False), (False, True)):
        before = ff.DTYPES["bf16"]
        got = ff.factor_features(xn, planes, lines, nd, sigma=sig, app=app, dtype=bf)
        assert ff.DTYPES["bf16"] == before + 1
        ref = ff.factor_features_plain(xn, planes, lines, nd, sigma=sig, app=app, dtype=bf)
        if app:
            assert got[1].dtype == bf and ref[1].dtype == bf
        for g, r in zip(got, ref):
            if r is not None:
                assert torch.equal(g, r), float((g.float() - r.float()).abs().max())
    d_sig = torch.randn(n, generator=gen, device=cuda)
    d_app = torch.randn(n, sum(widths[1]), generator=gen, device=cuda).to(bf)
    if zero is not None:
        d_sig[zero] = 0.0
        d_app[zero] = 0.0
    for ds, da in ((d_sig, d_app), (d_sig, None), (None, d_app)):
        ref = ff.factor_features_backward_plain(xn, planes, lines, nd, ds, da, bf)
        for d_in in ((da,) if da is None else (da, da.float())):
            before = ff.BWD_DTYPES["bf16"]
            got = ff.factor_features_backward(xn, planes, lines, nd, ds, d_in, dtype=bf)
            torch.cuda.synchronize()
            assert ff.BWD_DTYPES["bf16"] == before + 1 and ff.BWD_LAST_GRID[0] == route
            assert _rel_err(got, ref) <= BWD_TOL
            for g, r in zip((*got[0], *got[1]), (*ref[0], *ref[1])):
                if float(r.abs().max()) == 0:
                    assert float(g.abs().max()) == 0


def test_bf16_train_path_copies_the_tables_once_per_version(cuda):
    # FactorFeatures in bf16 on the card: kernel A's app_raw and the
    # gradient autograd hands kernel A' are bf16, the two kernels share one
    # bf16 copy of each table, and an optimizer step makes the next copy
    cfg = ptf.TensoRFConfig()
    field = _field(cfg, (48, 40, 56), cuda).requires_grad_(True)
    opt = torch.optim.Adam(field.parameters(), lr=1e-3)
    gen = torch.Generator(device=cuda).manual_seed(21)
    xn = _ray_major(256, 16, 48, gen, cuda).contiguous()
    seen = []
    launch = ff._launch_backward

    def spy(xn_, planes, lines, nd, d_sigma, d_app_raw, bf16, out):
        seen.append((d_app_raw.dtype, bf16))
        return launch(xn_, planes, lines, nd, d_sigma, d_app_raw, bf16, out)

    ff._launch_backward = spy
    try:
        for _ in range(2):
            copies = ff.BF16_COPIES
            sigma, app = field.fused_features(xn, torch.bfloat16)
            (sigma.sum() + app.square().sum()).backward()
            torch.cuda.synchronize()
            assert ff.BF16_COPIES == copies + 6
            opt.step()
            opt.zero_grad()
    finally:
        ff._launch_backward = launch
    assert seen == [(torch.bfloat16, True)] * 2


def test_train_step_on_the_card_matches_the_cpu(cuda):
    # the compacted and the dense train step at tiny size, kernels A and A'
    # on the card against the plain versions on the CPU, same jitter
    from text2nerf_tpu_torch.engine import checkpoints as PC
    from text2nerf_tpu_torch.engine import train_step as PTS

    cfg = ptf.TensoRFConfig(density_n_comp=(16, 16, 16), app_n_comp=(48, 48, 48))
    field = _field(cfg, (32, 32, 32), cuda)
    with torch.no_grad():
        zs = torch.linspace(-8, 8, 32, device=cuda)
        field.lines[0][:, :16] = torch.where((zs > 3) & (zs < 5), 2.0, -2.0)[:, None]
        field.planes[0][..., :16] = field.planes[0][..., :16].abs() + 1.0
    field_cpu = params_from_jax(params_to_jax(field), cfg, device="cpu")
    aabb = torch.tensor([[-8.0] * 3, [8.0] * 3])
    mask, _ = ptf.update_alpha_mask(field, aabb, (16, 16, 16), pool=5, device=cuda)
    mask_cpu, _ = ptf.update_alpha_mask(field_cpu, aabb, (16, 16, 16), pool=5, device="cpu")
    dirs = PR.ray_directions(16, 16, (16.0, 16.0), device="cpu")
    rays = torch.cat(PR.rays_from_pose(dirs, np.eye(4)), -1)
    gen = torch.Generator().manual_seed(1)
    batch = {"rays": rays, "rgb": torch.rand(256, 3, generator=gen),
             "depth": torch.full((256,), 4.0)}
    jitter = torch.rand(256, 1, generator=gen)
    kw = dict(n_samples=48, app_k=16, compact_k=16, density_group=2, density_block=3,
              depth_cap_band=6, microbatch=4)
    for masked in (True, False):
        grads, metrics = [], []
        for f, m, d in ((field, mask, cuda), (field_cpu.requires_grad_(True), mask_cpu, "cpu")):
            state, opt = PTS.make_train_state(f, runtime_decay=True)
            step = PTS.make_train_step(cfg, opt, device=d, runtime_decay=True, **kw)
            a0, b0 = ff.LAUNCHES, ff.BWD_LAUNCHES
            _, met = step(state, aabb, batch, alpha_mask=m if masked else None, jitter=jitter)
            if d == cuda:
                assert ff.LAUNCHES > a0 and ff.BWD_LAUNCHES > b0
            metrics.append({k: float(v) for k, v in met.items()})
            grads.append(PC.grads_to_jax(f))
        for k in metrics[1]:
            assert abs(metrics[0][k] - metrics[1][k]) <= 1e-5 * abs(metrics[1][k]), k
        for k, want in grads[1].items():
            scale = float(np.abs(want).max())
            assert float(np.abs(grads[0][k] - want).max()) <= 1e-4 * scale + 1e-12, k
        assert metrics[1]["mse"] > 0


def test_adaptive_render_on_the_card_matches_the_cpu(cuda):
    cfg = ptf.TensoRFConfig(density_n_comp=(8, 8, 8), app_n_comp=(16, 16, 16),
                            distance_scale=0.02)
    field = _field(cfg, (24, 24, 24), cuda)
    with torch.no_grad():
        for i in range(3):
            d = field.nd[i]
            field.planes[i][..., :d] = field.planes[i][..., :d].abs() + 1.0
            field.lines[i][..., :d] = field.lines[i][..., :d].abs() + 1.0
    field_cpu = params_from_jax(params_to_jax(field), cfg, device="cpu").requires_grad_(False)
    aabb = torch.tensor([[-8.0] * 3, [8.0] * 3])
    mask, _ = ptf.update_alpha_mask(field, aabb, (16, 16, 16), pool=5, device=cuda)
    mask_cpu, _ = ptf.update_alpha_mask(field_cpu, aabb, (16, 16, 16), pool=5, device="cpu")
    assert torch.equal(mask["volume"].cpu(), mask_cpu["volume"])
    h = w = 24
    intr = PR.default_intrinsics(h, w)
    dirs = PR.ray_directions(h, w, intr[:2], intr[2:], device="cpu")
    rays = torch.cat(PR.rays_from_pose(dirs, np.eye(4)), -1)
    kw = dict(n_samples=ptf.default_n_samples((24, 24, 24), 1.0), chunk=256, app_k=16,
              k_ladder=(4, 8, 16), feature_dtype="fp32", probe=False)
    a0, b0 = ff.LAUNCHES, sm.LAUNCHES
    got, ks = PRd.render_chunked_adaptive(field, aabb, rays, mask, device=cuda, **kw)
    assert ff.LAUNCHES > a0 and sm.LAUNCHES > b0
    want, ks_cpu = PRd.render_chunked_adaptive(field_cpu, aabb, rays, mask_cpu, device="cpu",
                                               **kw)
    assert ks == ks_cpu and max(ks) > 4
    for name in ("rgb", "depth", "acc"):
        assert float((getattr(got, name).cpu() - getattr(want, name)).abs().max()) <= 1e-4


def test_cuda_calls_never_reach_the_plain_versions(cuda, monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("a CUDA call reached a plain version")

    monkeypatch.setattr(ff, "factor_features_plain", boom)
    monkeypatch.setattr(ff, "factor_features_backward_plain", boom)
    monkeypatch.setattr(sm, "shade_fea_noview_plain", boom)
    monkeypatch.setattr(PRd, "_select_plain", boom)
    cfg = ptf.TensoRFConfig(density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8))
    field = _field(cfg, (16, 16, 16), cuda)
    aabb = torch.tensor([[-8.0] * 3, [8.0] * 3])
    mask, _ = ptf.update_alpha_mask(field, aabb, (12, 12, 12), pool=3, device=cuda)
    dirs = PR.ray_directions(16, 16, (16.0, 16.0), device=cuda)
    rays = torch.cat(PR.rays_from_pose(dirs, np.eye(4)), -1)
    for compact_k in (-1, 8, 0):  # adaptive, fixed-K compact, dense
        out = PRd.render_chunked(field, aabb, rays, n_samples=20, chunk=128, app_k=8,
                                 alpha_mask=mask, compact_k=compact_k, device=cuda)
        assert out.rgb.is_cuda and bool(torch.isfinite(out.rgb).all())
    # the train step's backward runs kernel A' and never the plain version
    from text2nerf_tpu_torch.engine import train_step as PTS

    field.requires_grad_(True)
    state, opt = PTS.make_train_state(field)
    step = PTS.make_train_step(cfg, opt, device=cuda, n_samples=20, app_k=8, compact_k=8)
    before = ff.BWD_LAUNCHES
    batch = {"rays": rays, "rgb": torch.rand(rays.shape[0], 3, device=cuda),
             "depth": torch.full((rays.shape[0],), 4.0, device=cuda)}
    for m in (mask, None):
        _, metrics = step(state, aabb, batch, alpha_mask=m)
        assert bool(torch.isfinite(metrics["mse"]))
    assert ff.BWD_LAUNCHES >= before + 3  # compacted (fused), dense (density, app)


def test_native_bilateral_filter_builds_and_runs(cuda):
    # the seed fit's host filter, built with g++ from the port's own copy
    # of its source into the package's build directory
    from pathlib import Path

    from text2nerf_tpu_torch import native
    from text2nerf_tpu_torch.ops import filters
    from text2nerf_tpu_torch.ops.kernels import _build

    pkg = Path(filters.__file__).resolve().parents[1]
    assert native.SOURCE.parent == pkg / "native"
    rng = np.random.default_rng(0)
    depth = (2.0 + 0.01 * rng.random((48, 40))).astype(np.float32)
    depth[10:30, 5:20] += 2.0  # a step: the filter works along its edges
    img = rng.random((48, 40, 3)).astype(np.float32)
    out_img, out_depth = filters.sparse_bilateral_filtering(depth, img)
    assert _build.hashed_path("host_ops", [native.SOURCE], native.GXX_FLAGS).exists()
    assert out_img.dtype == out_depth.dtype == np.float32
    assert out_img.shape == img.shape and out_depth.shape == depth.shape
    changed = np.abs(out_img - img).max(-1) > 0
    # the step's edges change; an interior patch far from them does not (the
    # filter replaces the border ring by its neighbours)
    assert changed[8:32, 3:22].any() and not changed[40:47, 30:39].any()
    again = filters.sparse_bilateral_filtering(depth, img)
    assert np.array_equal(again[0], out_img) and np.array_equal(again[1], out_depth)


def test_support_warp_on_the_card_matches_the_cpu(cuda):
    # index_put_(accumulate=True) adds in a run-to-run order on the card:
    # coverage masks exact, the uint8-rounded image within one level, the
    # depths within rounding
    from text2nerf_tpu_torch.data import trajectories as traj
    from text2nerf_tpu_torch.data.io import depth_process
    from text2nerf_tpu_torch.ops import splat
    from text2nerf_tpu_torch.services import fallbacks

    h = w = 64
    img = fallbacks.procedural_text2img("a card test", hw=(h, w))
    depth = depth_process(fallbacks.procedural_depth(img))
    poses = traj.local_fixed_poses(np.eye(4), angle=0.2, range_center=0.2, range_yaw=0.6,
                                   range_pitch=0.2)
    intr = PR.default_intrinsics(h, w)
    outs = []
    for dev in (cuda, "cpu"):
        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        outs.append([x.cpu() for x in splat.warp_one_to_many(t(img), t(depth), t(poses[0]),
                                                            t(poses[1:]), intr)])
    (rgb_g, m_g, d_g), (rgb_c, m_c, d_c) = outs
    assert torch.equal(m_g, m_c) and 0.3 < float(m_c.float().mean()) < 1.0
    assert float((rgb_g - rgb_c).abs().max()) <= 1.0 / 255 + 1e-6
    assert float(((d_g - d_c).abs() / d_c.abs().clamp(min=1e-6)).max()) <= 1e-5


def test_tiny_unet_on_the_card_matches_the_cpu(cuda):
    # the 9-channel tiny UNet (fp32, TF32 off) from one seeded init on both
    # devices: conv and matmul sums in other orders
    from text2nerf_tpu_torch.models import diffusion as PD

    cfg = PD.UNetConfig(**{**PD.UNetConfig.tiny().__dict__, "in_channels": 9})
    cpu = PD.materialize(lambda: PD.UNet(cfg), "cpu", torch.Generator().manual_seed(0))
    card = PD.materialize(lambda: PD.UNet(cfg), cuda)
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    args = (torch.randn(2, 9, 16, 16, generator=g), torch.tensor([10.0, 500.5]),
            torch.randn(2, 7, 64, generator=g))
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want = cpu(*args)
        got = card(*[a.to(cuda) for a in args]).cpu()
    assert got.shape == want.shape == (2, 4, 16, 16)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


def test_tiny_leres_on_the_card_matches_the_cpu(cuda):
    # the tiny LeReS (fp32, TF32 off) from one seeded init on both devices,
    # and the boosted estimate's image work (cubic resize, blur) likewise
    from text2nerf_tpu_torch.models import diffusion as PD
    from text2nerf_tpu_torch.models import leres as PL
    from text2nerf_tpu_torch.services import image_ops as IO

    make = lambda: PL.RelDepthModel(PL.LeReSConfig.tiny())  # noqa: E731
    cpu = PD.materialize(make, "cpu", torch.Generator().manual_seed(0))
    card = PD.materialize(make, cuda)
    card.load_state_dict(cpu.state_dict())
    x = torch.rand(1, 3, 96, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want = cpu(x)
        got = card(x.to(cuda)).cpu()
    assert got.shape == want.shape == (1, 96, 64)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    img = torch.rand(77, 51, 3, generator=torch.Generator().manual_seed(2))
    for hw in ((448, 448), (20, 30)):
        assert float((IO.resize(img.to(cuda), hw).cpu() - IO.resize(img, hw)).abs().max()) <= 1e-6
    blur_c = IO.gaussian_blur(img[..., 0], 13)
    blur_g = IO.gaussian_blur(img[..., 0].to(cuda), 13).cpu()
    assert float((blur_g - blur_c).abs().max()) <= 1e-6


def test_ssim_and_lpips_on_the_card_match_the_cpu(cuda, tmp_path):
    # SSIM in float64: card and CPU sum the same window in the same order;
    # LPIPS in fp32 with TF32 off (its convolutions sum in other orders),
    # alex and vgg at random init from torch-layout files
    from text2nerf_tpu_torch.engine import metrics as PM
    from text2nerf_tpu_torch.models import lpips as PL

    g = torch.Generator().manual_seed(0)
    a = torch.rand(96, 80, 3, generator=g)
    b = (a + 0.1 * torch.randn(96, 80, 3, generator=g)).clamp(0, 1)
    s_card, s_cpu = PM.ssim(a, b, device=cuda), PM.ssim(a, b, device="cpu")
    assert abs(s_card - s_cpu) <= 1e-6 and 0 < s_cpu < 1
    for net, name in (("alex", "alexnet-owt.pth"), ("vgg", "vgg16.pth")):
        torch.manual_seed(1)
        feats = PL.alex_features() if net == "alex" else PL.vgg16_features()
        torch.save({f"features.{k}": v for k, v in feats.state_dict().items()}, tmp_path / name)
        torch.save({f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1)
                    for i, c in enumerate(PL.CHANNELS[net])}, tmp_path / f"{net}.pth")
        d_card = PM.lpips(a, b, net, str(tmp_path), device=cuda)
        d_cpu = PM.lpips(a, b, net, str(tmp_path), device="cpu")
        assert abs(d_card - d_cpu) <= 1e-4 * abs(d_cpu) and d_cpu > 0


def _tiny_resume_setup(root, device):
    from text2nerf_tpu_torch.data import scene_state as pss
    from text2nerf_tpu_torch.engine import expansion as PE
    from text2nerf_tpu_torch.engine import trainer as PT
    from text2nerf_tpu_torch.services import fallbacks
    from text2nerf_tpu_torch.services.merge import DepthMergeService
    from text2nerf_tpu_torch.services.registry import Services

    hw = (32, 32)
    scene_cfg = pss.SceneConfig(datadir=str(root / "d"), prompt="card resume",
                                pose_traj="circle0_30", num_training=2, hw=hw,
                                num_filter_iter=2, filter_size=(3, 3))
    cfg = PT.TrainConfig(
        expname="r", basedir=str(root / "log"), n_stage1=1, n_stage2=2, n_stage3=1,
        batch_size=512, n_voxel_init=16 ** 3, app_k=8, eval_every_epochs=10, seed=5,
        eval_mask_pool=5, resume=True, resume_every_epochs=1,
        # the default head: kernel B takes feature_c 128
        model=ptf.TensoRFConfig(density_n_comp=(2, 2, 2), app_n_comp=(4, 4, 4)))
    services = Services(
        text2img=lambda p, n="": fallbacks.procedural_text2img(p, n, hw=hw),
        inpaint=lambda *a, **kw: fallbacks.diffusion_fill_inpaint(*a, device=device, **kw),
        estimate_depth=fallbacks.procedural_depth, rank=fallbacks.histogram_rank,
        merge=DepthMergeService(net_size=64, num_downs=4, device=device))
    ex = PE.ExpansionConfig(prompt=scene_cfg.prompt, n_candidates=1, candidates_per_round=1,
                            merge_iters=2, chunk=256, app_k=8, update_known_views=True)
    return cfg, scene_cfg, services, ex


def test_resume_on_the_card(cuda, tmp_path):
    # a fit with update_known_views and a resume point every epoch; its
    # last point (the entry of stage 3) resumed; the pools the snapshot
    # gives on the card and on the CPU: the same rays, rgb within a level
    import json
    import shutil

    from text2nerf_tpu_torch.data import scene_state as pss
    from text2nerf_tpu_torch.engine import checkpoints as PC
    from text2nerf_tpu_torch.engine import trainer as PT

    cfg, scene_cfg, services, ex = _tiny_resume_setup(tmp_path, cuda)
    first = PT.reconstruction(cfg, scene_cfg, services, ex, device=cuda)
    folder = first[4]
    loop = PC.load_checkpoint(f"{folder}/r_resume.npz", device=cuda)[-1]
    assert loop["epoch"] == 3 and loop["next_view"] == 2
    assert os.path.isdir(f"{folder}/DIBR/rgbs_support/00001_warp2known")
    snap = f"{folder}/scene_snapshot.npz"
    pools = [pss.load_scene_snapshot(snap, n_views_pools=2, device=d).updates
             for d in (cuda, "cpu")]
    for v in ("00000", "00001"):
        (gr, gc, gd), (cr, cc, cd) = pools[0][v], pools[1][v]
        assert len(gr) == len(cr) > 0 and np.array_equal(gr, cr)
        assert np.abs(gc - cc).max() <= 1.0 / 255 + 1e-6
    shutil.copy(f"{folder}/metrics.jsonl", tmp_path / "first.jsonl")
    second = PT.reconstruction(cfg, scene_cfg, services, ex, device=cuda)
    rows = [json.loads(line) for line in open(f"{second[4]}/metrics.jsonl")]
    n_first = sum(1 for _ in open(tmp_path / "first.jsonl"))
    assert [r["resume_epoch"] for r in rows[n_first:] if "resume_epoch" in r] == [3]
    assert second[3].rgbs_gen_split.shape[0] == 2
    assert all(torch.isfinite(p).all() for p in second[1].parameters())


@pytest.mark.parametrize("ladder", [None, LADDER], ids=["no_ladder", "ladder"])
@pytest.mark.parametrize("pool", [3, 5])
@pytest.mark.parametrize("n_samples", [259, 20, 433])
@pytest.mark.parametrize("k", K_CASES)
def test_eval_prepass_matches_the_plain_select(cuda, k, n_samples, pool, ladder):
    # rays that miss, leave or start in the box, run along the axes, cross
    # only dead voxels, and hold fewer or more live samples than K
    field, aabb, mask, rays = prepass_scene(cuda, pool)
    kw = select_kwargs(k, n_samples, PRd._occ_stride(field, aabb, mask), ladder)
    before = ep.LAUNCHES
    got = PRd._select_kernel(field, aabb, rays, mask, **kw)
    assert ep.LAUNCHES == before + 1
    want = PRd._select_plain(field, aabb, rays, mask, **kw)
    torch.cuda.synchronize()
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.bool
    assert ladder is None or got[6].dtype == torch.int8
    assert_same_select(got, want)
    n_live = want[5]
    assert bool((n_live == 0).any()) and bool(((n_live > 0) & (n_live < kw["k"])).any())


def _render_routes(field, aabb, rays, mask, monkeypatch, render):
    """``render()`` through the kernel route, then through the plain select
    on the same CUDA tensors."""
    before = ep.LAUNCHES
    got = render()
    assert ep.LAUNCHES > before
    with monkeypatch.context() as m:
        m.setattr(PRd, "_select_kernel", PRd._select_plain)
        want = render()
    return got, want


def _assert_outputs_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("pool", [3, 5])
def test_compacted_renders_match_through_either_select(cuda, pool, monkeypatch):
    field, aabb, mask, rays = prepass_scene(cuda, pool)
    kw = dict(n_samples=259, app_k=64, eval_z_min=-0.6, feature_dtype="fp32")
    # a padded last chunk; the ladder escalates the weak field's long rays
    monkeypatch.setattr(PRd, "_ADAPTIVE_PROBE_CACHE", {})
    (got, ks), (want, ks_p) = _render_routes(
        field, aabb, rays, mask, monkeypatch,
        lambda: PRd.render_chunked_adaptive(field, aabb, rays, mask, chunk=1024, probe=False,
                                            k_ladder=(16, 32, 64), device=cuda, **kw))
    assert ks == ks_p and max(ks) > 16
    _assert_outputs_equal(got, want)
    for render in (PRd.render_rays_compact_need, PRd.render_rays_compact_flagged):
        extra = {"k_ladder": LADDER} if render is PRd.render_rays_compact_need else {}
        (out, flag), (out_p, flag_p) = _render_routes(
            field, aabb, rays, mask, monkeypatch,
            lambda: render(field, aabb, rays, mask, compact_k=32, **extra, **kw))
        _assert_outputs_equal(out, out_p)
        assert flag.dtype == flag_p.dtype and torch.equal(flag, flag_p)
    # app_k under K: the top-K by weight after the selection, bf16 features
    got, want = _render_routes(
        field, aabb, rays, mask, monkeypatch,
        lambda: PRd.render_chunked(field, aabb, rays, alpha_mask=mask, chunk=1024,
                                   compact_k=96, **dict(kw, app_k=48, feature_dtype="bf16")))
    _assert_outputs_equal(got, want)


def test_a_warm_chunk_selects_and_composites_without_a_host_sync(cuda):
    from torch.profiler import ProfilerActivity, profile

    field, aabb, mask, rays = prepass_scene(cuda, 3)
    kw = dict(n_samples=259, chunk=1024, app_k=64, eval_z_min=-0.6, feature_dtype="fp32",
              k_ladder=LADDER, probe=False, device=cuda)
    PRd.render_chunked_adaptive(field, aabb, rays, mask, **kw)  # the step memo filled
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        PRd.render_chunked_adaptive(field, aabb, rays, mask, **kw)
        torch.cuda.synchronize()
    events = prof.events()
    inside = [e.time_range for e in events if e.name in ("t2n.select", "t2n.composite")]
    assert inside

    def within(e):
        return any(r.start <= e.time_range.start and e.time_range.end <= r.end for r in inside)

    # the host's calls into the runtime (the device's own copies run on
    # the device clock, which a later span may overlap)
    calls = [e.name for e in events if e.name.startswith(("cuda", "cu")) and within(e)]
    assert any(name.startswith(("cudaLaunch", "cuLaunch")) for name in calls)
    syncs = [name for name in calls if "Synchronize" in name or "Memcpy" in name]
    syncs += [e.name for e in events if within(e) and e.name in ("aten::item",
                                                                   "aten::_local_scalar_dense")]
    assert not syncs, syncs
