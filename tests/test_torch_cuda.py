"""The CUDA kernels against their plain versions, on the card.

These skip without an NVIDIA GPU.  The module imports no JAX, so on a
machine with a card and no JAX it runs with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from text2nerf_tpu_torch.engine.checkpoints import params_from_jax, params_to_jax
from text2nerf_tpu_torch.models import tensorf as ptf
from text2nerf_tpu_torch.ops import rays as PR
from text2nerf_tpu_torch.ops import render as PRd
from text2nerf_tpu_torch.ops.kernels import factor_features as ff
from text2nerf_tpu_torch.ops.kernels import shading_mlp as sm

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
        # bit for bit equal in both compute types
        for g, r in zip(got, ref):
            assert (g is None) == (r is None)
            if r is not None:
                assert g.shape == r.shape
                assert torch.equal(g, r), float((g - r).abs().max())


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
                    assert torch.equal(g, r), (name, float((g - r).abs().max()))


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


def test_kernels_refuse_grad_inputs(cuda):
    cfg = ptf.TensoRFConfig(density_n_comp=(2, 2, 2), app_n_comp=(4, 4, 4))
    field = _field(cfg, (6, 6, 6), cuda).requires_grad_(True)
    xn = torch.zeros(8, 3, device=cuda)
    with pytest.raises(RuntimeError, match="no_grad"):
        field.fused_features(xn)
    with pytest.raises(RuntimeError, match="no_grad"):
        sm.shade_fea_noview(field.mlp, torch.zeros(8, cfg.app_dim, device=cuda), cfg.fea_pe)


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
    monkeypatch.setattr(sm, "shade_fea_noview_plain", boom)
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
