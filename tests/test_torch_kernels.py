"""The port's two kernel modules against the JAX package, on the CPU.

On the CPU each wrapper runs its plain PyTorch version, so these tests
hold the plain versions against the JAX functions the kernels replace:

- kernel A (factor features) against compute_fused_features_packed,
  compute_density_feature_packed and compute_app_feature_packed, fp32
  (≤ 1e-5) and bf16 (≤ 5e-3, the JAX package's own bf16 bound), and in
  bf16 at the room shell's real magnitudes against jitted JAX (sigma
  within one bf16 ulp of its largest value, app channels within two; the
  adaptive render's rgb ≤ 1e-4);
- kernel B (the MLP_Fea_noview head) against mlp.shade, the reference of
  the Pallas kernel (tests/test_pallas_shading.py), at 4096 rows (≤ 1e-5);
- what the CUDA kernels' Python side gives them, which only the card can
  run: kernel B's weight images (K-major, K-permuted, zero-padded, TF32
  hi/lo), a CPU emulation of its 3xTF32 head that reads those images as
  wgmma's descriptors address them (≤ 1e-6 of the plain head at full
  width).

tests/test_torch_cuda.py holds each CUDA kernel against its plain version
on the card.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2nerf_tpu.engine.checkpoints import _flatten
from text2nerf_tpu.models import mlp as M
from text2nerf_tpu.models import tensorf as tf
from text2nerf_tpu_torch.engine.checkpoints import params_from_jax
from text2nerf_tpu_torch.models import mlp as PM
from text2nerf_tpu_torch.ops.kernels import factor_features as ff
from text2nerf_tpu_torch.ops.kernels import shading_mlp as sm

torch.set_num_threads(1)

CFG = tf.TensoRFConfig(density_n_comp=(4, 5, 6), app_n_comp=(8, 7, 9))
GRID = (20, 17, 23)
TOL = {"fp32": 1e-5, "bf16": 5e-3}


@pytest.fixture(scope="module")
def fields():
    params = tf.init_params(jax.random.PRNGKey(3), CFG, GRID)
    # features of order 0.1-0.5: not all near 0, and within [-0.5, 0.5]
    # where a bf16 ulp (2^-9) is below the 5e-3 bound
    for k, scale in (("density_planes", 2.5), ("density_lines", 2.5),
                     ("app_planes", 4.0), ("app_lines", 4.0)):
        params[k] = jax.tree.map(lambda x: scale * x, params[k])
    with torch.no_grad():
        field = params_from_jax(_flatten(params), CFG, device="cpu")
    return params, field.requires_grad_(False)


def _xn(n=777, seed=0):
    xn = np.random.default_rng(seed).uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    xn[:6] = [[-1, -1, -1], [1, 1, 1], [1, -1, 0], [0, 1, -1], [-1, 0, 1], [0, 0, 0]]
    return xn


@functools.partial(jax.jit, static_argnames=("mode", "dtype"))
def _jax_features(params, xn, mode, dtype):
    if mode == "fused":
        return tf.compute_fused_features_packed(
            CFG, tf.pack_params_fused(CFG, params), xn, dtype=dtype)
    if mode == "density":
        return (tf.compute_density_feature_packed(
            CFG, tf.pack_params(CFG, params), xn, dtype=dtype),)
    return (tf.compute_app_feature_packed(
        CFG, tf.pack_params(CFG, params), xn, dtype=dtype),)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["fused", "density", "app"])
def test_factor_features_match_jax(fields, mode, dtype):
    params, field = fields
    xn = _xn()
    jdt = jnp.bfloat16 if dtype == "bf16" else None
    tdt = torch.bfloat16 if dtype == "bf16" else None
    x_t = torch.from_numpy(xn)
    want = _jax_features(params, jnp.asarray(xn), mode, jdt)
    if mode == "fused":
        got = field.fused_features(x_t, tdt)
    elif mode == "density":
        got = (field.density_feature(x_t, tdt),)
    else:
        got = (field.app_feature(x_t, tdt),)
    for w, g in zip(want, got):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL[dtype])
    assert float(np.abs(np.asarray(want[0])).max()) > 0.1


def test_factor_features_at_walk_widths_match_jax_in_any_order():
    # the main path's widths (16 + 48 = 64 channels per axis: the CUDA walk
    # kernel's), rays of 16 consecutive one-voxel steps, in three orders
    cfg = tf.TensoRFConfig()
    params = tf.init_params(jax.random.PRNGKey(4), cfg, GRID)
    for k, scale in (("density_planes", 2.5), ("density_lines", 2.5),
                     ("app_planes", 4.0), ("app_lines", 4.0)):
        params[k] = jax.tree.map(lambda x: scale * x, params[k])
    with torch.no_grad():
        field = params_from_jax(_flatten(params), cfg, device="cpu").requires_grad_(False)
    rng = np.random.default_rng(5)
    o = rng.uniform(-0.8, 0.8, (48, 1, 3))
    d = rng.standard_normal((48, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    xn = np.clip(o + d * np.arange(16)[None, :, None] * (2.0 / (max(GRID) - 1)), -1, 1)
    xn = xn.reshape(-1, 3).astype(np.float32)
    want = jax.jit(lambda p, x: tf.compute_fused_features_packed(
        cfg, tf.pack_params_fused(cfg, p), x))(params, jnp.asarray(xn))
    base = field.fused_features(torch.from_numpy(xn))
    for w, g in zip(want, base):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL["fp32"])
    for order in (np.arange(len(xn))[::-1].copy(), rng.permutation(len(xn))):
        got = field.fused_features(torch.from_numpy(xn[order]))
        assert all(torch.equal(g, b[torch.from_numpy(order)]) for g, b in zip(got, base))


def _bf16_ulps(got, want):
    """|got - want| in bf16 ulps of ``want`` (8-bit significand)."""
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    return np.abs(np.asarray(got, np.float32) - want) / ulp


def test_bf16_at_real_magnitudes_near_jitted_jax():
    # the room shell of bench.py at full widths (grid cut to 40^3): density
    # features up to |sigma| ~ 70, where a bf16 ulp is 0.5.  Jitted XLA
    # keeps bf16 chains in fp32 and rounds fewer times than the port, which
    # rounds after every op as eager JAX does.  Held: sigma within one bf16
    # ulp of the largest |sigma| (its three axis sums cancel, so an ulp of
    # the value itself is no scale), app channels within two bf16 ulps of
    # each value, and the default bf16 adaptive render's rgb and acc within
    # 1e-4 with identical per-chunk ks.
    import bench
    from text2nerf_tpu.data import trajectories as traj
    from text2nerf_tpu.ops import rays as R
    from text2nerf_tpu.ops import render as Rd
    from text2nerf_tpu_torch.models import tensorf as ptf
    from text2nerf_tpu_torch.ops import render as PRd

    cfg = tf.TensoRFConfig()
    aabb = jnp.array([[-8.0] * 3, [8.0] * 3])
    reso = tf.n_to_reso(40 ** 3, aabb)
    shell = bench.build_scene_field(cfg, reso)
    field = params_from_jax(_flatten(shell), ptf.TensoRFConfig(), device="cpu")
    field.requires_grad_(False)
    xn = _xn(2000, seed=2)
    want = jax.jit(lambda p, x: tf.compute_fused_features_packed(
        cfg, tf.pack_params_fused(cfg, p), x, dtype=jnp.bfloat16))(shell, jnp.asarray(xn))
    got = field.fused_features(torch.from_numpy(xn), torch.bfloat16)
    sig_max = float(np.abs(np.asarray(want[0])).max())
    sig_err = float(np.abs(got[0].numpy() - np.asarray(want[0])).max())
    app_ulps = float(_bf16_ulps(got[1].numpy(), want[1]).max())
    assert sig_max > 32
    assert sig_err <= sig_max * 2.0 ** -7, (sig_err, sig_max)
    assert app_ulps <= 2, app_ulps

    mask, _ = tf.update_alpha_mask(cfg, shell, aabb, (24,) * 3, pool=5)
    aabb_t = torch.tensor(np.asarray(aabb))
    pmask, _ = ptf.update_alpha_mask(field, aabb_t, (24,) * 3, pool=5, device="cpu")
    hw = 32
    intr = R.default_intrinsics(hw, hw)
    pose = traj.test_trajectory("circle0", np.eye(4), angle=0.2, trans_range=0.2)[3]
    rays = R.rays_from_poses(R.ray_directions(hw, hw, intr[:2], intr[2:]),
                             jnp.asarray(pose[None]))[0]
    Rd._ADAPTIVE_PROBE_CACHE.clear()
    PRd._ADAPTIVE_PROBE_CACHE.clear()
    kw = dict(n_samples=int(tf.default_n_samples(reso, 1.0)), chunk=512, app_k=32,
              k_ladder=(8, 16, 32))  # feature_dtype: the bf16 default
    want_r, ks = Rd.render_chunked_adaptive(cfg, shell, aabb, rays, mask, **kw)
    got_r, pks = PRd.render_chunked_adaptive(field, aabb_t, np.asarray(rays), pmask,
                                             device="cpu", **kw)
    dev = {k: float(np.abs(getattr(got_r, k).numpy() - np.asarray(getattr(want_r, k))).max())
           for k in ("rgb", "acc")}
    print(f"bf16 port vs jitted JAX: sigma {sig_err:g} abs at |sigma| <= {sig_max:g}, "
          f"app {app_ulps:g} bf16 ulps; render max abs {dev}, ks {pks}")
    assert pks == ks
    assert max(dev.values()) <= 1e-4, dev
    assert float(np.asarray(want_r.acc).max()) > 0.9


def test_factor_features_plain_matches_unfused_reference(fields):
    # the density sum and app channels of the fused tables equal the
    # split-table gathers of the independent grid_sample path
    params, field = fields
    xn = _xn(300, seed=1)
    sig, app_raw = ff.factor_features(
        torch.from_numpy(xn), tuple(field.planes), tuple(field.lines), field.nd)
    want_sig, want_app = jax.jit(lambda p, x: (
        tf.compute_density_feature(CFG, p, x), tf.compute_app_feature(CFG, p, x)
    ))(params, jnp.asarray(xn))
    np.testing.assert_allclose(sig.numpy(), np.asarray(want_sig), atol=1e-5)
    np.testing.assert_allclose((app_raw @ field.basis).numpy(), np.asarray(want_app),
                               atol=1e-5)


def test_shading_head_matches_jax():
    app_dim, fea_pe = 27, 6
    in_dim = M.mlp_input_dim("MLP_Fea_noview", app_dim, 2, fea_pe, 6)
    params = M.init_mlp(jax.random.PRNGKey(0), in_dim)
    feats = 2.0 * np.random.default_rng(0).standard_normal((4096, app_dim)).astype(np.float32)
    want = jax.jit(lambda p, f: M.shade("MLP_Fea_noview", p, None, None, f, fea_pe=fea_pe))(
        params, jnp.asarray(feats))
    head = PM.ShadingMLP(in_dim).requires_grad_(False)
    with torch.no_grad():
        for k in ("w1", "b1", "w2", "b2", "w3", "b3"):
            head[k].copy_(torch.from_numpy(np.array(params[k])))
    got = sm.shade_fea_noview(head, torch.from_numpy(feats), fea_pe)
    assert tuple(got.shape) == (4096, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # the PE layout is the reference's channel-major one
    pe = PM.positional_encoding(torch.from_numpy(feats[:64]), fea_pe)
    np.testing.assert_allclose(
        pe.numpy(), np.asarray(M.positional_encoding(jnp.asarray(feats[:64]), fea_pe)),
        atol=1e-6)


def test_wrappers_reject_bad_inputs(fields):
    _, field = fields
    planes, lines = tuple(field.planes), tuple(field.lines)
    with pytest.raises(ValueError):
        ff.factor_features(torch.zeros(4, 2), planes, lines, field.nd)
    with pytest.raises(ValueError):
        ff.factor_features(torch.zeros(4, 3), planes, lines, field.nd, sigma=False, app=False)
    with pytest.raises(ValueError):
        ff.factor_features(torch.zeros(4, 3, dtype=torch.float64), planes, lines, field.nd)
    with pytest.raises(ValueError):
        sm.shade_fea_noview(field.mlp, torch.zeros(4, 26), CFG.fea_pe)


def test_non_cpu_tensors_never_reach_the_plain_versions(fields, monkeypatch):
    # a tensor that is not on the CPU launches the kernel or raises; the
    # plain versions are never a fallback (meta tensors stand in for a
    # device without a kernel)
    _, field = fields

    def boom(*a, **k):
        raise AssertionError("plain version reached")

    monkeypatch.setattr(ff, "factor_features_plain", boom)
    monkeypatch.setattr(sm, "shade_fea_noview_plain", boom)
    meta = copy.deepcopy(field).to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        ff.factor_features(torch.zeros(4, 3, device="meta"), tuple(meta.planes),
                           tuple(meta.lines), meta.nd)
    with pytest.raises(ValueError, match="no kernel"):
        sm.shade_fea_noview(meta.mlp, torch.zeros(4, CFG.app_dim, device="meta"),
                            CFG.fea_pe)


# ---- kernel B: what the wrapper hands the 3xTF32 kernel ---------------------


def _tf32_reference(x):
    """fp32 -> TF32 (11 significant bits), to nearest, ties away from zero."""
    m, e = np.frexp(x.astype(np.float64))
    return (np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5) * 2.0 ** (e - 11)).astype(
        np.float32)


def _descriptor_view(img, part):
    """(128, K) matrix that the kernel's wgmma B descriptors read from a
    weight image (slices, 2, 1024): no swizzle, K-major core matrices of
    8 rows x 16 B, LBO 128 B between the two K halves of a slice, SBO 256 B
    between 8-row groups, hi part then lo part per slice."""
    img = img.numpy()
    n = np.arange(128)[:, None]
    k = np.arange(img.shape[0] * 8)[None, :]
    byte = (n // 8) * 256 + (k % 8 // 4) * 128 + (n % 8) * 16 + (k % 4) * 4
    return img[k // 8, part, byte // 4]


def test_tf32_rounding_is_cvt_rna():
    # normal values (weights and activations of the head are never subnormal)
    x = np.array([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                  -7.25, 1e30], np.float32)
    x = np.concatenate([x, np.random.default_rng(0).standard_normal(10000).astype(np.float32)])
    got = sm.tf32_rna(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _tf32_reference(x))
    assert not (got.view(np.int32) & 0x1FFF).any()
    # ties round away from zero
    assert got[0] == np.float32(1 + 2 ** -10) and got[2] == np.float32(-(1 + 2 ** -10))


@pytest.mark.parametrize("app_dim,fea_pe", [(27, 6), (12, 2)])
def test_head_weight_preparation(app_dim, fea_pe):
    in_dim = app_dim * (1 + 2 * fea_pe)
    head = PM.init_mlp(in_dim, generator=torch.Generator().manual_seed(5), device="cpu")
    w1img, w2img = sm.prepare_weights(head, app_dim, fea_pe)
    kk1 = sm.layer1_slices(app_dim, fea_pe)
    assert tuple(w1img.shape) == (kk1, 2, 1024) and tuple(w2img.shape) == (16, 2, 1024)
    if (app_dim, fea_pe) == (27, 6):
        assert kk1 * 8 == 352  # K padded 351 -> 352
    cols = sm.layer1_columns(app_dim, fea_pe).numpy()
    # every column of x = [f, sin, cos] once, the rest zero padding
    assert sorted(cols[cols >= 0].tolist()) == list(range(in_dim))
    assert int((cols < 0).sum()) == kk1 * 8 - in_dim
    # a thread's slots t and t + 4 of a slice hold a sine and its cosine
    cf = app_dim * fea_pe
    sines = cols.reshape(kk1, 2, 4)
    trig = (sines[:, 0] >= app_dim) & (sines[:, 0] < app_dim + cf)
    np.testing.assert_array_equal(sines[:, 1][trig], sines[:, 0][trig] + cf)
    # layer 2's K axis: within each group of 8, hidden columns 0 2 4 6 1 3 5 7
    c2 = sm.layer2_columns().numpy()
    np.testing.assert_array_equal(c2[:8], [0, 2, 4, 6, 1, 3, 5, 7])
    np.testing.assert_array_equal(np.sort(c2), np.arange(128))
    w1t = np.where(cols[None, :] >= 0, head.w1.detach().numpy().T[:, np.maximum(cols, 0)], 0)
    w2t = head.w2.detach().numpy().T[:, c2]
    for img, want in ((w1img, w1t), (w2img, w2t)):
        hi, lo = _descriptor_view(img, 0), _descriptor_view(img, 1)
        for part in (hi, lo):  # TF32: the low 13 mantissa bits are zero
            assert not (part.view(np.int32) & 0x1FFF).any()
        np.testing.assert_array_equal(hi, _tf32_reference(want))
        err = np.abs(hi.astype(np.float64) + lo - want)
        assert np.all(err <= 2.0 ** -21 * np.abs(want)), float(err.max())
    assert not w1t[:, cols < 0].any()


def _emulated_3xtf32_head(head, feats, fea_pe):
    """The kernel's arithmetic on the CPU: x in the kernel's K order, A
    split into TF32 hi and lo, B read from the weight images through the
    descriptors' addressing, acc += a_lo·b_hi + a_hi·b_lo + a_hi·b_hi with
    fp32 accumulation, layer 2's A taken in the kernel's K order from the
    ReLU'd layer-1 output, layer 3 and the sigmoid in fp32."""
    c = feats.shape[1]
    w1img, w2img = sm.prepare_weights(head, c, fea_pe)
    cols = sm.layer1_columns(c, fea_pe)
    x = torch.cat([feats, PM.positional_encoding(feats, fea_pe)], -1)
    a1 = torch.where(cols >= 0, x[:, cols.clamp(min=0)], torch.zeros(()))

    def mm3(a, img):
        b_hi = torch.from_numpy(_descriptor_view(img, 0)).T
        b_lo = torch.from_numpy(_descriptor_view(img, 1)).T
        a_hi, a_lo = sm.tf32_split(a)
        return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi

    h1 = torch.relu(mm3(a1, w1img) + head.b1)
    h2 = torch.relu(mm3(h1[:, sm.layer2_columns()], w2img) + head.b2)
    return torch.sigmoid(h2 @ head.w3 + head.b3)


def test_emulated_3xtf32_head_matches_plain_at_full_width():
    # the full-width head (351 x 128 x 128 x 3) of the seeded room shell
    from text2nerf_tpu_torch.data import synthetic as syn
    from text2nerf_tpu_torch.models import tensorf as ptf

    field = syn.room_shell_field(ptf.TensoRFConfig(), (8, 8, 8),
                                 generator=torch.Generator().manual_seed(0), device="cpu")
    head = field.mlp.requires_grad_(False)
    cfg = field.cfg
    assert tuple(head.w1.shape) == (351, 128)
    feats = 2.0 * torch.from_numpy(
        np.random.default_rng(0).standard_normal((4096, cfg.app_dim)).astype(np.float32))
    want = sm.shade_fea_noview_plain(head, feats, cfg.fea_pe)
    got = _emulated_3xtf32_head(head, feats, cfg.fea_pe)
    # 3xTF32 products are fp32-faithful to ~2^-21 relative: far inside
    # TOL["head"] = 1e-4 of chip_smoke.py (one TF32 product would give ~3e-5)
    assert float((got - want).abs().max()) <= 1e-6


def test_head_weight_cache_follows_the_weights():
    head = PM.init_mlp(351, generator=torch.Generator().manual_seed(1), device="cpu")
    first = sm._prepared(head, 27, 6)
    assert sm._prepared(head, 27, 6) is first
    with torch.no_grad():
        head["w1"].mul_(2.0)  # in place: same storage, new version
    edited = sm._prepared(head, 27, 6)
    assert edited is not first
    torch.testing.assert_close(edited[0], sm.prepare_weights(head, 27, 6)[0], rtol=0, atol=0)
    other = PM.init_mlp(351, generator=torch.Generator().manual_seed(2), device="cpu")
    assert sm._prepared(other, 27, 6) is not edited
    assert sm._prepared(head, 27, 6) is edited
