"""Kernel B's view-dependent mode (the eval ``MLP_Fea`` head) on the CPU:

- its layer-1 K order: every column of the reference's head input x = [f,
  d, PE(f), PE(d)] held once, a sine beside its cosine, K zero-padded to
  a multiple of 8 (150 -> 152 at TensoRF's 27 / 2 / 2), and W1^T's image
  laid out in that order;
- the kernel's arithmetic emulated on the CPU (3xTF32 from the weight
  images, rows read along their ray's direction) against the plain head;
- the wrapper on CPU tensors runs the plain version, which reads row r
  along ``dirs[r // k]``;
- ``_shade`` takes the mode for the eval ``MLP_Fea`` head on CUDA tensors
  only, and counts its rows as ``head.view_samples`` under a profiler;
- a TensorCP field's features on the CPU count no kernel C sample.

The kernel itself runs on the card only (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from text2nerf_tpu_torch.engine import tracing
from text2nerf_tpu_torch.models import mlp as PM
from text2nerf_tpu_torch.models import tensorf as tf
from text2nerf_tpu_torch.ops import render as Rd
from text2nerf_tpu_torch.ops.kernels import shading_mlp as sm

#: (app_dim, fea_pe, view_pe): TensoRF's CP head, either PE off, odd widths
CASES = [(27, 2, 2), (27, 0, 2), (27, 2, 0), (12, 1, 3), (32, 2, 2), (5, 0, 0)]


def _in_dim(c, fea_pe, view_pe):
    return PM.mlp_input_dim("MLP_Fea", c, view_pe, fea_pe, 0)


def _head(c, fea_pe, view_pe, seed=5):
    return PM.init_mlp(_in_dim(c, fea_pe, view_pe), generator=torch.Generator().manual_seed(seed),
                       device="cpu").requires_grad_(False)


def _from_image(img):
    """(128, K) W^T from a (K/8, 2, 1024) weight image's hi or lo part
    (the inverse of ``core_matrix_image``)."""
    kk = img.shape[0]
    return img.reshape(kk, 16, 2, 8, 4).permute(1, 3, 0, 2, 4).reshape(128, 8 * kk)


@pytest.mark.parametrize("c,fea_pe,view_pe", CASES)
def test_view_layer1_columns_cover_the_head_input(c, fea_pe, view_pe):
    d_in = _in_dim(c, fea_pe, view_pe)
    kk1 = sm.layer1_slices(c, fea_pe, view_pe)
    cols = sm.layer1_columns(c, fea_pe, view_pe).numpy()
    assert cols.shape == (8 * kk1,)
    assert sorted(cols[cols >= 0].tolist()) == list(range(d_in))
    assert int((cols < 0).sum()) == 8 * kk1 - d_in < 32
    if (c, fea_pe, view_pe) == (27, 2, 2):
        assert (d_in, 8 * kk1) == (150, 152)
    # a thread's slots t and t + 4 of a slice hold a sine and its cosine:
    # the features' sines start at c + 3, the direction's at c + 3 + 2cF
    cf, pe0 = c * fea_pe, c + 3
    pairs = cols.reshape(kk1, 2, 4)
    first, second = pairs[:, 0], pairs[:, 1]
    trig_f = (first >= pe0) & (first < pe0 + cf)
    np.testing.assert_array_equal(second[trig_f], first[trig_f] + cf)
    d0 = pe0 + 2 * cf
    trig_d = (first >= d0) & (first < d0 + 3 * view_pe)
    np.testing.assert_array_equal(second[trig_d], first[trig_d] + 3 * view_pe)
    assert int(trig_f.sum()) == cf and int(trig_d.sum()) == 3 * view_pe
    # the trig pairs come first, then the raw values two a pair, in order
    raw = cols[cols < pe0]
    raw = raw[raw >= 0]
    np.testing.assert_array_equal(np.sort(raw), np.arange(pe0))


def test_the_noview_columns_are_the_view_modes_without_a_direction():
    # view_pe None is the noview head: its K order, as kernel B had it
    np.testing.assert_array_equal(sm.layer1_columns(27, 6, None).numpy(),
                                  sm.layer1_columns(27, 6).numpy())
    assert sm.layer1_slices(27, 6) == 44 and sm.layer1_slices(27, 2, 2) == 19


@pytest.mark.parametrize("c,fea_pe,view_pe", CASES[:3])
def test_view_weight_images_hold_w1t_in_the_kernel_order(c, fea_pe, view_pe):
    head = _head(c, fea_pe, view_pe)
    w1img, w2img = sm.prepare_weights(head, c, fea_pe, view_pe)
    kk1 = sm.layer1_slices(c, fea_pe, view_pe)
    assert tuple(w1img.shape) == (kk1, 2, 1024) and tuple(w2img.shape) == (16, 2, 1024)
    cols = sm.layer1_columns(c, fea_pe, view_pe)
    w1t = torch.where(cols >= 0, head.w1.T[:, cols.clamp(min=0)], torch.zeros(()))
    hi, lo = _from_image(w1img[:, 0]), _from_image(w1img[:, 1])
    torch.testing.assert_close(hi, sm.tf32_rna(w1t), rtol=0, atol=0)
    err = (hi.double() + lo.double() - w1t.double()).abs()
    assert bool((err <= 2.0 ** -21 * w1t.double().abs()).all())
    assert not bool(hi[:, cols < 0].any())


def _emulated_view_head(head, feats, dirs, k, fea_pe, view_pe):
    """The view mode's arithmetic: x in the kernel's K order from each
    row's features and its ray's direction, A split into TF32 hi and lo, B
    from the weight images, acc += a_lo·b_hi + a_hi·b_lo + a_hi·b_hi in
    fp32, layer 2 in its K order, layer 3 and the sigmoid in fp32."""
    c = feats.shape[1]
    w1img, w2img = sm.prepare_weights(head, c, fea_pe, view_pe)
    cols = sm.layer1_columns(c, fea_pe, view_pe)
    d = torch.repeat_interleave(dirs, k, dim=0)
    parts = [feats, d]
    if fea_pe:
        parts.append(PM.positional_encoding(feats, fea_pe))
    if view_pe:
        parts.append(PM.positional_encoding(d, view_pe))
    x = torch.cat(parts, -1)
    a1 = torch.where(cols >= 0, x[:, cols.clamp(min=0)], torch.zeros(()))

    def mm3(a, img):
        b_hi, b_lo = _from_image(img[:, 0]).T, _from_image(img[:, 1]).T
        a_hi, a_lo = sm.tf32_split(a)
        return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi

    h1 = torch.relu(mm3(a1, w1img) + head.b1)
    h2 = torch.relu(mm3(h1[:, sm.layer2_columns()], w2img) + head.b2)
    return torch.sigmoid(h2 @ head.w3 + head.b3)


@pytest.mark.parametrize("c,fea_pe,view_pe", CASES[:4])
@pytest.mark.parametrize("k", [1, 32])
def test_emulated_view_head_matches_plain(c, fea_pe, view_pe, k):
    rng = np.random.default_rng(k)
    n_rays = 129 // k + 3
    feats = torch.from_numpy(2.0 * rng.standard_normal((n_rays * k, c)).astype(np.float32))
    dirs = torch.from_numpy(rng.standard_normal((n_rays, 3)).astype(np.float32))
    dirs[::2] *= -7.5  # negative and large components
    head = _head(c, fea_pe, view_pe)
    want = sm.shade_fea_plain(head, feats, dirs, k, fea_pe, view_pe)
    got = _emulated_view_head(head, feats, dirs, k, fea_pe, view_pe)
    # 3xTF32 is fp32-faithful to ~2^-21 relative (one TF32 product: ~3e-5)
    assert float((got - want).abs().max()) <= 1e-6


def test_the_wrapper_on_the_cpu_is_the_plain_head_along_each_rays_direction():
    c, fea_pe, view_pe, k = 27, 2, 2, 4
    head = _head(c, fea_pe, view_pe)
    gen = torch.Generator().manual_seed(3)
    feats = torch.randn(6 * k, c, generator=gen)
    rays = torch.randn(6, 6, generator=gen)
    got = sm.shade_fea(head, feats, rays[:, 3:6], k, fea_pe, view_pe)
    want = PM.shade("MLP_Fea", head, None, rays[:, 3:6].repeat_interleave(k, 0), feats,
                    view_pe=view_pe, fea_pe=fea_pe)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="rows"):
        sm.shade_fea(head, feats[:-1], rays[:, 3:6], k, fea_pe, view_pe)
    with pytest.raises(ValueError, match="mlp w1"):
        sm.shade_fea(head, feats, rays[:, 3:6], k, fea_pe, view_pe + 1)


class _CudaLike:
    """Stands in for a CUDA feature tensor: ``_shade`` reads only its
    device and its row count before it dispatches."""

    is_cuda = True

    def __init__(self, n, c):
        self.shape = (n, c)


@pytest.mark.parametrize("mode,is_train,cuda,route", [
    ("MLP_Fea", False, True, "view"),
    ("MLP_Fea", False, False, "plain"),
    ("MLP_Fea", True, True, "plain"),
    ("MLP_Fea_noview", False, True, "noview"),
    ("MLP_PE", False, True, "plain"),
    ("MLP", False, True, "plain"),
])
def test_shade_takes_the_view_mode_for_the_eval_mlp_fea_head_on_cuda(mode, is_train, cuda,
                                                                     route, monkeypatch):
    calls = []
    monkeypatch.setattr(Rd.shading_mlp, "shade_fea",
                        lambda mlp, f, d, k, fp, vp: calls.append(("view", d, k, fp, vp)))
    monkeypatch.setattr(Rd.shading_mlp, "shade_fea_noview",
                        lambda mlp, f, fp: calls.append(("noview",)))
    monkeypatch.setattr(Rd.mlp_mod, "shade", lambda m, *a, **kw: calls.append(("plain", a[2])))
    monkeypatch.setattr(tracing._autograd_profiler, "_is_profiler_enabled", True)
    tracing.reset_counts()
    cfg = tf.TensoRFConfig(model_name="cp", shading_mode=mode, fea_pe=2, view_pe=2)
    field = type("Field", (), {"mlp": object()})()
    b, k = 5, 8
    rays_d = torch.randn(b, 3)
    feats = _CudaLike(b * k, cfg.app_dim) if cuda else torch.zeros(b * k, cfg.app_dim)
    Rd._shade(cfg, field, torch.zeros(b * k, 3), rays_d, k, feats, is_train)
    assert [c[0] for c in calls] == [route]
    counts = tracing.counts()
    tracing.reset_counts()
    if route == "view":
        assert calls[0][1] is rays_d and calls[0][2:] == (k, 2, 2)
        assert counts == {"head.view_samples": b * k}
    elif route == "plain":
        # the plain head gets each row's direction
        assert torch.equal(calls[0][1], rays_d.repeat_interleave(k, 0))
        assert counts == {}
    else:
        assert counts == {"head.samples": b * k}


def test_a_cp_eval_on_the_cpu_counts_no_kernel_c_sample(monkeypatch):
    monkeypatch.setattr(tracing._autograd_profiler, "_is_profiler_enabled", True)
    tracing.reset_counts()
    cfg = tf.TensoRFConfig(model_name="cp", density_n_comp=(4,), app_n_comp=(8,),
                           shading_mode="MLP_Fea", fea_pe=2, view_pe=2)
    field = tf.init_params(cfg, (12, 12, 12), generator=torch.Generator().manual_seed(0),
                           device="cpu").requires_grad_(False)
    xn = torch.rand(40, 3) * 2 - 1
    with torch.no_grad():
        field.fused_features(xn)
        field.density_feature(xn)
    counts = tracing.counts()
    tracing.reset_counts()
    assert "cp.sigma_samples" not in counts and "cp.app_samples" not in counts
