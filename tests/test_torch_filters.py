"""The filters' device backend (``ops/filters.py``) against the JAX
package's device programs, on the CPU, and the backend choice.

Each device function gets seeded inputs (depth with holes and a step, an
RGB image, a mask, discontinuity maps):

- ``sparse_bilateral_filtering(backend="device")`` and
  ``sparse_bilateral_filtering_image_edge``: bit-equal to JAX's, with and
  without the mask (both sort stably and accumulate the weights in
  float32 in order); the device backend also equals the native one;
- ``range_median_filter``: bit-equal;
- the synchronous-pass ``hole_fill``: the filled mask bit-equal, image
  and depth within 1e-6 of their largest value (the 3x3 means are
  convolution sums, in other orders).

``auto`` takes the native library for numpy and the device program for
tensors; ``TEXT2NERF_BILATERAL`` overrides it; a native build that fails
raises instead of moving to the device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2nerf_tpu.ops import filters as JF
from text2nerf_tpu_torch import native
from text2nerf_tpu_torch.ops import filters as PF
from text2nerf_tpu_torch.ops.kernels import _build


def _inputs(seed, h=40, w=44):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(1, 3, (h, w)) * (rng.uniform(size=(h, w)) > 0.03)
    depth[8:18, 5:30] += 2.0
    img = rng.uniform(0, 1, (h, w, 3))
    mask = rng.uniform(size=(h, w)) > 0.2
    return depth.astype(np.float32), img.astype(np.float32), mask.astype(np.float32)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


CASES = [(0, (5, 5, 3, 3), 4, False), (1, (5, 5, 3, 3), 4, True), (2, (7, 5, 5, 3, 3), 5, False),
         (3, 3, 3, True)]


@pytest.mark.parametrize("seed,fs,num_iter,with_mask", CASES)
def test_sparse_bilateral_device_bit_equal_to_jax(seed, fs, num_iter, with_mask):
    depth, img, mask = _inputs(seed)
    m = mask if with_mask else None
    wi, wd = JF.sparse_bilateral_filtering(depth, img, fs, 0.02, num_iter, mask=m,
                                           backend="device")
    gi, gd = PF.sparse_bilateral_filtering(_t(depth), _t(img), fs, 0.02, num_iter, mask=_t(m))
    assert isinstance(gi, torch.Tensor) and isinstance(gd, torch.Tensor)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    ni, nd = PF.sparse_bilateral_filtering(depth, img, fs, 0.02, num_iter, mask=m,
                                           backend="native")
    np.testing.assert_array_equal(ni, gi.numpy())
    np.testing.assert_array_equal(nd, gd.numpy())


@pytest.mark.parametrize("seed,with_mask", [(4, False), (5, True)])
def test_image_edge_variant_bit_equal_to_jax(seed, with_mask):
    depth, img, mask = _inputs(seed)
    m = mask if with_mask else None
    wi, wd = JF.sparse_bilateral_filtering_image_edge(depth, img, (5, 5, 3, 3), 0.1, 4, mask=m)
    gi, gd = PF.sparse_bilateral_filtering_image_edge(_t(depth), _t(img), (5, 5, 3, 3), 0.1, 4,
                                                      mask=_t(m))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    # numpy in, numpy out, on the asked device
    ni, nd = PF.sparse_bilateral_filtering_image_edge(depth, img, (5, 5, 3, 3), 0.1, 4, mask=m,
                                                      device="cpu")
    assert isinstance(ni, np.ndarray)
    np.testing.assert_array_equal(nd, np.asarray(wd))


@pytest.mark.parametrize("window", [3, 5, 7])
def test_range_median_filter_bit_equal_to_jax(window):
    depth, _, _ = _inputs(6)
    disc = (np.random.default_rng(7).uniform(size=depth.shape) > 0.8).astype(np.float32)
    want = np.asarray(JF.range_median_filter(jnp.asarray(depth), jnp.asarray(disc), window))
    got = PF.range_median_filter(_t(depth), _t(disc), window).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("with_depth", [False, True])
def test_hole_fill_matches_jax(with_depth):
    depth, img, _ = _inputs(8)
    holes = (np.random.default_rng(9).uniform(size=depth.shape) > 0.35).astype(np.float32)
    d = depth if with_depth else None
    want = JF.hole_fill(img, holes, None if d is None else jnp.asarray(d))
    got = PF.hole_fill(_t(img), _t(holes), _t(d))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].sum() > holes.sum()  # something was filled
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        if w is None:
            assert g is None
            continue
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-6 * np.abs(w).max()


def test_auto_picks_by_input_type(monkeypatch):
    depth, img, _ = _inputs(10)
    calls = []
    real = native.sparse_bilateral
    monkeypatch.setattr(native, "sparse_bilateral",
                        lambda *a, **k: calls.append("native") or real(*a, **k))
    monkeypatch.delenv("TEXT2NERF_BILATERAL", raising=False)
    out = PF.sparse_bilateral_filtering(depth, img)
    assert calls == ["native"] and isinstance(out[0], np.ndarray)
    out = PF.sparse_bilateral_filtering(_t(depth), _t(img))
    assert calls == ["native"] and isinstance(out[0], torch.Tensor)
    with pytest.raises(TypeError):
        PF.sparse_bilateral_filtering(_t(depth), _t(img), backend="native")


def test_environment_overrides_auto(monkeypatch):
    depth, img, _ = _inputs(11)
    monkeypatch.setattr(native, "sparse_bilateral",
                        lambda *a, **k: pytest.fail("the native backend was taken"))
    monkeypatch.setenv("TEXT2NERF_BILATERAL", "device")
    gi, gd = PF.sparse_bilateral_filtering(depth, img, device="cpu")
    wi, wd = JF.sparse_bilateral_filtering(depth, img, backend="device")
    assert isinstance(gi, np.ndarray)
    np.testing.assert_array_equal(gd, np.asarray(wd))
    monkeypatch.setenv("TEXT2NERF_BILATERAL", "gpu")
    with pytest.raises(ValueError, match="TEXT2NERF_BILATERAL"):
        PF.sparse_bilateral_filtering(depth, img)


def test_a_failing_native_build_raises(monkeypatch, tmp_path):
    depth, img, _ = _inputs(12)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("TEXT2NERF_BILATERAL", raising=False)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        PF.sparse_bilateral_filtering(depth, img)
