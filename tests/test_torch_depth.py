"""The port's boosted depth family against the JAX package, on the CPU.
Inputs come from a numpy seed; flax parameters reach the port through
the bridges of ``services/weights.py``.  Tolerances (the worst seen in
brackets):

- the nets (tiny LeReS, SGRNet's layout of it, ``MidasNet(tiny,
  features=16)``, ``DepthNetConfig.tiny()``) at 64x64 and 96x64, fp32:
  1e-5 of the largest |JAX output| [1.7e-6]; bf16 compute on both sides:
  4e-2 of the largest output and at most twice JAX's own bf16-vs-fp32
  gap [port vs JAX 1.5e-2 to 2.2e-2, JAX's own gap 1.5e-2 to 2.1e-2];
  RelDepthNet at 100x76, sides that are not multiples of 32 (upsampling
  by 7/4, 13/7, 25/13 and 100/25 instead of 2; LeReS and MiDaS need
  multiples of 32, in JAX as here): 1e-5 [9.6e-7], the bilinear source
  coordinates rounding differently in the last bit;
- the align-corners resize: equal to JAX's to 1 ulp;
- the loaders: every tensor equal to JAX's converted tree carried
  across; < 99% coverage raises in both; the search paths equal;
- the cv2 equivalents (skipped without OpenCV): the host ones
  (``sobel_grad``, ``resize_area`` at the decisions' ratios and at
  integer ones, ``dilate``, ``integral``) equal; the cubic and linear
  resizes within 1e-6 absolute on [0, 1] images [4.8e-7]; the Gaussian
  blur 1e-6 [6e-7]; the 3000² blend mask 5e-6 [1.3e-6];
- the decisions (processing size, patch scale, every patch rect): equal;
- the booster end to end (injected tiny LeReS, receptive field 64,
  pix2pix 128, the fallback merge and a tiny pix2pix merge): the same
  processing size and patch list (3 patches merged), counts within
  1e-4 · 65535 [0.055 counts with either merge]; at the default sizes on
  the 512² procedural seed image (a base net that ignores the size): the
  same 44 base calls, 21 patches, counts within 1e-4 · 65535 [0.22].
  ``polyfit_map`` against numpy on fp32 data, on both sides of numpy's
  rank cut: 2e-5 of the largest value.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2nerf_tpu.models import leres as JL
from text2nerf_tpu.models import midas as JM
from text2nerf_tpu.models import monodepth as JMD
from text2nerf_tpu.models import pix2pix as JP
from text2nerf_tpu.services import depth_service as JDS
from text2nerf_tpu.services import fallbacks as JFB
from text2nerf_tpu.services import weight_convert as JWC
from text2nerf_tpu_torch.models import diffusion as PD
from text2nerf_tpu_torch.models import leres as PL
from text2nerf_tpu_torch.models import midas as PM
from text2nerf_tpu_torch.models import monodepth as PMD
from text2nerf_tpu_torch.models import pix2pix as PP
from text2nerf_tpu_torch.services import depth_service as PDS
from text2nerf_tpu_torch.services import image_ops as IO
from text2nerf_tpu_torch.services import weights as PW

torch.set_num_threads(2)

MEAN = np.array([0.485, 0.456, 0.406])
STD = np.array([0.229, 0.224, 0.225])


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _random_params(jnet, x, seed):
    """A random flax tree of ``jnet``'s shapes (traced, not compiled):
    kernels N(0, 1/fan_in), norm scales and BatchNorm variances around 1,
    biases and means around 0."""
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x)["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, n = path[-1].key, rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return n / np.sqrt(np.prod(s.shape[:-1]))
        if name in ("scale", "var"):
            return 1 + 0.1 * np.abs(n) if name == "var" else 1 + 0.1 * n
        return 0.1 * n

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _nets(name, dtype):
    """(flax module, port maker, bridge) of a tiny net."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    pdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    tiny = PL.LeReSConfig.tiny()
    if name == "leres":
        return (JL.RelDepthModel(JL.LeReSConfig.tiny(), jdt), lambda: PL.RelDepthModel(tiny, pdt),
                lambda p: PW.leres_state_from_flax(p, tiny))
    if name == "sgrnet":
        return (JL.RelDepthModel(JL.LeReSConfig.tiny(), jdt), lambda: PL.SGRNetDepth(tiny, pdt),
                lambda p: PW.sgrnet_state_from_flax(p, tiny))
    if name == "midas":
        return (JM.MidasNet(JL.LeReSConfig.tiny(), features=16, dtype=jdt),
                lambda: PM.MidasNet(tiny, 16, dtype=pdt),
                lambda p: PW.midas_state_from_flax(p, tiny, 16))
    cfg = PMD.DepthNetConfig.tiny()
    return (JMD.RelDepthNet(JMD.DepthNetConfig.tiny(), jdt), lambda: PMD.RelDepthNet(cfg, pdt),
            lambda p: PW.reldepthnet_state_from_flax(p, cfg))


def _run_pair(name, dtype, hw, seed=0):
    jnet, make, bridge = _nets(name, dtype)
    x = np.random.default_rng(seed).random((1, *hw, 3)).astype(np.float32)
    xn = ((x - MEAN) / STD).astype(np.float32)
    params = _random_params(jnet, xn, seed + 1)
    want = np.asarray(jax.jit(jnet.apply)({"params": params}, xn), np.float32)
    net = PD.materialize(make, "cpu")
    net.load_state_dict(bridge(params))
    with torch.no_grad():
        got = net(torch.from_numpy(xn).permute(0, 3, 1, 2)).float().numpy()
    return got, want, (jnet, params, xn)


@pytest.mark.parametrize("name,hw", [(n, hw) for n in ("leres", "midas", "reldepth")
                                     for hw in ((64, 64), (96, 64))] + [("sgrnet", (96, 64))])
def test_nets_match_jax_fp32(name, hw):
    got, want, _ = _run_pair(name, "fp32", hw)
    assert got.shape == want.shape == (1, *hw)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("name", ["leres", "midas", "reldepth"])
def test_nets_match_jax_bf16(name):
    got, want, (jnet, params, xn) = _run_pair(name, "bf16", (64, 64))
    fp32 = type(jnet)(**{**{f: getattr(jnet, f) for f in jnet.__dataclass_fields__
                            if f not in ("parent", "name")}, "dtype": jnp.float32})
    want32 = np.asarray(jax.jit(fp32.apply)({"params": params}, xn), np.float32)
    jax_gap = _rel(want, want32)
    assert np.isfinite(got).all() and jax_gap > 1e-4  # bf16 really ran
    assert _rel(got, want) <= min(4e-2, 2 * jax_gap)


def test_reldepthnet_at_sides_not_multiples_of_32():
    got, want, _ = _run_pair("reldepth", "fp32", (100, 76))
    assert got.shape == (1, 100, 76) and _rel(got, want) <= 1e-5


@pytest.mark.parametrize("hw,out", [((7, 5), (14, 10)), ((28, 21), (56, 42)), ((5, 1), (10, 2))])
def test_align_corners_resize_matches_jax(hw, out):
    x = np.random.default_rng(3).standard_normal((2, *hw, 3)).astype(np.float32)
    want = np.asarray(JL.resize_bilinear_align_corners(jnp.asarray(x), out))
    got = PL.resize_bilinear_align_corners(torch.from_numpy(x).permute(0, 3, 1, 2), out)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=2.4e-7)


# ---------------------------------------------------------------------------
# Loaders
# ---------------------------------------------------------------------------


def _random_reference_state(make, name_map, seed):
    """A random state dict under the reference's names, at full width,
    with a DataParallel prefix and the BatchNorms' batch counters."""
    rng = np.random.default_rng(seed)
    tmpl = PW._template(make)
    state = {}
    for k, v in tmpl.items():
        if k not in name_map:
            continue
        state["module." + k] = torch.from_numpy(rng.random(tuple(v.shape), np.float32) - 0.5)
        if k.endswith("running_var"):
            state["module." + k[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    return state


LOADERS = {
    "leres": (lambda: PL.RelDepthModel(PL.LeReSConfig.resnext101()),
              lambda: PW.leres_name_map(PL.LeReSConfig.resnext101()), "depth_model",
              PW.load_leres_checkpoint, JWC.load_leres_checkpoint,
              lambda t: PW.leres_state_from_flax(t, PL.LeReSConfig.resnext101())),
    "sgrnet": (lambda: PL.SGRNetDepth(PL.LeReSConfig.resnet50()),
               lambda: PW.sgrnet_name_map(PL.LeReSConfig.resnet50()), "state_dict",
               PW.load_sgrnet_checkpoint, JWC.load_sgrnet_checkpoint,
               lambda t: PW.sgrnet_state_from_flax(t, PL.LeReSConfig.resnet50())),
    "midas": (lambda: PM.MidasNet(PL.LeReSConfig.resnext101()),
              lambda: PW.midas_name_map(PL.LeReSConfig.resnext101()), None,
              PW.load_midas_checkpoint, JWC.load_midas_checkpoint,
              lambda t: PW.midas_state_from_flax(t, PL.LeReSConfig.resnext101())),
}


@pytest.mark.parametrize("name", list(LOADERS))
def test_loaders_match_jax_at_full_width(tmp_path, name):
    make, name_map, container, port_load, jax_load, bridge = LOADERS[name]
    nm = name_map()
    state = _random_reference_state(make, nm, 5)
    path = str(tmp_path / f"{name}.pth")
    torch.save({container: state} if container else state, path)
    got = port_load(path).state_dict()
    want = bridge(jax_load(path))
    assert set(got) == set(want)
    for k in got:
        if k.startswith("scratch.refinenet4.resConfUnit1."):
            # unused by the forward; flax never builds it (the bridge
            # zero-fills it), the port keeps the checkpoint's
            assert torch.equal(got[k], state["module." + k]), k
            continue
        assert torch.equal(got[k], want[k]), k
    assert not any(k.startswith("module.") for k in got)


@pytest.mark.parametrize("name", list(LOADERS))
def test_loaders_raise_below_99_percent_coverage(tmp_path, name):
    make, name_map, container, port_load, jax_load, _ = LOADERS[name]
    nm = name_map()
    # shapes do not matter to the coverage check: one small tensor a key
    keys = sorted(nm)
    keep = keys[: int(0.98 * len(keys))]
    state = {k: torch.zeros(1) for k in keep}
    path = str(tmp_path / "cut.pth")
    torch.save({container: state} if container else state, path)
    with pytest.raises(ValueError, match="layout mismatch"):
        port_load(path)
    with pytest.raises(ValueError, match="layout mismatch"):
        jax_load(path)


def test_unreadable_checkpoint_raises(tmp_path):
    path = tmp_path / "res101.pth"
    path.write_bytes(b"not a checkpoint")
    with pytest.raises(Exception):
        PW.load_leres_checkpoint(str(path))
    with pytest.raises(Exception):
        PDS.make_depth_estimator(str(tmp_path), device="cpu")


def test_checkpoint_search_paths_match_jax(tmp_path):
    root = tmp_path / "weights"
    files = ["leres/res101.pth", "leres2/pix2pix/checkpoints/res101.pth",
             "weights_BoostingMonocularDepth/pix2pix/checkpoints/res101.pth",
             "midas_a/model.pt", "midas_b/midas/model.pt",
             "weights_BoostingMonocularDepth/midas/model.pt",
             "sgr_a/model.pth.tar", "sgr_b/structuredrl/model.pth.tar",
             "structuredrl/model.pth.tar", "other/readme.txt"]
    for f in files:
        (root / f).parent.mkdir(parents=True, exist_ok=True)
        (root / f).write_bytes(b"")
    (root / "empty").mkdir()
    probes = ["", "leres", "leres2", "midas_a", "midas_b", "sgr_a", "sgr_b", "other", "empty",
              "leres/res101.pth", "midas_a/model.pt", "sgr_a/model.pth.tar", "missing"]
    for finder in ("_find_leres_checkpoint", "_find_midas_checkpoint",
                   "_find_sgrnet_checkpoint"):
        for p in probes:
            path = str(root / p) if p else ""
            assert getattr(PDS, finder)(path) == getattr(JDS, finder)(path), (finder, p)


# ---------------------------------------------------------------------------
# The cv2 equivalents
# ---------------------------------------------------------------------------


def _images():
    rng = np.random.default_rng(7)
    out = {}
    for hw in ((512, 512), (384, 512)):
        h, w = hw
        out[("noise", hw)] = rng.random((h, w, 3)).astype(np.float32)
        out[("seed", hw)] = JFB.procedural_text2img("a beautiful garden with flowers", hw=hw)
        ramp = np.linspace(0, 1, w, dtype=np.float32)[None, :, None] * np.linspace(
            0.2, 1, h, dtype=np.float32)[:, None, None]
        out[("ramp", hw)] = np.repeat(ramp, 3, 2).astype(np.float32)
    return out


IMAGES = _images()


@pytest.mark.parametrize("shape", [(512, 512), (384, 512), (448, 448), (512, 256), (100, 37)])
def test_host_ops_equal_cv2(shape):
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(1).random((*shape, 3)).astype(np.float32)
    gray = IO.rgb2gray(img)
    grad = np.abs(cv2.Sobel(gray, cv2.CV_64F, 0, 1, ksize=3)) + np.abs(
        cv2.Sobel(gray, cv2.CV_64F, 1, 0, ksize=3))
    np.testing.assert_array_equal(IO.sobel_grad(gray), grad)
    dim = min(shape)
    sq = cv2.resize(grad, (dim, dim), interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(IO.resize_area(grad, (dim, dim)), sq)
    binary = (sq >= sq.min() + 0.4 * (sq.max() - sq.min())).astype(np.float32)
    for p in (14, 16, 21, 28, 32, 35, 42):
        if p > dim:
            continue
        for src in (binary, sq.astype(np.float32), sq):
            want = cv2.resize(src, (p, p), interpolation=cv2.INTER_AREA)
            np.testing.assert_array_equal(IO.resize_area(src, (p, p)), want)
        small = (cv2.resize(binary, (p, p), interpolation=cv2.INTER_AREA) >= 0.5).astype(
            np.float32)
        np.testing.assert_array_equal(IO.dilate(small, 14),
                                      cv2.dilate(small, np.ones((14, 14), np.float32)))
    np.testing.assert_array_equal(IO.integral(grad), cv2.integral(grad))


@pytest.mark.parametrize("src,dst", [((512, 512), (448, 448)), ((512, 512), (2688, 2688)),
                                     ((384, 512), (1792, 2389)), ((1344, 1344), (1024, 1024)),
                                     ((448, 448), (1024, 1024)), ((213, 197), (896, 896)),
                                     ((1024, 1024), (230, 231)), ((3000, 3000), (97, 130))])
def test_resizes_match_cv2(src, dst):
    cv2 = pytest.importorskip("cv2")
    a = np.random.default_rng(2).random((*src, 3)).astype(np.float32)
    for name, flag in (("cubic", cv2.INTER_CUBIC), ("linear", cv2.INTER_LINEAR)):
        if name == "linear" and src != (3000, 3000):
            continue
        want = cv2.resize(a, dst[::-1], interpolation=flag)
        got = IO.resize(torch.from_numpy(a), dst, name).numpy()
        assert np.abs(got - want).max() <= 1e-6
        got1 = IO.resize(torch.from_numpy(a[..., 0]), dst, name).numpy()
        assert np.abs(got1 - want[..., 0]).max() <= 1e-6


@pytest.mark.parametrize("n,k,sigma", [(1024, 129, 0), (448, 57, 0), (64, 5, 0), (10, 25, 3.0)])
def test_gaussian_blur_matches_cv2(n, k, sigma):
    cv2 = pytest.importorskip("cv2")
    a = np.random.default_rng(4).random((n, n)).astype(np.float32)
    np.testing.assert_array_equal(IO.gaussian_kernel(k, sigma),
                                  cv2.getGaussianKernel(k, sigma, cv2.CV_32F)[:, 0])
    got = IO.gaussian_blur(torch.from_numpy(a), k, sigma).numpy()
    assert np.abs(got - cv2.GaussianBlur(a, (k, k), sigma)).max() <= 1e-6


def test_blend_mask_matches_cv2_at_full_size():
    pytest.importorskip("cv2")
    want = JDS.gaussian_blend_mask((3000, 3000))
    got = IO.gaussian_blend_mask((3000, 3000)).numpy()
    assert got.shape == want.shape and np.abs(got - want).max() <= 5e-6


@pytest.mark.parametrize("spread", [0.3, 1e-3, 1e-5, 0.0])
def test_polyfit_map_matches_numpy(spread):
    # numpy fits fp32 data in fp32 with rcond = n · eps32: a narrow x
    # keeps one direction (the minimum-norm solution) instead of the line
    rng = np.random.default_rng(8)
    x = (0.8 + spread * rng.standard_normal((128, 128))).astype(np.float32)
    y = (3 * x - 1 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", np.exceptions.RankWarning)
        want = np.polyval(np.polyfit(x.reshape(-1), y.reshape(-1), deg=1), x)
    got = IO.polyfit_map(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert np.abs(got - want).max() <= 2e-5 * max(1.0, np.abs(want).max())


# ---------------------------------------------------------------------------
# The decisions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", list(IMAGES), ids=lambda k: f"{k[0]}-{k[1][0]}x{k[1][1]}")
def test_decisions_equal_jax(key):
    pytest.importorskip("cv2")
    img = IMAGES[key]
    for rf in (448, 64):
        got = PDS.calculate_processing_res(img, rf)
        assert got == JDS.calculate_processing_res(img, rf)
        optimal, patch_scale = got
        factor = max(min(1.0, 4 * patch_scale * optimal / 3000), 0.2)
        for base in (2 * rf, 128):
            assert PDS.generate_patches(img, base, factor) == JDS.generate_patches(
                img, base, factor)


# ---------------------------------------------------------------------------
# The booster end to end
# ---------------------------------------------------------------------------


def _jax_base(jnet, params):
    import cv2

    apply = jax.jit(jnet.apply)

    def base_estimate(img, size):
        x = cv2.resize(img, (int(size), int(size)), interpolation=cv2.INTER_CUBIC)
        d = apply({"params": params}, jnp.asarray((x - MEAN) / STD, jnp.float32)[None])
        return cv2.resize(np.asarray(d[0], np.float32), (img.shape[1], img.shape[0]),
                          interpolation=cv2.INTER_CUBIC)

    return base_estimate


@pytest.mark.parametrize("merge", ["fallback", "pix2pix"])
def test_booster_matches_jax(merge):
    pytest.importorskip("cv2")
    img = JFB.procedural_text2img("a beautiful garden with flowers", hw=(96, 96))
    jnet = JL.RelDepthModel(JL.LeReSConfig.tiny())
    params = _random_params(jnet, jnp.zeros((1, 64, 64, 3)), 1)
    net = PD.materialize(lambda: PL.RelDepthModel(PL.LeReSConfig.tiny()), "cpu")
    net.load_state_dict(PW.leres_state_from_flax(params, PL.LeReSConfig.tiny()))
    jmerge = pmerge = None
    if merge == "pix2pix":
        junet = JP.UnetGenerator(input_nc=2, output_nc=1, num_downs=5, ngf=4)
        mp = _random_params(junet, jnp.zeros((1, 128, 128, 2)), 2)
        mapply = jax.jit(junet.apply)

        def jmerge(low, high):
            inp = jnp.stack([JP.minmax_normalize(jnp.asarray(low)),
                             JP.minmax_normalize(jnp.asarray(high))], -1)[None]
            return (np.asarray(mapply({"params": mp}, inp)[0, :, :, 0]) + 1) / 2

        unet = PP.UnetGenerator(2, 1, 5, ngf=4)
        unet.load_state_dict(PP.state_from_flax(mp))
        pmerge = PDS.make_merge_double(unet.requires_grad_(False), "cpu")
    kw = dict(receptive_field=64, pix2pix_size=128, max_patches=3)
    jb = JDS.BoostedDepthEstimator(_jax_base(jnet, params), jmerge, **kw)
    pb = PDS.BoostedDepthEstimator(PDS.make_base_estimate(net, "cpu"), pmerge, device="cpu", **kw)
    want = jb.estimate(img)
    got = pb.estimate(img)
    assert pb.last["patches"] > 0
    assert got.dtype == np.float64 and got.shape == (96, 96)
    assert got.min() == 0 and got.max() == 65535
    assert np.abs(got - want).max() <= 1e-4 * 65535


def test_booster_matches_jax_at_the_default_sizes():
    # receptive field 448, pix2pix 1024, the 512² procedural seed image:
    # processing size 1344, a 2688² enlarged image, 21 patches, one of
    # whose fits numpy cuts to rank 1; a base net that ignores the size
    pytest.importorskip("cv2")
    img = JFB.procedural_text2img("a beautiful garden with flowers", hw=(512, 512))
    sizes = {"jax": [], "port": []}

    def base(side, to_gray):
        def estimate(im, size):
            sizes[side].append((tuple(im.shape[:2]), int(size)))
            return to_gray(im)
        return estimate

    jb = JDS.BoostedDepthEstimator(base("jax", lambda im: (im[..., 0] * 0.5 + im[..., 1])))
    pb = PDS.BoostedDepthEstimator(base("port", lambda im: (im[..., 0] * 0.5 + im[..., 1])),
                                   device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", np.exceptions.RankWarning)
        want = jb.estimate(img)
    got = pb.estimate(img)
    assert sizes["port"] == sizes["jax"] and len(sizes["port"]) == 44
    assert pb.last == {"optimal": 1344, "patches": 21, "img_big": (2688, 2688)}
    assert np.abs(got - want).max() <= 1e-4 * 65535
