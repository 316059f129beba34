"""Boosted monocular depth estimation (port of
``text2nerf_tpu/services/depth_service.py``).

The boosting algorithm: a content-adaptive processing size
(:func:`calculate_processing_res`), a whole-image double estimate (the
base net at the receptive field and at that size, merged), an enlarged
image cut into gradient-dense patches (:func:`generate_patches`), and a
double estimate of each patch merged back into the whole through a
linear fit and the Gaussian blend mask.

- The discrete decisions (the processing size, the patch list) run on
  the host in numpy, with OpenCV's arithmetic
  (:mod:`.image_ops`), so they equal the JAX package's.
- The image work (the cubic and linear resizes, the fallback merge's
  blur, the blend, the fit) and the nets run on the service's device;
  the enlarged image comes back to the host once for the patch
  selection.

:func:`make_depth_estimator` backs the booster with the networks of a
weights directory: LeReS (``res101.pth``), SGRNet (``model.pth.tar``) or
MiDaS (``model.pt``) from their checkpoints, else the weights-free
:class:`..models.monodepth.RelDepthNet` (from a converted ``depth`` tree
or a seeded init); the pix2pix merge from a converted ``merge`` tree,
else the fallback merge.  The depth nets compute in bf16, the merge net
in fp32, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from . import image_ops as ops

WHOLE_SIZE_THRESHOLD = 3000  # R_max
GPU_THRESHOLD = 1600 - 32    # the largest single-pass size


def calculate_processing_res(img: np.ndarray, basesize: int, confidence: float = 0.2,
                             scale_threshold: int = 3,
                             whole_size_threshold: int = WHOLE_SIZE_THRESHOLD):
    """The processing size R_x: grow it while no more than ``confidence``
    of the pixels lose every contextual cue (the edge map, shrunk to the
    size, dilated by a receptive-field-sized box).  Returns (size,
    size / basesize)."""
    speed_scale = 32
    image_dim = int(min(img.shape[:2]))
    grad = ops.sobel_grad(ops.rgb2gray(img))
    grad = ops.resize_area(grad, (image_dim, image_dim))
    middle = grad.min() + 0.4 * (grad.max() - grad.min())
    grad = (grad >= middle).astype(np.float32)

    k = max(int(basesize / speed_scale), 1)
    threshold = min(whole_size_threshold, scale_threshold * max(img.shape[:2]))
    outputsize_scale = basesize / speed_scale
    for p_size in range(int(basesize / speed_scale), int(threshold / speed_scale),
                        max(int(basesize / (2 * speed_scale)), 1)):
        grad_resized = (ops.resize_area(grad, (p_size, p_size)) >= 0.5).astype(np.float32)
        dilated = ops.dilate(grad_resized, k)
        if (1 - dilated).mean() > confidence:
            break
        outputsize_scale = p_size

    optimal = int(outputsize_scale * speed_scale)
    return optimal, optimal / max(basesize, 1)


def _box_sum(integral, rect):
    x, y, w, h = rect
    return (integral[y + h, x + w] - integral[y, x + w]
            - integral[y + h, x] + integral[y, x])


def generate_patches(img: np.ndarray, base_size: int, factor: float) -> List[Dict]:
    """Gradient-driven patch selection: a grid of receptive-field
    patches, those denser in gradients than the whole image kept, each
    grown while its density stays above the image's; biggest first."""
    h, w = img.shape[:2]
    grad = ops.sobel_grad(ops.rgb2gray(img))
    pos = grad[grad > 0]
    thr = pos.mean() if pos.size else 0.0
    grad[grad < thr] = 0
    gf = grad.sum() / grad.size
    integral = ops.integral(grad)

    blsize = int(round(base_size / 2))
    stride = int(round(blsize * 0.75))
    search_step = max(int(32 / max(factor, 1e-6)), 1)

    patches = []
    for y in range(0, max(h - blsize, 1), stride):
        for x in range(0, max(w - blsize, 1), stride):
            rect = [x, y, min(blsize, w - x - 1), min(blsize, h - y - 1)]
            if rect[2] < 8 or rect[3] < 8:
                continue
            if _box_sum(integral, rect) / (rect[2] * rect[3]) < gf:
                continue
            bbox, test = rect.copy(), rect.copy()
            while True:
                test = [test[0] - search_step // 2, test[1] - search_step // 2,
                        test[2] + search_step, test[3] + search_step]
                if (test[0] < 0 or test[1] < 0
                        or test[1] + test[3] >= h or test[0] + test[2] >= w):
                    break
                if _box_sum(integral, test) / (test[2] * test[3]) < gf:
                    break
                bbox = test.copy()
            patches.append({"rect": bbox, "size": bbox[2]})
    patches.sort(key=lambda p: p["size"], reverse=True)
    return patches


def _minmax01(x, eps):
    lo, hi = x.min(), x.max()
    return (x - lo) / torch.clamp(hi - lo, min=eps)


class BoostedDepthEstimator:
    """The booster over an injected base estimator
    ``base_estimate(img, size)`` ((h, w, 3) fp32 tensor → (h, w) fp32
    tensor on ``device``) and merger ``merge_double(low, high)`` ((p, p)
    tensors → (p, p)); the fallback merge when none is given."""

    def __init__(self, base_estimate: Callable, merge_double: Optional[Callable] = None,
                 receptive_field: int = 448, pix2pix_size: int = 1024,
                 max_patches: Optional[int] = None, device=None):
        self.base_estimate = base_estimate
        self.merge_double = merge_double or self._fallback_merge
        self.rf = receptive_field
        self.pix2pix_size = pix2pix_size
        self.max_patches = max_patches
        self.device = resolve_device(device)
        self._mask3000 = None
        #: the last estimate's processing size and its patches (after the
        #: size filter), for callers that report them
        self.last = {}

    @staticmethod
    def _fallback_merge(low, high):
        """The weights-free merge: the low-resolution estimate's structure
        plus the high-resolution one's detail (itself minus its Gaussian
        low-pass), min-max normalized."""
        k = max(int(low.shape[0] / 16) * 2 + 1, 3)
        merged = low + (high - ops.gaussian_blur(high, k, 0))
        return _minmax01(merged, 1e-12)

    def _double_estimate(self, img, size1, size2):
        size2 = min(size2, GPU_THRESHOLD)
        e1 = self.base_estimate(img, min(size1, GPU_THRESHOLD))
        e2 = self.base_estimate(img, size2)
        p = self.pix2pix_size
        m = self.merge_double(ops.resize(e1, (p, p)), ops.resize(e2, (p, p)))
        return _minmax01(m, 1e-12)

    @torch.no_grad()
    def estimate(self, img: np.ndarray, output_input_res: bool = True) -> np.ndarray:
        """(H, W, 3) image in [0, 1] → float64 16-bit counts, 65535 ·
        the min-max normalized estimate."""
        img = np.asarray(img, np.float32)
        dev = self.device
        x = torch.from_numpy(img).to(dev)
        input_res = img.shape
        optimal, patch_scale = calculate_processing_res(img, self.rf)
        whole = self._double_estimate(x, self.rf, optimal)

        factor = max(min(1.0, 4 * patch_scale * optimal / WHOLE_SIZE_THRESHOLD), 0.2)
        if img.shape[0] > img.shape[1]:
            a, b = 2 * optimal, round(2 * optimal * img.shape[1] / img.shape[0])
        else:
            a, b = round(2 * optimal * img.shape[0] / img.shape[1]), 2 * optimal
        a, b = int(round(a / factor)), int(round(b / factor))
        img_big = ops.resize(x, (a, b))

        patches = generate_patches(img_big.cpu().numpy(), self.rf * 2, factor)
        if self.max_patches is not None:
            patches = patches[: self.max_patches]

        mergein_scale = input_res[0] / a
        estimate = ops.resize(whole, (round(a * mergein_scale), round(b * mergein_scale)))
        if self._mask3000 is None:
            self._mask3000 = ops.gaussian_blend_mask((3000, 3000), dev)

        merged = 0
        p = self.pix2pix_size
        for patch in patches:
            px, py, pw, ph = patch["rect"]
            xo, yo = int(round(px * mergein_scale)), int(round(py * mergein_scale))
            wo, ho = int(round(pw * mergein_scale)), int(round(ph * mergein_scale))
            if wo < 8 or ho < 8:
                continue
            patch_est = self._double_estimate(img_big[py: py + ph, px: px + pw],
                                              self.rf, self.rf * 2)
            base_patch = estimate[yo: yo + ho, xo: xo + wo]
            base_up = ops.resize(base_patch, (p, p))
            mapped = ops.polyfit_map(self.merge_double(base_up, patch_est), base_up)
            mapped = ops.resize(mapped, (ho, wo))
            blend = ops.resize(self._mask3000, (ho, wo), "linear")
            estimate[yo: yo + ho, xo: xo + wo] = base_patch * (1 - blend) + mapped * blend
            merged += 1
        self.last = {"optimal": optimal, "patches": merged, "img_big": (a, b)}

        if output_input_res:
            estimate = ops.resize(estimate, tuple(input_res[:2]))
        norm = _minmax01(estimate, float(np.finfo(np.float32).eps))
        return (65535.0 * norm).cpu().numpy().astype(np.float64)


# ---------------------------------------------------------------------------
# Checkpoint search paths (the reference's weights layout)
# ---------------------------------------------------------------------------


def _find_checkpoint(weights_path: str, names, parent: str, suffix: str):
    if not weights_path:
        return None
    candidates = [weights_path]
    if os.path.isdir(weights_path):
        candidates += [os.path.join(weights_path, names[0]),
                       os.path.join(weights_path, *names[1]),
                       os.path.join(os.path.dirname(weights_path), *parent)]
    for cand in candidates:
        if os.path.isfile(cand) and cand.endswith(suffix):
            return cand
    return None


def _find_leres_checkpoint(weights_path: str):
    """``res101.pth``: the path itself, inside it, under
    ``pix2pix/checkpoints/``, or the reference's
    ``weights_BoostingMonocularDepth/pix2pix/checkpoints/`` beside it."""
    return _find_checkpoint(
        weights_path, ("res101.pth", ("pix2pix", "checkpoints", "res101.pth")),
        ("weights_BoostingMonocularDepth", "pix2pix", "checkpoints", "res101.pth"), ".pth")


def _find_midas_checkpoint(weights_path: str):
    """``model.pt``: the path, inside it, under ``midas/``, or the
    reference's ``weights_BoostingMonocularDepth/midas/`` beside it."""
    return _find_checkpoint(
        weights_path, ("model.pt", ("midas", "model.pt")),
        ("weights_BoostingMonocularDepth", "midas", "model.pt"), ".pt")


def _find_sgrnet_checkpoint(weights_path: str):
    """``model.pth.tar``: the path, inside it, under ``structuredrl/``, or
    ``structuredrl/`` beside it."""
    return _find_checkpoint(
        weights_path, ("model.pth.tar", ("structuredrl", "model.pth.tar")),
        ("structuredrl", "model.pth.tar"), ".pth.tar")


# ---------------------------------------------------------------------------
# The estimator of a weights directory
# ---------------------------------------------------------------------------


def make_base_estimate(model, device, midas_aspect: bool = False):
    """``base_estimate(img, size)`` of a depth net: ``img`` cubic-resized to
    size² (MiDaS: its aspect-keeping multiple-of-32 shape), ImageNet-
    normalized in fp64, one forward, the output cubic-resized back to the
    image's size, fp32."""
    from ..models.midas import midas_resize_shape

    mean = torch.tensor([0.485, 0.456, 0.406], dtype=torch.float64, device=device)
    std = torch.tensor([0.229, 0.224, 0.225], dtype=torch.float64, device=device)

    def base_estimate(img, size):
        h, w = img.shape[:2]
        sz = int(size)
        shape = midas_resize_shape(h, w, sz) if midas_aspect else (sz, sz)
        x = ((ops.resize(img, shape).double() - mean) / std).float()
        d = model(x.permute(2, 0, 1)[None].contiguous())[0].float()
        return ops.resize(d, (h, w))

    return base_estimate


def make_merge_double(merge_net, device, dtype=torch.float32):
    """``merge_double(low, high)`` of the pix2pix merge generator
    (2 channels in): each input min-max normalized to [−1, 1], one
    forward, the output mapped to [0, 1]."""
    from ..models.pix2pix import minmax_normalize

    def merge_double(low, high):
        inp = torch.stack([minmax_normalize(low), minmax_normalize(high)], 0)[None]
        return (merge_net(inp.to(device), dtype)[0, 0].float() + 1) / 2

    return merge_double


def _net_maker(weights_path: str, net: str):
    """(make, checkpoint loader or None, MiDaS aspect) of the net that
    ``weights_path`` holds for the family ``net``."""
    from ..models.leres import LeReSConfig, RelDepthModel, SGRNetDepth
    from ..models.midas import MidasNet
    from . import weights as W

    bf16 = torch.bfloat16
    ckpt = {"leres": _find_leres_checkpoint, "sgrnet": _find_sgrnet_checkpoint,
            "midas": _find_midas_checkpoint}[net](weights_path)
    if ckpt is None:
        return None
    if net == "leres":
        cfg = LeReSConfig.resnext101()
        return lambda: RelDepthModel(cfg, bf16), lambda m: W.load_leres_checkpoint(ckpt, m), False
    if net == "sgrnet":
        cfg = LeReSConfig.resnet50()
        return lambda: SGRNetDepth(cfg, bf16), lambda m: W.load_sgrnet_checkpoint(ckpt, m), False
    cfg = LeReSConfig.resnext101()
    return lambda: MidasNet(cfg, dtype=bf16), lambda m: W.load_midas_checkpoint(ckpt, m), True


def standin_config(net: str):
    """The weights-free RelDepthNet's configuration for a family."""
    from ..models.monodepth import DepthNetConfig

    return {"leres": DepthNetConfig.leres, "midas": DepthNetConfig.midas,
            "sgrnet": DepthNetConfig.sgrnet}[net]()


def make_depth_estimator(weights_path: str, net: str = "leres", *, device=None):
    """The depth service: the ``estimate`` of a booster on ``device`` (cuda
    unless asked) backed by the nets of ``weights_path`` (see the module
    docstring; the booster is its ``__self__``, its depth net the
    booster's ``model``).  A checkpoint that the search paths find and
    that does not load raises."""
    from ..models import monodepth as MD
    from ..models.diffusion import materialize
    from ..models.pix2pix import UnetGenerator, state_from_flax
    from . import weights as W

    dev = resolve_device(device)
    converted = W.load_converted(weights_path)
    found = _net_maker(weights_path, net)
    if found is not None:
        make, load, midas_aspect = found
        model = load(materialize(make, torch.device("cpu"))).to(dev)
    else:
        cfg, midas_aspect = standin_config(net), False

        def make():
            return MD.RelDepthNet(cfg, torch.bfloat16)

        if converted is not None and "depth" in converted:
            model = materialize(make, dev)
            model.load_state_dict(W.reldepthnet_state_from_flax(converted["depth"], cfg))
        else:
            model = materialize(make, dev, torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(False).eval()

    merge_double = None
    if converted is not None and "merge" in converted:
        merge_net = UnetGenerator(input_nc=2, output_nc=1, num_downs=10)
        merge_net.load_state_dict(state_from_flax(converted["merge"]))
        merge_double = make_merge_double(merge_net.to(dev).requires_grad_(False), dev)
    booster = BoostedDepthEstimator(make_base_estimate(model, dev, midas_aspect),
                                    merge_double, device=dev)
    booster.model = model
    return booster.estimate
