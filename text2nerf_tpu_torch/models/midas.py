"""The MiDaS v2.1 monocular depth network (port of
``text2nerf_tpu/models/midas.py``), NCHW: the boosted stack's base
estimator when a ``midas/model.pt`` is given.

- ``pretrained``: the ResNeXt-101 32x8d pyramid of
  :class:`..models.leres.ResNetEncoder`, under MiDaS's names
  (``pretrained.layer1`` is the stem and stage 1 in one Sequential: conv
  at 0, BN at 1, stage 1's blocks at 4);
- ``scratch``: four bias-free 3x3 convs to ``features`` channels
  (``layerN_rn``), the RefineNet fusion blocks ``refinenet4`` ..
  ``refinenet1`` (two residual conv units, x2 align-corners upsample)
  and the head ``output_conv`` (conv → x2 bilinear → conv → ReLU → 1x1
  conv → ReLU), so ``model.pt``'s state dict loads by key.

(B, 3, H, W) ImageNet-normalized RGB → (B, H, W) inverse depth; H and W
multiples of 32.  ``dtype`` as in :mod:`.leres`.  The head's x2 upsample
(``align_corners=False``) is ``F.interpolate``'s bilinear, which for an
integer upsampling factor computes ``jax.image.resize``'s.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .diffusion import conv
from .leres import LeReSConfig, ResNetEncoder, resize_bilinear_align_corners


class ResidualConvUnit(nn.Module):
    """ReLU → conv → ReLU → conv, plus the input."""

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        h = conv(self.conv1, F.relu(x), self.dtype)
        return conv(self.conv2, F.relu(h), self.dtype) + x


class FeatureFusionBlock(nn.Module):
    """The lateral input through ``resConfUnit1`` added, ``resConfUnit2``,
    then x2 align-corners upsample."""

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features, dtype)
        self.resConfUnit2 = ResidualConvUnit(features, dtype)

    def forward(self, x, skip=None):
        out = x if skip is None else x + self.resConfUnit1(skip)
        out = self.resConfUnit2(out)
        h, w = out.shape[-2:]
        return resize_bilinear_align_corners(out, (h * 2, w * 2))


class _Pretrained(nn.Module):
    """The encoder under MiDaS's names; runs :class:`ResNetEncoder`'s
    forward on the stem and stages it holds."""

    def __init__(self, cfg: LeReSConfig, dtype=torch.float32):
        super().__init__()
        enc = ResNetEncoder(cfg, dtype)
        self.dtype = dtype
        self.layer1 = nn.Sequential(enc.conv1, enc.bn1, nn.ReLU(), nn.MaxPool2d(3, 2, 1),
                                    enc.layer1)
        self.layer2, self.layer3, self.layer4 = enc.layer2, enc.layer3, enc.layer4

    def forward(self, x):
        h = F.relu(self.layer1[1](conv(self.layer1[0], x, self.dtype)))
        h = self.layer1[4](F.max_pool2d(h, 3, 2, 1))
        feats = [h]
        for layer in (self.layer2, self.layer3, self.layer4):
            h = layer(h)
            feats.append(h)
        return feats


class _Scratch(nn.Module):
    def __init__(self, cfg: LeReSConfig, features: int, dtype=torch.float32):
        super().__init__()
        for i, p in enumerate(cfg.planes):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(p * 4, features, 3, padding=1,
                                                          bias=False))
        for k in range(1, 5):
            setattr(self, f"refinenet{k}", FeatureFusionBlock(features, dtype))
        self.output_conv = nn.Sequential(
            nn.Conv2d(features, 128, 3, padding=1), nn.Identity(),
            nn.Conv2d(128, 32, 3, padding=1), nn.ReLU(), nn.Conv2d(32, 1, 1), nn.ReLU())


class MidasNet(nn.Module):
    """(B, 3, H, W) → (B, H, W) inverse depth (see the module docstring)."""

    def __init__(self, cfg: LeReSConfig = LeReSConfig(), features: int = 256,
                 non_negative: bool = True, dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype, self.non_negative = cfg, dtype, non_negative
        self.pretrained = _Pretrained(cfg, dtype)
        self.scratch = _Scratch(cfg, features, dtype)

    def forward(self, x):
        dt, s = self.dtype, self.scratch
        rn = [conv(getattr(s, f"layer{i + 1}_rn"), f, dt)
              for i, f in enumerate(self.pretrained(x))]
        p = s.refinenet4(rn[3])
        p = s.refinenet3(p, rn[2])
        p = s.refinenet2(p, rn[1])
        p = s.refinenet1(p, rn[0])
        out = conv(s.output_conv[0], p, dt)
        out = F.interpolate(out, scale_factor=2, mode="bilinear", align_corners=False)
        out = F.relu(conv(s.output_conv[2], out, dt))
        out = conv(s.output_conv[4], out, dt)
        if self.non_negative:
            out = F.relu(out)
        return out[:, 0]


def midas_resize_shape(h: int, w: int, target: int = 384,
                       multiple_of: int = 32) -> Tuple[int, int]:
    """The MiDaS Resize transform's output shape (keep the aspect ratio,
    ``upper_bound``, each side a multiple of 32): the smaller scale bounds
    both sides, each rounded to a multiple of 32 but floored when over
    the target."""

    def constrain(x):
        y = int(round(x / multiple_of) * multiple_of)
        if y > target:
            y = int(x // multiple_of * multiple_of)
        return max(y, multiple_of)

    scale = min(target / h, target / w)
    return constrain(scale * h), constrain(scale * w)
