"""The LeReS relative-depth network (port of ``text2nerf_tpu/models/leres.py``),
NCHW: the default base estimator of the boosted depth stack.

- :class:`ResNetEncoder`: the torchvision ResNet / ResNeXt stride-32
  pyramid (V1.5 bottlenecks, stride on the grouped 3x3), returning the
  features at 1/4, 1/8, 1/16 and 1/32.
- :class:`LeReSDecoder`: FTB(2048 → 512) → conv(512 → 256) → x2 → FFM
  at 1/16, 1/8, 1/4 → AO(256 → 1), every upsample bilinear with
  align_corners=True (:func:`resize_bilinear_align_corners`).
- :class:`RelDepthModel`: (B, 3, H, W) ImageNet-normalized RGB → (B, H,
  W) raw relative-depth logits, H and W multiples of 32.  Its entries
  carry the names of the reference's ``res101.pth``
  (``depth_model.encoder_modules.*``, ``depth_model.decoder_modules.*``);
  :class:`SGRNetDepth` is the same network under ``encoder.*`` /
  ``decoder.*``, SGRNet's ``model.pth.tar`` layout.

BatchNorms are frozen (:class:`FrozenBatchNorm`, the running statistics
held as buffers).  ``dtype`` is the compute type, as flax's ``dtype=``:
convolutions cast their input, kernel and bias to it and return it; a
FrozenBatchNorm keeps its fp32 parameters, so its output is fp32 (JAX's
promotion of bf16 with fp32), and so is the encoder's residual stream
between bf16 convolutions; the align-corners resize weights are fp32, so
the decoder's upsampled features are fp32 too.

A seeded init (:func:`..models.diffusion.materialize` with a generator)
draws flax's: LeCun-normal conv kernels, zero biases, identity
BatchNorms.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .diffusion import conv

# ImageNet normalization of estimateleres (the reference's scale_torch)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class FrozenBatchNorm(nn.Module):
    """Inference BatchNorm2d: ``(x - mean) · rsqrt(var + eps) · weight +
    bias`` with fp32 parameters (torch's names, so a BatchNorm2d's state
    loads by key; ``num_batches_tracked`` is not kept)."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    @torch.no_grad()
    def init_extra_(self, generator=None):
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shape = (1, -1, 1, 1)
        return (x - self.running_mean.view(shape)) * inv.view(shape) + self.bias.view(shape)


def align_corners_grid(n_in: int, n_out: int, device=None):
    """The source coordinates of an align-corners resize, fp32, as the
    JAX package's ``jnp.linspace(0, n_in - 1, n_out)`` comes out of XLA
    on the CPU: ``((n_in - 1) · fl(1 / (n_out - 1))) · i``, the last one
    exactly ``n_in - 1``; computed on ``device`` (no host copy)."""
    grid = torch.zeros(n_out, dtype=torch.float32, device=device)
    if n_out > 1:
        step = np.float32(n_in - 1) * (np.float32(1.0) / np.float32(n_out - 1))
        grid = torch.arange(n_out, dtype=torch.float32, device=device) * float(step)
        grid[-1] = n_in - 1
    return grid


def resize_bilinear_align_corners(x, out_hw: Tuple[int, int]):
    """(B, C, H, W) → (B, C, Ho, Wo), bilinear on the align-corners grid
    (source index i_out · (H_in − 1) / (H_out − 1)), fp32 weights: rows
    first, then columns, in the JAX package's order of operations."""
    _, _, h, w = x.shape
    ho, wo = out_hw

    def taps(n_in, n_out):
        s = align_corners_grid(n_in, n_out, x.device)
        i0 = torch.floor(s).long()
        return i0, torch.clamp(i0 + 1, max=n_in - 1), s - i0

    y0, y1, wy = taps(h, ho)
    x0, x1, wx = taps(w, wo)
    wy = wy.view(1, 1, -1, 1)
    rows = x[:, :, y0] * (1 - wy) + x[:, :, y1] * wy
    return rows[..., x0] * (1 - wx) + rows[..., x1] * wx


class Bottleneck(nn.Module):
    """torchvision's V1.5 bottleneck (stride on the 3x3), grouped for
    ResNeXt; ``downsample`` (conv, BN) where the shape changes."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, groups: int = 1,
                 base_width: int = 64, has_downsample: bool = False, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        width = int(planes * base_width / 64.0) * groups
        out_ch = planes * 4
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, groups=groups, bias=False)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = nn.Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, out_ch, 1, stride, bias=False), FrozenBatchNorm(out_ch)
        ) if has_downsample else None

    def forward(self, x):
        dt = self.dtype
        h = F.relu(self.bn1(conv(self.conv1, x, dt)))
        h = F.relu(self.bn2(conv(self.conv2, h, dt)))
        h = self.bn3(conv(self.conv3, h, dt))
        if self.downsample is not None:
            x = self.downsample[1](conv(self.downsample[0], x, dt))
        return F.relu(x + h)


@dataclasses.dataclass(frozen=True)
class LeReSConfig:
    blocks: Tuple[int, ...] = (3, 4, 23, 3)
    planes: Tuple[int, ...] = (64, 128, 256, 512)
    groups: int = 32
    base_width: int = 8
    # the decoder's mid widths
    mid: Tuple[int, ...] = (256, 256, 256, 512)

    @staticmethod
    def resnext101():  # res101.pth
        return LeReSConfig()

    @staticmethod
    def resnet50():  # SGRNet's encoder
        return LeReSConfig(blocks=(3, 4, 6, 3), groups=1, base_width=64)

    @staticmethod
    def tiny():
        return LeReSConfig(blocks=(1, 1, 1, 1), planes=(8, 16, 32, 64), groups=2,
                           base_width=8, mid=(16, 16, 16, 32))


class ResNetEncoder(nn.Module):
    """The stem (7x7/2 conv, BN, ReLU, 3x3/2 max-pool) and the four
    stages ``layer1`` .. ``layer4``; returns each stage's output."""

    def __init__(self, cfg: LeReSConfig, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        c = cfg
        self.conv1 = nn.Conv2d(3, c.planes[0], 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(c.planes[0])
        inplanes = c.planes[0]
        for s, (planes, n_blocks) in enumerate(zip(c.planes, c.blocks)):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and s > 0) else 1
                has_ds = b == 0 and (stride != 1 or inplanes != planes * 4)
                blocks.append(Bottleneck(inplanes, planes, stride, c.groups, c.base_width,
                                         has_ds, dtype))
                inplanes = planes * 4
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        h = F.relu(self.bn1(conv(self.conv1, x, self.dtype)))
        h = F.max_pool2d(h, 3, 2, 1)
        feats = []
        for s in range(4):
            h = getattr(self, f"layer{s + 1}")(h)
            feats.append(h)
        return feats


class FTB(nn.Module):
    """Feature-transfer block: a 3x3 conv, then the residual branch
    ReLU → conv → BN → ReLU → conv (``conv_branch`` indices 1, 2, 4)."""

    def __init__(self, inchannels: int, mid: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(inchannels, mid, 3, padding=1)
        self.conv_branch = nn.Sequential(
            nn.ReLU(), nn.Conv2d(mid, mid, 3, padding=1), FrozenBatchNorm(mid), nn.ReLU(),
            nn.Conv2d(mid, mid, 3, padding=1))

    def forward(self, x):
        dt = self.dtype
        x = conv(self.conv1, x, dt)
        h = conv(self.conv_branch[1], F.relu(x), dt)
        h = F.relu(self.conv_branch[2](h))
        h = conv(self.conv_branch[4], h, dt)
        return F.relu(x + h)


class FFM(nn.Module):
    """Feature fusion: FTB(low) + high → FTB → x``upfactor`` align-corners
    upsample."""

    def __init__(self, inchannels: int, mid: int, out: int, upfactor: int = 2,
                 dtype=torch.float32):
        super().__init__()
        self.upfactor = upfactor
        self.ftb1 = FTB(inchannels, mid, dtype)
        self.ftb2 = FTB(mid, out, dtype)

    def forward(self, low, high):
        x = self.ftb2(self.ftb1(low) + high)
        h, w = x.shape[-2:]
        return resize_bilinear_align_corners(x, (h * self.upfactor, w * self.upfactor))


class AO(nn.Module):
    """Adaptive output head: conv → BN → ReLU → conv → x``upfactor``
    upsample (``adapt_conv`` indices 0, 1, 3)."""

    def __init__(self, inchannels: int, out: int = 1, upfactor: int = 2, dtype=torch.float32):
        super().__init__()
        self.dtype, self.upfactor = dtype, upfactor
        self.adapt_conv = nn.Sequential(
            nn.Conv2d(inchannels, inchannels // 2, 3, padding=1),
            FrozenBatchNorm(inchannels // 2), nn.ReLU(),
            nn.Conv2d(inchannels // 2, out, 3, padding=1))

    def forward(self, x):
        dt = self.dtype
        h = F.relu(self.adapt_conv[1](conv(self.adapt_conv[0], x, dt)))
        h = conv(self.adapt_conv[3], h, dt)
        hh, ww = h.shape[-2:]
        return resize_bilinear_align_corners(h, (hh * self.upfactor, ww * self.upfactor))


class LeReSDecoder(nn.Module):
    """The top-down FTB / FFM / AO decoder over the encoder's four
    features."""

    def __init__(self, cfg: LeReSConfig, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        mid = cfg.mid
        inch = [p * 4 for p in cfg.planes]  # the stages' widths
        self.conv = FTB(inch[3], mid[3], dtype)
        self.conv1 = nn.Conv2d(mid[3], mid[2], 3, padding=1)
        self.ffm2 = FFM(inch[2], mid[2], mid[2], dtype=dtype)
        self.ffm1 = FFM(inch[1], mid[1], mid[1], dtype=dtype)
        self.ffm0 = FFM(inch[0], mid[0], mid[0], dtype=dtype)
        self.outconv = AO(mid[0], 1, 2, dtype)

    def forward(self, feats):
        x = conv(self.conv1, self.conv(feats[3]), self.dtype)
        h, w = x.shape[-2:]
        x = resize_bilinear_align_corners(x, (h * 2, w * 2))
        x = self.ffm2(feats[2], x)
        x = self.ffm1(feats[1], x)
        x = self.ffm0(feats[0], x)
        return self.outconv(x)


class _EncoderDecoder(nn.Module):
    """LeReS's ``depth_model``: ``encoder_modules`` and ``decoder_modules``."""

    def __init__(self, cfg: LeReSConfig, dtype=torch.float32):
        super().__init__()
        self.encoder_modules = ResNetEncoder(cfg, dtype)
        self.decoder_modules = LeReSDecoder(cfg, dtype)

    def forward(self, x):
        return self.decoder_modules(self.encoder_modules(x))


class RelDepthModel(nn.Module):
    """(B, 3, H, W) ImageNet-normalized RGB → (B, H, W) raw relative-depth
    logits (no activation), under the ``res101.pth`` names."""

    def __init__(self, cfg: LeReSConfig = LeReSConfig(), dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.depth_model = _EncoderDecoder(cfg, dtype)

    def forward(self, x):
        return self.depth_model(x)[:, 0]


class SGRNetDepth(nn.Module):
    """:class:`RelDepthModel` (ResNet-50 by default) under SGRNet's
    ``encoder.*`` / ``decoder.*`` names."""

    def __init__(self, cfg: LeReSConfig = LeReSConfig.resnet50(), dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.encoder = ResNetEncoder(cfg, dtype)
        self.decoder = LeReSDecoder(cfg, dtype)

    def forward(self, x):
        return self.decoder(self.encoder(x))[:, 0]


def normalize_imagenet(rgb01):
    """(..., 3, H, W) RGB in [0, 1] → ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=rgb01.dtype, device=rgb01.device).view(3, 1, 1)
    std = torch.tensor(IMAGENET_STD, dtype=rgb01.dtype, device=rgb01.device).view(3, 1, 1)
    return (rgb01 - mean) / std
