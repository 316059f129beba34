"""The weights-free relative-depth network (port of ``RelDepthNet`` and
``DepthNetConfig`` from ``text2nerf_tpu/models/monodepth.py``), NCHW.

What the boosted depth service runs for a ``leres/`` (or ``midas``,
``sgrnet``) entry that holds no checkpoint: a stride-32 pyramid of
GroupNorm bottlenecks, a top-down decoder (lateral 1x1 convs, bilinear
upsample-add, 3x3 smoothing), a head at 1/4 resolution upsampled to the
input size, and softplus.  (B, 3, H, W) → (B, H, W); any H and W.

Entry names are the port's own; :func:`reldepthnet_name_map` maps each
to the flax path of the JAX module (``Conv_k``, ``GroupNorm_k``,
``Bottleneck_i``, numbered in creation order).  ``dtype`` as in
:mod:`.leres`; GroupNorms (eps 1e-6, flax's) take their statistics in
fp32 and return ``dtype``.  The bilinear resizes are ``F.interpolate``'s
(``align_corners=False``), ``jax.image.resize``'s for upsampling.

:func:`sync_batch_norm` / :class:`SyncBatchNorm` are the JAX module's
cross-device batch norm (the reference's syncbn extension): per-channel
sum and square sum all-reduced over a ``torch.distributed`` group, with
autograd through the collective.  No inference path calls them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .diffusion import conv, group_norm


def sync_batch_norm(x, group=None, eps: float = 1e-5):
    """Batch normalization of ``x`` (N, C, ...) with statistics over every
    axis but the channel axis 1, summed over the ranks of ``group`` (a
    ``torch.distributed`` process group; None: this process alone).  The
    all-reduce is ``torch.distributed.nn.functional.all_reduce``, so the
    backward pass sums the statistics' gradients over the ranks."""
    dims = [0, *range(2, x.ndim)]
    n = x.numel() // x.shape[1]
    s = torch.sum(x, dim=dims)
    ss = torch.sum(x * x, dim=dims)
    if group is not None:
        import torch.distributed as dist
        from torch.distributed.nn.functional import all_reduce

        s = all_reduce(s, group=group)
        ss = all_reduce(ss, group=group)
        n = n * dist.get_world_size(group)
    mean = s / n
    var = ss / n - mean * mean
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return (x - mean.reshape(shape)) * torch.rsqrt(var + eps).reshape(shape)


class SyncBatchNorm(nn.Module):
    """Batch norm with optional cross-rank statistics and a learned affine
    (``scale`` ones, ``bias`` zeros); ``use_running_average`` normalizes
    with the ``mean`` / ``var`` buffers (zeros / ones) instead."""

    def __init__(self, channels: int, group=None):
        super().__init__()
        self.group = group
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x, use_running_average: bool = True):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if use_running_average:
            xn = (x - self.mean.reshape(shape)) * torch.rsqrt(self.var + 1e-5).reshape(shape)
        else:
            xn = sync_batch_norm(x, self.group)
        return xn * self.scale.reshape(shape) + self.bias.reshape(shape)


def _gn(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, ch), ch, eps=1e-6)


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, width: int, stride: int = 1, groups: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        out_ch = width * 4
        groups = groups if width % groups == 0 else 1
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.norm1 = _gn(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, groups=groups, bias=False)
        self.norm2 = _gn(width)
        self.conv3 = nn.Conv2d(width, out_ch, 1, bias=False)
        self.norm3 = _gn(out_ch)
        self.down = None
        if in_ch != out_ch or stride != 1:
            self.down = nn.Sequential(nn.Conv2d(in_ch, out_ch, 1, stride, bias=False),
                                      _gn(out_ch))

    def forward(self, x):
        dt = self.dtype
        h = F.relu(group_norm(self.norm1, conv(self.conv1, x, dt), dt))
        h = F.relu(group_norm(self.norm2, conv(self.conv2, h, dt), dt))
        h = group_norm(self.norm3, conv(self.conv3, h, dt), dt)
        if self.down is not None:
            x = group_norm(self.down[1], conv(self.down[0], x, dt), dt)
        return F.relu(x + h)


@dataclasses.dataclass(frozen=True)
class DepthNetConfig:
    blocks: Tuple[int, ...] = (3, 4, 6, 3)
    base_width: int = 64
    groups: int = 1
    decoder_width: int = 256

    @staticmethod
    def leres():
        return DepthNetConfig(blocks=(3, 4, 23, 3), groups=32, base_width=128)

    @staticmethod
    def midas():
        return DepthNetConfig(blocks=(3, 4, 6, 3))

    @staticmethod
    def sgrnet():
        return DepthNetConfig(blocks=(3, 4, 6, 3))

    @staticmethod
    def tiny():
        return DepthNetConfig(blocks=(1, 1, 1, 1), base_width=8, decoder_width=16)


class RelDepthNet(nn.Module):
    """See the module docstring."""

    def __init__(self, cfg: DepthNetConfig, dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        c = cfg
        self.stem_conv = nn.Conv2d(3, c.base_width, 7, 2, 3, bias=False)
        self.stem_norm = _gn(c.base_width)
        blocks, stage_ch = [], []
        in_ch, width = c.base_width, c.base_width
        for stage, n_blocks in enumerate(c.blocks):
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                blocks.append(Bottleneck(in_ch, width, stride, c.groups, dtype))
                in_ch = width * 4
            stage_ch.append(in_ch)
            width *= 2
        self.blocks = nn.ModuleList(blocks)
        dw = c.decoder_width
        # laterals[0] takes the last stage, laterals[j] stage -1-j
        self.laterals = nn.ModuleList([nn.Conv2d(ch, dw, 1) for ch in stage_ch[::-1]])
        self.smooths = nn.ModuleList([nn.Conv2d(dw, dw, 3, padding=1)
                                      for _ in stage_ch[:-1]])
        self.head1 = nn.Conv2d(dw, dw // 2, 3, padding=1)
        self.head2 = nn.Conv2d(dw // 2, 1, 3, padding=1)

    def forward(self, x):
        dt, c = self.dtype, self.cfg
        h = F.relu(group_norm(self.stem_norm, conv(self.stem_conv, x, dt), dt))
        h = F.max_pool2d(h, 3, 2, 1)
        feats, i = [], 0
        for n_blocks in c.blocks:
            for _ in range(n_blocks):
                h = self.blocks[i](h)
                i += 1
            feats.append(h)
        d = conv(self.laterals[0], feats[-1], dt)
        for j, f in enumerate(feats[-2::-1]):
            lat = conv(self.laterals[j + 1], f, dt)
            d = F.interpolate(d, size=lat.shape[-2:], mode="bilinear", align_corners=False)
            d = F.relu(conv(self.smooths[j], d + lat, dt))
        d = F.relu(conv(self.head1, d, dt))
        d = F.interpolate(d, size=x.shape[-2:], mode="bilinear", align_corners=False)
        return F.softplus(conv(self.head2, d, dt)[:, 0])


def reldepthnet_name_map(cfg: DepthNetConfig) -> Dict[str, str]:
    """The port's entry name → the JAX module's flax path."""
    m = {"stem_conv.weight": "Conv_0/kernel", "stem_norm.weight": "GroupNorm_0/scale",
         "stem_norm.bias": "GroupNorm_0/bias"}
    in_ch, width, i = cfg.base_width, cfg.base_width, 0
    for stage, n_blocks in enumerate(cfg.blocks):
        for b in range(n_blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            t, f = f"blocks.{i}", f"Bottleneck_{i}"
            parts = [("conv1", "norm1"), ("conv2", "norm2"), ("conv3", "norm3")]
            if in_ch != width * 4 or stride != 1:
                parts.append(("down.0", "down.1"))
            for k, (cn, nn_) in enumerate(parts):
                m[f"{t}.{cn}.weight"] = f"{f}/Conv_{k}/kernel"
                m[f"{t}.{nn_}.weight"] = f"{f}/GroupNorm_{k}/scale"
                m[f"{t}.{nn_}.bias"] = f"{f}/GroupNorm_{k}/bias"
            in_ch, i = width * 4, i + 1
        width *= 2
    convs = ["laterals.0"]
    for j in range(len(cfg.blocks) - 1):
        convs += [f"laterals.{j + 1}", f"smooths.{j}"]
    convs += ["head1", "head2"]
    for k, t in enumerate(convs):
        m[f"{t}.weight"], m[f"{t}.bias"] = f"Conv_{k + 1}/kernel", f"Conv_{k + 1}/bias"
    return m
