"""The pix2pix U-Net generator of the depth-merge network (port of
``UnetSkipBlock``, ``UnetGenerator`` and ``minmax_normalize`` from
``text2nerf_tpu/models/pix2pix.py``), NCHW.

A recursive skip-connection U-Net of 4x4 stride-2 convolutions: each
level is leaky-ReLU → conv down → the inner levels → ReLU → transposed
conv up, its input concatenated before its output ``[x, up]`` (the
outermost level ends in tanh instead).  The production shape is
``unet_1024``: 10 levels, ngf 64, one channel in and out, no norm.

- Blocks are stored flat, ``blocks[i]`` the JAX package's
  ``UnetSkipBlock_i`` (0 the innermost); the recursion is in
  :meth:`UnetGenerator.forward`.
- Initialization is flax's: kernels LeCun-normal (variance 1/fan_in,
  truncated at two standard deviations), biases zero, drawn from an
  explicit ``torch.Generator``.
- ``dtype`` computes in that type the way flax's ``dtype=`` does: inputs,
  kernels and biases cast to it, the parameters kept in fp32.
- A transposed conv here is torch's (the conv's gradient, kernel (I, O,
  kh, kw)); flax's ``ConvTranspose(padding="SAME")`` does not flip its
  kernel, so :func:`state_from_flax` flips it on the way in.
- :class:`PatchDiscriminator` (the 70x70 PatchGAN of offline
  pretraining) and :func:`gan_loss`; the discriminator's layers sit in
  an ``nn.Sequential`` named ``model`` at the reference's indices, so
  its torch state dict loads as it is (:func:`discriminator_state_from_torch`
  follows ``patchgan_name_map``).
- Dropout (off in every configuration of the repo) is not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# stddev of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _lecun_normal(shape, fan_in: int, generator) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    w = torch.empty(shape)
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class UnetSkipBlock(nn.Module):
    """One U-Net level: 4x4 stride-2 conv ``input_nc → inner_nc`` down,
    4x4 stride-2 transposed conv ``inner_nc (innermost) or 2·inner_nc →
    outer_nc`` up."""

    def __init__(self, outer_nc: int, inner_nc: int, input_nc: Optional[int] = None,
                 outermost: bool = False, innermost: bool = False, generator=None):
        super().__init__()
        input_nc = outer_nc if input_nc is None else input_nc
        up_nc = inner_nc if innermost else 2 * inner_nc
        self.outermost = outermost
        self.down_weight = nn.Parameter(
            _lecun_normal((inner_nc, input_nc, 4, 4), 16 * input_nc, generator))
        self.down_bias = nn.Parameter(torch.zeros(inner_nc))
        self.up_weight = nn.Parameter(
            _lecun_normal((up_nc, outer_nc, 4, 4), 16 * up_nc, generator))
        self.up_bias = nn.Parameter(torch.zeros(outer_nc))

    def forward(self, x, inner=None, dtype=torch.float32):
        """``inner`` (a callable) runs the levels inside this one."""
        down = x if self.outermost else F.leaky_relu(x, 0.2)
        down = F.conv2d(down.to(dtype), self.down_weight.to(dtype), self.down_bias.to(dtype),
                        stride=2, padding=1)
        mid = down if inner is None else inner(down)
        up = F.conv_transpose2d(F.relu(mid), self.up_weight.to(dtype), self.up_bias.to(dtype),
                                stride=2, padding=1)
        if self.outermost:
            return torch.tanh(up)
        return torch.cat([x, up], 1)


class UnetGenerator(nn.Module):
    """The recursive U-Net: ``max(num_downs, 5)`` levels, so 10 shrink a
    1024² input to 1x1 at the bottleneck."""

    def __init__(self, input_nc: int = 1, output_nc: int = 1, num_downs: int = 10,
                 ngf: int = 64, generator=None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        blocks = [UnetSkipBlock(ngf * 8, ngf * 8, innermost=True, generator=g)]
        blocks += [UnetSkipBlock(ngf * 8, ngf * 8, generator=g) for _ in range(num_downs - 5)]
        blocks += [UnetSkipBlock(ngf * m, ngf * m * 2, generator=g) for m in (4, 2, 1)]
        blocks.append(UnetSkipBlock(output_nc, ngf, input_nc=input_nc, outermost=True,
                                    generator=g))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x, dtype=torch.float32):
        """x (N, input_nc, H, W) → (N, output_nc, H, W) in ``dtype``."""

        def level(i):
            if i < 0:
                return None
            inner = level(i - 1)
            return lambda t: self.blocks[i](t, inner, dtype)

        return level(len(self.blocks) - 1)(x)


class PatchDiscriminator(nn.Module):
    """The 70x70 PatchGAN (the reference's ``NLayerDiscriminator`` with
    norm 'none'): 4x4 convolutions, padding 1, leaky ReLU 0.2; ``n_layers``
    stride-2 convolutions (widths ndf·min(2^n, 8)), one stride-1 and a
    one-channel head.  NCHW in (condition and depth, ``input_nc`` 2),
    logits out.  Initialized as flax initializes the JAX module's convs
    (LeCun normal, zero bias), from ``generator``."""

    def __init__(self, input_nc: int = 2, ndf: int = 64, n_layers: int = 3, generator=None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        widths = [input_nc, ndf] + [ndf * min(2 ** n, 8) for n in range(1, n_layers)]
        widths += [ndf * min(2 ** n_layers, 8), 1]
        layers = []
        for i in range(n_layers + 2):
            c_in, c_out = widths[i], widths[i + 1]
            conv = nn.Conv2d(c_in, c_out, 4, stride=2 if i < n_layers else 1, padding=1)
            with torch.no_grad():
                conv.weight.copy_(_lecun_normal((c_out, c_in, 4, 4), 16 * c_in, g))
                conv.bias.zero_()
            layers.append(conv)
            if i < n_layers + 1:
                layers.append(nn.LeakyReLU(0.2))
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


def gan_loss(pred, target_is_real: bool, mode: str = "vanilla"):
    """The reference's GANLoss: 'vanilla' is BCE with logits (the JAX
    package's stable form), 'lsgan' the MSE to the 0 / 1 target."""
    target = torch.ones_like(pred) if target_is_real else torch.zeros_like(pred)
    if mode == "lsgan":
        return torch.mean((pred - target) ** 2)
    if mode == "vanilla":
        return torch.mean(torch.clamp(pred, min=0) - pred * target
                          + torch.log1p(torch.exp(-torch.abs(pred))))
    raise ValueError(mode)


def _conv_index(fpath: str) -> int:
    """Sequential index of the flax ``Conv_i`` of a discriminator path."""
    return 2 * int(fpath.split("/")[0].rsplit("_", 1)[1])


def discriminator_state_from_torch(state: dict, n_layers: int = 3) -> dict:
    """The discriminator's state dict from the reference's torch one,
    through ``patchgan_name_map`` (both keep torch's layouts); a missing
    entry raises."""
    from ..services.weights import patchgan_name_map

    out = {}
    for tname, fpath in patchgan_name_map(n_layers).items():
        leaf = "weight" if fpath.endswith("kernel") else "bias"
        out[f"model.{_conv_index(fpath)}.{leaf}"] = torch.as_tensor(state[tname]).float()
    return out


def discriminator_state_from_flax(params) -> dict:
    """The discriminator's state dict from the JAX module's flax params
    (``Conv_i/{kernel, bias}``, kernels (kh, kw, I, O))."""
    out = {}
    for name, layer in params.items():
        i = _conv_index(name)
        out[f"model.{i}.weight"] = torch.tensor(
            np.asarray(layer["kernel"], np.float32).transpose(3, 2, 0, 1).copy())
        out[f"model.{i}.bias"] = torch.tensor(np.asarray(layer["bias"], np.float32))
    return out


def minmax_normalize(x):
    """Min-max to [0, 1], then scaled to [-1, 1]."""
    x = (x - x.min()) / torch.clamp(x.max() - x.min(), min=1e-12)
    return x * 2.0 - 1.0


def state_from_flax(params) -> dict:
    """The generator's state dict from the JAX package's flax params: a
    nested tree ``UnetSkipBlock_i/{Conv_0,ConvTranspose_0}/{kernel,bias}``
    or the flat ``"a/b/c"`` keys of its saved npz.  Conv kernels (kh, kw,
    I, O) become (O, I, kh, kw); transposed-conv kernels become (I, O,
    kh, kw), flipped in both spatial axes.  A tree under one
    ``generator`` root (the weights tool's ``merge_model_sc.npz``) is
    read the same way."""
    if any("/" in k for k in params):
        tree: dict = {}
        for key, val in params.items():
            node = tree
            *parts, leaf = key.split("/")
            for p in parts:
                node = node.setdefault(p, {})
            node[leaf] = val
        params = tree
    if set(params) == {"generator"}:
        params = params["generator"]
    state = {}
    for i in range(len(params)):
        block = params[f"UnetSkipBlock_{i}"]
        conv, convt = block["Conv_0"], block["ConvTranspose_0"]
        kd, ku = np.asarray(conv["kernel"], np.float32), np.asarray(convt["kernel"], np.float32)
        state[f"blocks.{i}.down_weight"] = torch.tensor(kd.transpose(3, 2, 0, 1))
        state[f"blocks.{i}.down_bias"] = torch.tensor(np.asarray(conv["bias"], np.float32))
        state[f"blocks.{i}.up_weight"] = torch.tensor(ku[::-1, ::-1].transpose(2, 3, 0, 1).copy())
        state[f"blocks.{i}.up_bias"] = torch.tensor(np.asarray(convt["bias"], np.float32))
    return state


def state_to_flax(state: dict) -> dict:
    """The inverse of :func:`state_from_flax`: flat ``"UnetSkipBlock_i/
    {Conv_0,ConvTranspose_0}/{kernel,bias}"`` float32 numpy arrays in the
    flax layouts (conv kernels (kh, kw, I, O), transposed-conv kernels
    flipped back)."""
    out = {}
    n = len({k.split(".")[1] for k in state})
    for i in range(n):
        kd = state[f"blocks.{i}.down_weight"].detach().cpu().float().numpy()
        ku = state[f"blocks.{i}.up_weight"].detach().cpu().float().numpy()
        b = f"UnetSkipBlock_{i}"
        out[f"{b}/Conv_0/kernel"] = np.ascontiguousarray(kd.transpose(2, 3, 1, 0))
        out[f"{b}/Conv_0/bias"] = state[f"blocks.{i}.down_bias"].detach().cpu().float().numpy()
        out[f"{b}/ConvTranspose_0/kernel"] = np.ascontiguousarray(
            ku.transpose(2, 3, 0, 1)[::-1, ::-1])
        up_bias = state[f"blocks.{i}.up_bias"]
        out[f"{b}/ConvTranspose_0/bias"] = up_bias.detach().cpu().float().numpy()
    return out
