"""The latent-diffusion models of Stable Diffusion 2 (port of
``text2nerf_tpu/models/diffusion.py``), NCHW.

- :class:`UNet`: the conditional UNet of SD 2.1-base (4 input channels)
  and SD 2-inpainting (9: the latents, the mask and the masked image's
  latents): block widths (320, 640, 1280, 1280), 2 resnets a block,
  GroupNorm(32, eps 1e-5) + SiLU resnets, linear-projection transformers
  with GEGLU feed-forwards, cross-attention width 1024, head width 64.
- :class:`AutoencoderKL`: the VAE (128, 256, 512, 512), GroupNorm eps
  1e-6, single-head mid attention, the quant / post-quant 1x1 convs.
- Schedules: :class:`EulerSchedule` (text2img), :class:`DDIMSchedule`,
  :class:`PNDMSchedule` (the inpainting checkpoint's PLMS, precomputed on
  the host), and :func:`denoise_loop`, classifier-free guidance in a
  Python loop.

Parameters carry the diffusers names (``down_blocks.0.resnets.1.conv1
.weight``, ``mid_block.attentions.0.proj_in.weight``, ...), so a
diffusers ``state_dict`` loads with ``load_state_dict(strict=True)``; the
JAX package's flax names map one to one
(``services/weights.py`` ``unet_state_from_flax``).

``dtype`` is the compute type, as flax's ``dtype=``: convolutions and
dense layers cast their input, kernel and bias to it, the parameters stay
fp32; GroupNorm and LayerNorm take their statistics and apply them in
fp32 and return the compute type; the attention softmax runs in fp32.
Type promotion then follows JAX's (bf16 with fp32 gives fp32).  The token
order of every attention is JAX's: (b, c, h, w) flattens h-major.

:func:`init_flax_` draws flax's default initialization from an explicit
``torch.Generator``: LeCun-normal kernels (variance 1/fan_in, truncated
at two standard deviations), zero biases, unit norm scales, N(0, 1/dim)
embeddings.  The draws differ from ``jax.random``'s; the distributions
are the same.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# stddev of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


# ---------------------------------------------------------------------------
# Initialization and the compute-type primitives
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_flax_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Flax's default initialization of every Linear, Conv2d, norm and
    Embedding of ``module``, in place, drawn from ``generator`` (on the
    parameters' device)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            std = math.sqrt(1.0 / m.weight[0].numel()) / _TRUNC_STD  # fan_in
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, m.embedding_dim ** -0.5, generator=generator)
    return module


def materialize(make, device, generator: Optional[torch.Generator] = None):
    """``make()`` built without memory, then allocated on ``device`` and,
    with ``generator``, initialized as flax does (:func:`init_flax_` and
    the module's own ``init_extra_``); without one the caller loads a
    state dict."""
    with torch.device("meta"):
        module = make()
    module = module.to_empty(device=device).requires_grad_(False).eval()
    if generator is not None:
        init_flax_(module, generator)
        for m in module.modules():
            if hasattr(m, "init_extra_"):
                m.init_extra_(generator)
    return module


def linear(m: nn.Linear, x, dtype):
    bias = None if m.bias is None else m.bias.to(dtype)
    return F.linear(x.to(dtype), m.weight.to(dtype), bias)


def conv(m: nn.Conv2d, x, dtype):
    bias = None if m.bias is None else m.bias.to(dtype)
    return F.conv2d(x.to(dtype), m.weight.to(dtype), bias, m.stride, m.padding, 1, m.groups)


def group_norm(m: nn.GroupNorm, x, dtype):
    return F.group_norm(x.float(), m.num_groups, m.weight.float(), m.bias.float(),
                        m.eps).to(dtype)


def layer_norm(m: nn.LayerNorm, x, dtype):
    return F.layer_norm(x.float(), m.normalized_shape, m.weight.float(), m.bias.float(),
                        m.eps).to(dtype)


def attention(q, k, v, heads: int, dtype, mask=None):
    """Multi-head attention over (b, n, dim) projections: the scores in
    ``dtype`` scaled by 1/sqrt(head width) (plus ``mask``), the softmax in
    fp32, cast back, and the weighted sum: two batched matmuls around an
    fp32 softmax.  Returns (b, n, dim)."""
    b, n, dim = q.shape
    m, hd = k.shape[1], dim // heads

    def split(t, length):
        return t.reshape(b, length, heads, hd).transpose(1, 2).reshape(b * heads, length, hd)

    q, k, v = split(q, n), split(k, m), split(v, m)
    base = q.new_zeros(()).expand(b * heads, n, m) if mask is None else mask.to(dtype).expand(
        b * heads, n, m)
    scores = torch.baddbmm(base, q, k.transpose(1, 2), beta=0.0 if mask is None else 1.0,
                           alpha=1.0 / math.sqrt(hd))
    probs = torch.softmax(scores, -1, dtype=torch.float32).to(dtype)
    del scores
    out = torch.bmm(probs, v)
    return out.reshape(b, heads, n, hd).transpose(1, 2).reshape(b, n, dim)


def timestep_embedding(timesteps, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding (b,) → (b, dim), cos half then sin half."""
    half = dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(-math.log(max_period) * ar / half)
    args = timesteps.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


class ResnetBlock(nn.Module):
    """GroupNorm → SiLU → conv, twice, the time embedding added between,
    a 1x1 shortcut when the width changes (diffusers ResnetBlock2D)."""

    def __init__(self, in_ch: int, out_ch: int, temb_ch: Optional[int] = None,
                 eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.GroupNorm(32, in_ch, eps)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_ch, out_ch) if temb_ch else None
        self.norm2 = nn.GroupNorm(32, out_ch, eps)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x, temb=None):
        dt = self.dtype
        h = conv(self.conv1, F.silu(group_norm(self.norm1, x, dt)), dt)
        if temb is not None:
            h = h + linear(self.time_emb_proj, F.silu(temb), dt)[:, :, None, None]
        h = conv(self.conv2, F.silu(group_norm(self.norm2, h, dt)), dt)
        if self.conv_shortcut is not None:
            x = conv(self.conv_shortcut, x, dt)
        return x + h


class Attention(nn.Module):
    """diffusers Attention: ``to_q`` / ``to_k`` / ``to_v`` (bias-free in
    the UNet) and ``to_out.0``; keys and values from ``context`` when
    given (cross-attention)."""

    def __init__(self, dim: int, heads: int, context_dim: Optional[int] = None,
                 qkv_bias: bool = False, dtype=torch.float32):
        super().__init__()
        self.dtype, self.heads = dtype, heads
        context_dim = context_dim or dim
        self.to_q = nn.Linear(dim, dim, bias=qkv_bias)
        self.to_k = nn.Linear(context_dim, dim, bias=qkv_bias)
        self.to_v = nn.Linear(context_dim, dim, bias=qkv_bias)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim), nn.Identity()])

    def forward(self, x, context=None):
        dt = self.dtype
        context = x if context is None else context
        out = attention(linear(self.to_q, x, dt), linear(self.to_k, context, dt),
                        linear(self.to_v, context, dt), self.heads, dt)
        return linear(self.to_out[0], out, dt)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)


class FeedForward(nn.Module):
    """GEGLU feed-forward: ``net.0.proj`` (dim → 2·4·dim), a · gelu(gate)
    with torch's exact erf gelu, ``net.2`` back to dim."""

    def __init__(self, dim: int, mult: int = 4, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x):
        dt = self.dtype
        a, gate = linear(self.net[0].proj, x, dt).chunk(2, -1)
        return linear(self.net[2], a * F.gelu(gate), dt)


class TransformerBlock(nn.Module):
    """BasicTransformerBlock: pre-LN (eps 1e-5) self-attention,
    cross-attention on the text context, GEGLU feed-forward."""

    def __init__(self, dim: int, heads: int, context_dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, dtype=dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, context_dim, dtype=dtype)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, dtype=dtype)

    def forward(self, x, context):
        dt = self.dtype
        x = x + self.attn1(layer_norm(self.norm1, x, dt))
        x = x + self.attn2(layer_norm(self.norm2, x, dt), context)
        return x + self.ff(layer_norm(self.norm3, x, dt))


class SpatialTransformer(nn.Module):
    """Transformer2DModel with linear ``proj_in`` / ``proj_out`` (SD 2),
    GroupNorm eps 1e-6, one transformer block; tokens h-major."""

    def __init__(self, ch: int, heads: int, context_dim: int, depth: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = nn.GroupNorm(32, ch, eps=1e-6)
        self.proj_in = nn.Linear(ch, ch)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(ch, heads, context_dim, dtype) for _ in range(depth)])
        self.proj_out = nn.Linear(ch, ch)

    def forward(self, x, context):
        dt = self.dtype
        b, c, h, w = x.shape
        t = group_norm(self.norm, x, dt).permute(0, 2, 3, 1).reshape(b, h * w, c)
        t = linear(self.proj_in, t, dt)
        for block in self.transformer_blocks:
            t = block(t, context)
        t = linear(self.proj_out, t, dt)
        return t.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class Downsample(nn.Module):
    """3x3 stride-2 conv: symmetric padding in the UNet, bottom / right
    only in the VAE encoder (``asymmetric``)."""

    def __init__(self, ch: int, asymmetric: bool = False, dtype=torch.float32):
        super().__init__()
        self.dtype, self.asymmetric = dtype, asymmetric
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=0 if asymmetric else 1)

    def forward(self, x):
        if self.asymmetric:
            x = F.pad(x, (0, 1, 0, 1))
        return conv(self.conv, x, self.dtype)


class Upsample(nn.Module):
    """Nearest 2x upsample, then a 3x3 conv."""

    def __init__(self, ch: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return conv(self.conv, F.interpolate(x, scale_factor=2, mode="nearest"), self.dtype)


class _Stage(nn.Module):
    """One diffusers down, mid or up block: ``resnets`` and, where the
    block has them, ``attentions`` and ``downsamplers`` / ``upsamplers``;
    the owner runs them."""

    def __init__(self, resnets, attentions=(), downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions else None
        self.downsamplers = nn.ModuleList([downsample]) if downsample is not None else None
        self.upsamplers = nn.ModuleList([upsample]) if upsample is not None else None


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4  # 9 for the inpainting variant
    out_channels: int = 4
    block_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024  # SD 2.x (OpenCLIP-H)
    head_dim: int = 64
    attn_blocks: Tuple[bool, ...] = (True, True, True, False)

    @staticmethod
    def sd21_base():
        return UNetConfig()

    @staticmethod
    def sd2_inpaint():
        return UNetConfig(in_channels=9)

    @staticmethod
    def tiny(cross_attention_dim: int = 64):
        """A miniature configuration for tests."""
        return UNetConfig(block_channels=(32, 64), layers_per_block=1,
                          cross_attention_dim=cross_attention_dim, head_dim=16,
                          attn_blocks=(True, False))


class _TimeEmbedding(nn.Module):
    def __init__(self, ch: int, tdim: int):
        super().__init__()
        self.linear_1 = nn.Linear(ch, tdim)
        self.linear_2 = nn.Linear(tdim, tdim)


class UNet(nn.Module):
    """SD 2 conditional UNet over latents (b, in_channels, h, w) at
    timesteps (b,) on a text context (b, L, cross_attention_dim); returns
    the predicted noise (b, out_channels, h, w) in ``dtype``.

    ``down_blocks.{i}`` and ``up_blocks.{k}`` are diffusers' (up block k
    works at channel-table position L-1-k, the JAX package's ``up_{L-1-k}``).
    """

    def __init__(self, cfg: UNetConfig, dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        c = cfg
        ch0 = c.block_channels[0]
        tdim = ch0 * 4
        L = len(c.block_channels)
        ctx = c.cross_attention_dim

        def res(i, o):
            return ResnetBlock(i, o, tdim, 1e-5, dtype)

        def attn(ch):
            return SpatialTransformer(ch, ch // c.head_dim, ctx, dtype=dtype)

        self.conv_in = nn.Conv2d(c.in_channels, ch0, 3, padding=1)
        self.time_embedding = _TimeEmbedding(ch0, tdim)
        skips, prev = [ch0], ch0
        down = []
        for i, ch in enumerate(c.block_channels):
            resnets, attns = [], []
            for _ in range(c.layers_per_block):
                resnets.append(res(prev, ch))
                if c.attn_blocks[i]:
                    attns.append(attn(ch))
                prev = ch
                skips.append(ch)
            last = i == L - 1
            down.append(_Stage(resnets, attns, None if last else Downsample(ch, dtype=dtype)))
            if not last:
                skips.append(ch)
        self.down_blocks = nn.ModuleList(down)
        mid = c.block_channels[-1]
        self.mid_block = _Stage([res(mid, mid), res(mid, mid)], [attn(mid)])
        up = []
        for i in reversed(range(L)):
            ch = c.block_channels[i]
            resnets, attns = [], []
            for _ in range(c.layers_per_block + 1):
                resnets.append(res(prev + skips.pop(), ch))
                if c.attn_blocks[i]:
                    attns.append(attn(ch))
                prev = ch
            up.append(_Stage(resnets, attns, upsample=Upsample(ch, dtype) if i > 0 else None))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = nn.GroupNorm(32, ch0, eps=1e-5)
        self.conv_out = nn.Conv2d(ch0, c.out_channels, 3, padding=1)

    def forward(self, x, timesteps, context):
        dt = self.dtype
        te = self.time_embedding
        temb = timestep_embedding(timesteps, self.cfg.block_channels[0])
        temb = linear(te.linear_2, F.silu(linear(te.linear_1, temb, dt)), dt)
        h = conv(self.conv_in, x, dt)
        skips = [h]
        for stage in self.down_blocks:
            for j, r in enumerate(stage.resnets):
                h = r(h, temb)
                if stage.attentions is not None:
                    h = stage.attentions[j](h, context)
                skips.append(h)
            if stage.downsamplers is not None:
                h = stage.downsamplers[0](h)
                skips.append(h)
        mid = self.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h, temb), context), temb)
        for stage in self.up_blocks:
            for j, r in enumerate(stage.resnets):
                h = r(torch.cat([h, skips.pop()], 1), temb)
                if stage.attentions is not None:
                    h = stage.attentions[j](h, context)
            if stage.upsamplers is not None:
                h = stage.upsamplers[0](h)
        h = F.silu(group_norm(self.conv_norm_out, h, dt))
        return conv(self.conv_out, h, dt)


# ---------------------------------------------------------------------------
# VAE (AutoencoderKL)
# ---------------------------------------------------------------------------


class VAEAttention(Attention):
    """The VAE's single-head mid attention: GroupNorm eps 1e-6, biased
    q / k / v / out projections, a residual around it."""

    def __init__(self, ch: int, dtype=torch.float32):
        super().__init__(ch, 1, qkv_bias=True, dtype=dtype)
        self.group_norm = nn.GroupNorm(32, ch, eps=1e-6)

    def forward(self, x):
        b, c, h, w = x.shape
        t = group_norm(self.group_norm, x, self.dtype).permute(0, 2, 3, 1).reshape(b, h * w, c)
        return x + super().forward(t).reshape(b, h, w, c).permute(0, 3, 1, 2)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 4
    block_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215

    @staticmethod
    def tiny():
        return VAEConfig(block_channels=(32, 64), layers_per_block=1)


def _vae_mid(top: int, dtype):
    return _Stage([ResnetBlock(top, top, None, 1e-6, dtype), ResnetBlock(top, top, None, 1e-6, dtype)],
                  [VAEAttention(top, dtype)])


def _run_mid(mid: _Stage, h):
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))


class VAEEncoder(nn.Module):
    """diffusers Encoder: (b, 3, H, W) → the moments before the quant
    conv, (b, 2·latent_channels, H/f, W/f)."""

    def __init__(self, cfg: VAEConfig, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        c = cfg
        self.conv_in = nn.Conv2d(3, c.block_channels[0], 3, padding=1)
        blocks, prev = [], c.block_channels[0]
        for i, ch in enumerate(c.block_channels):
            resnets = []
            for _ in range(c.layers_per_block):
                resnets.append(ResnetBlock(prev, ch, None, 1e-6, dtype))
                prev = ch
            last = i == len(c.block_channels) - 1
            blocks.append(_Stage(resnets, downsample=None if last else Downsample(ch, True, dtype)))
        self.down_blocks = nn.ModuleList(blocks)
        top = c.block_channels[-1]
        self.mid_block = _vae_mid(top, dtype)
        self.conv_norm_out = nn.GroupNorm(32, top, eps=1e-6)
        self.conv_out = nn.Conv2d(top, 2 * c.latent_channels, 3, padding=1)

    def forward(self, x):
        dt = self.dtype
        h = conv(self.conv_in, x, dt)
        for stage in self.down_blocks:
            for r in stage.resnets:
                h = r(h)
            if stage.downsamplers is not None:
                h = stage.downsamplers[0](h)
        h = _run_mid(self.mid_block, h)
        return conv(self.conv_out, F.silu(group_norm(self.conv_norm_out, h, dt)), dt)


class VAEDecoder(nn.Module):
    """diffusers Decoder: latents (b, latent_channels, h, w) → images
    (b, 3, f·h, f·w) in [-1, 1] (before clipping)."""

    def __init__(self, cfg: VAEConfig, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        c = cfg
        top = c.block_channels[-1]
        self.conv_in = nn.Conv2d(c.latent_channels, top, 3, padding=1)
        self.mid_block = _vae_mid(top, dtype)
        blocks, prev = [], top
        for i in reversed(range(len(c.block_channels))):
            ch = c.block_channels[i]
            resnets = []
            for _ in range(c.layers_per_block + 1):
                resnets.append(ResnetBlock(prev, ch, None, 1e-6, dtype))
                prev = ch
            blocks.append(_Stage(resnets, upsample=Upsample(ch, dtype) if i > 0 else None))
        self.up_blocks = nn.ModuleList(blocks)
        ch0 = c.block_channels[0]
        self.conv_norm_out = nn.GroupNorm(32, ch0, eps=1e-6)
        self.conv_out = nn.Conv2d(ch0, 3, 3, padding=1)

    def forward(self, z):
        dt = self.dtype
        h = _run_mid(self.mid_block, conv(self.conv_in, z, dt))
        for stage in self.up_blocks:
            for r in stage.resnets:
                h = r(h)
            if stage.upsamplers is not None:
                h = stage.upsamplers[0](h)
        return conv(self.conv_out, F.silu(group_norm(self.conv_norm_out, h, dt)), dt)


class AutoencoderKL(nn.Module):
    """The VAE in diffusers' layout (``encoder``, ``quant_conv``,
    ``decoder``, ``post_quant_conv``)."""

    def __init__(self, cfg: VAEConfig, dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        lat = cfg.latent_channels
        self.encoder = VAEEncoder(cfg, dtype)
        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1)
        self.decoder = VAEDecoder(cfg, dtype)
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)

    def encode(self, x):
        """Images (b, 3, H, W) in [-1, 1] → the moments (mean ‖ logvar)."""
        return conv(self.quant_conv, self.encoder(x), self.dtype)

    def decode(self, z):
        return self.decoder(conv(self.post_quant_conv, z, self.dtype))


# ---------------------------------------------------------------------------
# Schedules (host-side fp32 numpy; each step's scalars computed in fp32)
# ---------------------------------------------------------------------------

_f32 = np.float32


def _linspace32(start, stop, num: int) -> np.ndarray:
    """fp32 ``jnp.linspace`` as XLA evaluates it: start·(1 − k·r) +
    k·(stop·r), r = 1/(num − 1), the last element ``stop`` (``[start]``
    for one element)."""
    start, stop = _f32(start), _f32(stop)
    if num == 1:
        return np.array([start], _f32)
    r = _f32(1) / _f32(num - 1)
    k = np.arange(num - 1, dtype=_f32)
    out = start * (_f32(1) - k * r) + k * _f32(stop * r)
    return np.concatenate([out, [stop]]).astype(_f32)


def make_betas(n_train: int = 1000, beta_start=0.00085, beta_end=0.012) -> np.ndarray:
    """scaled_linear betas (the SD default), fp32."""
    b = _linspace32(beta_start ** 0.5, beta_end ** 0.5, n_train)
    return (b * b).astype(_f32)


def _alphas_cum(betas) -> np.ndarray:
    """The fp32 cumulative product of 1 − β (sequential; XLA associates
    the same product in another order, within 2e-6 relative)."""
    return torch.cumprod(torch.from_numpy(_f32(1) - betas), 0).numpy()


@dataclasses.dataclass
class EulerSchedule:
    """Euler discrete (text2img): sigma parameterization for an
    epsilon-predicting model.  The UNet gets the fractional timesteps;
    the sigma index truncates them."""

    timesteps: np.ndarray  # (S,) fp32
    sigmas: np.ndarray     # (S+1,) descending, last 0

    @staticmethod
    def create(num_steps: int, n_train: int = 1000, beta_start=0.00085, beta_end=0.012,
               steps_offset: int = 0):
        del steps_offset  # Euler's linspace spacing ignores the offset
        ac = _alphas_cum(make_betas(n_train, beta_start, beta_end))
        all_sigmas = np.sqrt((_f32(1) - ac) / ac).astype(_f32)
        ts = _linspace32(n_train - 1, 0, num_steps)
        idx = np.clip(ts.astype(np.int32), 0, n_train - 1)
        return EulerSchedule(timesteps=ts,
                             sigmas=np.concatenate([all_sigmas[idx], [_f32(0)]]).astype(_f32))

    def _norm(self, i):
        s = self.sigmas[i]
        return float(np.sqrt(s * s + _f32(1)))

    @property
    def init_noise_sigma(self) -> float:
        return self._norm(0)

    def scale_model_input(self, x, i):
        return x / self._norm(i)

    def init_state(self, latents):
        return None

    def step_state(self, eps, i, x, state):
        sigma = self.sigmas[i]
        pred_x0 = x - float(sigma) * eps
        d = (x - pred_x0) / float(sigma)
        return x + d * float(self.sigmas[i + 1] - sigma), state


@dataclasses.dataclass
class DDIMSchedule:
    timesteps: np.ndarray   # (S,) int
    alphas_cum: np.ndarray  # (n_train,) fp32

    @staticmethod
    def create(num_steps: int, n_train: int = 1000, beta_start=0.00085, beta_end=0.012,
               steps_offset: int = 0):
        step = n_train // num_steps
        ts = np.clip((np.arange(num_steps) * step + steps_offset)[::-1], 0, n_train - 1)
        return DDIMSchedule(timesteps=ts.astype(np.int64),
                            alphas_cum=_alphas_cum(make_betas(n_train, beta_start, beta_end)))

    init_noise_sigma = 1.0

    def scale_model_input(self, x, i):
        return x

    def init_state(self, latents):
        return None

    def step_state(self, eps, i, x, state):
        ac = self.alphas_cum
        a_t = ac[self.timesteps[i]]
        # set_alpha_to_one=False: the last step lands on alphas_cum[0]
        a_prev = ac[self.timesteps[i + 1]] if i + 1 < len(self.timesteps) else ac[0]
        x0 = (x - float(np.sqrt(_f32(1) - a_t)) * eps) / float(np.sqrt(a_t))
        return float(np.sqrt(a_prev)) * x0 + float(np.sqrt(_f32(1) - a_prev)) * eps, state


@dataclasses.dataclass
class PNDMSchedule:
    """PNDM (PLMS) with ``skip_prk_steps`` as the SD checkpoints ship it
    (steps_offset 1, set_alpha_to_one false): the Adams-Bashforth
    weights over [eps, 3-deep history] and the effective (t, t_prev) of
    every evaluation precomputed on the host, as the JAX package does.
    ``num_steps + 1`` UNet evaluations: the warm-up evaluates the second
    timestep again and steps from the saved sample."""

    timesteps: np.ndarray   # (S+1,) UNet timesteps, PLMS order
    t_eff: np.ndarray       # (S+1,) effective t of the update
    t_prev: np.ndarray      # (S+1,) effective previous t (< 0 at the end)
    coeffs: np.ndarray      # (S+1, 4) fp32 weights over [eps, h0, h1, h2]
    push: np.ndarray        # (S+1,) push eps onto the history
    use_saved: np.ndarray   # (S+1,) update from the saved sample
    save: np.ndarray        # (S+1,) save x as the sample
    alphas_cum: np.ndarray  # (n_train,) fp32

    @staticmethod
    def create(num_steps: int, n_train: int = 1000, beta_start=0.00085, beta_end=0.012,
               steps_offset: int = 1):
        ratio = n_train // num_steps
        base = (np.arange(num_steps) * ratio).round().astype(np.int64) + steps_offset
        # drop the last, repeat the second-to-last, append the last, reverse
        plms = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1].copy()
        s1 = len(plms)
        t_eff, t_prev = plms.copy(), plms - ratio
        coeffs = np.zeros((s1, 4), _f32)
        coeffs[0] = (1.0, 0.0, 0.0, 0.0)
        push, use_saved, save = np.ones(s1, bool), np.zeros(s1, bool), np.zeros(s1, bool)
        save[0] = True
        if s1 > 1:
            t_eff[1], t_prev[1] = plms[1] + ratio, plms[1]
            coeffs[1] = (0.5, 0.5, 0.0, 0.0)
            push[1], use_saved[1] = False, True
        if s1 > 2:
            coeffs[2] = (1.5, -0.5, 0.0, 0.0)
        if s1 > 3:
            coeffs[3] = (23 / 12, -16 / 12, 5 / 12, 0.0)
        if s1 > 4:
            coeffs[4:] = (55 / 24, -59 / 24, 37 / 24, -9 / 24)
        return PNDMSchedule(plms, t_eff, t_prev, coeffs, push, use_saved, save,
                            _alphas_cum(make_betas(n_train, beta_start, beta_end)))

    init_noise_sigma = 1.0

    def scale_model_input(self, x, i):
        return x

    def init_state(self, latents):
        zero = torch.zeros_like(latents)
        return {"hist": [zero, zero, zero], "cur": zero}

    def step_state(self, eps, i, x, state):
        h, c = state["hist"], self.coeffs[i]
        e = float(c[0]) * eps + float(c[1]) * h[0] + float(c[2]) * h[1] + float(c[3]) * h[2]
        sample = state["cur"] if self.use_saved[i] else x
        ac = self.alphas_cum
        a_t = ac[self.t_eff[i]]
        a_prev = ac[self.t_prev[i]] if self.t_prev[i] >= 0 else ac[0]
        sample_coeff = np.sqrt(a_prev / a_t)
        denom = a_t * np.sqrt(_f32(1) - a_prev) + np.sqrt(a_t * (_f32(1) - a_t) * a_prev)
        x_new = float(sample_coeff) * sample - float(a_prev - a_t) * e / float(denom)
        return x_new, {"hist": [eps, h[0], h[1]] if self.push[i] else h,
                       "cur": x if self.save[i] else state["cur"]}


# ---------------------------------------------------------------------------
# Guided sampling
# ---------------------------------------------------------------------------


@torch.no_grad()
def denoise_loop(unet: UNet, schedule, latents, context_cond, context_uncond,
                 guidance_scale: float = 7.5, extra_channels=None):
    """Classifier-free-guided sampling from ``latents`` (b, 4, h, w), one
    UNet evaluation of the doubled batch (unconditional first) per
    schedule entry.  ``extra_channels`` (1, k, h, w) (the inpainting mask
    and masked-image latents, k = 5) join the input every step.  The
    guidance runs in fp32 on the UNet's output, as in JAX."""
    context = torch.cat([context_uncond, context_cond], 0)
    x = latents.float() * schedule.init_noise_sigma
    state = schedule.init_state(x)
    g = float(_f32(guidance_scale))
    for i, t in enumerate(schedule.timesteps):
        inp = schedule.scale_model_input(x, i)
        if extra_channels is not None:
            inp = torch.cat([inp, extra_channels.expand(x.shape[0], -1, -1, -1).to(inp.dtype)], 1)
        inp2 = torch.cat([inp, inp], 0)
        ts = torch.full((inp2.shape[0],), float(t), dtype=torch.float32, device=x.device)
        eps_u, eps_c = unet(inp2, ts, context).chunk(2)
        eps = eps_u.float() + g * (eps_c - eps_u).float()
        x, state = schedule.step_state(eps, i, x, state)
    return x
