"""CLIP text and vision towers (port of ``text2nerf_tpu/models/clip.py``).

- :class:`CLIPTextEncoder`: the text conditioning of the SD 2 UNets (the
  OpenCLIP ViT-H text tower: width 1024, 23 layers, 16 heads, exact gelu)
  and the ViT-B/32 text side; causal mask, end-of-text pooling.
- :class:`CLIPVisionEncoder`: the candidate ranker's ViT-B/32 (768 wide,
  12 layers, patch 32 at 224, quick-gelu), class-token pooling.
- :func:`cosine_scores` and :func:`hash_tokenize` (the stand-in tokenizer
  when no BPE vocabulary ships with the weights).

Parameters carry Hugging Face's names (``text_model.encoder.layers.{i}
.self_attn.q_proj.weight``, ``vision_model.pre_layrnorm.weight``, ...).
Compute types and initialization follow :mod:`.diffusion`; the position
and class embeddings draw from N(0, 0.01²) (text) and N(0, 0.02²)
(vision), as the flax module does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .diffusion import attention, conv, layer_norm, linear


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 512
    layers: int = 12
    heads: int = 8
    context_length: int = 77
    projection_dim: int = 512
    use_quick_gelu: bool = True  # original CLIP; OpenCLIP uses the exact gelu

    @staticmethod
    def vit_b32():
        return CLIPTextConfig()

    @staticmethod
    def sd2_text():  # the OpenCLIP ViT-H text tower
        return CLIPTextConfig(width=1024, layers=23, heads=16, projection_dim=1024,
                              use_quick_gelu=False)

    @staticmethod
    def tiny():
        return CLIPTextConfig(vocab_size=256, width=32, layers=2, heads=2, context_length=16,
                              projection_dim=32)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    projection_dim: int = 512
    use_quick_gelu: bool = True

    @staticmethod
    def vit_b32():
        return CLIPVisionConfig()

    @staticmethod
    def tiny():
        return CLIPVisionConfig(image_size=32, patch_size=8, width=32, layers=2, heads=2,
                                projection_dim=32)


def _act(x, quick: bool):
    # HF "gelu" is the exact erf form, not the tanh approximation
    return x * torch.sigmoid(1.702 * x) if quick else F.gelu(x)


class _SelfAttention(nn.Module):
    def __init__(self, width: int, heads: int, dtype):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.q_proj, self.k_proj = nn.Linear(width, width), nn.Linear(width, width)
        self.v_proj, self.out_proj = nn.Linear(width, width), nn.Linear(width, width)

    def forward(self, x, mask=None):
        dt = self.dtype
        out = attention(linear(self.q_proj, x, dt), linear(self.k_proj, x, dt),
                        linear(self.v_proj, x, dt), self.heads, dt, mask)
        return linear(self.out_proj, out, dt)


class _MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(width, width * 4), nn.Linear(width * 4, width)


class TransformerLayer(nn.Module):
    """HF CLIPEncoderLayer: pre-LN (eps 1e-5) attention and MLP."""

    def __init__(self, width: int, heads: int, quick_gelu: bool, dtype=torch.float32):
        super().__init__()
        self.quick, self.dtype = quick_gelu, dtype
        self.layer_norm1 = nn.LayerNorm(width, eps=1e-5)
        self.self_attn = _SelfAttention(width, heads, dtype)
        self.layer_norm2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = _MLP(width)

    def forward(self, x, mask=None):
        dt = self.dtype
        x = x + self.self_attn(layer_norm(self.layer_norm1, x, dt), mask)
        h = _act(linear(self.mlp.fc1, layer_norm(self.layer_norm2, x, dt), dt), self.quick)
        return x + linear(self.mlp.fc2, h, dt)


class _Encoder(nn.Module):
    def __init__(self, layers: int, width: int, heads: int, quick: bool, dtype):
        super().__init__()
        self.layers = nn.ModuleList([TransformerLayer(width, heads, quick, dtype)
                                     for _ in range(layers)])


class _TextEmbeddings(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(c.vocab_size, c.width)
        self.position_embedding = nn.Embedding(c.context_length, c.width)

    def init_extra_(self, generator):
        self.position_embedding.weight.normal_(0.0, 0.01, generator=generator)


class _TextTransformer(nn.Module):
    def __init__(self, c: CLIPTextConfig, dtype):
        super().__init__()
        self.embeddings = _TextEmbeddings(c)
        self.encoder = _Encoder(c.layers, c.width, c.heads, c.use_quick_gelu, dtype)
        self.final_layer_norm = nn.LayerNorm(c.width, eps=1e-5)


class CLIPTextEncoder(nn.Module):
    """Text tower: tokens (B, L) → {'hidden' (B, L, W), 'pooled' (B, W),
    'embeds' (B, projection_dim)}.  ``skip_last_layers`` exposes an
    earlier layer's hidden state, normed by ``final_layer_norm`` (HF's
    rule: the JAX module's ``ln_skip`` holds the same weights)."""

    def __init__(self, cfg: CLIPTextConfig, skip_last_layers: int = 0, dtype=torch.float32):
        super().__init__()
        self.cfg, self.skip, self.dtype = cfg, skip_last_layers, dtype
        self.text_model = _TextTransformer(cfg, dtype)
        self.text_projection = nn.Linear(cfg.width, cfg.projection_dim, bias=False)

    def forward(self, tokens):
        dt, tm = self.dtype, self.text_model
        L = tokens.shape[1]
        x = F.embedding(tokens, tm.embeddings.token_embedding.weight.to(dt))
        x = x + tm.embeddings.position_embedding.weight[:L]
        causal = torch.triu(torch.full((L, L), -1e9, dtype=dt, device=x.device), 1)
        at_skip = None
        for i, layer in enumerate(tm.encoder.layers):
            x = layer(x, causal)
            if i == self.cfg.layers - 1 - self.skip:
                at_skip = x
        final = layer_norm(tm.final_layer_norm, x, dt)
        hidden = layer_norm(tm.final_layer_norm, at_skip, dt) if self.skip > 0 else final
        # pooled: the end-of-text token, the highest id
        pooled = final[torch.arange(final.shape[0], device=x.device), tokens.argmax(-1)]
        return {"hidden": hidden, "pooled": pooled,
                "embeds": linear(self.text_projection, pooled, dt)}


class _VisionEmbeddings(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        n = (c.image_size // c.patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.empty(c.width))
        self.patch_embedding = nn.Conv2d(3, c.width, c.patch_size, stride=c.patch_size,
                                         bias=False)
        self.position_embedding = nn.Embedding(n, c.width)

    def init_extra_(self, generator):
        self.class_embedding.normal_(0.0, 0.02, generator=generator)
        self.position_embedding.weight.normal_(0.0, 0.02, generator=generator)


class _VisionTransformer(nn.Module):
    def __init__(self, c: CLIPVisionConfig, dtype):
        super().__init__()
        self.embeddings = _VisionEmbeddings(c)
        self.pre_layrnorm = nn.LayerNorm(c.width, eps=1e-5)  # HF's spelling
        self.encoder = _Encoder(c.layers, c.width, c.heads, c.use_quick_gelu, dtype)
        self.post_layernorm = nn.LayerNorm(c.width, eps=1e-5)


class CLIPVisionEncoder(nn.Module):
    """Vision tower: normalized images (B, 3, H, W) → {'embeds' (B, proj)}."""

    def __init__(self, cfg: CLIPVisionConfig, dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.vision_model = _VisionTransformer(cfg, dtype)
        self.visual_projection = nn.Linear(cfg.width, cfg.projection_dim, bias=False)

    def forward(self, images):
        dt, vm = self.dtype, self.vision_model
        emb = vm.embeddings
        x = conv(emb.patch_embedding, images, dt)
        x = x.flatten(2).transpose(1, 2)  # (B, gh·gw, width), h-major
        cls = emb.class_embedding.expand(x.shape[0], 1, -1)
        top = torch.promote_types(cls.dtype, x.dtype)
        x = torch.cat([cls.to(top), x.to(top)], 1) + emb.position_embedding.weight
        x = layer_norm(vm.pre_layrnorm, x, dt)
        for layer in vm.encoder.layers:
            x = layer(x)
        pooled = layer_norm(vm.post_layernorm, x[:, 0], dt)
        return {"embeds": linear(self.visual_projection, pooled, dt)}


def cosine_scores(image_embeds, ref_embed, logit_scale: float = 100.0):
    """Cosine of each L2-normalized embedding with the reference's, times
    ``logit_scale``."""
    a = image_embeds / torch.linalg.norm(image_embeds, dim=-1, keepdim=True)
    b = ref_embed / torch.linalg.norm(ref_embed, dim=-1, keepdim=True)
    return (a @ b.T)[:, 0] * logit_scale


def hash_tokenize(texts, context_length: int = 77, vocab_size: int = 49408) -> np.ndarray:
    """Whitespace tokens hashed into the vocabulary, 0 the start token and
    ``vocab_size - 1`` the end (argmax-pooled): the stand-in when no BPE
    vocabulary ships with the weights.  Python's ``hash`` is salted per
    process, as in the JAX package: ids agree with it inside one process
    and change between processes."""
    out = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        toks = [0]
        for word in text.lower().split()[: context_length - 2]:
            toks.append(hash(word) % (vocab_size - 2) + 1)
        toks.append(vocab_size - 1)
        out[i, : len(toks)] = toks
    return out
