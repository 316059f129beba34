"""Pretrained weights of the diffusion and CLIP networks (the port's share
of ``text2nerf_tpu/services/weight_convert.py``).

- Reading: :func:`load_torch_checkpoint` (``.bin`` / ``.pt`` through
  ``torch.load(weights_only=True)``, ``.safetensors`` through
  :func:`read_safetensors`, a numpy reader of the format: a u64 header
  length, a JSON header, raw little-endian data) and
  :func:`find_weights_file`.
- The name maps, torch name → the JAX package's flax path (the port's
  copies of ``sd_unet_name_map``, ``sd_vae_{encoder,decoder}_name_map``,
  ``clip_text_name_map``, ``clip_vision_name_map``).  The port's modules
  carry the torch names, so a map serves the coverage check, the legacy
  VAE attention aliases and the bridge from flax.
- :func:`require_coverage`: a checkpoint must hold ≥ 99% of a map's
  required entries, else it raises (a layout mismatch never becomes a
  zero-filled net); :func:`load_state` then copies it into a module,
  missing entries zero-filled as the JAX package's ``fill_missing_params``.
- The bridge from the JAX package's parameter trees (nested dicts, or the
  flat ``a/b/c`` keys of its ``.npz``): :func:`unet_state_from_flax`,
  :func:`vae_state_from_flax`, :func:`clip_text_state_from_flax`,
  :func:`clip_vision_state_from_flax`.  Dense kernels (in, out) become
  Linear weights (out, in), conv kernels HWIO become OIHW, norm ``scale``
  becomes ``weight``.  :func:`load_converted` reads the JAX package's
  converted ``.npz``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..models.clip import CLIPTextConfig, CLIPTextEncoder, CLIPVisionConfig, CLIPVisionEncoder
from ..models.diffusion import AutoencoderKL, UNet, UNetConfig, VAEConfig

# ---------------------------------------------------------------------------
# Reading checkpoints
# ---------------------------------------------------------------------------

_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "BF16": np.uint16,
              "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
              "U8": np.uint8, "BOOL": np.bool_}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file as CPU tensors; raises ValueError on a file
    that is not one."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        n = int.from_bytes(head, "little") if len(head) == 8 else -1
        if not 0 < n <= size - 8:
            raise ValueError(f"{path}: not a safetensors file (header length {n})")
        try:
            header = json.loads(f.read(n))
        except ValueError as e:
            raise ValueError(f"{path}: unreadable safetensors header ({e})") from None
    data = np.memmap(path, np.uint8, "r", offset=8 + n)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info.get("dtype"))
        b, e = info.get("data_offsets", (0, -1))
        shape = tuple(info.get("shape", ()))
        if dtype is None or not 0 <= b <= e <= len(data) or (
                e - b != int(np.prod(shape)) * np.dtype(dtype).itemsize):
            raise ValueError(f"{path}: bad safetensors entry {name}: {info}")
        t = torch.from_numpy(np.array(data[b:e]).view(dtype).reshape(shape))
        out[name] = t.view(torch.bfloat16) if info["dtype"] == "BF16" else t
    return out


def load_torch_checkpoint(path: str) -> Optional[Dict[str, torch.Tensor]]:
    """A ``.safetensors`` / ``.bin`` / ``.pt`` state dict as CPU tensors,
    or None when ``path`` is no file.  A file that does not parse raises."""
    if not os.path.isfile(path):
        return None
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


WEIGHT_FILES = ("diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin",
                "model.safetensors", "pytorch_model.bin")
#: suffixes of files that hold weights, readable by the port or not
CHECKPOINT_SUFFIXES = (".safetensors", ".bin", ".pt", ".pth", ".ckpt", ".npz", ".msgpack",
                       ".h5", ".onnx")


def find_weights_file(d: str) -> Optional[str]:
    for name in WEIGHT_FILES:
        p = os.path.join(d, name)
        if os.path.isfile(p):
            return p
    return None


def checkpoint_files(d: str):
    """Every file under ``d`` that holds weights, by its suffix."""
    return sorted(os.path.join(root, f) for root, _, files in os.walk(d) for f in files
                  if f.endswith(CHECKPOINT_SUFFIXES))


# ---------------------------------------------------------------------------
# Name maps (torch name → flax path; "lin:" a Linear that legacy
# checkpoints store as a 1x1 conv, "raw:" no layout change)
# ---------------------------------------------------------------------------


def _resnet_map(t: str, f: str, with_time: bool = True) -> Dict[str, str]:
    """diffusers ResnetBlock2D; ``conv_shortcut`` only where the width
    changes (an optional entry)."""
    m = {}
    for p in ("norm1", "norm2"):
        m[f"{t}.{p}.weight"], m[f"{t}.{p}.bias"] = f"{f}/{p}/scale", f"{f}/{p}/bias"
    for p in ("conv1", "conv2", "conv_shortcut") + (("time_emb_proj",) if with_time else ()):
        m[f"{t}.{p}.weight"], m[f"{t}.{p}.bias"] = f"{f}/{p}/kernel", f"{f}/{p}/bias"
    return m


def _transformer_map(t: str, f: str) -> Dict[str, str]:
    """diffusers Transformer2DModel (linear projections, one block)."""
    m = {f"{t}.norm.weight": f"{f}/norm/scale", f"{t}.norm.bias": f"{f}/norm/bias"}
    for p in ("proj_in", "proj_out"):
        m[f"{t}.{p}.weight"], m[f"{t}.{p}.bias"] = f"{f}/{p}/kernel", f"{f}/{p}/bias"
    tb, fb = f"{t}.transformer_blocks.0", f"{f}/block_0"
    for a in ("attn1", "attn2"):
        for p in ("to_q", "to_k", "to_v"):
            m[f"{tb}.{a}.{p}.weight"] = f"{fb}/{a}/{p}/kernel"
        m[f"{tb}.{a}.to_out.0.weight"] = f"{fb}/{a}/to_out/kernel"
        m[f"{tb}.{a}.to_out.0.bias"] = f"{fb}/{a}/to_out/bias"
    for n in ("norm1", "norm2", "norm3"):
        m[f"{tb}.{n}.weight"], m[f"{tb}.{n}.bias"] = f"{fb}/{n}/scale", f"{fb}/{n}/bias"
    for tp, fp in (("ff.net.0.proj", "ff/proj"), ("ff.net.2", "ff/out")):
        m[f"{tb}.{tp}.weight"], m[f"{tb}.{tp}.bias"] = f"{fb}/{fp}/kernel", f"{fb}/{fp}/bias"
    return m


def _kernel_bias(t: str, f: str) -> Dict[str, str]:
    return {f"{t}.weight": f"{f}/kernel", f"{t}.bias": f"{f}/bias"}


def sd_unet_name_map(cfg: UNetConfig) -> Dict[str, str]:
    """diffusers UNet2DConditionModel (SD 2.x) → the flax UNet."""
    m = {"conv_norm_out.weight": "norm_out/scale", "conv_norm_out.bias": "norm_out/bias"}
    for t, f in (("conv_in", "conv_in"), ("conv_out", "conv_out"),
                 ("time_embedding.linear_1", "time_dense_1"),
                 ("time_embedding.linear_2", "time_dense_2")):
        m.update(_kernel_bias(t, f))
    L = len(cfg.block_channels)
    for i in range(L):
        for j in range(cfg.layers_per_block):
            m.update(_resnet_map(f"down_blocks.{i}.resnets.{j}", f"down_{i}_res_{j}"))
            if cfg.attn_blocks[i]:
                m.update(_transformer_map(f"down_blocks.{i}.attentions.{j}", f"down_{i}_attn_{j}"))
        if i < L - 1:
            m.update(_kernel_bias(f"down_blocks.{i}.downsamplers.0.conv", f"down_{i}_downsample/conv"))
    m.update(_resnet_map("mid_block.resnets.0", "mid_res_0"))
    m.update(_transformer_map("mid_block.attentions.0", "mid_attn"))
    m.update(_resnet_map("mid_block.resnets.1", "mid_res_1"))
    for i in range(L):
        k = L - 1 - i  # diffusers' up blocks run from the lowest resolution
        for j in range(cfg.layers_per_block + 1):
            m.update(_resnet_map(f"up_blocks.{k}.resnets.{j}", f"up_{i}_res_{j}"))
            if cfg.attn_blocks[i]:
                m.update(_transformer_map(f"up_blocks.{k}.attentions.{j}", f"up_{i}_attn_{j}"))
        if i > 0:
            m.update(_kernel_bias(f"up_blocks.{k}.upsamplers.0.conv", f"up_{i}_upsample/conv"))
    return m


def _vae_attn_map(t: str, f: str) -> Dict[str, str]:
    """The VAE mid attention: modern (to_q, ..., to_out.0) and legacy
    (query, key, value, proj_attn; 1x1-conv shaped) names alike."""
    m = {f"{t}.group_norm.weight": f"{f}/group_norm/scale",
         f"{t}.group_norm.bias": f"{f}/group_norm/bias"}
    for tname, fname in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"),
                         ("to_out.0", "to_out"), ("query", "to_q"), ("key", "to_k"),
                         ("value", "to_v"), ("proj_attn", "to_out")):
        m[f"{t}.{tname}.weight"] = f"lin:{f}/attn/{fname}/kernel"
        m[f"{t}.{tname}.bias"] = f"{f}/attn/{fname}/bias"
    return m


def _vae_ends(side: str, quant: str) -> Dict[str, str]:
    m = {f"{side}.conv_norm_out.weight": "norm_out/scale",
         f"{side}.conv_norm_out.bias": "norm_out/bias"}
    for t, f in ((f"{side}.conv_in", "conv_in"), (f"{side}.conv_out", "conv_out"),
                 (quant, quant)):
        m.update(_kernel_bias(t, f))
    mid = f"{side}.mid_block"
    m.update(_resnet_map(f"{mid}.resnets.0", "mid_res_0", False))
    m.update(_vae_attn_map(f"{mid}.attentions.0", "mid_attn"))
    m.update(_resnet_map(f"{mid}.resnets.1", "mid_res_1", False))
    return m


def sd_vae_encoder_name_map(cfg: VAEConfig) -> Dict[str, str]:
    """AutoencoderKL encoder + quant_conv → the flax VAEEncoder."""
    m = _vae_ends("encoder", "quant_conv")
    L = len(cfg.block_channels)
    for i in range(L):
        for j in range(cfg.layers_per_block):
            m.update(_resnet_map(f"encoder.down_blocks.{i}.resnets.{j}", f"down_{i}_res_{j}",
                                 False))
        if i < L - 1:
            m.update(_kernel_bias(f"encoder.down_blocks.{i}.downsamplers.0.conv",
                               f"down_{i}_downsample/conv"))
    return m


def sd_vae_decoder_name_map(cfg: VAEConfig) -> Dict[str, str]:
    """AutoencoderKL decoder + post_quant_conv → the flax VAEDecoder."""
    m = _vae_ends("decoder", "post_quant_conv")
    L = len(cfg.block_channels)
    for i in range(L):
        k = L - 1 - i  # decoder up block 0 works at the top width
        for j in range(cfg.layers_per_block + 1):
            m.update(_resnet_map(f"decoder.up_blocks.{k}.resnets.{j}", f"up_{i}_res_{j}", False))
        if i > 0:
            m.update(_kernel_bias(f"decoder.up_blocks.{k}.upsamplers.0.conv",
                               f"up_{i}_upsample/conv"))
    return m


def _clip_layers_map(prefix: str, layers: int) -> Dict[str, str]:
    m = {}
    for i in range(layers):
        t, f = f"{prefix}.encoder.layers.{i}", f"TransformerLayer_{i}"
        for tn, fn in (("layer_norm1", "LayerNorm_0"), ("layer_norm2", "LayerNorm_1")):
            m[f"{t}.{tn}.weight"], m[f"{t}.{tn}.bias"] = f"{f}/{fn}/scale", f"{f}/{fn}/bias"
        for j, proj in enumerate(("q_proj", "k_proj", "v_proj", "out_proj")):
            m.update(_kernel_bias(f"{t}.self_attn.{proj}", f"{f}/MaskedAttention_0/Dense_{j}"))
        m.update(_kernel_bias(f"{t}.mlp.fc1", f"{f}/Dense_0"))
        m.update(_kernel_bias(f"{t}.mlp.fc2", f"{f}/Dense_1"))
    return m


def clip_text_name_map(layers: int = 12) -> Dict[str, str]:
    """HF CLIP text tower + text projection → the flax CLIPTextEncoder."""
    m = {"text_model.embeddings.token_embedding.weight": "raw:Embed_0/embedding",
         "text_model.embeddings.position_embedding.weight": "raw:positional_embedding",
         "text_model.final_layer_norm.weight": "ln_final/scale",
         "text_model.final_layer_norm.bias": "ln_final/bias",
         "text_projection.weight": "text_projection/kernel"}
    m.update(_clip_layers_map("text_model", layers))
    return m


def clip_vision_name_map(layers: int = 12) -> Dict[str, str]:
    """HF CLIP vision tower + visual projection → the flax
    CLIPVisionEncoder (HF's ``pre_layrnorm`` spelling)."""
    m = {"vision_model.embeddings.patch_embedding.weight": "Conv_0/kernel",
         "vision_model.embeddings.class_embedding": "class_embedding",
         "vision_model.embeddings.position_embedding.weight": "raw:positional_embedding",
         "vision_model.pre_layrnorm.weight": "ln_pre/scale",
         "vision_model.pre_layrnorm.bias": "ln_pre/bias",
         "vision_model.post_layernorm.weight": "ln_post/scale",
         "vision_model.post_layernorm.bias": "ln_post/bias",
         "visual_projection.weight": "visual_projection/kernel"}
    m.update(_clip_layers_map("vision_model", layers))
    return m


def _target(fpath: str):
    """(flax path, marker) of a map entry."""
    marker = None
    for p in ("convT:", "raw:", "lin:"):
        if fpath.startswith(p):
            fpath, marker = fpath[len(p):], p[:-1]
    return fpath, marker


# ---------------------------------------------------------------------------
# Coverage and loading
# ---------------------------------------------------------------------------


def checkpoint_map_coverage(state, name_map, optional_substr=("conv_shortcut",)):
    """(hits, required) of a name map against a state dict.  Torch names
    that map to one flax target (modern and legacy aliases) count as one
    entry, hit by any of them; an entry whose every name contains an
    ``optional_substr`` is not required."""
    groups: Dict[str, list] = {}
    for tk, fk in name_map.items():
        groups.setdefault(_target(fk)[0], []).append(tk)
    hits = required = 0
    for tks in groups.values():
        if all(any(s in tk for s in optional_substr) for tk in tks):
            continue
        required += 1
        hits += any(tk in state for tk in tks)
    return hits, required


def require_coverage(state, name_map, what: str, path: str,
                     optional_substr=("conv_shortcut",)):
    """Raise unless ≥ 99% of the map's required entries are present."""
    hits, required = checkpoint_map_coverage(state, name_map, optional_substr)
    if hits < 0.99 * required:
        raise ValueError(f"{what} checkpoint layout mismatch: {hits}/{required} mapped keys "
                         f"present in {path}")


@torch.no_grad()
def load_state(module: torch.nn.Module, state, name_maps) -> torch.nn.Module:
    """Copy a torch checkpoint's ``state`` into ``module`` (whose entries
    carry the torch names of ``name_maps``, one map per flax tree): each
    entry from its own name or an alias of it in its map, a
    1x1-conv-shaped legacy Linear squeezed, an entry the checkpoint lacks
    zero-filled.  A shape that differs raises."""
    names = {}
    for name_map in name_maps:
        groups: Dict[str, list] = {}
        for tk, fk in name_map.items():
            groups.setdefault(_target(fk)[0], []).append(tk)
        for tks in groups.values():
            for tk in tks:
                names[tk] = tks
    new = {}
    for key, ref in module.state_dict().items():
        src = next((n for n in names.get(key, [key]) if n in state), None)
        if src is None:
            new[key] = torch.zeros(ref.shape, dtype=ref.dtype)
            continue
        v = torch.as_tensor(state[src])
        if v.ndim == 4 and ref.ndim == 2:
            v = v[..., 0, 0]
        if tuple(v.shape) != tuple(ref.shape):
            raise ValueError(f"{src}: shape {tuple(v.shape)}, the module's {key} has "
                             f"{tuple(ref.shape)}")
        new[key] = v
    module.load_state_dict(new, strict=True)
    return module


# ---------------------------------------------------------------------------
# The bridge from the JAX package's flax trees
# ---------------------------------------------------------------------------


def _flat(tree, prefix="") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _template(make):
    with torch.device("meta"):
        return make().state_dict()


def state_from_flax(tree, name_map, template) -> Dict[str, torch.Tensor]:
    """The state dict of ``template``'s entries (each must be in the map)
    from a flax tree: conv kernels HWIO → OIHW, dense kernels transposed,
    ``raw:`` entries as they are."""
    flat = _flat(tree)
    state = {}
    for key, ref in template.items():
        path, marker = _target(name_map[key])
        if path not in flat:
            raise ValueError(f"the flax tree has no {path} (for {key})")
        a = np.asarray(flat[path], np.float32)
        if marker != "raw" and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif marker != "raw" and a.ndim == 2:
            a = a.T
        if a.shape != tuple(ref.shape):
            raise ValueError(f"{path}: shape {a.shape}, {key} has {tuple(ref.shape)}")
        state[key] = torch.from_numpy(np.array(a, order="C"))
    return state


def unet_state_from_flax(params, cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    return state_from_flax(params, sd_unet_name_map(cfg), _template(lambda: UNet(cfg)))


def vae_state_from_flax(encoder_params, decoder_params, cfg: VAEConfig):
    """:class:`AutoencoderKL`'s state from the flax VAEEncoder's and
    VAEDecoder's trees."""
    tmpl = _template(lambda: AutoencoderKL(cfg))
    enc_map, dec_map = sd_vae_encoder_name_map(cfg), sd_vae_decoder_name_map(cfg)
    return {**state_from_flax(encoder_params, enc_map,
                              {k: v for k, v in tmpl.items() if k in enc_map}),
            **state_from_flax(decoder_params, dec_map,
                              {k: v for k, v in tmpl.items() if k in dec_map})}


def clip_text_state_from_flax(params, cfg: CLIPTextConfig):
    """The text tower's state; the flax ``ln_skip`` (a copy of
    ``ln_final`` under ``skip_last_layers > 0``) has no entry of its own."""
    return state_from_flax(params, clip_text_name_map(cfg.layers),
                           _template(lambda: CLIPTextEncoder(cfg)))


def clip_vision_state_from_flax(params, cfg: CLIPVisionConfig):
    return state_from_flax(params, clip_vision_name_map(cfg.layers),
                           _template(lambda: CLIPVisionEncoder(cfg)))


def load_converted(weights_path: str) -> Optional[dict]:
    """The JAX package's converted ``.npz`` tree (``weights_path`` itself,
    ``weights_path + ".npz"`` or ``weights_path/converted.npz``) as nested
    dicts of numpy arrays, or None."""
    for cand in (weights_path, weights_path + ".npz", os.path.join(weights_path, "converted.npz")):
        if os.path.isfile(cand) and cand.endswith(".npz"):
            tree: dict = {}
            with np.load(cand) as z:
                for key in z.files:
                    node = tree
                    *parts, leaf = key.split("/")
                    for p in parts:
                        node = node.setdefault(p, {})
                    node[leaf] = z[key]
            return tree
    return None
