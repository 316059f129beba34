"""Pretrained weights of the diffusion, CLIP and depth networks (the
port's share of ``text2nerf_tpu/services/weight_convert.py``).

- Reading: :func:`load_torch_checkpoint` (``.bin`` / ``.pt`` through
  ``torch.load(weights_only=True)``, ``.safetensors`` through
  :func:`read_safetensors`, a numpy reader of the format: a u64 header
  length, a JSON header, raw little-endian data) and
  :func:`find_weights_file`.
- The name maps, torch name → the JAX package's flax path (the port's
  copies of ``sd_unet_name_map``, ``sd_vae_{encoder,decoder}_name_map``,
  ``clip_text_name_map``, ``clip_vision_name_map``, ``leres_name_map``,
  ``sgrnet_name_map``, ``midas_name_map``, ``unet_generator_name_map``,
  ``lpips_{alex,vgg}_name_map``).  The port's modules carry the
  torch names, so a map serves the coverage check, the legacy VAE
  attention aliases and the bridge from flax.
- The depth checkpoints: :func:`load_leres_checkpoint` (``res101.pth``),
  :func:`load_sgrnet_checkpoint` (``model.pth.tar``) and
  :func:`load_midas_checkpoint` (``model.pt``), each reading the
  containers ``{"depth_model": ...}``, ``{"state_dict": ...}`` or a plain
  state dict, ``module.`` prefixes stripped.
- :func:`require_coverage`: a checkpoint must hold ≥ 99% of a map's
  required entries, else it raises (a layout mismatch never becomes a
  zero-filled net); :func:`load_state` then copies it into a module,
  missing entries zero-filled as the JAX package's ``fill_missing_params``.
- The bridge from the JAX package's parameter trees (nested dicts, or the
  flat ``a/b/c`` keys of its ``.npz``): :func:`unet_state_from_flax`,
  :func:`vae_state_from_flax`, :func:`clip_text_state_from_flax`,
  :func:`clip_vision_state_from_flax`, :func:`leres_state_from_flax`,
  :func:`sgrnet_state_from_flax`, :func:`midas_state_from_flax`,
  :func:`reldepthnet_state_from_flax`, :func:`lpips_state_from_flax`.
  Dense kernels (in, out) become Linear weights (out, in), conv kernels
  HWIO become OIHW, norm ``scale`` becomes ``weight``.
  :func:`load_converted` reads the JAX package's converted ``.npz``.
- LPIPS (:func:`load_lpips`): the JAX package's converted
  ``lpips_<net>.npz`` through the bridge, else the torch originals read
  as they are: torchvision's ``alexnet*.pth`` / ``vgg16*.pth``
  (``features.*``) and lpips v0.1's ``alex.pth`` / ``vgg.pth`` heads
  (``lin<i>.model.1.weight``), anywhere under the weights directory.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..models.clip import CLIPTextConfig, CLIPTextEncoder, CLIPVisionConfig, CLIPVisionEncoder
from ..models.diffusion import AutoencoderKL, UNet, UNetConfig, VAEConfig, materialize
from ..models.leres import LeReSConfig, RelDepthModel, SGRNetDepth
from ..models.lpips import ALEX_CONVS, VGG16_CONVS, LPIPSModel
from ..models.midas import MidasNet
from ..models.monodepth import DepthNetConfig, RelDepthNet, reldepthnet_name_map

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


def _bn_map(t: str, f: str) -> Dict[str, str]:
    """BatchNorm2d → the flax FrozenBatchNorm (running stats as params)."""
    return {f"{t}.weight": f"{f}/scale", f"{t}.bias": f"{f}/bias",
            f"{t}.running_mean": f"raw:{f}/mean", f"{t}.running_var": f"raw:{f}/var"}


def _ftb_map(t: str, f: str) -> Dict[str, str]:
    """FTB: conv1, conv_branch (ReLU, Conv, BN, ReLU, Conv)."""
    m = {**_kernel_bias(f"{t}.conv1", f"{f}/conv1"),
         **_kernel_bias(f"{t}.conv_branch.1", f"{f}/branch_conv1"),
         **_kernel_bias(f"{t}.conv_branch.4", f"{f}/branch_conv2")}
    m.update(_bn_map(f"{t}.conv_branch.2", f"{f}/branch_bn"))
    return m


def _resnet_stage_map(t_prefix: str, f_prefix: str, stage: int, planes: int,
                      n_blocks: int, inplanes: int) -> Dict[str, str]:
    """One torchvision ResNet stage ``{t_prefix}.{b}`` → the flax
    ``{f_prefix}/layer{stage}_{b}`` blocks."""
    m: Dict[str, str] = {}
    for b in range(n_blocks):
        t, f = f"{t_prefix}.{b}", f"{f_prefix}/layer{stage}_{b}"
        for k in (1, 2, 3):
            m[f"{t}.conv{k}.weight"] = f"{f}/conv{k}/kernel"
            m.update(_bn_map(f"{t}.bn{k}", f"{f}/bn{k}"))
        stride = 2 if (b == 0 and stage > 1) else 1
        if b == 0 and (stride != 1 or inplanes != planes * 4):
            m[f"{t}.downsample.0.weight"] = f"{f}/downsample_conv/kernel"
            m.update(_bn_map(f"{t}.downsample.1", f"{f}/downsample_bn"))
        inplanes = planes * 4
    return m


def leres_name_map(cfg: LeReSConfig, encoder_prefix: str = "depth_model.encoder_modules",
                   decoder_prefix: str = "depth_model.decoder_modules") -> Dict[str, str]:
    """LeReS's RelDepthModel (``res101.pth``) → the flax RelDepthModel."""
    e, d = encoder_prefix, decoder_prefix
    m = {f"{e}.conv1.weight": "encoder/conv1/kernel"}
    m.update(_bn_map(f"{e}.bn1", "encoder/bn1"))
    inplanes = cfg.planes[0]
    for s, (planes, n_blocks) in enumerate(zip(cfg.planes, cfg.blocks)):
        m.update(_resnet_stage_map(f"{e}.layer{s + 1}", "encoder", s + 1, planes, n_blocks,
                                   inplanes))
        inplanes = planes * 4
    m.update(_ftb_map(f"{d}.conv", "decoder/conv"))
    m.update(_kernel_bias(f"{d}.conv1", "decoder/conv1"))
    for name in ("ffm2", "ffm1", "ffm0"):
        m.update(_ftb_map(f"{d}.{name}.ftb1", f"decoder/{name}/ftb1"))
        m.update(_ftb_map(f"{d}.{name}.ftb2", f"decoder/{name}/ftb2"))
    m.update(_kernel_bias(f"{d}.outconv.adapt_conv.0", "decoder/outconv/conv1"))
    m.update(_bn_map(f"{d}.outconv.adapt_conv.1", "decoder/outconv/bn"))
    m.update(_kernel_bias(f"{d}.outconv.adapt_conv.3", "decoder/outconv/conv2"))
    return m


def sgrnet_name_map(cfg: LeReSConfig) -> Dict[str, str]:
    """SGRNet's DepthNet (``model.pth.tar``): LeReS under ``encoder.`` /
    ``decoder.``."""
    return leres_name_map(cfg, "encoder", "decoder")


def midas_name_map(cfg: LeReSConfig) -> Dict[str, str]:
    """MiDaS v2.1 (``model.pt``) → the flax MidasNet: the stem and stage
    1 in ``pretrained.layer1`` (indices 0, 1, 4), the scratch convs, the
    refinenets and the output head."""
    m = {"pretrained.layer1.0.weight": "pretrained/conv1/kernel"}
    m.update(_bn_map("pretrained.layer1.1", "pretrained/bn1"))
    inplanes = cfg.planes[0]
    for s, (planes, n_blocks) in enumerate(zip(cfg.planes, cfg.blocks)):
        t_prefix = "pretrained.layer1.4" if s == 0 else f"pretrained.layer{s + 1}"
        m.update(_resnet_stage_map(t_prefix, "pretrained", s + 1, planes, n_blocks, inplanes))
        inplanes = planes * 4
    for i in range(4):
        m[f"scratch.layer{i + 1}_rn.weight"] = f"layer{i + 1}_rn/kernel"
    for k in range(1, 5):
        for j in (1, 2):
            for c in (1, 2):
                m.update(_kernel_bias(f"scratch.refinenet{k}.resConfUnit{j}.conv{c}",
                                      f"refinenet{k}/resConfUnit{j}/conv{c}"))
    for t_idx, f_name in ((0, "output_conv1"), (2, "output_conv2"), (4, "output_conv3")):
        m.update(_kernel_bias(f"scratch.output_conv.{t_idx}", f_name))
    return m


def unet_generator_name_map(num_downs: int = 10) -> Dict[str, str]:
    """The reference pix2pix UnetGenerator (norm 'none': the Identity
    norms keep their Sequential indices) → the flax path.  The outermost
    block is ``model``; each inner block sits at index 1 (outermost) or 3
    of its parent's Sequential; flax counts ``UnetSkipBlock_i`` from the
    innermost."""
    m = {}
    n_blocks = max(num_downs, 5)
    node = "model"
    for depth in range(n_blocks):
        i = n_blocks - 1 - depth
        if depth == 0:
            down, up = f"{node}.0", f"{node}.3"
            node = f"{node}.1"
        elif depth == n_blocks - 1:
            down, up = f"{node}.model.1", f"{node}.model.3"
        else:
            down, up = f"{node}.model.1", f"{node}.model.5"
            node = f"{node}.model.3"
        m.update(_kernel_bias(down, f"UnetSkipBlock_{i}/Conv_0"))
        m[f"{up}.weight"] = f"convT:UnetSkipBlock_{i}/ConvTranspose_0/kernel"
        m[f"{up}.bias"] = f"UnetSkipBlock_{i}/ConvTranspose_0/bias"
    return m


def patchgan_name_map(n_layers: int = 3) -> Dict[str, str]:
    """The reference's PatchGAN (``NLayerDiscriminator``, norm 'none': a
    flat Sequential of Conv2d and LeakyReLU, so the convs sit at indices
    0, 2, 4, ...) → the flax path ``Conv_i/{kernel, bias}``."""
    name_map = {}
    for i in range(n_layers + 2):
        name_map[f"model.{2 * i}.weight"] = f"Conv_{i}/kernel"
        name_map[f"model.{2 * i}.bias"] = f"Conv_{i}/bias"
    return name_map


def pix2pix_key(fpath: str) -> str:
    """The port's ``models.pix2pix.UnetGenerator`` entry of a flax path
    of :func:`unet_generator_name_map` (its tensors keep torch's layouts:
    Conv2d (O, I, kh, kw), ConvTranspose2d (I, O, kh, kw))."""
    block, layer, leaf = _target(fpath)[0].split("/")
    side = "down" if layer == "Conv_0" else "up"
    return f"blocks.{block.rsplit('_', 1)[1]}.{side}_{'weight' if leaf == 'kernel' else 'bias'}"


def _lpips_map(convs) -> Dict[str, str]:
    m = {}
    for i, t in enumerate(convs):
        m.update(_kernel_bias(f"features.{t}", f"features/Conv_{i}"))
    for i in range(5):
        m[f"lin{i}.model.1.weight"] = f"lins/{i}"
    return m


def lpips_alex_name_map() -> Dict[str, str]:
    """LPIPS-alex: torchvision AlexNet's convolutions (``features.{0,3,6,
    8,10}``) and the five lpips heads."""
    return _lpips_map(ALEX_CONVS)


def lpips_vgg_name_map() -> Dict[str, str]:
    """LPIPS-vgg: torchvision VGG16's thirteen convolutions and the five
    lpips heads."""
    return _lpips_map(VGG16_CONVS)


def lpips_name_map(net: str) -> Dict[str, str]:
    return lpips_alex_name_map() if net == "alex" else lpips_vgg_name_map()


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


def read_depth_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A depth checkpoint's state dict: the ``depth_model`` or
    ``state_dict`` entry of a container, or the file's plain dict, with
    ``module.`` (DataParallel) prefixes stripped.  A file that does not
    parse raises."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("depth_model", "state_dict"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    if not isinstance(ckpt, dict):
        raise ValueError(f"{path}: not a state dict ({type(ckpt).__name__})")
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in ckpt.items()}


def _load_depth(path: str, module, name_map, what: str):
    state = read_depth_checkpoint(path)
    require_coverage(state, name_map, what, path, optional_substr=())
    return load_state(module, state, [name_map])


def load_leres_checkpoint(path: str, module: Optional[RelDepthModel] = None):
    """``res101.pth`` into ``module`` (a ResNeXt-101 RelDepthModel built
    on the CPU when none is given), ≥ 99% coverage, missing entries
    zero-filled; returns the module."""
    module = module or materialize(lambda: RelDepthModel(LeReSConfig.resnext101()), "cpu")
    return _load_depth(path, module, leres_name_map(module.cfg), "LeReS")


def load_sgrnet_checkpoint(path: str, module: Optional[SGRNetDepth] = None):
    """SGRNet's ``model.pth.tar`` into ``module`` (ResNet-50 by default)."""
    module = module or materialize(lambda: SGRNetDepth(LeReSConfig.resnet50()), "cpu")
    return _load_depth(path, module, sgrnet_name_map(module.cfg), "SGRNet")


def load_midas_checkpoint(path: str, module: Optional[MidasNet] = None):
    """MiDaS v2.1's ``model.pt`` into ``module`` (ResNeXt-101, 256
    features by default)."""
    module = module or materialize(lambda: MidasNet(LeReSConfig.resnext101()), "cpu")
    return _load_depth(path, module, midas_name_map(module.cfg), "MiDaS")


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


def leres_state_from_flax(params, cfg: LeReSConfig):
    """:class:`RelDepthModel`'s state from the flax RelDepthModel's tree."""
    return state_from_flax(params, leres_name_map(cfg), _template(lambda: RelDepthModel(cfg)))


def sgrnet_state_from_flax(params, cfg: LeReSConfig):
    """:class:`SGRNetDepth`'s state from the flax RelDepthModel's tree."""
    return state_from_flax(params, sgrnet_name_map(cfg), _template(lambda: SGRNetDepth(cfg)))


def midas_state_from_flax(params, cfg: LeReSConfig, features: int = 256):
    """:class:`MidasNet`'s state from the flax MidasNet's tree; refinenet4
    takes no lateral input, so flax never builds its ``resConfUnit1``
    (the reference holds one, unused): zeros here."""
    tmpl = _template(lambda: MidasNet(cfg, features))
    unused = "scratch.refinenet4.resConfUnit1."
    state = state_from_flax(params, midas_name_map(cfg),
                            {k: v for k, v in tmpl.items() if not k.startswith(unused)})
    state.update({k: torch.zeros(v.shape) for k, v in tmpl.items() if k.startswith(unused)})
    return state


def reldepthnet_state_from_flax(params, cfg: DepthNetConfig):
    return state_from_flax(params, reldepthnet_name_map(cfg),
                           _template(lambda: RelDepthNet(cfg)))


def lpips_state_from_flax(tree, net: str) -> Dict[str, torch.Tensor]:
    """:class:`LPIPSModel`'s state from the JAX package's LPIPS tree
    (``features`` and ``lins``).  A head may be stored as torch's (1, C,
    1, 1), the converter's (1, 1, C, 1) or a flat (C,): each becomes (1,
    C, 1, 1)."""
    tmpl = _template(lambda: LPIPSModel(net))
    name_map = lpips_name_map(net)
    heads = {k: v for k, v in tmpl.items() if k.startswith("lin")}
    state = state_from_flax({"features": tree["features"]}, name_map,
                            {k: v for k, v in tmpl.items() if k not in heads})
    flat = _flat(tree)
    for key, ref in heads.items():
        path = name_map[key]
        if path not in flat:
            raise ValueError(f"the flax tree has no {path} (for {key})")
        a = np.asarray(flat[path], np.float32)
        if a.size != ref.numel():
            raise ValueError(f"{path}: {a.size} values, {key} has {tuple(ref.shape)}")
        state[key] = torch.from_numpy(a.reshape(tuple(ref.shape)).copy())
    return state


def _lpips_torch_files(weights_dir: str, net: str):
    """(backbone file, heads file) of the torch originals under
    ``weights_dir``, or None."""
    import glob

    backbone = sorted(glob.glob(os.path.join(
        weights_dir, "**", "alexnet*.pth" if net == "alex" else "vgg16*.pth"), recursive=True))
    heads = sorted(glob.glob(os.path.join(weights_dir, "**", f"{net}.pth"), recursive=True))
    return (backbone[0], heads[0]) if backbone and heads else None


def load_lpips(net: str, weights_dir, device=None) -> LPIPSModel:
    """LPIPS-``net`` on ``device`` (cuda unless asked), in evaluation mode,
    from ``weights_dir``: the JAX package's converted ``lpips_<net>.npz``,
    else the torch originals (:func:`_lpips_torch_files`), every mapped
    entry required.  No weights raises FileNotFoundError naming where
    they were looked for."""
    from ..device import resolve_device

    dev = resolve_device(device)
    model = LPIPSModel(net)
    converted = os.path.join(weights_dir, f"lpips_{net}") if weights_dir else None
    tree = load_converted(converted) if converted else None
    if tree is not None:
        model.load_state_dict(lpips_state_from_flax(tree, net))
    else:
        files = _lpips_torch_files(weights_dir, net) if weights_dir else None
        if files is None:
            raise FileNotFoundError(
                f"LPIPS-{net} needs weights: {converted}.npz, or "
                f"{'alexnet' if net == 'alex' else 'vgg16'}*.pth and {net}.pth under "
                f"{weights_dir!r}; none found")
        state = {}
        for path in files:
            state.update(load_torch_checkpoint(path))
        name_map = lpips_name_map(net)
        require_coverage(state, name_map, f"LPIPS-{net}", " + ".join(files),
                         optional_substr=())
        load_state(model, state, [name_map])
    return model.to(dev).eval()


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
