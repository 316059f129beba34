"""Per-checkpoint expectation manifests of a reference-style weights tree
(port of ``text2nerf_tpu/services/weights_manifest.py``).

Every pretrained family the reference installs either validates against
its manifest or fails with named diffs: the offending file, state-dict
key or shape and the name map it belongs to.  The families, statuses
("ok", "absent", "error"), report dicts and ``MAX_NAMED_DIFFS`` are the
JAX package's.

- **Torch-checkpoint families** (LeReS, MiDaS, SGRNet, the merge
  pix2pix, CLIP): the expected shape of every mapped key comes from the
  port's own module (its ``state_dict()`` built on the ``meta`` device),
  reached through the name maps of :mod:`.weights` that the loaders use,
  so the audit covers the whole state dict and cannot drift from them.
- **Diffusers trees** (SD 2.1-base, SD 2-inpainting): the required files
  and literal spot-tensor shapes, read straight off the state-dict files
  (no model build): enough to catch a wrong variant (a 4-channel UNet
  where the 9-channel inpainting UNet belongs, an SD-1.x text tower).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List

from .weights import load_torch_checkpoint

MAX_NAMED_DIFFS = 10

EPS_NOTES = {
    "stable-diffusion-2-1-base": "text LN 1e-5, UNet GN 1e-5, VAE GN 1e-6",
    "stable-diffusion-2-inpainting": "text LN 1e-5, UNet GN 1e-5, VAE GN 1e-6",
    "leres": "frozen BN (running stats), align_corners=True upsampling",
    "midas": "frozen BN (running stats)",
    "sgrnet": "frozen BN (running stats)",
    "merge_model_sc": "norm='none' unet_1024 (Identity norms skip indices)",
    "clip-vit-base-patch32": "LN eps 1e-5, quick_gelu",
}

# conv_in tells the base UNet (4 latent channels) from the inpainting one
# (4 + 4 + 1 = 9); the token embedding's width tells the SD 2 OpenCLIP
# text tower (1024) from an SD 1 one (768)
_SD_FILES = [
    "unet/config.json",
    "vae/config.json",
    "text_encoder/config.json",
    "scheduler/scheduler_config.json",
    "tokenizer/vocab.json",
    "tokenizer/merges.txt",
]
_SD_CKPTS = {
    "unet": ("unet/diffusion_pytorch_model.safetensors",
             "unet/diffusion_pytorch_model.bin"),
    "vae": ("vae/diffusion_pytorch_model.safetensors",
            "vae/diffusion_pytorch_model.bin"),
    "text_encoder": ("text_encoder/model.safetensors",
                     "text_encoder/pytorch_model.bin"),
}
_SD_SPOTS = {
    "stable-diffusion-2-1-base": {
        "unet": {"conv_in.weight": (320, 4, 3, 3),
                 "time_embedding.linear_1.weight": (1280, 320)},
        "vae": {"encoder.conv_in.weight": (128, 3, 3, 3),
                "decoder.conv_in.weight": (512, 4, 3, 3)},
        "text_encoder": {"text_model.embeddings.token_embedding.weight": (49408, 1024)},
    },
    "stable-diffusion-2-inpainting": {
        "unet": {"conv_in.weight": (320, 9, 3, 3),
                 "time_embedding.linear_1.weight": (1280, 320)},
        "vae": {"encoder.conv_in.weight": (128, 3, 3, 3),
                "decoder.conv_in.weight": (512, 4, 3, 3)},
        "text_encoder": {"text_model.embeddings.token_embedding.weight": (49408, 1024)},
    },
}


def expected_shapes(name_map: Dict[str, str], template, key_of=None) -> Dict[str, tuple]:
    """{torch name: shape} of every map entry the module holds: the
    module's entry is ``template[key_of(flax path)]`` (by default the
    torch name itself, the port's modules carrying the torch names)."""
    out = {}
    for tname, fpath in name_map.items():
        key = tname if key_of is None else key_of(fpath)
        if key in template:
            out[tname] = tuple(int(x) for x in template[key].shape)
    return out


def audit_state_dict(state: Dict, name_map: Dict[str, str], shapes: Dict[str, tuple],
                     map_name: str, min_coverage: float = 0.99) -> List[str]:
    """The named diffs of a torch state dict against a name map (empty:
    clean): the missing mapped keys when fewer than ``min_coverage`` of
    them are present, and every present key whose shape is not
    ``shapes``' (a linear stored as a 1x1 convolution passes)."""
    diffs: List[str] = []
    missing = [k for k in name_map if k not in state]
    if len(name_map) - len(missing) < min_coverage * len(name_map):
        for k in missing[:MAX_NAMED_DIFFS]:
            diffs.append(f"{map_name}: missing key {k!r}")
        if len(missing) > MAX_NAMED_DIFFS:
            diffs.append(
                f"{map_name}: ... {len(missing) - MAX_NAMED_DIFFS} more missing "
                f"({len(name_map) - len(missing)}/{len(name_map)} mapped keys present)")
    n_shape = 0
    for tname, fpath in name_map.items():
        if tname not in state or tname not in shapes:
            continue
        want = shapes[tname]
        got = tuple(int(x) for x in state[tname].shape)
        if fpath.startswith("lin:") and len(got) == 4:
            got = got[:2]  # (O, I, 1, 1) storage of a linear
        if got != want:
            n_shape += 1
            if n_shape <= MAX_NAMED_DIFFS:
                diffs.append(f"{map_name}: {tname!r} has shape {got}, expected {want} "
                             f"(flax leaf {fpath.split(':')[-1]!r})")
    if n_shape > MAX_NAMED_DIFFS:
        diffs.append(f"{map_name}: ... {n_shape - MAX_NAMED_DIFFS} more shape mismatches")
    return diffs


def _report(family: str, status: str, diffs=None, detail: str = "") -> dict:
    return {"family": family, "status": status, "diffs": list(diffs or []),
            "detail": detail, "eps": EPS_NOTES.get(family, "")}


def _validate_sd_tree(weights_dir: str, family: str) -> dict:
    d = os.path.join(weights_dir, family)
    if not os.path.isdir(d):
        return _report(family, "absent")
    diffs = [f"missing file {f}" for f in _SD_FILES if not os.path.exists(os.path.join(d, f))]
    for part, cands in _SD_CKPTS.items():
        path = next((os.path.join(d, c) for c in cands if os.path.exists(os.path.join(d, c))),
                    None)
        if path is None:
            diffs.append(f"missing checkpoint {cands[0]} (or .bin)")
            continue
        state = load_torch_checkpoint(path)
        if state is None:
            diffs.append(f"unreadable checkpoint {path}")
            continue
        for key, want in _SD_SPOTS[family][part].items():
            if key not in state:
                diffs.append(f"{part}: missing key {key!r}")
            elif tuple(state[key].shape) != want:
                diffs.append(f"{part}: {key!r} has shape {tuple(state[key].shape)}, "
                             f"expected {want}")
    return _report(family, "error" if diffs else "ok", diffs)


def _leres_like(weights_dir: str, family: str) -> dict:
    """LeReS ``res101.pth``, MiDaS ``model.pt``, SGRNet ``model.pth.tar``:
    found and read as the loaders find and read them, then audited."""
    from ..models.leres import LeReSConfig, RelDepthModel, SGRNetDepth
    from ..models.midas import MidasNet
    from . import weights as W
    from .depth_service import (_find_leres_checkpoint, _find_midas_checkpoint,
                                _find_sgrnet_checkpoint)

    find = {"leres": _find_leres_checkpoint, "midas": _find_midas_checkpoint,
            "sgrnet": _find_sgrnet_checkpoint}[family]
    ckpt = find(os.path.join(weights_dir, "leres")) or find(weights_dir)
    if ckpt is None:
        return _report(family, "absent")
    state = W.read_depth_checkpoint(ckpt)
    if family == "leres":
        cfg = LeReSConfig.resnext101()
        name_map, map_name = W.leres_name_map(cfg), "leres_name_map(resnext101)"
        template = W._template(lambda: RelDepthModel(cfg))
    elif family == "sgrnet":
        cfg = LeReSConfig.resnet50()
        name_map, map_name = W.sgrnet_name_map(cfg), "sgrnet_name_map(resnet50)"
        template = W._template(lambda: SGRNetDepth(cfg))
    else:
        cfg = LeReSConfig.resnext101()
        name_map, map_name = W.midas_name_map(cfg), "midas_name_map(resnext101)"
        template = W._template(lambda: MidasNet(cfg))
    diffs = audit_state_dict(state, name_map, expected_shapes(name_map, template), map_name)
    return _report(family, "error" if diffs else "ok", diffs, ckpt)


def _validate_merge(weights_dir: str) -> dict:
    from ..models.pix2pix import UnetGenerator
    from . import weights as W

    cands = sorted(glob.glob(os.path.join(weights_dir, "merge_model_sc", "**", "*net_G*.pth"),
                             recursive=True))
    cands += sorted(glob.glob(os.path.join(weights_dir, "**", "epoch_*"), recursive=True))
    cands = [c for c in cands if os.path.isfile(c)]
    if not cands:
        return _report("merge_model_sc", "absent")
    state = load_torch_checkpoint(cands[0])
    if state is None:
        return _report("merge_model_sc", "error", [f"unreadable checkpoint {cands[0]}"])
    name_map = W.unet_generator_name_map(10)
    shapes = expected_shapes(name_map, W._template(lambda: UnetGenerator(1, 1, 10)),
                             key_of=W.pix2pix_key)
    diffs = audit_state_dict(state, name_map, shapes, "unet_generator_name_map(10)")
    return _report("merge_model_sc", "error" if diffs else "ok", diffs, cands[0])


def _validate_clip(weights_dir: str) -> dict:
    from ..models.clip import (CLIPTextConfig, CLIPTextEncoder, CLIPVisionConfig,
                               CLIPVisionEncoder)
    from . import weights as W

    family = "clip-vit-base-patch32"
    d = os.path.join(weights_dir, family)
    if not os.path.isdir(d):
        return _report(family, "absent")
    path = next((os.path.join(d, f) for f in ("model.safetensors", "pytorch_model.bin")
                 if os.path.exists(os.path.join(d, f))), None)
    if path is None:
        return _report(family, "error",
                       ["missing checkpoint model.safetensors (or pytorch_model.bin)"])
    state = load_torch_checkpoint(path)
    if state is None:
        return _report(family, "error", [f"unreadable checkpoint {path}"])
    vcfg, tcfg = CLIPVisionConfig.vit_b32(), CLIPTextConfig.vit_b32()
    vmap, tmap = W.clip_vision_name_map(vcfg.layers), W.clip_text_name_map(tcfg.layers)
    diffs = audit_state_dict(
        state, vmap, expected_shapes(vmap, W._template(lambda: CLIPVisionEncoder(vcfg))),
        "clip_vision_name_map")
    diffs += audit_state_dict(
        state, tmap, expected_shapes(tmap, W._template(lambda: CLIPTextEncoder(tcfg))),
        "clip_text_name_map")
    return _report(family, "error" if diffs else "ok", diffs, path)


def validate_tree(weights_dir: str) -> List[dict]:
    """One report dict per family under ``weights_dir``: status ok,
    absent or error, with ``diffs`` naming each offending file, key or
    shape and its name map.  An empty or absent tree is all-absent (the
    services then run their procedural or random-init stand-ins)."""
    if not weights_dir or not os.path.isdir(weights_dir):
        return [_report(f, "absent") for f in EPS_NOTES]
    return [
        _validate_sd_tree(weights_dir, "stable-diffusion-2-1-base"),
        _validate_sd_tree(weights_dir, "stable-diffusion-2-inpainting"),
        _leres_like(weights_dir, "leres"),
        _leres_like(weights_dir, "midas"),
        _leres_like(weights_dir, "sgrnet"),
        _validate_merge(weights_dir),
        _validate_clip(weights_dir),
    ]
