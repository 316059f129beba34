"""CLIP ranking of inpainting candidates (port of
``text2nerf_tpu/services/clip_rank.py``): the candidates and the seed view
embedded by the ViT-B/32 vision tower, scored by the cosine of each
candidate's embedding with the seed view's, times the logit scale.

:func:`preprocess` resizes as ``cv2.resize(INTER_CUBIC)`` does on float32
images (separable Keys cubic, A = -0.75, half-pixel centres, clamped
taps, no antialias), in numpy: the port imports no image library.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.clip import CLIPVisionConfig, CLIPVisionEncoder, cosine_scores
from ..models.diffusion import materialize
from . import weights as W
from .fallbacks import _resize_bicubic_np

_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
CV2_CUBIC = -0.75  # OpenCV's INTER_CUBIC coefficient


def preprocess(images: Sequence[np.ndarray], size: int = 224) -> np.ndarray:
    """(B, size, size, 3): each image resized bicubically, then CLIP's
    normalization."""
    return np.stack([
        (_resize_bicubic_np(np.asarray(img, np.float32), size, size, CV2_CUBIC) - _CLIP_MEAN)
        / _CLIP_STD for img in images]).astype(np.float32)


def make_clip_ranker(weights_path: str, logit_scale: float = 100.0, device=None):
    """``rank(candidates, reference)`` → scores (higher is better) on
    ``device`` (cuda unless asked); the net is its ``model`` attribute.
    Weights: the ``vision`` tree of a converted ``.npz``, else an HF CLIP
    checkpoint (``model.safetensors`` / ``pytorch_model.bin``, held to the
    ≥ 99% coverage check), else, when the directory holds no checkpoint, a
    seeded random init."""
    dev = resolve_device(device)
    cfg = CLIPVisionConfig.vit_b32()

    def make():
        return CLIPVisionEncoder(cfg)

    tree = W.load_converted(weights_path)
    if tree is not None and "vision" in tree:
        model = materialize(make, dev)
        model.load_state_dict(W.clip_vision_state_from_flax(tree["vision"], cfg), strict=True)
    else:
        model = None
        for fname in ("model.safetensors", "pytorch_model.bin"):
            path = os.path.join(weights_path, fname)
            state = W.load_torch_checkpoint(path)
            if state is not None:
                name_map = W.clip_vision_name_map(cfg.layers)
                W.require_coverage(state, name_map, "CLIP vision", path)
                model = W.load_state(materialize(make, dev), state, [name_map])
                break
        if model is None:
            found = W.checkpoint_files(weights_path) if os.path.isdir(weights_path) else []
            if found:
                raise ValueError(f"{weights_path} holds checkpoint files the port cannot read: "
                                 f"{found}")
            model = materialize(make, dev, torch.Generator(device=dev).manual_seed(0))

    @torch.no_grad()
    def rank(candidates: Sequence[np.ndarray], reference: np.ndarray) -> np.ndarray:
        imgs = torch.from_numpy(preprocess(list(candidates) + [reference])).to(dev)
        embeds = model(imgs.permute(0, 3, 1, 2))["embeds"]
        return cosine_scores(embeds[:-1], embeds[-1:], logit_scale).cpu().numpy()

    rank.model = model
    return rank
