"""The generative services behind one injectable bundle (port of
``text2nerf_tpu/services/registry.py``, the procedural route and the
depth-merge net).

The trainer's scene bootstrap calls ``text2img`` and ``estimate_depth``;
scene expansion calls ``inpaint``, ``rank``, ``estimate_depth`` and
``merge``.  :func:`default_services` resolves each as the JAX package
does: the procedural stand-ins, and the merge net from
``merge_model_sc.npz`` in ``weights_dir`` when it is there, else at its
seeded random init.  A ``weights_dir`` that holds diffusion, LeReS or
CLIP weights raises: those networks are not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable, List, Optional, Sequence

import numpy as np

from . import fallbacks
from .merge import DepthMergeService

#: the weight entries of a weights directory, by service, whose networks
#: are not ported
_UNPORTED = {
    "text2img": "stable-diffusion-2-1-base",
    "inpaint": "stable-diffusion-2-inpainting",
    "depth": "leres",
    "rank": "clip-vit-base-patch32",
}
MERGE_WEIGHTS = "merge_model_sc.npz"


@dataclasses.dataclass
class Services:
    """The generative prior bundle used by the trainer."""

    # (prompt, negative_prompt) -> (H, W, 3) float image in [0, 1]
    text2img: Callable[..., np.ndarray]
    # (image01) -> 16-bit depth counts (LeReS convention)
    estimate_depth: Callable[..., np.ndarray]
    # (image01, holes_mask, prompt=, negative_prompt=, num_images=, seed=)
    # -> [candidates]
    inpaint: Optional[Callable[..., List[np.ndarray]]] = None
    # (candidates, reference01) -> scores, higher is better
    rank: Optional[Callable[[Sequence[np.ndarray], np.ndarray], np.ndarray]] = None
    # the per-view depth-merge finetuner
    merge: Optional[DepthMergeService] = None
    # what each family resolved to: 'real' | 'fallback' | 'init'
    resolution: dict = dataclasses.field(default_factory=dict)


def default_services(weights_dir: Optional[str] = None, hw=(512, 512),
                     merge_net_size: int = 1024, merge_num_downs: int = 10,
                     device=None) -> Services:
    """The bundle: procedural text2img, depth, inpainting and ranking, and
    the merge net at ``merge_net_size`` / ``merge_num_downs`` (from
    ``weights_dir/merge_model_sc.npz`` when it exists).  The inpainting
    blur and the merge finetune run on ``device`` (cuda unless asked)."""
    weights_dir = weights_dir or ""

    def _has(sub):
        return bool(weights_dir) and os.path.exists(os.path.join(weights_dir, sub))

    found = [sub for sub in _UNPORTED.values() if _has(sub)]
    if found:
        raise NotImplementedError(
            f"{weights_dir} holds real weights ({', '.join(found)}); the diffusion, "
            "depth and CLIP networks are not ported yet"
        )

    def text2img(prompt, negative_prompt=""):
        return fallbacks.procedural_text2img(prompt, negative_prompt, hw=hw)

    merge = DepthMergeService(
        ckpt_path=os.path.join(weights_dir, MERGE_WEIGHTS) if weights_dir else None,
        net_size=merge_net_size, num_downs=merge_num_downs, device=device,
    )
    return Services(
        text2img=text2img,
        estimate_depth=fallbacks.procedural_depth,
        inpaint=functools.partial(fallbacks.diffusion_fill_inpaint, device=device),
        rank=fallbacks.histogram_rank,
        merge=merge,
        resolution={"text2img": "fallback", "inpaint": "fallback", "depth": "fallback",
                    "rank": "fallback", "merge": "real" if _has(MERGE_WEIGHTS) else "init"},
    )
