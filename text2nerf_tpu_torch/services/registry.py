"""The generative services behind one injectable bundle (port of
``text2nerf_tpu/services/registry.py``).

The trainer's scene bootstrap calls ``text2img`` and ``estimate_depth``;
scene expansion calls ``inpaint``, ``rank``, ``estimate_depth`` and
``merge``.  :func:`default_services` resolves each as the JAX package
does: a service whose entry exists in ``weights_dir`` runs its network
("real": SD 2.1-base text2img, SD 2-inpainting, the CLIP ViT-B/32 ranker,
each from its checkpoint or, in a directory that holds none, at its
seeded random init), else its procedural stand-in ("fallback"); the merge
net from ``merge_model_sc.npz`` when it is there, else at its seeded
random init.  A ``weights_dir`` with a ``leres/`` entry raises: the depth
family comes with a later slice of the port.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable, List, Optional, Sequence

import numpy as np

from . import fallbacks
from .merge import DepthMergeService

#: the entry of a weights directory of each service
WEIGHTS = {
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
    """The bundle for ``weights_dir`` (see the module docstring); the
    networks, the inpainting blur and the merge finetune run on ``device``
    (cuda unless asked)."""
    weights_dir = weights_dir or ""

    def _has(sub):
        return bool(weights_dir) and os.path.exists(os.path.join(weights_dir, sub))

    def path(service):
        return os.path.join(weights_dir, WEIGHTS[service])

    if _has(WEIGHTS["depth"]):
        raise NotImplementedError(
            f"{path('depth')}: the depth estimators (LeReS, MiDaS, monodepth) are not ported "
            "yet; they come with the port's depth-family slice")
    if _has(WEIGHTS["text2img"]):
        from .diffusion_service import make_text2img

        text2img = make_text2img(path("text2img"), hw=hw, device=device)
    else:
        def text2img(prompt, negative_prompt=""):
            return fallbacks.procedural_text2img(prompt, negative_prompt, hw=hw)
    if _has(WEIGHTS["inpaint"]):
        from .diffusion_service import make_inpaint

        inpaint = make_inpaint(path("inpaint"), hw=hw, device=device)
    else:
        inpaint = functools.partial(fallbacks.diffusion_fill_inpaint, device=device)
    if _has(WEIGHTS["rank"]):
        from .clip_rank import make_clip_ranker

        rank = make_clip_ranker(path("rank"), device=device)
    else:
        rank = fallbacks.histogram_rank

    merge = DepthMergeService(
        ckpt_path=os.path.join(weights_dir, MERGE_WEIGHTS) if weights_dir else None,
        net_size=merge_net_size, num_downs=merge_num_downs, device=device,
    )
    resolution = {k: "real" if _has(sub) else "fallback" for k, sub in WEIGHTS.items()}
    resolution["merge"] = "real" if _has(MERGE_WEIGHTS) else "init"
    return Services(text2img=text2img, estimate_depth=fallbacks.procedural_depth,
                    inpaint=inpaint, rank=rank, merge=merge, resolution=resolution)
