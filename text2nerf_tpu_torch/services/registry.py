"""The generative services behind one injectable bundle (port of
``text2nerf_tpu/services/registry.py``, the procedural route only).

The trainer's scene bootstrap calls ``text2img`` and ``estimate_depth``.
``inpaint``, ``rank`` and ``merge`` belong to scene expansion and stay
``None`` until it is ported; so do the real networks: a ``weights_dir``
that holds any of their weights raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np

from . import fallbacks

#: the weight entries of a weights directory, by service
_WEIGHTS = {
    "text2img": "stable-diffusion-2-1-base",
    "inpaint": "stable-diffusion-2-inpainting",
    "depth": "leres",
    "rank": "clip-vit-base-patch32",
    "merge": "merge_model_sc.npz",
}


@dataclasses.dataclass
class Services:
    """The generative prior bundle used by the trainer."""

    # (prompt, negative_prompt) -> (H, W, 3) float image in [0, 1]
    text2img: Callable[..., np.ndarray]
    # (image01) -> 16-bit depth counts (LeReS convention)
    estimate_depth: Callable[..., np.ndarray]
    inpaint: Optional[Callable] = None
    rank: Optional[Callable] = None
    merge: Optional[object] = None
    # what each family resolved to ('fallback' here)
    resolution: dict = dataclasses.field(default_factory=dict)


def default_services(weights_dir: Optional[str] = None, hw=(512, 512)) -> Services:
    """The procedural bundle.  A ``weights_dir`` holding any real weights
    raises ``NotImplementedError``: the networks are not ported yet."""
    if weights_dir:
        found = [sub for sub in _WEIGHTS.values()
                 if os.path.exists(os.path.join(weights_dir, sub))]
        if found:
            raise NotImplementedError(
                f"{weights_dir} holds real weights ({', '.join(found)}); the "
                "generative networks are not ported yet"
            )

    def text2img(prompt, negative_prompt=""):
        return fallbacks.procedural_text2img(prompt, negative_prompt, hw=hw)

    return Services(
        text2img=text2img,
        estimate_depth=fallbacks.procedural_depth,
        resolution={"text2img": "fallback", "depth": "fallback"},
    )
