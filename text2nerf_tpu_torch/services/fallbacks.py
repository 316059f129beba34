"""Procedural stand-ins for the generative services (port of
``text2nerf_tpu/services/fallbacks.py``).

- :func:`procedural_text2img`: a seed image from the prompt's hash.
- :func:`procedural_depth`: 16-bit depth counts in the LeReS convention
  ``counts = (depth - push) * 12000``.
- :func:`diffusion_fill_inpaint`: hole filling by an iterated masked
  blur on the device, plus per-candidate texture noise (numpy).
- :func:`histogram_rank`: candidates ranked by color statistics.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

import numpy as np
import torch

from ..device import resolve_device


def _prompt_seed(prompt: str) -> int:
    return int.from_bytes(hashlib.sha256(prompt.encode()).digest()[:4], "little")


def _cubic_weights(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys cubic interpolation kernel (the bicubic resize kernel)."""
    ax = np.abs(x)
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax ** 3 - (a + 3.0) * ax ** 2 + 1.0,
        np.where(
            ax < 2.0,
            a * ax ** 3 - 5.0 * a * ax ** 2 + 8.0 * a * ax - 4.0 * a,
            0.0,
        ),
    ).astype(np.float32)


def _resize_bicubic_np(grid: np.ndarray, h: int, w: int, a: float = -0.5) -> np.ndarray:
    """Separable bicubic resize (half-pixel centers, clamped taps, no
    antialias) with Keys coefficient ``a``: -0.5 is ``jax.image.resize``'s,
    -0.75 OpenCV's ``INTER_CUBIC``."""

    def along(arr, n_out, axis):
        n_in = arr.shape[axis]
        coord = (np.arange(n_out, dtype=np.float64) + 0.5) * n_in / n_out - 0.5
        base = np.floor(coord).astype(np.int64)
        taps = base[None, :] + np.arange(-1, 3)[:, None]          # (4, n_out)
        wts = _cubic_weights(coord[None, :] - taps, a)            # (4, n_out)
        wts /= np.maximum(wts.sum(0, keepdims=True), 1e-8)
        taps = np.clip(taps, 0, n_in - 1)
        moved = np.moveaxis(arr, axis, 0)
        out = np.einsum("ko,ko...->o...", wts, moved[taps])
        return np.moveaxis(out.astype(np.float32), 0, axis)

    g = along(grid.astype(np.float32), h, 0)
    return along(g, w, 1)


def _box_mean_same(x: np.ndarray, k: int) -> np.ndarray:
    """Zero-padded k×k windowed mean (= SAME conv with a 1/k² kernel)."""
    p = k // 2
    xp = np.pad(x.astype(np.float64), p)
    s = np.pad(np.cumsum(np.cumsum(xp, 0), 1), ((1, 0), (1, 0)))
    h, w = x.shape
    win = (
        s[k : k + h, k : k + w]
        - s[0:h, k : k + w]
        - s[k : k + h, 0:w]
        + s[0:h, 0:w]
    )
    return (win / float(k * k)).astype(np.float32)


def _value_noise(rng: np.random.Generator, h: int, w: int, octaves=(4, 8, 16, 32)):
    """Smooth multi-octave value noise in [0, 1]."""
    acc = np.zeros((h, w), np.float32)
    amp_total = 0.0
    for i, cells in enumerate(octaves):
        amp = 0.5 ** i
        grid = rng.random((cells, cells)).astype(np.float32)
        acc += amp * _resize_bicubic_np(grid, h, w)
        amp_total += amp
    acc /= amp_total
    return np.clip(acc, 0.0, 1.0)


def procedural_text2img(prompt: str, negative_prompt: str = "", hw=(512, 512)):
    """Deterministic scene-like seed image derived from the prompt: a
    sky/ground gradient, smooth noise texture and a prompt-seeded palette.
    Returns float32 [0, 1] (H, W, 3)."""
    h, w = hw
    rng = np.random.default_rng(_prompt_seed(prompt))
    base = rng.random(3).astype(np.float32) * 0.5 + 0.25
    accent = rng.random(3).astype(np.float32) * 0.6 + 0.2

    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    sky = np.stack(
        [np.clip(base[c] + 0.35 * (1 - y), 0, 1) * np.ones((h, w)) for c in range(3)],
        -1,
    )
    tex = _value_noise(rng, h, w)
    detail = _value_noise(rng, h, w, octaves=(16, 32, 64))
    ground_blend = np.clip((y - 0.45) * 4.0, 0, 1)[..., None]
    ground = np.stack(
        [accent[c] * (0.5 + 0.5 * tex) for c in range(3)], -1
    )
    img = sky * (1 - ground_blend) + ground * ground_blend
    img += (detail[..., None] - 0.5) * 0.15
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def procedural_depth(image: np.ndarray, push_depth: float = 2.0) -> np.ndarray:
    """Plausible depth counts for an image: near ground at the bottom, far
    sky at the top, modulated by smooth luminance structure.  Returns
    counts such that ``counts / 12000 + push_depth`` is a metric depth in
    about [push, push + 4.5]."""
    h, w = image.shape[:2]
    lum = image.mean(-1).astype(np.float32)
    smooth = _box_mean_same(lum, 9)  # zero-padded 9x9 box mean
    y = np.linspace(1.0, 0.0, h, dtype=np.float32)[:, None]  # top far
    depth_rel = 0.5 + 3.5 * (0.7 * y + 0.3 * smooth)  # ~[0.5, 4.5]
    counts = depth_rel * 12000.0
    return counts.astype(np.float64)


# the 3x3 binomial kernel of the fill's blur
_BINOMIAL = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float32) / 16.0
_FILL_ITERS = 256


def _blur(x, k):
    """Each plane of ``x`` (P, H, W) convolved with the 3x3 ``k`` under
    zero "SAME" padding (a depthwise conv2d)."""
    p = x.shape[0]
    return torch.nn.functional.conv2d(x[None], k.expand(p, 1, 3, 3), padding=1, groups=p)[0]


@torch.no_grad()
def _masked_fill(img, known):
    """Holes (``known`` == 0) of ``img`` (H, W, 3) filled by 256 rounds of
    a blur of the known-weighted colours and of the weights, normalized,
    with the known pixels put back after each round."""
    k = torch.as_tensor(_BINOMIAL, device=img.device)[None, None]
    img_c = img.permute(2, 0, 1)
    w = known[None]
    vals = img_c * w
    for _ in range(_FILL_ITERS):
        b = _blur(torch.cat([vals, w]), k)
        vals, w2 = b[:3], b[3:]
        vals = vals / torch.clamp(w2, min=1e-8)
        vals = vals * (1 - known) + img_c * known
        w = torch.maximum(w2, known[None])
        vals = vals * w
    return (vals / torch.clamp(w, min=1e-8)).permute(1, 2, 0)


def diffusion_fill_inpaint(
    image: np.ndarray,
    mask_holes: np.ndarray,
    prompt: str = "",
    negative_prompt: str = "",
    guidance_scale: float = 7.5,
    num_images: int = 5,
    seed: int = 0,
    device=None,
) -> List[np.ndarray]:
    """Fill the ``mask_holes > 0.5`` pixels of ``image`` (H, W, 3) in [0,
    1] by iterated masked diffusion of the surrounding content (on
    ``device``, cuda unless asked), then add per-candidate texture noise
    (numpy, seeded with ``seed`` and the prompt) inside the holes.
    Returns ``num_images`` float32 candidates in [0, 1], the contract of
    a diffusion inpainter; ``negative_prompt`` and ``guidance_scale`` are
    accepted for that contract and unused."""
    dev = resolve_device(device)
    img = np.asarray(image, np.float32)
    holes = np.asarray(mask_holes, np.float32)
    if holes.ndim == 3:
        holes = holes[..., 0]
    holes = (holes > 0.5).astype(np.float32)
    known = torch.as_tensor(1.0 - holes, device=dev)
    # TF32 off: the blur's sums stay fp32 on every device
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        base = _masked_fill(torch.as_tensor(img, device=dev), known).cpu().numpy()
    outs = []
    rng = np.random.default_rng(seed + _prompt_seed(prompt))
    for _ in range(num_images):
        tex = _value_noise(rng, img.shape[0], img.shape[1], octaves=(16, 32, 64))
        cand = base + (tex[..., None] - 0.5) * 0.08 * holes[..., None]
        outs.append(np.clip(cand, 0.0, 1.0).astype(np.float32))
    return outs


def histogram_rank(candidates: Sequence[np.ndarray], reference: np.ndarray):
    """Scores of inpainting candidates (higher is better): minus the
    chi-square distance of their 32-bin per-channel color histograms to
    the seed view's (the stand-in for CLIP's cosine ranking)."""
    def hist(img):
        hs = [
            np.histogram(img[..., c], bins=32, range=(0, 1), density=True)[0]
            for c in range(3)
        ]
        return np.concatenate(hs) + 1e-6

    ref_h = hist(np.asarray(reference))
    scores = []
    for cand in candidates:
        ch = hist(np.asarray(cand))
        chi2 = np.sum((ch - ref_h) ** 2 / (ch + ref_h))
        scores.append(-float(chi2))
    return np.asarray(scores)
