"""Procedural stand-ins for the generative services (port of
``procedural_text2img`` and ``procedural_depth`` from
``text2nerf_tpu/services/fallbacks.py``, numpy only).

- :func:`procedural_text2img`: a seed image from the prompt's hash.
- :func:`procedural_depth`: 16-bit depth counts in the LeReS convention
  ``counts = (depth - push) * 12000``.

The inpainting and ranking stand-ins come with scene expansion.
"""

from __future__ import annotations

import hashlib

import numpy as np


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


def _resize_bicubic_np(grid: np.ndarray, h: int, w: int) -> np.ndarray:
    """Separable bicubic upsample (half-pixel centers)."""

    def along(arr, n_out, axis):
        n_in = arr.shape[axis]
        coord = (np.arange(n_out, dtype=np.float64) + 0.5) * n_in / n_out - 0.5
        base = np.floor(coord).astype(np.int64)
        taps = base[None, :] + np.arange(-1, 3)[:, None]          # (4, n_out)
        wts = _cubic_weights(coord[None, :] - taps)               # (4, n_out)
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
