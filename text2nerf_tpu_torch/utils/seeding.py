"""Determinism helper (port of ``text2nerf_tpu/utils/seeding.py``).

The port's device randomness is explicit (``torch.Generator``s seeded by
the trainer and the services); this seeds the host's global numpy and
``random`` generators that samplers and pose jitter draw from.
"""

from __future__ import annotations

import random

import numpy as np


def set_seed(seed: int, base: int = 0) -> int:
    seed += base
    if seed < 0:
        raise ValueError(f"seed must be >= 0, got {seed}")
    np.random.seed(seed)
    random.seed(seed)
    return seed
