"""The LPIPS perceptual distance (port of ``text2nerf_tpu/models/lpips.py``):
AlexNet or VGG16 feature stacks, each layer's features normalized over
channels and compared through the learned 1x1 linear heads of lpips v0.1.

The modules carry the torch originals' names (torchvision's
``features.<i>`` and lpips' ``lin<i>.model.1.weight``), so their state
dicts load as they are; ``services/weights.py`` ``load_lpips`` reads the
weights (the torch files, or the JAX package's converted
``lpips_<net>.npz``) and raises without them: a random-weight LPIPS means
nothing as a metric.  NCHW, fp32, convolutions through cuDNN with TF32
off.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn as nn

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# torchvision's ``features`` indices of the convolutions, and of the
# ReLUs whose outputs LPIPS compares
ALEX_CONVS = (0, 3, 6, 8, 10)
ALEX_TAPS = (1, 4, 7, 9, 11)
VGG16_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
VGG16_TAPS = (3, 8, 15, 22, 29)
CHANNELS = {"alex": (64, 192, 384, 256, 256), "vgg": (64, 128, 256, 512, 512)}


def alex_features() -> nn.Sequential:
    """torchvision AlexNet's ``features`` up to its last ReLU."""
    return nn.Sequential(
        nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
        nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
        nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
        nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
        nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(),
    )


def vgg16_features() -> nn.Sequential:
    """torchvision VGG16's ``features`` up to relu5_3 (2+2+3+3+3 convs,
    a 2x2 pool after each of the first four stages)."""
    layers: List[nn.Module] = []
    c_in = 3
    for stage, (width, n) in enumerate(zip(CHANNELS["vgg"], (2, 2, 3, 3, 3))):
        for _ in range(n):
            layers += [nn.Conv2d(c_in, width, 3, padding=1), nn.ReLU()]
            c_in = width
        if stage < 4:
            layers.append(nn.MaxPool2d(2, 2))
    return nn.Sequential(*layers)


class NetLin(nn.Module):
    """lpips' linear head: a 1x1 convolution to one channel, no bias
    (``model.0`` is its dropout, the identity at evaluation)."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, x):
        return self.model(x)


class LPIPSModel(nn.Module):
    """LPIPS over one backbone (``net`` "alex" or "vgg")."""

    def __init__(self, net: str = "alex"):
        super().__init__()
        if net not in CHANNELS:
            raise ValueError(f"LPIPS net {net!r}: 'alex' or 'vgg'")
        self.features = alex_features() if net == "alex" else vgg16_features()
        self.taps = ALEX_TAPS if net == "alex" else VGG16_TAPS
        for i, c in enumerate(CHANNELS[net]):
            setattr(self, f"lin{i}", NetLin(c))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)

    def feature_maps(self, x):
        """The compared ReLU outputs of an NCHW batch in [0, 1]."""
        h = ((x * 2 - 1) - self.shift) / self.scale
        feats = []
        for i, layer in enumerate(self.features):
            h = layer(h)
            if i in self.taps:
                feats.append(h)
        return feats

    def forward(self, img0, img1):
        """The distance of two NCHW batches in [0, 1], one per item."""
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            f0, f1 = self.feature_maps(img0), self.feature_maps(img1)
            total = 0.0
            for i, (a, b) in enumerate(zip(f0, f1)):
                a = a / (torch.sqrt(torch.sum(a * a, dim=1, keepdim=True)) + 1e-10)
                b = b / (torch.sqrt(torch.sum(b * b, dim=1, keepdim=True)) + 1e-10)
                total = total + getattr(self, f"lin{i}")((a - b) ** 2).mean(dim=(1, 2, 3))
        return total

    @torch.no_grad()
    def distance(self, img0, img1) -> float:
        """The distance of two (H, W, 3) images in [0, 1] (numpy or
        tensors), computed on the model's device."""
        dev = next(self.parameters()).device

        def nchw(x):
            t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x, np.float32))
            return t.to(device=dev, dtype=torch.float32).permute(2, 0, 1)[None]

        return float(self(nchw(img0), nchw(img1))[0])

