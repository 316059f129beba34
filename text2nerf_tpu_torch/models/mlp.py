"""Shading head (port of ``text2nerf_tpu/models/mlp.py``).

- ``MLP_Fea_noview``, the default Text2NeRF head: input = [app_features,
  PE(app_features, fea_pe)], two hidden ReLU layers, sigmoid RGB;
- ``MLP_Fea``: adds the view directions and their PE;
- ``MLP_PE``: the sample positions' PE (the renderers pass the normalized
  coordinates, as the JAX package's do) and the view directions' (the
  head's input width is the input it gets: see :func:`mlp_input_dim`);
- ``MLP``: the view directions' PE only;
- ``SH``: degree-2 real SH of the view direction against 3 × 9
  coefficients, ReLU(· + 0.5); ``RGB``: the features themselves.

Weights are kept in the JAX package's ``(in, out)`` layout so the two
packages' parameters map one to one.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .sh import eval_sh_bases


def positional_encoding(x, freqs: int):
    """Sin/cos PE over 2**k bands: (..., D) → (..., 2 * freqs * D), all
    sines of every (dim, band) pair, channel-major, then all cosines."""
    bands = 2.0 ** torch.arange(freqs, dtype=x.dtype, device=x.device)
    pts = (x[..., None] * bands).reshape(*x.shape[:-1], freqs * x.shape[-1])
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=-1)


def mlp_input_dim(mode: str, app_dim: int, view_pe: int, fea_pe: int, pos_pe: int):
    if mode == "MLP_Fea_noview":
        return 2 * fea_pe * app_dim + app_dim
    if mode == "MLP_Fea":
        return 2 * view_pe * 3 + 2 * fea_pe * app_dim + 3 + app_dim
    if mode == "MLP_PE":
        # the input :func:`shade` builds: features, view directions and the
        # PE of both positions and directions.  The JAX package (as the
        # reference TensoRF's MLPRender_PE) counts 3 more, for raw positions
        # its head never concatenates, so its MLP_PE field fails at its
        # first shade; the port sizes the head to its input.
        return (3 + 2 * view_pe * 3) + 2 * pos_pe * 3 + app_dim
    if mode == "MLP":
        return (3 + 2 * view_pe * 3) + app_dim
    raise ValueError(f"unknown MLP shading mode: {mode}")


class ShadingMLP(nn.Module):
    """Three-layer ReLU MLP with sigmoid output; weights ``(in, out)``."""

    def __init__(self, in_dim: int, feature_c: int = 128, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.w1 = nn.Parameter(torch.empty(in_dim, feature_c, **kw))
        self.b1 = nn.Parameter(torch.empty(feature_c, **kw))
        self.w2 = nn.Parameter(torch.empty(feature_c, feature_c, **kw))
        self.b2 = nn.Parameter(torch.empty(feature_c, **kw))
        self.w3 = nn.Parameter(torch.empty(feature_c, 3, **kw))
        self.b3 = nn.Parameter(torch.empty(3, **kw))

    def __getitem__(self, key: str):
        return getattr(self, key)


def init_mlp(in_dim: int, feature_c: int = 128, *, generator: torch.Generator,
             device=None, dtype=torch.float32) -> ShadingMLP:
    """torch.nn.Linear default init (U[-1/sqrt(fan_in), 1/sqrt(fan_in)]) and
    a zero final bias.  Same statistics as the JAX init, not the same bits."""
    mlp = ShadingMLP(in_dim, feature_c, device=device, dtype=dtype)
    with torch.no_grad():
        for w, b, fan_in in ((mlp.w1, mlp.b1, in_dim), (mlp.w2, mlp.b2, feature_c)):
            bound = 1.0 / fan_in ** 0.5
            w.uniform_(-bound, bound, generator=generator)
            b.uniform_(-bound, bound, generator=generator)
        mlp.w3.uniform_(-1.0 / feature_c ** 0.5, 1.0 / feature_c ** 0.5,
                        generator=generator)
        mlp.b3.zero_()
    return mlp


def apply_mlp(params, x):
    """The 3-layer ReLU MLP + sigmoid in fp32."""
    h = torch.relu(x @ params["w1"] + params["b1"])
    h = torch.relu(h @ params["w2"] + params["b2"])
    rgb = h @ params["w3"] + params["b3"]
    return torch.sigmoid(rgb.float())


def shade(
    mode: str,
    mlp_params,
    pts: Optional[torch.Tensor],
    viewdirs: Optional[torch.Tensor],
    features,
    view_pe: int = 6,
    fea_pe: int = 6,
    pos_pe: int = 6,
):
    """Plain shading head for every mode; returns (N, 3) rgb in [0, 1].
    ``pts`` are the normalized sample coordinates (``MLP_PE`` only) and
    ``viewdirs`` the ray directions (every mode but ``MLP_Fea_noview`` and
    ``RGB``)."""
    if mode == "MLP_Fea_noview":
        x = torch.cat([features, positional_encoding(features, fea_pe)], dim=-1)
        return apply_mlp(mlp_params, x)
    if mode == "MLP_Fea":
        parts = [features, viewdirs]
        if fea_pe > 0:
            parts.append(positional_encoding(features, fea_pe))
        if view_pe > 0:
            parts.append(positional_encoding(viewdirs, view_pe))
        return apply_mlp(mlp_params, torch.cat(parts, dim=-1))
    if mode == "MLP_PE":
        parts = [features, viewdirs]
        if pos_pe > 0:
            parts.append(positional_encoding(pts, pos_pe))
        if view_pe > 0:
            parts.append(positional_encoding(viewdirs, view_pe))
        return apply_mlp(mlp_params, torch.cat(parts, dim=-1))
    if mode == "MLP":
        parts = [features, viewdirs]
        if view_pe > 0:
            parts.append(positional_encoding(viewdirs, view_pe))
        return apply_mlp(mlp_params, torch.cat(parts, dim=-1))
    if mode == "SH":
        sh_mult = eval_sh_bases(2, viewdirs)[:, None]
        rgb_sh = features.reshape(-1, 3, sh_mult.shape[-1])
        return torch.relu(torch.sum(sh_mult * rgb_sh, dim=-1) + 0.5)
    if mode == "RGB":
        return features
    raise ValueError(f"unknown shading mode: {mode}")
