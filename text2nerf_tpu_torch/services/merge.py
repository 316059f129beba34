"""The depth-merge service (port of ``DepthMergeService`` from
``text2nerf_tpu/services/merge.py``): per-view test-time finetuning of
the pix2pix U-Net.

Given the field's rendered depth on the known pixels (the reference) and
the aligned monocular estimate of the whole inpainted view (the source),
both in [-1, 1], :meth:`DepthMergeService.run_finetune` finetunes the
one-channel ``unet_1024`` generator for ``iters`` Adam steps so that its
output matches the reference where known, then predicts the whole view.
The loop is plain Python on the device: forward at ``net_size``², the
masked MSE of the output nearest-resized to ``outsize``, backward,
``torch.optim.Adam``.

The generator starts from a ``merge_model_sc.npz`` in the JAX package's
layout (flax params under ``UnetSkipBlock_i/...``, see
:func:`..models.pix2pix.state_from_flax`) when one is given, else from a
seeded random init.  Torch checkpoints of the reference, offline
pretraining and saving are not ported.
"""

from __future__ import annotations

import copy
import os
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.pix2pix import UnetGenerator, minmax_normalize, state_from_flax


def nearest_resize(img, size):
    """(H, W) → (size, size), or (h, w) for a pair, the source pixel of
    output i being floor((i + 0.5) · in / out) computed in fp32
    (``jax.image.resize``'s "nearest", half-pixel centres: a 1024 → 512
    downsample takes pixel 2i + 1)."""
    out_h, out_w = (size, size) if isinstance(size, int) else size

    def index(n_in, n_out):
        pos = (torch.arange(n_out, dtype=torch.float32, device=img.device) + 0.5) * n_in / n_out
        return torch.floor(pos).long()

    return img[index(img.shape[0], out_h)][:, index(img.shape[1], out_w)]


class DepthMergeService:
    """The generator and its base parameters.  Each call finetunes a copy
    of the base parameters on ``device`` (cuda unless asked), resolved at
    the call.  The generator is built on the CPU at first use, so its
    random init does not depend on the device."""

    def __init__(self, ckpt_path: Optional[str] = None, net_size: int = 1024,
                 num_downs: int = 10, seed: int = 0, compute_dtype=torch.bfloat16,
                 device=None):
        if ckpt_path is not None and os.path.exists(ckpt_path) \
                and not ckpt_path.endswith(".npz"):
            raise NotImplementedError(
                f"{ckpt_path}: only the npz layout of flax params is read; torch "
                "checkpoints of the merge net are not ported yet")
        self.ckpt_path = ckpt_path
        self.net_size = net_size
        self.num_downs = num_downs
        self.seed = seed
        self.compute_dtype = compute_dtype
        self.device = device
        self._model = None
        self._net = None  # the finetuned copy, on the device of the last call

    @property
    def model(self) -> UnetGenerator:
        """The generator at its base parameters (on the CPU), built at
        first use: the checkpoint's weights, else the seeded init."""
        if self._model is None:
            model = UnetGenerator(1, 1, self.num_downs,
                                  generator=torch.Generator().manual_seed(self.seed))
            if self.ckpt_path is not None and os.path.exists(self.ckpt_path):
                with np.load(self.ckpt_path) as data:
                    model.load_state_dict(state_from_flax(dict(data)))
            self._model = model.requires_grad_(False)
        return self._model

    def _inputs(self, depth_src, dev):
        inp = nearest_resize(torch.as_tensor(np.asarray(depth_src, np.float32), device=dev),
                             self.net_size)
        return minmax_normalize(inp)[None, None]

    def _working_net(self, dev):
        """The generator on ``dev``, reset to the base parameters."""
        if self._net is None or self._net[0] != dev:
            self._net = (dev, copy.deepcopy(self.model).to(dev))
        net = self._net[1]
        with torch.no_grad():
            for p, p0 in zip(net.parameters(), self.model.parameters()):
                p.copy_(p0)
        return net

    def run_finetune(self, depth_ref: np.ndarray, depth_src: np.ndarray,
                     mask_ref: np.ndarray, outsize: int = 512, lr: float = 1e-5,
                     iters: int = 500) -> np.ndarray:
        """``depth_ref`` (outsize, outsize) in [-1, 1], valid where
        ``mask_ref`` > 0; ``depth_src`` (outsize, outsize) in [-1, 1].
        Returns the merged (outsize, outsize) depth in [-1, 1], float32
        holding values of the compute type."""
        dev = resolve_device(self.device)
        inp = self._inputs(depth_src, dev)
        ref = torch.as_tensor(np.asarray(depth_ref, np.float32), device=dev)
        mask = torch.as_tensor(np.asarray(mask_ref, np.float32), device=dev)
        net = self._working_net(dev)
        net.requires_grad_(True)
        opt = torch.optim.Adam(net.parameters(), lr=float(lr), betas=(0.9, 0.99), eps=1e-8)
        for _ in range(iters):
            opt.zero_grad(set_to_none=True)
            out = nearest_resize(net(inp, self.compute_dtype)[0, 0], outsize)
            # the product with the fp32 mask promotes the loss to fp32
            loss = torch.mean((out * mask - ref * mask) ** 2)
            loss.backward()
            opt.step()
        net.requires_grad_(False)
        with torch.no_grad():
            out = nearest_resize(net(inp, self.compute_dtype)[0, 0], outsize)
        return out.float().cpu().numpy()

    @torch.no_grad()
    def run(self, depth_src: np.ndarray, outsize: int = 512) -> np.ndarray:
        """The generator's plain forward pass at the base parameters."""
        dev = resolve_device(self.device)
        net = self._working_net(dev)
        out = nearest_resize(net(self._inputs(depth_src, dev), self.compute_dtype)[0, 0],
                             outsize)
        return out.float().cpu().numpy()
