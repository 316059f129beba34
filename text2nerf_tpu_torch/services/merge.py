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

The generator starts from the checkpoint given, else from a seeded
random init: a ``merge_model_sc.npz`` in the JAX package's layout (flax
params under ``UnetSkipBlock_i/...``, see
:func:`..models.pix2pix.state_from_flax`), or the reference's torch
checkpoint (``.pth`` / ``.pt`` / ``.tar`` / ``.safetensors``, such as
``latest_net_G.pth``) read through ``unet_generator_name_map`` with every
parameter it lacks zero, as the JAX package reads it.

Offline pretraining (the reference's ``merge_model_single_channel.py``
training loop): :func:`synthetic_corruption` and
:func:`pretrain_merge_model`; :meth:`DepthMergeService.save` writes the
base parameters in the JAX package's npz layout.
"""

from __future__ import annotations

import copy
import os
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.pix2pix import UnetGenerator, minmax_normalize, state_from_flax, state_to_flax
from ..utils.atomic_io import atomic_savez

#: suffixes of the reference's torch checkpoints (the JAX package's list)
TORCH_SUFFIXES = (".pth", ".pt", ".tar", ".safetensors")


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


def state_from_torch(path: str, model: UnetGenerator, num_downs: int) -> dict:
    """``model``'s state dict from the reference's torch checkpoint at
    ``path``: each entry of ``unet_generator_name_map(num_downs)`` under
    its port name (both keep torch's layouts), every entry the checkpoint
    lacks zero (the JAX package's ``fill_missing_params``).  A shape that
    differs raises."""
    from .weights import load_torch_checkpoint, pix2pix_key, unet_generator_name_map

    ckpt = load_torch_checkpoint(path)
    state = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    for tname, fpath in unet_generator_name_map(num_downs).items():
        if tname not in ckpt:
            continue
        key = pix2pix_key(fpath)
        val = torch.as_tensor(ckpt[tname]).float()
        if val.shape != state[key].shape:
            raise ValueError(f"{path}: {tname} has shape {tuple(val.shape)}, the generator's "
                             f"{key} {tuple(state[key].shape)}")
        state[key] = val
    return state


class DepthMergeService:
    """The generator and its base parameters.  Each call finetunes a copy
    of the base parameters on ``device`` (cuda unless asked), resolved at
    the call.  The generator is built on the CPU at first use, so its
    random init does not depend on the device."""

    def __init__(self, ckpt_path: Optional[str] = None, net_size: int = 1024,
                 num_downs: int = 10, seed: int = 0, compute_dtype=torch.bfloat16,
                 device=None):
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
                if self.ckpt_path.endswith(TORCH_SUFFIXES):
                    state = state_from_torch(self.ckpt_path, model, self.num_downs)
                else:
                    with np.load(self.ckpt_path) as data:
                        state = state_from_flax(dict(data))
                model.load_state_dict(state)
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

    def save(self, path: str):
        """The base parameters as the JAX package's ``save`` writes them:
        flat ``UnetSkipBlock_i/...`` keys in the flax layouts."""
        atomic_savez(path, **state_to_flax(self.model.state_dict()))

    @torch.no_grad()
    def run(self, depth_src: np.ndarray, outsize: int = 512) -> np.ndarray:
        """The generator's plain forward pass at the base parameters."""
        dev = resolve_device(self.device)
        net = self._working_net(dev)
        out = nearest_resize(net(self._inputs(depth_src, dev), self.compute_dtype)[0, 0],
                             outsize)
        return out.float().cpu().numpy()


def synthetic_corruption(rng: np.random.Generator, depth: np.ndarray):
    """The reference's training corruption (its data loader), numpy, with
    the JAX package's draws in its order: given depth in [-1, 1],

        d2       = minmax(depth)                      # [0, 1]
        shift    ~ U(0, 1);  degree ~ randint(30, 60) # inclusive
        scale1   = U(0.9, 1.1) * d2 ** (1 / degree)   # pixelwise
        depth_in = minmax((d2 + shift) * scale1) * 2 - 1

    Returns depth_in in [-1, 1]."""
    lo, hi = depth.min(), depth.max()
    d2 = (depth - lo) / max(hi - lo, 1e-12)
    shift = rng.uniform(0.0, 1.0)
    degree = int(rng.integers(30, 61))  # random.randint(30, 60) inclusive
    scale1 = rng.uniform(0.9, 1.1) * np.power(d2, 1.0 / degree)
    depth_in = (d2 + shift) * scale1
    lo, hi = depth_in.min(), depth_in.max()
    return ((depth_in - lo) / max(hi - lo, 1e-12)) * 2.0 - 1.0


def pretrain_merge_model(service: DepthMergeService, clean_depths, steps: int = 1000,
                         lr: float = 1e-4, outsize: int = 512, seed: int = 0):
    """Offline training of the merge generator: each step draws a clean
    depth, corrupts it (:func:`synthetic_corruption`), nearest-resizes it
    to the net size, runs the generator and minimizes the MSE between its
    output nearest-resized to min(outsize, net size) and the clean depth,
    with Adam(lr, betas (0.9, 0.999)); the generator alone, no GAN term,
    as the reference trains it.  The numpy draws are the JAX package's,
    in its order.  Runs on the service's device and updates its base
    parameters; returns the losses (floats)."""
    dev = resolve_device(service.device)
    net = copy.deepcopy(service.model).to(dev).requires_grad_(True)
    opt = torch.optim.Adam(net.parameters(), lr=float(lr), betas=(0.9, 0.999), eps=1e-8)
    rng = np.random.default_rng(seed)
    size = service.net_size
    losses = []
    for _ in range(steps):
        d = np.asarray(clean_depths[rng.integers(len(clean_depths))], np.float64)
        lo, hi = d.min(), d.max()
        depth = (d - lo) / max(hi - lo, 1e-12) * 2.0 - 1.0  # [-1, 1]
        depth_in = synthetic_corruption(rng, depth)
        inp = nearest_resize(torch.as_tensor(depth_in, dtype=torch.float32, device=dev), size)
        inp = minmax_normalize(inp)[None, None]
        tgt = nearest_resize(torch.as_tensor(depth, dtype=torch.float32, device=dev),
                             min(outsize, size))
        opt.zero_grad(set_to_none=True)
        out = nearest_resize(net(inp, service.compute_dtype)[0, 0], tgt.shape[-1])
        loss = torch.mean((out - tgt) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    with torch.no_grad():
        for p, q in zip(service.model.parameters(), net.parameters()):
            p.copy_(q.cpu())
    return [float(v) for v in losses]
