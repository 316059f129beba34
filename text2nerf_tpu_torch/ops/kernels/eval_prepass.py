"""The eval prepass kernel wrapper (``csrc/eval_prepass.cu``): the
compacted eval renderer's march, occupancy test, first-K live selection
and escalation rung in one launch.

Replaces no TPU kernel (the JAX package lowers the prepass to XLA ops).
Its plain version is the renderer's own select on CPU tensors
(:func:`..render._select_plain`), which the renderer takes for CPU
tensors; this wrapper launches the kernel for CUDA tensors or raises.
Kernel and plain version agree bit for bit (the source says why).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build

#: kernel launches since the last reset (the main path's proof of use)
LAUNCHES = 0

#: the most ladder rungs the kernel takes as arguments
MAX_RUNGS = 16


class Prepass(NamedTuple):
    idx: torch.Tensor     # (B, K) int32 sample indices, pads n_samples - 1
    sel: torch.Tensor     # (B, K) bool, False on pads
    z_k: torch.Tensor     # (B, K) fp32 sample depths
    xn_k: torch.Tensor    # (B, K, 3) fp32 normalized points in [-1, 1]
    n_live: torch.Tensor  # (B,) int64 live samples of each ray
    rung: Optional[torch.Tensor]  # (B,) int8 ladder rung covering n_live, or None


def eval_prepass(rays, aabb, step, alpha_mask, *, n_samples: int, k: int, near: float,
                 far: float, eval_z_min: float, occ_stride: int, ladder=None) -> Prepass:
    """The prepass of ``rays`` (B, >= 6) [o | d] through the box ``aabb``
    (2, 3) at depth step ``step`` (0-d), all fp32 on one CUDA device, over
    the mask ``alpha_mask`` ({'volume' (D, H, W), 'aabb'}) tested every
    ``occ_stride``-th sample; ``ladder`` the escalation rungs' K, or None."""
    dev = rays.device
    if dev.type != "cuda":
        raise ValueError(
            f"eval_prepass: no kernel for device {dev} (the renderer's plain select "
            "serves CPU tensors)")
    if rays.dim() != 2 or rays.shape[1] < 6 or rays.dtype != torch.float32:
        raise ValueError(f"rays must be (B, >= 6) float32, got {tuple(rays.shape)} {rays.dtype}")
    if not 1 <= k <= n_samples or occ_stride < 1:
        raise ValueError(f"eval_prepass: needs 1 <= k <= n_samples and occ_stride >= 1, got "
                         f"k={k}, n_samples={n_samples}, occ_stride={occ_stride}")
    ladder = () if ladder is None else tuple(int(r) for r in ladder)
    if len(ladder) > MAX_RUNGS:
        raise ValueError(f"eval_prepass: at most {MAX_RUNGS} ladder rungs, got {len(ladder)}")
    volume = alpha_mask["volume"]
    if volume.dim() != 3 or volume.dtype != torch.float32 or volume.device != dev:
        raise ValueError(f"alpha mask volume must be (D, H, W) float32 on {dev}")
    boxes = [t.to(device=dev, dtype=torch.float32) for t in (aabb, alpha_mask["aabb"])]
    if any(tuple(b.shape) != (2, 3) for b in boxes):
        raise ValueError("aabb and the mask's aabb must be (2, 3)")
    if step.numel() != 1 or step.dtype != torch.float32 or step.device != dev:
        raise ValueError(f"step must be one float32 on {dev}")
    return _launch(rays.contiguous(), *(b.contiguous() for b in boxes), step, volume.contiguous(),
                   n_samples, k, near, far, eval_z_min, occ_stride, ladder)


def _launch(rays, aabb, mask_aabb, step, volume, n_samples, k, near, far, eval_z_min,
            occ_stride, ladder) -> Prepass:
    global LAUNCHES
    b = rays.shape[0]
    dev = rays.device
    out = Prepass(
        idx=torch.empty((b, k), dtype=torch.int32, device=dev),
        sel=torch.empty((b, k), dtype=torch.bool, device=dev),
        z_k=torch.empty((b, k), dtype=torch.float32, device=dev),
        xn_k=torch.empty((b, k, 3), dtype=torch.float32, device=dev),
        n_live=torch.empty((b,), dtype=torch.int64, device=dev),
        rung=torch.empty((b,), dtype=torch.int8, device=dev) if ladder else None,
    )
    if b == 0:
        return out
    if b >= 2 ** 31:
        raise ValueError("eval_prepass: at most 2^31 - 1 rays per launch")
    lib = _lib()
    rungs = (ctypes.c_int * max(len(ladder), 1))(*ladder)
    with torch.cuda.device(dev):
        err = lib.t2n_eval_prepass(
            _build.ptr(rays), b, rays.shape[1], n_samples, k, _build.ptr(aabb), _build.ptr(step),
            float(near), float(far), float(eval_z_min), _build.ptr(volume), *volume.shape,
            _build.ptr(mask_aabb), occ_stride,
            ctypes.cast(rungs, ctypes.c_void_p), len(ladder),
            *(_build.ptr(t) for t in out), _build.stream_of(rays),
        )
    _build.check(err, "eval_prepass launch")
    with _build.COUNT_LOCK:
        LAUNCHES += 1
    return out


def _lib():
    lib = _build.library("eval_prepass")
    fn = lib.t2n_eval_prepass
    if fn.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, i, i, i, i, vp, vp, f, f, f, vp, i, i, i, vp, i, vp, i,
                       vp, vp, vp, vp, vp, vp, vp]
        fn.restype = ctypes.c_int
    return lib
