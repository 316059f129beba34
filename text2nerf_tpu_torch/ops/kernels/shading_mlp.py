"""Kernel B wrapper: the fused ``MLP_Fea_noview`` head
(``csrc/shading_mlp.cu``).

Port of the Pallas TPU kernel ``text2nerf_tpu/ops/pallas/shading_mlp.py``
(``shade_fea_noview_pallas``).  Eval only: the kernel has no backward.

For CPU tensors the wrapper runs :func:`shade_fea_noview_plain`; for CUDA
tensors it launches the kernel or raises.

The kernel runs layers 1 and 2 on the tensor cores in 3xTF32 (each
operand split into TF32 hi and lo parts, three products, fp32
accumulation), which keeps fp32 accuracy.  It reads the weights as
:func:`prepare_weights` lays them out: W^T, K-permuted, in the
core-matrix image ``wgmma`` reads, hi and lo per K-slice of 8.  The
prepared weights are cached per set of weights and rebuilt when a weight
tensor is replaced or edited in place.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ...models import mlp as mlp_mod
from . import _build

#: hidden width the kernel is written for (TensoRFConfig.feature_c)
KERNEL_FEATURE_C = 128

#: widest feature vector the kernel's shared memory holds
KERNEL_MAX_C = 32

#: kernel launches since the last reset (the main path's proof of use)
LAUNCHES = 0

_WEIGHTS = ("w1", "b1", "w2", "b2", "w3", "b3")

#: w1 tensor -> (key, (w1 image, w2 image)); an entry dies with its w1
_PREPARED = WeakIdKeyDictionary()


def shade_fea_noview_plain(mlp, features, fea_pe: int = 6):
    """Plain PyTorch version: ``mlp.shade("MLP_Fea_noview")``."""
    return mlp_mod.shade("MLP_Fea_noview", mlp, None, None, features, fea_pe=fea_pe)


def layer1_slices(c: int, fea_pe: int) -> int:
    """K-slices of 8 in the kernel's layer-1 operand: c·F (sin, cos) pairs
    and ceil(c/2) pairs of raw features, four pairs per slice."""
    pairs = c * fea_pe + (c + 1) // 2
    return (pairs + 3) // 4


def layer1_columns(c: int, fea_pe: int) -> torch.Tensor:
    """Column of x = [f, sin(f·2ᵏ), cos(f·2ᵏ)] (the reference's
    channel-major PE) held by each K slot of the kernel's layer-1 operand,
    -1 for zero padding.  Slot 8·kk + t holds the first and slot 8·kk + t + 4
    the second of pair q = 4·kk + t: the sine and cosine of (channel, band)
    q for q < c·F, else raw features 2r and 2r + 1 (r = q - c·F)."""
    cf = c * fea_pe
    cols = torch.full((8 * layer1_slices(c, fea_pe),), -1, dtype=torch.long)
    for q in range(cols.numel() // 2):
        if q < cf:
            first, second = c + q, c + cf + q
        else:
            c0 = 2 * (q - cf)
            first = c0 if c0 < c else -1
            second = c0 + 1 if c0 + 1 < c else -1
        slot = 8 * (q // 4) + q % 4
        cols[slot], cols[slot + 4] = first, second
    return cols


def layer2_columns(fc: int = KERNEL_FEATURE_C) -> torch.Tensor:
    """Hidden column held by each K slot of layer 2's operand: a thread's
    layer-1 accumulator holds columns 2t, 2t + 1 of each group of 8, which
    become its K slots t and t + 4."""
    perm = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
    return (torch.arange(0, fc, 8)[:, None] + perm).reshape(-1)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32, to nearest with ties away from zero, as the
    card's ``cvt.rna.tf32.f32`` does: the low 13 mantissa bits become 0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo), both TF32, with hi + lo = x to about 2^-22 relative."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def core_matrix_image(wt: torch.Tensor) -> torch.Tensor:
    """(K/8, N·8) image of a K-major (N, K) matrix, N = 128, as the kernel's
    no-swizzle wgmma operand: per K-slice of 8, core matrix (N-group ng,
    K-half kh) of 8 rows × 4 floats at float offset 32·(2·ng + kh)."""
    n, k = wt.shape
    return wt.reshape(n // 8, 8, k // 8, 2, 4).permute(2, 0, 3, 1, 4).reshape(k // 8, 8 * n)


def _image(wt):
    hi, lo = tf32_split(wt.contiguous())
    return torch.stack([core_matrix_image(hi), core_matrix_image(lo)], dim=1).contiguous()


def prepare_weights(mlp, c: int, fea_pe: int):
    """(w1 image (kk1, 2, 1024), w2 image (16, 2, 1024)): W1^T with its K
    axis in :func:`layer1_columns` order (zero padding at -1) and W2^T in
    :func:`layer2_columns` order, each split into TF32 hi and lo."""
    w1, w2 = mlp["w1"].detach(), mlp["w2"].detach()
    cols = layer1_columns(c, fea_pe).to(w1.device)
    w1t = torch.where(cols >= 0, w1.T[:, cols.clamp(min=0)], torch.zeros((), device=w1.device))
    w2t = w2.T[:, layer2_columns(w2.shape[0]).to(w2.device)]
    return _image(w1t), _image(w2t)


def _prepared(mlp, c, fea_pe):
    w1, w2 = mlp["w1"], mlp["w2"]
    key = (w1.data_ptr(), w1._version, id(w2), w2.data_ptr(), w2._version, c, fea_pe)
    hit = _PREPARED.get(w1)
    if hit is None or hit[0] != key:
        hit = (key, prepare_weights(mlp, c, fea_pe))
        _PREPARED[w1] = hit
    return hit[1]


def _check(mlp, features, fea_pe):
    if features.dim() != 2 or features.dtype != torch.float32:
        raise ValueError(
            f"features must be (N, C) float32, got {tuple(features.shape)} {features.dtype}"
        )
    c = features.shape[1]
    fc = mlp["w2"].shape[0]
    want = {
        "w1": (c * (1 + 2 * fea_pe), fc), "b1": (fc,), "w2": (fc, fc),
        "b2": (fc,), "w3": (fc, 3), "b3": (3,),
    }
    for k in _WEIGHTS:
        t = mlp[k]
        if tuple(t.shape) != want[k]:
            raise ValueError(f"mlp {k}: shape {tuple(t.shape)}, expected {want[k]}")
        if t.dtype != torch.float32 or t.device != features.device:
            raise ValueError(f"mlp {k}: must be float32 on {features.device}")


def shade_fea_noview(mlp, features, fea_pe: int = 6):
    """(N, 3) rgb in [0, 1] of the ``MLP_Fea_noview`` head."""
    _check(mlp, features, fea_pe)
    if features.device.type == "cpu":
        return shade_fea_noview_plain(mlp, features, fea_pe)
    if features.device.type != "cuda":
        raise ValueError(f"shade_fea_noview: no kernel for device {features.device}")
    return _launch(mlp, features, fea_pe)


def _launch(mlp, features, fea_pe):
    global LAUNCHES
    if torch.is_grad_enabled() and (
        features.requires_grad or any(mlp[k].requires_grad for k in _WEIGHTS)
    ):
        raise RuntimeError(
            "shade_fea_noview: the CUDA kernel is forward-only; call it under "
            "torch.no_grad()"
        )
    if mlp["w2"].shape[0] != KERNEL_FEATURE_C:
        raise ValueError(
            f"shade_fea_noview: the kernel takes feature_c={KERNEL_FEATURE_C}"
        )
    n, c = features.shape
    if not 1 <= c <= KERNEL_MAX_C or not 1 <= fea_pe <= 30:
        raise ValueError(
            f"shade_fea_noview: the kernel takes 1 <= C <= {KERNEL_MAX_C} and "
            f"1 <= fea_pe <= 30, got C={c}, fea_pe={fea_pe}"
        )
    tensors = [features] + [mlp[k] for k in _WEIGHTS]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("shade_fea_noview: inputs must be contiguous")
    out = torch.empty((n, 3), dtype=torch.float32, device=features.device)
    if n == 0:
        return out
    if n >= 2 ** 31:
        raise ValueError("shade_fea_noview: at most 2^31 - 1 rows per launch")
    w1img, w2img = _prepared(mlp, c, int(fea_pe))
    lib = _lib()
    with torch.cuda.device(features.device):
        err = lib.t2n_shade_fea_noview(
            _build.ptr(features), n, c, int(fea_pe), w1img.shape[0],
            _build.ptr(w1img), _build.ptr(w2img),
            *(_build.ptr(mlp[k]) for k in ("b1", "b2", "w3", "b3")),
            _build.ptr(out), _build.stream_of(features),
        )
    _build.check(err, "shade_fea_noview launch")
    LAUNCHES += 1
    return out


def _lib():
    lib = _build.library("shading_mlp")
    fn = lib.t2n_shade_fea_noview
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       vp, vp, vp, vp, vp, vp, vp, vp]
        fn.restype = ctypes.c_int
    return lib
