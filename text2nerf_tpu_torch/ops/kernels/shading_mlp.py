"""Kernel B wrappers: the fused ``MLP_Fea_noview`` head and its
view-dependent mode, the ``MLP_Fea`` head (``csrc/shading_mlp.cu``).

The noview mode ports the Pallas TPU kernel
``text2nerf_tpu/ops/pallas/shading_mlp.py`` (``shade_fea_noview_pallas``);
the view mode serves the eval renders of TensoRF's own head, which the
JAX package runs as XLA.  It reads each ray's direction, not each row's:
the rows of a ray lie one after another, ``k`` of them.  Eval only: the
kernel has no backward.

For CPU tensors each wrapper runs its plain version
(:func:`shade_fea_noview_plain`, :func:`shade_fea_plain`); for CUDA
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

#: kernel launches since the last reset (the main path's proof of use),
#: in all and by mode
LAUNCHES = 0
MODES = {"noview": 0, "view": 0}

_WEIGHTS = ("w1", "b1", "w2", "b2", "w3", "b3")

#: w1 tensor -> (key, (w1 image, w2 image)); an entry dies with its w1
_PREPARED = WeakIdKeyDictionary()


def shade_fea_noview_plain(mlp, features, fea_pe: int = 6):
    """Plain PyTorch version: ``mlp.shade("MLP_Fea_noview")``."""
    return mlp_mod.shade("MLP_Fea_noview", mlp, None, None, features, fea_pe=fea_pe)


def shade_fea_plain(mlp, features, dirs, k: int, fea_pe: int = 6, view_pe: int = 6):
    """Plain PyTorch version: ``mlp.shade("MLP_Fea")`` with row r seen
    along ``dirs[r // k]``."""
    viewdirs = torch.repeat_interleave(dirs, k, dim=0)
    return mlp_mod.shade("MLP_Fea", mlp, None, viewdirs, features, view_pe=view_pe,
                         fea_pe=fea_pe)


def _pairs(c: int, fea_pe: int, view_pe):
    """(trig pairs, all pairs) of the layer-1 operand: a (sin, cos) pair per
    (feature, band), then per (direction component, band) in the view mode
    (``view_pe`` not None), then the row's raw values two a pair."""
    values = c if view_pe is None else c + 3
    trig = c * fea_pe + (0 if view_pe is None else 3 * view_pe)
    return trig, trig + (values + 1) // 2


def layer1_slices(c: int, fea_pe: int, view_pe=None) -> int:
    """K-slices of 8 in the kernel's layer-1 operand, four pairs per slice
    (:func:`_pairs`); ``view_pe`` None is the noview head."""
    return (_pairs(c, fea_pe, view_pe)[1] + 3) // 4


def layer1_columns(c: int, fea_pe: int, view_pe=None) -> torch.Tensor:
    """Column of the reference's head input held by each K slot of the
    kernel's layer-1 operand, -1 for zero padding.  The input is x = [f,
    sin(f·2ᵏ), cos(f·2ᵏ)] for the noview head (``view_pe`` None) and x =
    [f, d, sin(f·2ᵏ), cos(f·2ᵏ), sin(d·2ʲ), cos(d·2ʲ)] for ``MLP_Fea``,
    each PE channel-major.  Slot 8·kk + t holds the first and slot
    8·kk + t + 4 the second of pair q = 4·kk + t: the sine and cosine of
    (feature, band) q for q < c·F, then of (direction component, band)
    q - c·F, else the row's raw values (features, then direction) 2r and
    2r + 1 (r = q - the trig pairs)."""
    cf = c * fea_pe
    trig, _ = _pairs(c, fea_pe, view_pe)
    values = c if view_pe is None else c + 3  # the raw values; the PE's columns follow
    cols = torch.full((8 * layer1_slices(c, fea_pe, view_pe),), -1, dtype=torch.long)
    for q in range(cols.numel() // 2):
        if q < cf:
            first, second = values + q, values + cf + q
        elif q < trig:
            d0 = values + 2 * cf
            first, second = d0 + q - cf, d0 + 3 * view_pe + q - cf
        else:
            c0 = 2 * (q - trig)
            first = c0 if c0 < values else -1
            second = c0 + 1 if c0 + 1 < values else -1
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


def prepare_weights(mlp, c: int, fea_pe: int, view_pe=None):
    """(w1 image (kk1, 2, 1024), w2 image (16, 2, 1024)): W1^T with its K
    axis in :func:`layer1_columns` order (zero padding at -1) and W2^T in
    :func:`layer2_columns` order, each split into TF32 hi and lo."""
    w1, w2 = mlp["w1"].detach(), mlp["w2"].detach()
    cols = layer1_columns(c, fea_pe, view_pe).to(w1.device)
    w1t = torch.where(cols >= 0, w1.T[:, cols.clamp(min=0)], torch.zeros((), device=w1.device))
    w2t = w2.T[:, layer2_columns(w2.shape[0]).to(w2.device)]
    return _image(w1t), _image(w2t)


def _prepared(mlp, c, fea_pe, view_pe=None):
    w1, w2 = mlp["w1"], mlp["w2"]
    key = (w1.data_ptr(), w1._version, id(w2), w2.data_ptr(), w2._version, c, fea_pe, view_pe)
    hit = _PREPARED.get(w1)
    if hit is None or hit[0] != key:
        hit = (key, prepare_weights(mlp, c, fea_pe, view_pe))
        _PREPARED[w1] = hit
    return hit[1]


def _check(mlp, features, fea_pe, view_pe=None):
    if features.dim() != 2 or features.dtype != torch.float32:
        raise ValueError(
            f"features must be (N, C) float32, got {tuple(features.shape)} {features.dtype}"
        )
    c = features.shape[1]
    fc = mlp["w2"].shape[0]
    mode = "MLP_Fea_noview" if view_pe is None else "MLP_Fea"
    d_in = mlp_mod.mlp_input_dim(mode, c, view_pe or 0, fea_pe, 0)
    want = {
        "w1": (d_in, fc), "b1": (fc,), "w2": (fc, fc),
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


def _launchable(name, mlp, features, fea_pe, least_pe):
    """Refuses what the kernel does not take; returns (n, c)."""
    if torch.is_grad_enabled() and (
        features.requires_grad or any(mlp[k].requires_grad for k in _WEIGHTS)
    ):
        raise RuntimeError(
            f"{name}: the CUDA kernel is forward-only; call it under torch.no_grad()"
        )
    if mlp["w2"].shape[0] != KERNEL_FEATURE_C:
        raise ValueError(f"{name}: the kernel takes feature_c={KERNEL_FEATURE_C}")
    n, c = features.shape
    if not 1 <= c <= KERNEL_MAX_C or not least_pe <= fea_pe <= 30:
        raise ValueError(
            f"{name}: the kernel takes 1 <= C <= {KERNEL_MAX_C} and "
            f"{least_pe} <= fea_pe <= 30, got C={c}, fea_pe={fea_pe}"
        )
    if not all(t.is_contiguous() for t in [features] + [mlp[k] for k in _WEIGHTS]):
        raise ValueError(f"{name}: inputs must be contiguous")
    if n >= 2 ** 31:
        raise ValueError(f"{name}: at most 2^31 - 1 rows per launch")
    return n, c


def _launch(mlp, features, fea_pe):
    global LAUNCHES
    n, c = _launchable("shade_fea_noview", mlp, features, fea_pe, 1)
    out = torch.empty((n, 3), dtype=torch.float32, device=features.device)
    if n == 0:
        return out
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
    with _build.COUNT_LOCK:
        LAUNCHES += 1
        MODES["noview"] += 1
    return out


def shade_fea(mlp, features, dirs, k: int, fea_pe: int = 6, view_pe: int = 6):
    """(N, 3) rgb in [0, 1] of the ``MLP_Fea`` head: row r of ``features``
    (N, C) seen along its ray's direction ``dirs[r // k]`` (``dirs`` (N / k,
    3), each ray's ``k`` rows one after another)."""
    _check(mlp, features, fea_pe, view_pe)
    k = int(k)
    if dirs.dim() != 2 or dirs.shape[1] != 3 or dirs.dtype != torch.float32:
        raise ValueError(f"dirs must be (B, 3) float32, got {tuple(dirs.shape)} {dirs.dtype}")
    if k < 1 or dirs.shape[0] * k != features.shape[0]:
        raise ValueError(f"shade_fea: {features.shape[0]} rows are not {k} rows of each of "
                         f"{dirs.shape[0]} rays")
    if dirs.device != features.device:
        raise ValueError("shade_fea: dirs and features are on different devices")
    if features.device.type == "cpu":
        return shade_fea_plain(mlp, features, dirs, k, fea_pe, view_pe)
    if features.device.type != "cuda":
        raise ValueError(f"shade_fea: no kernel for device {features.device}")
    return _launch_view(mlp, features, dirs, k, int(fea_pe), int(view_pe))


def _launch_view(mlp, features, dirs, k, fea_pe, view_pe):
    global LAUNCHES
    n, c = _launchable("shade_fea", mlp, features, fea_pe, 0)
    if not 0 <= view_pe <= 30:
        raise ValueError(f"shade_fea: the kernel takes 0 <= view_pe <= 30, got {view_pe}")
    out = torch.empty((n, 3), dtype=torch.float32, device=features.device)
    if n == 0:
        return out
    dirs = dirs.contiguous()  # rays[:, 3:6] is not
    w1img, w2img = _prepared(mlp, c, fea_pe, view_pe)
    lib = _lib()
    with torch.cuda.device(features.device):
        err = lib.t2n_shade_fea(
            _build.ptr(features), _build.ptr(dirs), n, c, k, fea_pe, view_pe,
            w1img.shape[0], _build.ptr(w1img), _build.ptr(w2img),
            *(_build.ptr(mlp[name]) for name in ("b1", "b2", "w3", "b3")),
            _build.ptr(out), _build.stream_of(features),
        )
    _build.check(err, "shade_fea launch")
    with _build.COUNT_LOCK:
        LAUNCHES += 1
        MODES["view"] += 1
    return out


def _lib():
    lib = _build.library("shading_mlp")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.t2n_shade_fea_noview
    if fn.argtypes is None:
        fn.argtypes = [vp, ci, ci, ci, ci, vp, vp, vp, vp, vp, vp, vp, vp]
        fn.restype = ci
    fn = lib.t2n_shade_fea
    if fn.argtypes is None:
        fn.argtypes = [vp, vp, ci, ci, ci, ci, ci, ci, vp, vp, vp, vp, vp, vp, vp, vp]
        fn.restype = ci
    return lib
