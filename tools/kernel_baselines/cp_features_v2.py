"""The wrapper of the second design of kernels C and C'
(tools/kernel_baselines/cp_features_v2.cu: fp32 lines and fp32
``app_raw`` / ``d_app_raw`` in both compute types), kept beside it for
tools/kernel_variants.py, which builds the two in place of the package's
own.  Nothing of the package loads it.

Kernel C and kernel C' wrappers: TensoRF CP factor features and their
scatter-add backward (``csrc/cp_features.cu``).

Kernel C replaces the XLA-lowered CP gather of
``text2nerf_tpu/models/tensorf.py:548-557`` (and its density-only
:344-350 and app-only :580-586 forms), a lines-only triple product that
kernel A (planes × lines) cannot compute; kernel C' replaces XLA's
autodiff of it, the scatter-add into the lines.  Inputs are the fused
(density ‖ app) lines of the CP field: three ``[L_i, nd + na]`` tables
whose first ``nd`` channels are density.  :class:`CPFeatures` joins the
two for autograd.

For CPU tensors each wrapper runs its plain version
(:func:`cp_features_plain`, :func:`cp_features_backward_plain`); for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..fused_gather import _coords, sample_line
from . import _build

VEC_MODE = (2, 1, 0)

#: kernel C launches since the last reset (the main path's proof of use),
#: and the same by compute type
LAUNCHES = 0
DTYPES = {"fp32": 0, "bf16": 0}
#: kernel C' launches since the last reset, and the same by compute type
#: and by route (the channel slices in shared memory, or global atomics
#: when the three lines do not fit a block's shared memory)
BWD_LAUNCHES = 0
BWD_DTYPES = {"fp32": 0, "bf16": 0}
BWD_ROUTES = {"shared": 0, "generic": 0}
#: (route, blocks, threads per block) of the last kernel C' launch
BWD_LAST_GRID = None
_ROUTE_NAMES = {1: "shared", 2: "generic"}


def _line_values(xn, lines, dtype):
    return [sample_line(lines[i], xn[:, VEC_MODE[i]], dtype) for i in range(3)]


def cp_features_plain(xn, lines, nd: int, *, sigma: bool = True, app: bool = True,
                      dtype: Optional[torch.dtype] = None):
    """Plain PyTorch version: (sigma_feat (N,) | None, app_raw (N, na) |
    None), both fp32.  ``dtype=torch.bfloat16`` rounds values, lerp
    weights and products to bf16 (index math stays fp32).  The density
    sum is taken in fp64 and rounded once, as the kernel takes it."""
    v = _line_values(xn, lines, dtype)
    prod = (v[0] * v[1]) * v[2]
    sig = prod[:, :nd].double().sum(dim=-1).float().to(prod.dtype).float() if sigma else None
    return sig, prod[:, nd:].float() if app else None


def _check(xn, lines, nd, sigma, app, dtype):
    if not (sigma or app):
        raise ValueError("cp_features: ask for sigma, app or both")
    if dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"cp_features: compute dtype {dtype} not supported")
    if xn.dim() != 2 or xn.shape[1] != 3 or xn.dtype != torch.float32:
        raise ValueError(f"xn must be (N, 3) float32, got {tuple(xn.shape)} {xn.dtype}")
    if len(lines) != 3:
        raise ValueError("cp_features takes three lines")
    c = lines[0].shape[1] if lines[0].dim() == 2 else -1
    for i, l in enumerate(lines):
        if l.dim() != 2 or l.shape[1] != c:
            raise ValueError(f"axis {i}: line {tuple(l.shape)}; every line must be [L, {c}]")
        if l.dtype != torch.float32:
            raise ValueError(f"axis {i}: lines must be float32")
        if l.device != xn.device:
            raise ValueError(f"axis {i}: the line and xn are on different devices")
    if not 0 <= nd <= c:
        raise ValueError(f"nd={nd} outside [0, {c}]")


def _dims(lines, nd):
    return (ctypes.c_int * 5)(*(l.shape[0] for l in lines), lines[0].shape[1], nd)


def cp_features(xn, lines, nd: int, *, sigma: bool = True, app: bool = True,
                dtype: Optional[torch.dtype] = None):
    """Density feature and raw app channels of the CP field at normalized
    coords ``xn``: ``(sigma_feat (N,) | None, app_raw (N, na) | None)``,
    fp32."""
    nd = int(nd)
    _check(xn, lines, nd, sigma, app, dtype)
    if dtype == torch.float32:
        dtype = None
    if xn.device.type == "cpu":
        return cp_features_plain(xn, lines, nd, sigma=sigma, app=app, dtype=dtype)
    if xn.device.type != "cuda":
        raise ValueError(f"cp_features: no kernel for device {xn.device}")
    return _launch(xn, lines, nd, sigma, app, dtype == torch.bfloat16)


def _launch(xn, lines, nd, sigma, app, bf16):
    global LAUNCHES
    tensors = (xn, *lines)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "cp_features: the CUDA kernel is forward-only; call it under torch.no_grad()"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("cp_features: inputs must be contiguous")
    n = xn.shape[0]
    na = lines[0].shape[1] - nd
    dev = xn.device
    sig_out = torch.empty(n, dtype=torch.float32, device=dev) if sigma else None
    app_out = torch.empty((n, na), dtype=torch.float32, device=dev) if app else None
    if n == 0:
        return sig_out, app_out
    if n >= 2 ** 31:
        raise ValueError("cp_features: at most 2^31 - 1 samples per launch")
    dims = _dims(lines, nd)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.t2n_cp_features(
            _build.ptr(xn), n, *(_build.ptr(l) for l in lines),
            ctypes.cast(dims, ctypes.c_void_p), int(bf16),
            _build.ptr(sig_out), _build.ptr(app_out), _build.stream_of(xn),
        )
    _build.check(err, "cp_features launch")
    with _build.COUNT_LOCK:
        LAUNCHES += 1
        DTYPES["bf16" if bf16 else "fp32"] += 1
    return sig_out, app_out


def _lib():
    lib = _build.library("cp_features")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if lib.t2n_cp_features.argtypes is None:
        lib.t2n_cp_features.argtypes = [vp, ci, vp, vp, vp, vp, ci, vp, vp, vp]
        lib.t2n_cp_features.restype = ci
    if lib.t2n_cp_features_bwd.argtypes is None:
        lib.t2n_cp_features_bwd.argtypes = [vp, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci,
                                            ci, vp, vp]
        lib.t2n_cp_features_bwd.restype = ci
    return lib


# ---------------------------------------------------------------------------
# Kernel C': the backward, a scatter-add into the lines
# ---------------------------------------------------------------------------


def cp_features_backward_plain(xn, lines, nd: int, d_sigma, d_app_raw,
                               dtype: Optional[torch.dtype] = None):
    """Plain PyTorch version of kernel C': the fp32 gradients of the three
    fused lines for the gradients ``d_sigma`` (N,) and ``d_app_raw`` (N,
    na) of :func:`cp_features`' outputs (either may be None).  The line
    values are recomputed as the forward computes them; per channel
    d01 = g·v2, dv2 = g·(v0·v1), dv0 = d01·v1, dv1 = d01·v0 (reverse-mode
    autodiff of (v0·v1)·v2), then dv·(1-t) and dv·t go to the two rows,
    scattered with ``index_add_`` in fp32.  ``dtype=torch.bfloat16``
    rounds g, the values, the weights and every product to bf16."""
    n, c = xn.shape[0], lines[0].shape[1]
    v = _line_values(xn, lines, dtype)
    g = torch.zeros((n, c), dtype=torch.float32, device=xn.device)
    if d_sigma is not None:
        g[:, :nd] = d_sigma[:, None]
    if d_app_raw is not None:
        g[:, nd:] = d_app_raw
    if dtype is not None:
        g = g.to(dtype)
    p01 = v[0] * v[1]
    d01 = g * v[2]
    dv = (d01 * v[1], d01 * v[0], g * p01)
    d_lines = []
    for i in range(3):
        length = lines[i].shape[0]
        l0, t = _coords(xn[:, VEC_MODE[i]], length)
        l1 = torch.clamp(l0 + 1, max=length - 1)
        if dtype is not None:
            t = t.to(dtype)
        t = t[:, None]
        dl = torch.zeros((length, c), dtype=torch.float32, device=xn.device)
        dl.index_add_(0, l0, (dv[i] * (1.0 - t)).float())
        dl.index_add_(0, l1, (dv[i] * t).float())
        d_lines.append(dl)
    return tuple(d_lines)


def cp_features_backward(xn, lines, nd: int, d_sigma=None, d_app_raw=None, *,
                         dtype: Optional[torch.dtype] = None, out=None):
    """Gradients of the three fused lines for the output gradients
    ``d_sigma`` (N,) and ``d_app_raw`` (N, na) (either may be None, not
    both): fp32, ``[L_i, nd + na]``.  ``out`` (three tables) accumulates
    into those instead of fresh zeroed ones."""
    nd = int(nd)
    _check(xn, lines, nd, d_sigma is not None, d_app_raw is not None, dtype)
    if dtype == torch.float32:
        dtype = None
    n = xn.shape[0]
    na = lines[0].shape[1] - nd
    if d_sigma is not None and (d_sigma.shape != (n,) or d_sigma.dtype != torch.float32):
        raise ValueError(f"d_sigma must be ({n},) float32, got {tuple(d_sigma.shape)}")
    if d_app_raw is not None and (d_app_raw.shape != (n, na)
                                  or d_app_raw.dtype != torch.float32):
        raise ValueError(f"d_app_raw must be ({n}, {na}) float32, got {tuple(d_app_raw.shape)}")
    if out is not None:
        for t, ref in zip(out, lines):
            if t.shape != ref.shape or t.dtype != torch.float32 or t.device != xn.device:
                raise ValueError("out tables must match the lines' shapes, fp32, same device")
    if xn.device.type == "cpu":
        got = cp_features_backward_plain(xn, lines, nd, d_sigma, d_app_raw, dtype)
        if out is None:
            return got
        for t, g in zip(out, got):
            t.add_(g)
        return tuple(out)
    if xn.device.type != "cuda":
        raise ValueError(f"cp_features_backward: no kernel for device {xn.device}")
    return _launch_backward(xn, lines, nd, d_sigma, d_app_raw, dtype == torch.bfloat16, out)


def _launch_backward(xn, lines, nd, d_sigma, d_app_raw, bf16, out):
    global BWD_LAUNCHES, BWD_LAST_GRID
    d_sigma = None if d_sigma is None else d_sigma.contiguous()
    d_app_raw = None if d_app_raw is None else d_app_raw.contiguous()
    if not all(t.is_contiguous() for t in (xn, *lines)):
        raise ValueError("cp_features_backward: inputs must be contiguous")
    zero = out is None
    if zero:
        out = tuple(torch.empty_like(l, dtype=torch.float32) for l in lines)
    elif not all(t.is_contiguous() for t in out):
        raise ValueError("cp_features_backward: out tables must be contiguous")
    out = tuple(out)
    n = xn.shape[0]
    if n >= 2 ** 31:
        raise ValueError("cp_features_backward: at most 2^31 - 1 samples per launch")
    if n == 0:
        if zero:
            for t in out:
                t.zero_()
        return out
    dims = _dims(lines, nd)
    info = (ctypes.c_int * 3)()
    lib = _lib()
    with torch.cuda.device(xn.device):
        err = lib.t2n_cp_features_bwd(
            _build.ptr(xn), n, *(_build.ptr(l) for l in lines),
            ctypes.cast(dims, ctypes.c_void_p), _build.ptr(d_sigma), _build.ptr(d_app_raw),
            *(_build.ptr(t) for t in out), int(zero), int(bf16),
            ctypes.cast(info, ctypes.c_void_p), _build.stream_of(xn),
        )
    _build.check(err, "cp_features_backward launch")
    route = _ROUTE_NAMES[info[0]]
    with _build.COUNT_LOCK:
        BWD_LAUNCHES += 1
        BWD_DTYPES["bf16" if bf16 else "fp32"] += 1
        BWD_ROUTES[route] += 1
        BWD_LAST_GRID = (route, info[1], info[2])
    return out


class CPFeatures(torch.autograd.Function):
    """CP features with a gradient for the lines: kernel C forward (on
    detached lines, under no_grad), kernel C' backward on CUDA tensors,
    their plain versions on CPU tensors.  ``xn`` gets no gradient.

    ``CPFeatures.apply(xn, nd, sigma, app, dtype, *lines)`` returns
    ``(sigma_feat | None, app_raw | None)`` as :func:`cp_features`."""

    @staticmethod
    def forward(ctx, xn, nd, sigma, app, dtype, *lines):
        with torch.no_grad():
            out = cp_features(xn, tuple(l.detach() for l in lines), nd, sigma=sigma, app=app,
                              dtype=dtype)
        ctx.save_for_backward(xn, *lines)
        ctx.nd, ctx.dtype = int(nd), dtype
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, d_sigma, d_app_raw):
        xn, *lines = ctx.saved_tensors
        needs = ctx.needs_input_grad[5:]
        if (d_sigma is None and d_app_raw is None) or not any(needs):
            return (None,) * (5 + len(lines))
        d_lines = cp_features_backward(xn, tuple(lines), ctx.nd, d_sigma, d_app_raw,
                                       dtype=ctx.dtype)
        grads = [g if need else None for g, need in zip(d_lines, needs)]
        return (None, None, None, None, None, *grads)
