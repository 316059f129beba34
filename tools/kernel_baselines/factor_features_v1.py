"""The wrapper of the first design of kernels A and A''s bf16 mode
(tools/kernel_baselines/factor_features_v1.cu, factor_features_bwd_v1.cu),
kept beside them for tools/kernel_variants.py, which builds the three in
place of the package's own.  Nothing of the package loads it.

Kernel A and kernel A' wrappers: TensoRF factor features
(``csrc/factor_features.cu``) and their scatter-add backward
(``csrc/factor_features_bwd.cu``).

Kernel A replaces the XLA-lowered fused factor gather of
``text2nerf_tpu/models/tensorf.py:538`` (and its density-only :335 and
app-only :575 forms); kernel A' replaces XLA's autodiff of it, the
scatter-add into the tables, in fp32 or (the bf16 train step) with its
products rounded to bf16 and fp32 accumulation.  Inputs are the fused
(density ‖ app) tables of the vm_split and vm fields: three planes ``[H_i, W_i, C_i]`` and three lines
``[L_i, C_i]`` whose first ``nd_i`` channels are density.
:class:`FactorFeatures` joins the two for autograd.

For CPU tensors each wrapper runs its plain version
(:func:`factor_features_plain`, :func:`factor_features_backward_plain`);
for CUDA tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ..fused_gather import _coords, sample_line, sample_plane
from . import _build

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)

#: kernel A launches since the last reset (the main path's proof of use)
LAUNCHES = 0
#: kernel A' launches since the last reset, and the same by output mode
#: and by route (``csrc/factor_features_bwd.cu``: the walk with line
#: gradients in shared memory for 64-wide tables whose lines fit there,
#: one warp per sample for the others)
BWD_LAUNCHES = 0
BWD_MODES = {"fused": 0, "density": 0, "app": 0}
#: kernel A' launches by compute type (bf16: the bf16 train step's backward)
BWD_DTYPES = {"fp32": 0, "bf16": 0}
BWD_ROUTES = {"shared": 0, "generic": 0}
#: (route, blocks, threads per block) of the last kernel A' launch
BWD_LAST_GRID = None
_ROUTE_NAMES = {1: "shared", 2: "generic"}


def factor_features_plain(
    xn, planes, lines, nd: Sequence[int], *, sigma: bool = True,
    app: bool = True, dtype: Optional[torch.dtype] = None,
):
    """Plain PyTorch version: (sigma_feat (N,) | None, app_raw (N, Σna) |
    None), both fp32.  ``dtype=torch.bfloat16`` rounds values, lerp
    weights and products to bf16 (index math stays fp32).  Each axis'
    density sum is taken in fp64 and rounded once, as the kernel takes it,
    so the result does not depend on the summation order."""
    sig = None
    feats = []
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        pf = sample_plane(planes[i], xn[:, m0], xn[:, m1], dtype)
        lf = sample_line(lines[i], xn[:, VEC_MODE[i]], dtype)
        prod = pf * lf
        if sigma:
            part = prod[:, : nd[i]].double().sum(dim=-1).float().to(prod.dtype)
            sig = part if sig is None else sig + part
        if app:
            feats.append(prod[:, nd[i]:])
    return (
        sig.float() if sigma else None,
        torch.cat(feats, dim=-1).float() if app else None,
    )


def _check(xn, planes, lines, nd, sigma, app, dtype):
    if not (sigma or app):
        raise ValueError("factor_features: ask for sigma, app or both")
    if dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"factor_features: compute dtype {dtype} not supported")
    if xn.dim() != 2 or xn.shape[1] != 3 or xn.dtype != torch.float32:
        raise ValueError(f"xn must be (N, 3) float32, got {tuple(xn.shape)} {xn.dtype}")
    if len(planes) != 3 or len(lines) != 3 or len(nd) != 3:
        raise ValueError("factor_features takes three planes, lines and nd")
    for i in range(3):
        p, l = planes[i], lines[i]
        if p.dim() != 3 or l.dim() != 2 or p.shape[2] != l.shape[1]:
            raise ValueError(
                f"axis {i}: plane {tuple(p.shape)} / line {tuple(l.shape)} mismatch"
            )
        if p.dtype != torch.float32 or l.dtype != torch.float32:
            raise ValueError(f"axis {i}: tables must be float32")
        if p.device != xn.device or l.device != xn.device:
            raise ValueError(f"axis {i}: tables and xn are on different devices")
        if not 0 <= nd[i] <= p.shape[2]:
            raise ValueError(f"axis {i}: nd={nd[i]} outside [0, {p.shape[2]}]")


def factor_features(
    xn, planes, lines, nd: Sequence[int], *, sigma: bool = True,
    app: bool = True, dtype: Optional[torch.dtype] = None,
):
    """Density feature and raw app channels at normalized coords ``xn``.

    Returns ``(sigma_feat (N,) | None, app_raw (N, Σna) | None)``, fp32.
    """
    nd = tuple(int(v) for v in nd)
    _check(xn, planes, lines, nd, sigma, app, dtype)
    if dtype == torch.float32:
        dtype = None
    if xn.device.type == "cpu":
        return factor_features_plain(
            xn, planes, lines, nd, sigma=sigma, app=app, dtype=dtype
        )
    if xn.device.type != "cuda":
        raise ValueError(f"factor_features: no kernel for device {xn.device}")
    return _launch(xn, planes, lines, nd, sigma, app, dtype == torch.bfloat16)


def _launch(xn, planes, lines, nd, sigma, app, bf16):
    global LAUNCHES
    tensors = (xn, *planes, *lines)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "factor_features: the CUDA kernel is forward-only; call it under "
            "torch.no_grad()"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("factor_features: inputs must be contiguous")
    n = xn.shape[0]
    na = [planes[i].shape[2] - nd[i] for i in range(3)]
    dev = xn.device
    sig_out = torch.empty(n, dtype=torch.float32, device=dev) if sigma else None
    app_out = (
        torch.empty((n, sum(na)), dtype=torch.float32, device=dev) if app else None
    )
    if n == 0:
        return sig_out, app_out
    if n >= 2 ** 31:
        raise ValueError("factor_features: at most 2^31 - 1 samples per launch")
    dims = (ctypes.c_int * 18)(
        *(p.shape[0] for p in planes),
        *(p.shape[1] for p in planes),
        *(l.shape[0] for l in lines),
        *(p.shape[2] for p in planes),
        *nd,
        0, na[0], na[0] + na[1],
    )
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.t2n_factor_features(
            _build.ptr(xn), n,
            *(_build.ptr(p) for p in planes), *(_build.ptr(l) for l in lines),
            ctypes.cast(dims, ctypes.c_void_p), sum(na), int(bf16),
            _build.ptr(sig_out), _build.ptr(app_out), _build.stream_of(xn),
        )
    _build.check(err, "factor_features launch")
    with _build.COUNT_LOCK:
        LAUNCHES += 1
    return sig_out, app_out


def _lib():
    lib = _build.library("factor_features")
    fn = lib.t2n_factor_features
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, ctypes.c_int, vp, vp, vp, vp, vp, vp, vp,
                       ctypes.c_int, ctypes.c_int, vp, vp, vp]
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# Kernel A': the backward, a scatter-add into the tables
# ---------------------------------------------------------------------------


def _channel_grads(n, c, nd, d_sigma, d_app_raw, app_off, like):
    """(N, C) gradient of one axis's products: d_sigma on the density
    channels, the axis's slice of d_app_raw on the app channels."""
    g = like.new_zeros((n, c))
    if d_sigma is not None:
        g[:, :nd] = d_sigma[:, None]
    if d_app_raw is not None:
        g[:, nd:] = d_app_raw[:, app_off: app_off + c - nd]
    return g


def factor_features_backward_plain(xn, planes, lines, nd: Sequence[int], d_sigma,
                                   d_app_raw, dtype: Optional[torch.dtype] = None):
    """Plain PyTorch version of kernel A': ``(d_planes, d_lines)``, fp32
    tables in the fused layout, for the gradients ``d_sigma`` (N,) and
    ``d_app_raw`` (N, Σna) of :func:`factor_features`' outputs (either may
    be None).  Per sample and axis the plane value ``pf`` and line value
    ``lf`` are recomputed as the forward computes them; ``g·lf`` goes to
    the four bilinear corners and ``g·pf`` to the two line rows, in the
    order of reverse-mode autodiff of the lerps, scattered with
    ``index_add_`` in fp32.  An edge-clamped upper index lands both
    weights in one row.  ``dtype=torch.bfloat16`` rounds g, the values,
    the weights and every product to bf16 (the accumulation stays fp32)."""
    n = xn.shape[0]
    d_planes, d_lines = [], []
    app_off = 0
    for i in range(3):
        plane, line = planes[i], lines[i]
        h, w, c = plane.shape
        length = line.shape[0]
        g = _channel_grads(n, c, nd[i], d_sigma, d_app_raw, app_off, plane)
        if dtype is not None:
            g = g.to(dtype)
        app_off += c - nd[i]
        m0, m1 = MAT_MODE[i]
        pf = sample_plane(plane, xn[:, m0], xn[:, m1], dtype)
        lf = sample_line(line, xn[:, VEC_MODE[i]], dtype)
        dpf, dlf = g * lf, g * pf
        x0, tx = _coords(xn[:, m0], w)
        y0, ty = _coords(xn[:, m1], h)
        l0, tl = _coords(xn[:, VEC_MODE[i]], length)
        if dtype is not None:
            tx, ty, tl = tx.to(dtype), ty.to(dtype), tl.to(dtype)
        x1 = torch.clamp(x0 + 1, max=w - 1)
        y1 = torch.clamp(y0 + 1, max=h - 1)
        tx, ty = tx[:, None], ty[:, None]
        d_top, d_bot = dpf * (1.0 - ty), dpf * ty
        dp = plane.new_zeros((h * w, c))
        dp.index_add_(0, y0 * w + x0, (d_top * (1.0 - tx)).float())
        dp.index_add_(0, y0 * w + x1, (d_top * tx).float())
        dp.index_add_(0, y1 * w + x0, (d_bot * (1.0 - tx)).float())
        dp.index_add_(0, y1 * w + x1, (d_bot * tx).float())
        l1 = torch.clamp(l0 + 1, max=length - 1)
        tl = tl[:, None]
        dl = line.new_zeros((length, c))
        dl.index_add_(0, l0, (dlf * (1.0 - tl)).float())
        dl.index_add_(0, l1, (dlf * tl).float())
        d_planes.append(dp.reshape(h, w, c))
        d_lines.append(dl)
    return tuple(d_planes), tuple(d_lines)


def factor_features_backward(xn, planes, lines, nd: Sequence[int], d_sigma=None,
                             d_app_raw=None, *, dtype: Optional[torch.dtype] = None,
                             out=None):
    """Gradients of the tables for the output gradients ``d_sigma`` (N,)
    and ``d_app_raw`` (N, Σna) (either may be None, not both): fp32 tables
    in the fused layout.  ``dtype=torch.bfloat16`` is the backward of the
    bf16 forward (products rounded to bf16, accumulated in fp32).
    ``out=(d_planes, d_lines)`` accumulates into those tables instead of
    fresh zeroed ones."""
    nd = tuple(int(v) for v in nd)
    _check(xn, planes, lines, nd, d_sigma is not None, d_app_raw is not None, dtype)
    if dtype == torch.float32:
        dtype = None
    n = xn.shape[0]
    na_total = sum(p.shape[2] - d for p, d in zip(planes, nd))
    if d_sigma is not None and (d_sigma.shape != (n,) or d_sigma.dtype != torch.float32):
        raise ValueError(f"d_sigma must be ({n},) float32, got {tuple(d_sigma.shape)}")
    if d_app_raw is not None and (
        d_app_raw.shape != (n, na_total) or d_app_raw.dtype != torch.float32
    ):
        raise ValueError(
            f"d_app_raw must be ({n}, {na_total}) float32, got {tuple(d_app_raw.shape)}"
        )
    if out is not None:
        for t, ref in zip((*out[0], *out[1]), (*planes, *lines)):
            if t.shape != ref.shape or t.dtype != torch.float32 or t.device != xn.device:
                raise ValueError("out tables must match the tables' shapes, fp32, same device")
    if xn.device.type == "cpu":
        got = factor_features_backward_plain(xn, planes, lines, nd, d_sigma, d_app_raw,
                                             dtype)
        if out is None:
            return got
        for t, g in zip((*out[0], *out[1]), (*got[0], *got[1])):
            t.add_(g)
        return out
    if xn.device.type != "cuda":
        raise ValueError(f"factor_features_backward: no kernel for device {xn.device}")
    return _launch_backward(xn, planes, lines, nd, d_sigma, d_app_raw,
                            dtype == torch.bfloat16, out)


def _launch_backward(xn, planes, lines, nd, d_sigma, d_app_raw, bf16, out):
    global BWD_LAUNCHES, BWD_LAST_GRID
    d_sigma = None if d_sigma is None else d_sigma.contiguous()
    d_app_raw = None if d_app_raw is None else d_app_raw.contiguous()
    if not all(t.is_contiguous() for t in (xn, *planes, *lines)):
        raise ValueError("factor_features_backward: inputs must be contiguous")
    zero = out is None
    if zero:
        out = (tuple(torch.empty_like(p, dtype=torch.float32) for p in planes),
               tuple(torch.empty_like(l, dtype=torch.float32) for l in lines))
    elif not all(t.is_contiguous() for t in (*out[0], *out[1])):
        raise ValueError("factor_features_backward: out tables must be contiguous")
    n = xn.shape[0]
    if n >= 2 ** 31:
        raise ValueError("factor_features_backward: at most 2^31 - 1 samples per launch")
    if n == 0:
        if zero:
            for t in (*out[0], *out[1]):
                t.zero_()
        return out
    na = [planes[i].shape[2] - nd[i] for i in range(3)]
    dims = (ctypes.c_int * 18)(
        *(p.shape[0] for p in planes),
        *(p.shape[1] for p in planes),
        *(l.shape[0] for l in lines),
        *(p.shape[2] for p in planes),
        *nd,
        0, na[0], na[0] + na[1],
    )
    info = (ctypes.c_int * 3)()
    lib = _lib_backward()
    with torch.cuda.device(xn.device):
        err = lib.t2n_factor_features_bwd(
            _build.ptr(xn), n,
            *(_build.ptr(p) for p in planes), *(_build.ptr(l) for l in lines),
            ctypes.cast(dims, ctypes.c_void_p), sum(na),
            _build.ptr(d_sigma), _build.ptr(d_app_raw),
            *(_build.ptr(t) for t in out[0]), *(_build.ptr(t) for t in out[1]),
            int(zero), int(bf16), ctypes.cast(info, ctypes.c_void_p), _build.stream_of(xn),
        )
    _build.check(err, "factor_features_backward launch")
    mode = "fused" if d_sigma is not None and d_app_raw is not None else (
        "density" if d_sigma is not None else "app")
    route = _ROUTE_NAMES[info[0]]
    with _build.COUNT_LOCK:
        BWD_LAUNCHES += 1
        BWD_MODES[mode] += 1
        BWD_DTYPES["bf16" if bf16 else "fp32"] += 1
        BWD_ROUTES[route] += 1
        BWD_LAST_GRID = (route, info[1], info[2])
    return out


def _lib_backward():
    lib = _build.library("factor_features_bwd")
    fn = lib.t2n_factor_features_bwd
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, ctypes.c_int, vp, vp, vp, vp, vp, vp, vp, ctypes.c_int,
                       vp, vp, vp, vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_int, vp, vp]
        fn.restype = ctypes.c_int
    return lib


class FactorFeatures(torch.autograd.Function):
    """Factor features with a gradient for the tables: kernel A forward
    (on detached tables, under no_grad), kernel A' backward on CUDA
    tensors, their plain versions on CPU tensors.  ``xn`` gets no
    gradient: rays are not trained.

    ``FactorFeatures.apply(xn, nd, sigma, app, dtype, *planes, *lines)``
    returns ``(sigma_feat | None, app_raw | None)`` as
    :func:`factor_features`."""

    @staticmethod
    def forward(ctx, xn, nd, sigma, app, dtype, *tables):
        planes, lines = tables[:3], tables[3:]
        with torch.no_grad():
            out = factor_features(
                xn, tuple(t.detach() for t in planes), tuple(t.detach() for t in lines),
                nd, sigma=sigma, app=app, dtype=dtype,
            )
        ctx.save_for_backward(xn, *tables)
        ctx.nd, ctx.dtype = tuple(int(v) for v in nd), dtype
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, d_sigma, d_app_raw):
        xn, *tables = ctx.saved_tensors
        needs = ctx.needs_input_grad[5:]
        if (d_sigma is None and d_app_raw is None) or not any(needs):
            return (None,) * (5 + len(tables))
        d_planes, d_lines = factor_features_backward(
            xn, tuple(tables[:3]), tuple(tables[3:]), ctx.nd, d_sigma, d_app_raw,
            dtype=ctx.dtype,
        )
        grads = [g if need else None for g, need in zip((*d_planes, *d_lines), needs)]
        return (None, None, None, None, None, *grads)
