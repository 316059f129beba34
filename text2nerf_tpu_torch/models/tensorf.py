"""TensoRF fields as an ``nn.Module`` (port of
``text2nerf_tpu/models/tensorf.py``: the field, its alpha mask, the
regularizers and the optimizer groups), in the three decompositions:

- ``vm_split`` (TensorVMSplit, the default): separate density and app
  plane × line factors per axis;
- ``vm`` (TensorVM): one plane / line stack per axis holding both, on a
  cubic grid;
- ``cp`` (TensorCP): rank-1 lines only, Σ_c Π_i line_i[c].

Layouts follow the JAX package: planes are channels-last ``[H, W, C]``,
lines ``[L, C]``, plane i spans world axes ``MAT_MODE[i]`` (x indexes W,
y indexes H) and line i spans ``VEC_MODE[i]``.

The field stores each axis's factors channel-fused, density channels
first: ``planes[i] = density_plane_i ‖ app_plane_i`` and likewise for the
lines (``cp`` has lines only).  This is the value layout of
``pack_params_fused`` (tensorf.py:481) without the TPU's corner packing,
so one table serves the density-only, app-only and fused feature paths:
kernel A for ``vm_split`` and ``vm`` (whose JAX stack keeps the app
channels first: :mod:`..engine.checkpoints` reorders them on the way in
and out), kernel C for ``cp``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import check_on, resolve_device
from ..engine.tracing import count
from ..ops.kernels.cp_features import CPFeatures, cp_features
from ..ops.kernels.factor_features import (
    MAT_MODE, VEC_MODE, FactorFeatures, factor_features,
)
from . import mlp as mlp_mod

MODEL_NAMES = ("vm_split", "vm", "cp")
SHADING_MODES = ("MLP_Fea_noview", "MLP_Fea", "MLP_PE", "MLP", "SH", "RGB")


@dataclasses.dataclass(frozen=True)
class TensoRFConfig:
    """Static model hyper-parameters (same fields and defaults as the JAX
    package's, so checkpoints carry one JSON form)."""

    model_name: str = "vm_split"  # vm_split | cp | vm
    density_n_comp: Tuple[int, ...] = (16, 16, 16)
    app_n_comp: Tuple[int, ...] = (48, 48, 48)
    app_dim: int = 27
    shading_mode: str = "MLP_Fea_noview"
    pos_pe: int = 6
    view_pe: int = 2
    fea_pe: int = 6
    feature_c: int = 128
    density_shift: float = -10.0
    distance_scale: float = 25.0
    raymarch_weight_thres: float = 1e-4
    alpha_mask_thres: float = 1e-4
    fea2dense: str = "softplus"  # softplus | relu
    step_ratio: float = 1.0
    near: float = 0.5
    far: float = 8.0

    def to_dict(self):
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d):
        d = dict(d)
        for k in ("density_n_comp", "app_n_comp"):
            if k in d:
                d[k] = tuple(d[k])
        return TensoRFConfig(**d)


# ---------------------------------------------------------------------------
# Grid bookkeeping
# ---------------------------------------------------------------------------


def n_to_reso(n_voxels: int, aabb) -> Tuple[int, int, int]:
    """Voxel count → per-axis resolution, in fp32 as the JAX package
    computes it."""
    aabb = np.asarray(aabb, np.float32)
    size = aabb[1] - aabb[0]
    voxel_size = (np.prod(size) / np.float32(n_voxels)) ** np.float32(1.0 / 3.0)
    return tuple(int(v) for v in (size / voxel_size))


def cal_n_samples(reso, step_ratio: float = 0.5) -> int:
    """Sample count along the grid diagonal."""
    return int(math.sqrt(sum(float(r) ** 2 for r in reso)) / step_ratio)


def default_n_samples(reso, step_ratio: float, n_samples_cap: int = 10 ** 6) -> int:
    """The training-time rule: min(cap, cal_n_samples / 2)."""
    return min(n_samples_cap, int(cal_n_samples(reso, step_ratio) / 2))


def step_size(aabb, grid_size, step_ratio: float):
    """Mean voxel edge × step_ratio, a 0-d fp32 tensor on aabb's device."""
    grid = torch.as_tensor(grid_size, dtype=torch.float32, device=aabb.device)
    units = (aabb[1] - aabb[0]) / (grid - 1)
    # sum · fp32(1/3), the JAX package's mean, bit for bit
    return torch.sum(units) * (1.0 / units.numel()) * step_ratio


def normalize_coord(aabb, xyz):
    """World → [-1, 1] grid coords."""
    inv = 2.0 / (aabb[1] - aabb[0])
    return (xyz - aabb[0]) * inv - 1.0


def feature2density(cfg: TensoRFConfig, feat):
    """softplus(feat + density_shift) or relu."""
    if cfg.fea2dense == "softplus":
        return F.softplus(feat + cfg.density_shift)
    return torch.relu(feat)


# ---------------------------------------------------------------------------
# The field
# ---------------------------------------------------------------------------


def component_counts(cfg: TensoRFConfig):
    """(density, app) components per axis: the config's for ``vm_split``;
    the first entry's on every axis for ``vm`` and ``cp``, as the JAX
    package reads them."""
    if cfg.model_name == "vm_split":
        return tuple(int(v) for v in cfg.density_n_comp), tuple(int(v) for v in cfg.app_n_comp)
    nd, na = int(cfg.density_n_comp[0]), int(cfg.app_n_comp[0])
    return (nd,) * 3, (na,) * 3


class TensoRF(nn.Module):
    """The factors (channel-fused per axis), the basis and, for the MLP
    shading modes, the head (``mlp`` is None for ``SH`` and ``RGB``).
    ``vm`` builds a cubic grid of ``grid_size[0]`` per axis, as the JAX
    package's init does."""

    def __init__(self, cfg: TensoRFConfig, grid_size, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        if cfg.model_name not in MODEL_NAMES:
            raise ValueError(f"unknown model_name: {cfg.model_name!r}")
        if cfg.shading_mode not in SHADING_MODES:
            raise ValueError(f"unknown shading mode: {cfg.shading_mode!r}")
        self.cfg = cfg
        gs = tuple(int(g) for g in grid_size)
        if cfg.model_name == "vm":
            gs = (gs[0],) * 3
        nd, na = component_counts(cfg)
        kw = dict(device=device, dtype=dtype)
        if cfg.model_name == "cp":
            self.planes = nn.ParameterList()
        else:
            self.planes = nn.ParameterList(
                nn.Parameter(torch.empty(gs[MAT_MODE[i][1]], gs[MAT_MODE[i][0]],
                                         nd[i] + na[i], **kw))
                for i in range(3)
            )
        self.lines = nn.ParameterList(
            nn.Parameter(torch.empty(gs[VEC_MODE[i]], nd[i] + na[i], **kw))
            for i in range(3)
        )
        n_app = na[0] if cfg.model_name == "cp" else sum(na)
        self.basis = nn.Parameter(torch.empty(n_app, cfg.app_dim, **kw))
        #: sums the basis product over the model axis of a mesh
        #: (:func:`..parallel.mesh.shard_params`); None for a whole field
        self.app_reduce = None
        self.mlp = None
        if cfg.shading_mode.startswith("MLP"):
            in_dim = mlp_mod.mlp_input_dim(
                cfg.shading_mode, cfg.app_dim, cfg.view_pe, cfg.fea_pe, cfg.pos_pe
            )
            self.mlp = mlp_mod.ShadingMLP(in_dim, cfg.feature_c, **kw)

    @property
    def is_cp(self) -> bool:
        return self.cfg.model_name == "cp"

    @property
    def nd(self) -> Tuple[int, ...]:
        """Density channels of each axis's fused table."""
        return component_counts(self.cfg)[0]

    def density_planes(self):
        return tuple(p[..., :d] for p, d in zip(self.planes, self.nd))

    def density_lines(self):
        return tuple(l[..., :d] for l, d in zip(self.lines, self.nd))

    def app_planes(self):
        return tuple(p[..., d:] for p, d in zip(self.planes, self.nd))

    def app_lines(self):
        return tuple(l[..., d:] for l, d in zip(self.lines, self.nd))

    def _factors(self, xn, sigma, app, dtype):
        planes, lines = tuple(self.planes), tuple(self.lines)
        train = torch.is_grad_enabled() and any(t.requires_grad for t in (*planes, *lines))
        if self.is_cp:
            # kernel C forward; in training kernel C' (the scatter-add) backward
            if train:
                return CPFeatures.apply(xn, self.nd[0], sigma, app, dtype, *lines)
            if xn.is_cuda:  # an eval launch of kernel C
                for name, want in (("cp.sigma_samples", sigma), ("cp.app_samples", app)):
                    if want:
                        count(name, xn.shape[0])
            return cp_features(xn, lines, self.nd[0], sigma=sigma, app=app, dtype=dtype)
        if train:
            # kernel A forward, kernel A' (the scatter-add) backward
            return FactorFeatures.apply(xn, self.nd, sigma, app, dtype, *planes, *lines)
        return factor_features(xn, planes, lines, self.nd, sigma=sigma, app=app, dtype=dtype)

    def _basis(self, app_raw, dtype):
        if dtype is None:
            out = app_raw @ self.basis
        else:
            # kernels A and C return a bf16 app_raw in bf16: it goes in as
            # it comes, no cast
            if app_raw.dtype != dtype:
                app_raw = app_raw.to(dtype)
            out = (app_raw @ self.basis.to(dtype)).float()
        return out if self.app_reduce is None else self.app_reduce(out)

    def fused_features(self, xn, dtype: Optional[torch.dtype] = None):
        """(density_feat (N,), app (N, app_dim)) at normalized coords from
        one pass over the fused tables (compute_fused_features_packed)."""
        sigma, app_raw = self._factors(xn, True, True, dtype)
        return sigma, self._basis(app_raw, dtype)

    def density_feature(self, xn, dtype: Optional[torch.dtype] = None):
        """Raw density feature (N,) (compute_density_feature_packed)."""
        return self._factors(xn, True, False, dtype)[0]

    def app_feature(self, xn, dtype: Optional[torch.dtype] = None):
        """Appearance features (N, app_dim) (compute_app_feature_packed)."""
        return self._basis(self._factors(xn, False, True, dtype)[1], dtype)


def init_params(cfg: TensoRFConfig, grid_size, *, generator: torch.Generator,
                device=None, dtype=torch.float32) -> TensoRF:
    """A randomly initialised field: 0.1·randn plane and line factors
    (0.2·randn for the CP lines), a bias-free basis U[±1/sqrt(fan_in)] and
    the head's Linear init.  The statistics of the JAX init, not its bits.
    ``generator`` must live on ``device``."""
    dev = resolve_device(device)
    field = TensoRF(cfg, grid_size, device=dev, dtype=dtype)
    scale = 0.2 if field.is_cp else 0.1
    with torch.no_grad():
        for p in (*field.planes, *field.lines):
            p.normal_(0.0, scale, generator=generator)
        bound = 1.0 / math.sqrt(field.basis.shape[0])
        field.basis.uniform_(-bound, bound, generator=generator)
    if field.mlp is not None:
        field.mlp = mlp_mod.init_mlp(
            field.mlp.w1.shape[0], cfg.feature_c, generator=generator,
            device=dev, dtype=dtype,
        )
    return field


def grid_resolution(field: TensoRF) -> Tuple[int, int, int]:
    """Grid resolution (x, y, z) from the line lengths."""
    ls = [field.lines[i].shape[0] for i in range(3)]
    return (ls[2], ls[1], ls[0])


def param_groups(field: TensoRF):
    """Optimizer groups: the factor planes and lines are ``spatial`` (lr
    0.02), the basis and the head ``network`` (lr 1e-3), as the JAX
    package's ``param_group_labels``."""
    mlp = [] if field.mlp is None else list(field.mlp.parameters())
    return [
        {"name": "spatial", "params": [*field.planes, *field.lines]},
        {"name": "network", "params": [field.basis, *mlp]},
    ]


def grouping_safe(aabb, grid_size, step_ratio: float, group: int = 2, block: int = 4,
                  dir_bound: float = 1.0) -> bool:
    """True when ``group`` ray-consecutive samples span at most ``block -
    2`` grid cells per axis: the worst drift across the group along an
    axis is (group-1)·step·dir_bound / unit (host arithmetic, fp32 units as
    the JAX package's)."""
    aabb = np.asarray(aabb, np.float32)
    units = (aabb[1] - aabb[0]) / (np.asarray(grid_size, np.float32) - np.float32(1))
    step = float(np.mean(units, dtype=np.float32)) * step_ratio
    drift = (group - 1) * step * dir_bound / float(np.min(units))
    return drift <= block - 2 + 1e-6


def grouping_block(aabb, grid_size, step_ratio: float, group: int = 2, max_block: int = 4,
                   dir_bound: float = 1.0) -> int:
    """Smallest safe packing block for grouped density samples, or 0 when
    none up to ``max_block`` is safe."""
    for block in range(3, max_block + 1):
        if grouping_safe(aabb, grid_size, step_ratio, group, block, dir_bound):
            return block
    return 0


# ---------------------------------------------------------------------------
# Regularizers, on the density and app channel slices of the fused tables
# (TV divides by each group's own channel count); CP's TV is over its
# lines, weighted 1e-3
# ---------------------------------------------------------------------------


def _tv_plane(plane):
    """TV of one (H, W, C) plane: 2·(h_tv / count_h + w_tv / count_w)."""
    h, w, c = plane.shape
    h_tv = torch.sum((plane[1:] - plane[:-1]) ** 2)
    w_tv = torch.sum((plane[:, 1:] - plane[:, :-1]) ** 2)
    return 2.0 * (h_tv / ((h - 1) * w * c) + w_tv / (h * (w - 1) * c))


def _tv_line(line):
    """TV of one (L, C) line: 2·sum of squared steps / ((L - 1)·C)."""
    l, c = line.shape
    return 2.0 * torch.sum((line[1:] - line[:-1]) ** 2) / ((l - 1) * c)


def tv_loss_density(field: TensoRF):
    if field.is_cp:
        return sum(_tv_line(l) for l in field.density_lines()) * 1e-3
    return sum(_tv_plane(p) for p in field.density_planes()) * 1e-2


def tv_loss_app(field: TensoRF):
    if field.is_cp:
        return sum(_tv_line(l) for l in field.app_lines()) * 1e-3
    return sum(_tv_plane(p) for p in field.app_planes()) * 1e-2


def density_l1(field: TensoRF):
    """Mean |.| of the density factors (CP: of its lines)."""
    if field.is_cp:
        return sum(torch.mean(torch.abs(l)) for l in field.density_lines())
    return sum(
        torch.mean(torch.abs(p)) + torch.mean(torch.abs(l))
        for p, l in zip(field.density_planes(), field.density_lines())
    )


def vector_comp_diffs(field: TensoRF, app_lines=None):
    """Orthogonality regularizer: mean |off-diagonal| of each line's
    component Gram matrix, over the density and the app lines
    (``app_lines`` in place of the field's own: a model shard passes the
    whole lines).  The ``vm`` decomposition keeps no separate density and
    app lines and raises, as the JAX package's does (its parameters have
    no such keys)."""
    if field.cfg.model_name == "vm":
        raise ValueError("vector_comp_diffs: the vm decomposition has no separate "
                         "density and app lines")

    def one(lines):
        total = 0.0
        for line in lines:
            v = line.T  # (C, L): components are rows
            dotp = v @ v.T
            n_comp = v.shape[0]
            off = dotp.reshape(-1)[1:].reshape(n_comp - 1, n_comp + 1)[..., :-1]
            total = total + torch.mean(torch.abs(off))
        return total

    return one(field.density_lines()) + one(field.app_lines() if app_lines is None
                                            else app_lines)


# ---------------------------------------------------------------------------
# Alpha queries / alpha-grid mask
# ---------------------------------------------------------------------------


def compute_alpha(field: TensoRF, aabb, xyz, length):
    """Opacity 1 - exp(-sigma * length) at world points."""
    xn = torch.clamp(normalize_coord(aabb, xyz), -1.0, 1.0)
    sigma = feature2density(field.cfg, field.density_feature(xn.contiguous()))
    return 1.0 - torch.exp(-sigma * length)


def sample_alpha_mask(alpha, xyz):
    """Trilinear sample of the binary alpha volume at world points ``xyz``
    (N, 3) → (N,).  ``alpha`` is a dict {'volume': (D, H, W) laid out
    [z, y, x], 'aabb': (2, 3)}; coordinates are clamped to the box and
    the corners to the volume (align-corners, border)."""
    volume = torch.as_tensor(alpha["volume"])
    aabb = torch.as_tensor(alpha["aabb"], dtype=volume.dtype, device=volume.device)
    xn = torch.clamp(normalize_coord(aabb, xyz.to(volume.device)), -1.0, 1.0)
    d, h, w = volume.shape
    flat = volume.reshape(-1)

    def corner(u, size):
        f = (u + 1.0) * 0.5 * (size - 1)
        i0 = torch.clamp(torch.floor(f).long(), 0, size - 1)
        t = torch.clamp(f - i0.to(f.dtype), 0.0, 1.0)
        return i0, torch.clamp(i0 + 1, max=size - 1), t

    x0, x1, tx = corner(xn[:, 0], w)
    y0, y1, ty = corner(xn[:, 1], h)
    z0, z1, tz = corner(xn[:, 2], d)

    def take(zi, yi, xi):
        return flat[(zi * h + yi) * w + xi]

    c00 = take(z0, y0, x0) * (1 - tx) + take(z0, y0, x1) * tx
    c01 = take(z0, y1, x0) * (1 - tx) + take(z0, y1, x1) * tx
    c10 = take(z1, y0, x0) * (1 - tx) + take(z1, y0, x1) * tx
    c11 = take(z1, y1, x0) * (1 - tx) + take(z1, y1, x1) * tx
    c0 = c00 * (1 - ty) + c01 * ty
    c1 = c10 * (1 - ty) + c11 * ty
    return c0 * (1 - tz) + c1 * tz


def _linspace01(g: int, device):
    """``jnp.linspace(0, 1, g)`` in fp32, bit for bit: iota·(1/(g-1)) with
    the end point set exactly."""
    if g == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    inv = torch.tensor(1.0, dtype=torch.float32) / (g - 1)
    u = torch.arange(g, dtype=torch.float32, device=device) * inv.to(device)
    u[-1] = 1.0
    return u


def dense_alpha(field: TensoRF, aabb, grid_size, step, chunk: int = 64 ** 3):
    """Alpha over a dense lattice → (alpha[gx, gy, gz], xyz[gx, gy, gz, 3])."""
    gx, gy, gz = (int(g) for g in grid_size)
    u = [_linspace01(g, aabb.device) for g in (gx, gy, gz)]
    grid = torch.stack(torch.meshgrid(*u, indexing="ij"), -1)
    dense_xyz = aabb[0] * (1 - grid) + aabb[1] * grid
    flat = dense_xyz.reshape(-1, 3)
    outs = [
        compute_alpha(field, aabb, flat[s : s + chunk], step)
        for s in range(0, flat.shape[0], chunk)
    ]
    return torch.cat(outs).reshape(gx, gy, gz), dense_xyz


@torch.no_grad()
def update_alpha_mask(field: TensoRF, aabb, grid_size, pool: int = 3, *,
                      device=None):
    """Binary alpha volume + tight AABB: ``pool``³ max-pool ("SAME", -inf
    padding) then threshold.  Returns ({'volume': [z, y, x] float 0/1,
    'aabb', 'pool'}, new_aabb).  ``pool`` must be odd."""
    if pool < 1 or pool % 2 == 0:
        raise ValueError(f"pool must be odd, got {pool}")
    dev = resolve_device(device)
    check_on(dev, field)
    aabb = torch.as_tensor(aabb, dtype=torch.float32).to(dev)
    step = step_size(aabb, grid_resolution(field), field.cfg.step_ratio)
    alpha, dense_xyz = dense_alpha(field, aabb, grid_size, step)
    vol = torch.clamp(alpha, 0, 1).permute(2, 1, 0).contiguous()  # [z, y, x]
    vol = F.max_pool3d(vol[None, None], pool, stride=1, padding=pool // 2)[0, 0]
    vol = (vol >= field.cfg.alpha_mask_thres).float()

    occupied = vol.permute(2, 1, 0) > 0.5  # [x, y, z]
    axes = (
        (occupied.any(dim=(1, 2)), dense_xyz[:, 0, 0, 0]),
        (occupied.any(dim=(0, 2)), dense_xyz[0, :, 0, 1]),
        (occupied.any(dim=(0, 1)), dense_xyz[0, 0, :, 2]),
    )
    new_aabb = aabb.clone()  # an empty mask keeps the full AABB
    for a, (occ, coord) in enumerate(axes):
        if bool(occ.any()):
            new_aabb[0, a] = coord[occ].min()
            new_aabb[1, a] = coord[occ].max()
    return {"volume": vol, "aabb": aabb, "pool": int(pool)}, new_aabb


def _linspace(start, stop, num: int):
    """``jnp.linspace(start, stop, num)`` in fp32 for 0-d tensors, bit for
    bit: start·(1 - s) + stop·s with s = iota·fp32(1/(num - 1)) (XLA's
    division by a constant), the end point set exactly."""
    if num == 1:
        return start.reshape(1)
    s = _linspace01(num, start.device)[:-1]
    return torch.cat([start * (1 - s) + stop * s, stop.reshape(1)])


@torch.no_grad()
def _stamp_volume(volume, aabb, rays, depth, band_voxels: int, z_samples: int, pool: int):
    o, d = rays[:, :3], rays[:, 3:6]
    dz, hz, wz = volume.shape  # [z, y, x]
    # band half-width in world units: band_voxels of the coarsest mask axis
    vox = torch.max((aabb[1] - aabb[0]) / torch.tensor([wz, hz, dz], dtype=volume.dtype,
                                                        device=volume.device))
    offs = _linspace(-band_voxels * vox, band_voxels * vox, z_samples)
    pts = o[:, None] + d[:, None] * (depth[:, None] + offs[None, :])[..., None]
    xn = torch.clamp(normalize_coord(aabb, pts.reshape(-1, 3)), -1.0, 1.0)
    ix = torch.round((xn[..., 0] + 1) * 0.5 * (wz - 1)).to(torch.int64)
    iy = torch.round((xn[..., 1] + 1) * 0.5 * (hz - 1)).to(torch.int64)
    iz = torch.round((xn[..., 2] + 1) * 0.5 * (dz - 1)).to(torch.int64)
    stamped = torch.zeros(dz * hz * wz, dtype=volume.dtype, device=volume.device)
    stamped[(iz * hz + iy) * wz + ix] = 1.0  # a max-reduction of 1.0 into zeros
    # dilate: ±band_voxels covers depth-alignment error across the rays;
    # the extra pool radius keeps the ±r invariant that licenses strided
    # occupancy tests
    k = 2 * (band_voxels + (pool - 1) // 2) + 1
    stamped = F.max_pool3d(stamped.reshape(1, 1, dz, hz, wz), k, stride=1, padding=k // 2)
    return torch.maximum(volume, stamped[0, 0])


def stamp_alpha_mask(mask, rays, depth, band_voxels: int = 2, z_samples: int = 5,
                     max_rays: int = 1 << 20):
    """Mark a ±``band_voxels`` band around each supervised ray's depth point
    live in the alpha mask (dilated by the mask's pool radius), so train
    compaction cannot freeze the support where supervised content must
    grow.

    ``rays`` / ``depth``: a training pool ((N, 6), (N,), host numpy).  An
    evenly spaced selection of the next power of two rays (at most
    ``max_rays``) is stamped, as the JAX package selects them.  Returns a
    new mask dict; the volume stays on its device."""
    rays, depth = np.asarray(rays), np.asarray(depth)
    n = rays.shape[0]
    if n == 0:
        return mask
    k = min(1 << max(n - 1, 1).bit_length(), max_rays)
    sel = np.linspace(0, n - 1, k).astype(np.int64)
    volume = mask["volume"]
    dev = volume.device
    vol = _stamp_volume(
        volume, torch.as_tensor(mask["aabb"], dtype=torch.float32).to(dev),
        torch.as_tensor(np.ascontiguousarray(rays[sel], np.float32), device=dev),
        torch.as_tensor(np.ascontiguousarray(depth[sel], np.float32), device=dev),
        int(band_voxels), int(z_samples), int(mask.get("pool", 3)),
    )
    out = dict(mask)
    out["volume"] = vol
    return out


# ---------------------------------------------------------------------------
# Grid resizing (coarse-to-fine) and AABB shrink, on the fused tables
# ---------------------------------------------------------------------------


def _with_tables(field: TensoRF, grid_size, planes, lines) -> TensoRF:
    """A new field of ``grid_size`` holding ``planes`` / ``lines`` and a
    copy of ``field``'s basis and head."""
    new = TensoRF(field.cfg, grid_size, device=field.basis.device, dtype=field.basis.dtype)
    new.app_reduce = field.app_reduce
    with torch.no_grad():
        for dst, src in zip((*new.planes, *new.lines), (*planes, *lines)):
            dst.copy_(src)
        new.basis.copy_(field.basis)
        if field.mlp is not None:
            for k in ("w1", "b1", "w2", "b2", "w3", "b3"):
                new.mlp[k].copy_(field.mlp[k])
    return new


def _resize_axis(table, axis: int, n_out: int):
    """Align-corners linear resize of ``table`` along ``axis`` to ``n_out``
    entries, computed as the JAX package's ``grid_sample_1d`` /
    ``grid_sample_2d`` compute it: coordinates from ``linspace(-1, 1)``,
    unnormalized to (u + 1)·0.5·(n - 1), then a lerp of the two rows."""
    n = table.shape[axis]
    one = torch.ones((), dtype=torch.float32, device=table.device)
    f = (_linspace(-one, one, n_out) + 1.0) * 0.5 * (n - 1)
    i0 = torch.clamp(torch.floor(f).to(torch.int64), 0, n - 1)
    i1 = torch.clamp(i0 + 1, max=n - 1)
    t = torch.clamp(f - i0.to(f.dtype), 0.0, 1.0)
    shape = [1] * table.ndim
    shape[axis] = n_out
    t = t.reshape(shape)
    return (torch.index_select(table, axis, i0) * (1.0 - t)
            + torch.index_select(table, axis, i1) * t)


@torch.no_grad()
def upsample_volume_grid(field: TensoRF, res_target) -> TensoRF:
    """Bilinear (planes) and linear (lines) align-corners resize of every
    factor table to ``res_target`` (x, y, z); a new field.  Each channel
    is resized alone, so the fused tables give the per-channel values of
    the JAX package's separate density and app tables; the arithmetic is
    its grid sampler's, W before H (equal bit for bit at test sizes; at a
    300-entry axis XLA's linspace rounds some coordinates by an ulp
    otherwise).  ``vm`` resizes every axis to ``res_target[0]`` (its grid
    stays cubic); ``cp`` has lines only."""
    res = tuple(int(r) for r in res_target)
    if field.cfg.model_name == "vm":
        res = (res[0],) * 3
    planes = []
    for i, plane in enumerate(field.planes):
        m0, m1 = MAT_MODE[i]
        planes.append(_resize_axis(_resize_axis(plane, 1, res[m0]), 0, res[m1]))
    lines = [_resize_axis(field.lines[i], 0, res[VEC_MODE[i]]) for i in range(3)]
    return _with_tables(field, res, planes, lines)


@torch.no_grad()
def shrink(field: TensoRF, aabb, new_aabb):
    """Crop the factor tables to a tighter AABB, snapped to the voxel
    lattice (``cp``: its lines).  Returns (field, corrected aabb (2, 3)
    fp32 on the field's device, new grid size).  ``vm`` raises: a per-axis
    crop would break its cubic grid, and the JAX package has no vm shrink
    either."""
    if field.cfg.model_name == "vm":
        raise ValueError("shrink: the vm decomposition has no shrink (its grid is cubic)")
    aabb = np.asarray(torch.as_tensor(aabb).cpu(), np.float32)
    new_aabb = np.asarray(torch.as_tensor(new_aabb).cpu(), np.float32)
    gs = np.asarray(grid_resolution(field))
    units = (aabb[1] - aabb[0]) / (gs - 1)
    t_l = np.round(np.round((new_aabb[0] - aabb[0]) / units)).astype(np.int64)
    b_r = np.round((new_aabb[1] - aabb[0]) / units).astype(np.int64) + 1
    b_r = np.minimum(b_r, gs)

    lines = [field.lines[i][t_l[VEC_MODE[i]]: b_r[VEC_MODE[i]]] for i in range(3)]
    planes = []
    for i, plane in enumerate(field.planes):
        m0, m1 = MAT_MODE[i]
        planes.append(plane[t_l[m1]: b_r[m1], t_l[m0]: b_r[m0]])
    new_gs = tuple(int(x) for x in (b_r - t_l))

    t_l_r = t_l / (gs - 1)
    b_r_r = (b_r - 1) / (gs - 1)
    correct = np.stack(
        [
            (1 - t_l_r) * aabb[0] + t_l_r * aabb[1],
            (1 - b_r_r) * aabb[0] + b_r_r * aabb[1],
        ]
    )
    out_aabb = torch.tensor(np.asarray(correct, np.float32), device=field.basis.device)
    return _with_tables(field, new_gs, planes, lines), out_aabb, new_gs
