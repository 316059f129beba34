"""TensoRF vm_split field as an ``nn.Module`` (port of
``text2nerf_tpu/models/tensorf.py``: the field, its alpha mask, the
regularizers and the optimizer groups).

Layouts follow the JAX package: planes are channels-last ``[H, W, C]``,
lines ``[L, C]``, plane i spans world axes ``MAT_MODE[i]`` (x indexes W,
y indexes H) and line i spans ``VEC_MODE[i]``.

The field stores each axis's factors channel-fused, density channels
first: ``planes[i] = density_plane_i ‖ app_plane_i`` and likewise for the
lines.  This is the value layout of ``pack_params_fused``
(tensorf.py:481) without the TPU's corner packing, so one table serves
the density-only, app-only and fused feature paths of kernel A.

Only ``vm_split`` is ported; ``cp`` and ``vm`` raise.
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
from ..ops.kernels.factor_features import (
    MAT_MODE, VEC_MODE, FactorFeatures, factor_features,
)
from . import mlp as mlp_mod


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


class TensoRF(nn.Module):
    """vm_split factors (channel-fused per axis), the basis and the head."""

    def __init__(self, cfg: TensoRFConfig, grid_size, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        if cfg.model_name != "vm_split":
            raise NotImplementedError(
                f"model_name={cfg.model_name!r} is not ported yet (vm_split only)"
            )
        if not cfg.shading_mode.startswith("MLP"):
            raise NotImplementedError(
                f"shading_mode={cfg.shading_mode!r} is not ported yet"
            )
        self.cfg = cfg
        gs = tuple(int(g) for g in grid_size)
        nd, na = cfg.density_n_comp, cfg.app_n_comp
        kw = dict(device=device, dtype=dtype)
        self.planes = nn.ParameterList(
            nn.Parameter(torch.empty(gs[MAT_MODE[i][1]], gs[MAT_MODE[i][0]],
                                     nd[i] + na[i], **kw))
            for i in range(3)
        )
        self.lines = nn.ParameterList(
            nn.Parameter(torch.empty(gs[VEC_MODE[i]], nd[i] + na[i], **kw))
            for i in range(3)
        )
        self.basis = nn.Parameter(torch.empty(sum(na), cfg.app_dim, **kw))
        in_dim = mlp_mod.mlp_input_dim(
            cfg.shading_mode, cfg.app_dim, cfg.view_pe, cfg.fea_pe, cfg.pos_pe
        )
        self.mlp = mlp_mod.ShadingMLP(in_dim, cfg.feature_c, **kw)

    @property
    def nd(self) -> Tuple[int, int, int]:
        return tuple(int(v) for v in self.cfg.density_n_comp)

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
        if torch.is_grad_enabled() and any(t.requires_grad for t in (*planes, *lines)):
            # training: kernel A forward, kernel A' (the scatter-add) backward
            return FactorFeatures.apply(xn, self.nd, sigma, app, dtype, *planes, *lines)
        return factor_features(xn, planes, lines, self.nd, sigma=sigma, app=app, dtype=dtype)

    def _basis(self, app_raw, dtype):
        if dtype is None:
            return app_raw @ self.basis
        return (app_raw.to(dtype) @ self.basis.to(dtype)).float()

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
    """A randomly initialised field: 0.1·randn factors, a bias-free basis
    U[±1/sqrt(fan_in)] and the head's Linear init.  The statistics of the
    JAX init, not its bits.  ``generator`` must live on ``device``."""
    dev = resolve_device(device)
    field = TensoRF(cfg, grid_size, device=dev, dtype=dtype)
    with torch.no_grad():
        for p in (*field.planes, *field.lines):
            p.normal_(0.0, 0.1, generator=generator)
        bound = 1.0 / math.sqrt(sum(cfg.app_n_comp))
        field.basis.uniform_(-bound, bound, generator=generator)
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
    return [
        {"name": "spatial", "params": [*field.planes, *field.lines]},
        {"name": "network", "params": [field.basis, *field.mlp.parameters()]},
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
# (TV divides by each group's own channel count)
# ---------------------------------------------------------------------------


def _tv_plane(plane):
    """TV of one (H, W, C) plane: 2·(h_tv / count_h + w_tv / count_w)."""
    h, w, c = plane.shape
    h_tv = torch.sum((plane[1:] - plane[:-1]) ** 2)
    w_tv = torch.sum((plane[:, 1:] - plane[:, :-1]) ** 2)
    return 2.0 * (h_tv / ((h - 1) * w * c) + w_tv / (h * (w - 1) * c))


def tv_loss_density(field: TensoRF):
    return sum(_tv_plane(p) for p in field.density_planes()) * 1e-2


def tv_loss_app(field: TensoRF):
    return sum(_tv_plane(p) for p in field.app_planes()) * 1e-2


def density_l1(field: TensoRF):
    """Mean |.| of the density factors."""
    return sum(
        torch.mean(torch.abs(p)) + torch.mean(torch.abs(l))
        for p, l in zip(field.density_planes(), field.density_lines())
    )


def vector_comp_diffs(field: TensoRF):
    """Orthogonality regularizer: mean |off-diagonal| of each line's
    component Gram matrix."""

    def one(lines):
        total = 0.0
        for line in lines:
            v = line.T  # (C, L): components are rows
            dotp = v @ v.T
            n_comp = v.shape[0]
            off = dotp.reshape(-1)[1:].reshape(n_comp - 1, n_comp + 1)[..., :-1]
            total = total + torch.mean(torch.abs(off))
        return total

    return one(field.density_lines()) + one(field.app_lines())


# ---------------------------------------------------------------------------
# Alpha queries / alpha-grid mask
# ---------------------------------------------------------------------------


def compute_alpha(field: TensoRF, aabb, xyz, length):
    """Opacity 1 - exp(-sigma * length) at world points."""
    xn = torch.clamp(normalize_coord(aabb, xyz), -1.0, 1.0)
    sigma = feature2density(field.cfg, field.density_feature(xn.contiguous()))
    return 1.0 - torch.exp(-sigma * length)


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
