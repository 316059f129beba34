"""Plain PyTorch reference of a TensoRF field, written from the TensoRF
paper and Text2NeRF's training recipe, independent of the program.

A field is a dict of fp32 tensors (the names :func:`leaf_shapes` gives):

- ``vm_split``: ``planes.i`` (H_i, W_i, nd_i + na_i) and ``lines.i``
  (L_i, nd_i + na_i), density channels first; plane i spans world axes
  ``MAT_MODE[i]`` (the first indexes W, the second H), line i spans
  ``VEC_MODE[i]``;
- ``cp``: ``lines.i`` (L_i, nd + na) only, the features are the product of
  the three lines' values;
- both: ``basis`` (Σna, app_dim) and the head ``mlp.w1`` .. ``mlp.b3``
  (weights laid out (in, out)).

Matrix products go through :func:`matmul`, which in ``precision="tf32"``
rounds both operands to TF32 (10 mantissa bits, to nearest) in the
forward and the backward: the control a comparison has to catch.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)


# ---------------------------------------------------------------------------
# Sizes of a configuration
# ---------------------------------------------------------------------------


def n_to_reso(n_voxels: int, aabb):
    """Voxel count -> (x, y, z) resolution, in fp32 arithmetic."""
    aabb = np.asarray(aabb, np.float32)
    size = aabb[1] - aabb[0]
    voxel = (np.prod(size) / np.float32(n_voxels)) ** np.float32(1.0 / 3.0)
    return tuple(int(v) for v in (size / voxel))


def n_samples_for(reso, step_ratio: float) -> int:
    """Samples per ray: half the grid diagonal in steps."""
    return int(int(math.sqrt(sum(float(r) ** 2 for r in reso)) / step_ratio) / 2)


def step_size(aabb, reso, step_ratio: float):
    units = (aabb[1] - aabb[0]) / (torch.tensor(reso, dtype=torch.float32,
                                                device=aabb.device) - 1)
    return torch.sum(units) * (1.0 / 3) * step_ratio


def components(cfg):
    """((nd_x, nd_y, nd_z), (na_x, na_y, na_z)) of a configuration dict."""
    if cfg["model_name"] == "cp":
        return (cfg["n_lamb_sigma"][0],) * 3, (cfg["n_lamb_sh"][0],) * 3
    return tuple(cfg["n_lamb_sigma"]), tuple(cfg["n_lamb_sh"])


def head_input_dim(cfg) -> int:
    a = cfg["app_dim"]
    if cfg["shadingMode"] == "MLP_Fea_noview":
        return a + 2 * cfg["fea_pe"] * a
    if cfg["shadingMode"] == "MLP_Fea":
        return a + 3 + 2 * cfg["fea_pe"] * a + 2 * cfg["view_pe"] * 3
    raise ValueError(f"no reference head for {cfg['shadingMode']!r}")


def leaf_shapes(cfg, reso):
    """[(name, shape)] of the field's tensors, in a fixed order."""
    nd, na = components(cfg)
    out = []
    if cfg["model_name"] != "cp":
        for i in range(3):
            out.append((f"planes.{i}", (reso[MAT_MODE[i][1]], reso[MAT_MODE[i][0]], nd[i] + na[i])))
    for i in range(3):
        out.append((f"lines.{i}", (reso[VEC_MODE[i]], nd[i] + na[i])))
    n_app = na[0] if cfg["model_name"] == "cp" else sum(na)
    fc, d_in = cfg["featureC"], head_input_dim(cfg)
    out += [("basis", (n_app, cfg["app_dim"])), ("mlp.w1", (d_in, fc)), ("mlp.b1", (fc,)),
            ("mlp.w2", (fc, fc)), ("mlp.b2", (fc,)), ("mlp.w3", (fc, 3)), ("mlp.b3", (3,))]
    return out


# ---------------------------------------------------------------------------
# Products in a stated precision
# ---------------------------------------------------------------------------


def tf32_round(x):
    """Round fp32 to TF32 (10 mantissa bits), to nearest, ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _MatmulTF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ tf32_round(b).T, tf32_round(a).T @ g


def matmul(a, b, precision: str):
    if precision == "fp32":
        return a @ b
    if precision == "tf32":
        return _MatmulTF32.apply(a, b)
    raise ValueError(f"precision must be fp32 or tf32, got {precision!r}")


# ---------------------------------------------------------------------------
# Features and the head
# ---------------------------------------------------------------------------


def _cell(u, size: int):
    f = (u + 1.0) * 0.5 * (size - 1)
    i0 = torch.clamp(torch.floor(f).long(), 0, size - 1)
    t = torch.clamp(f - i0.to(f.dtype), 0.0, 1.0)
    return i0, torch.clamp(i0 + 1, max=size - 1), t[:, None]


def _plane(plane, x, y):
    h, w, c = plane.shape
    x0, x1, tx = _cell(x, w)
    y0, y1, ty = _cell(y, h)
    flat = plane.reshape(h * w, c)
    top = flat[y0 * w + x0] * (1.0 - tx) + flat[y0 * w + x1] * tx
    bot = flat[y1 * w + x0] * (1.0 - tx) + flat[y1 * w + x1] * tx
    return top * (1.0 - ty) + bot * ty


def _line(line, u):
    l0, l1, t = _cell(u, line.shape[0])
    return line[l0] * (1.0 - t) + line[l1] * t


def features(cfg, p, xn, *, sigma=True, app=True, precision="fp32"):
    """(density feature (N,) | None, app features (N, app_dim) | None) at
    normalised coordinates ``xn`` (N, 3)."""
    nd, na = components(cfg)
    cp = cfg["model_name"] == "cp"
    sig, raws = None, []
    for i in range(1 if cp else 3):
        lo, dn = (0, nd[i]) if sigma else (nd[i], 0)
        hi = nd[i] + (na[i] if app else 0)
        if cp:
            prod = _line(p["lines.0"][:, lo:hi], xn[:, VEC_MODE[0]])
            for j in (1, 2):
                prod = prod * _line(p[f"lines.{j}"][:, lo:hi], xn[:, VEC_MODE[j]])
        else:
            m0, m1 = MAT_MODE[i]
            prod = (_plane(p[f"planes.{i}"][..., lo:hi], xn[:, m0], xn[:, m1])
                    * _line(p[f"lines.{i}"][:, lo:hi], xn[:, VEC_MODE[i]]))
        if sigma:
            part = prod[:, :dn].sum(-1)
            sig = part if sig is None else sig + part
        if app:
            raws.append(prod[:, dn:])
    feat = matmul(torch.cat(raws, -1), p["basis"], precision) if app else None
    return sig, feat


def density(cfg, feat):
    return F.softplus(feat + cfg["density_shift"])


def encode(x, freqs: int):
    bands = 2.0 ** torch.arange(freqs, dtype=x.dtype, device=x.device)
    pts = (x[..., None] * bands).reshape(*x.shape[:-1], freqs * x.shape[-1])
    return torch.cat([torch.sin(pts), torch.cos(pts)], -1)


def head(cfg, p, feat, viewdirs=None, precision="fp32"):
    """The shading head: rgb (N, 3) in [0, 1]."""
    if cfg["shadingMode"] == "MLP_Fea_noview":
        x = torch.cat([feat, encode(feat, cfg["fea_pe"])], -1)
    else:
        parts = [feat, viewdirs]
        if cfg["fea_pe"] > 0:
            parts.append(encode(feat, cfg["fea_pe"]))
        if cfg["view_pe"] > 0:
            parts.append(encode(viewdirs, cfg["view_pe"]))
        x = torch.cat(parts, -1)
    h = torch.relu(matmul(x, p["mlp.w1"], precision) + p["mlp.b1"])
    h = torch.relu(matmul(h, p["mlp.w2"], precision) + p["mlp.b2"])
    return torch.sigmoid(matmul(h, p["mlp.w3"], precision) + p["mlp.b3"])


# ---------------------------------------------------------------------------
# Rays, marching, compositing
# ---------------------------------------------------------------------------


def normalize(aabb, pts):
    return (pts - aabb[0]) * (2.0 / (aabb[1] - aabb[0])) - 1.0


def box_entry(rays, aabb, near, far):
    """Each ray's entry into the box, clamped to [near, far]."""
    o, d = rays[:, :3], rays[:, 3:6]
    d = torch.where(d == 0, torch.full_like(d, 1e-6), d)
    t = torch.amax(torch.minimum((aabb[1] - o) / d, (aabb[0] - o) / d), -1)
    return torch.clamp(t, near, far)


def inside(pts, aabb):
    return torch.all((pts >= aabb[0]) & (pts <= aabb[1]), -1)


def mask_lookup(mask, pts):
    """Nearest voxel of the 0/1 mask volume [z, y, x] at world points."""
    vol = mask["volume"]
    d, h, w = vol.shape
    xn = torch.clamp(normalize(mask["aabb"], pts), -1.0, 1.0)
    ix = torch.round((xn[..., 0] + 1) * 0.5 * (w - 1)).long()
    iy = torch.round((xn[..., 1] + 1) * 0.5 * (h - 1)).long()
    iz = torch.round((xn[..., 2] + 1) * 0.5 * (d - 1)).long()
    return vol.reshape(-1)[(iz * h + iy) * w + ix] > 0


def alpha_weights(sigma, dists):
    """Compositing weights and accumulated opacity."""
    alpha = 1.0 - torch.exp(-sigma * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], -1), -1)
    weights = alpha * trans[:, :-1]
    return weights, weights.sum(-1)


def clip01(x):
    """min(max(x, 0), 1): at a tie the gradient is split in halves."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


# ---------------------------------------------------------------------------
# The alpha mask
# ---------------------------------------------------------------------------


@torch.no_grad()
def alpha_mask(cfg, p, aabb, reso, mask_res, pool: int, chunk: int = 1 << 20):
    """The 0/1 occupancy volume [z, y, x] over a ``mask_res`` lattice of the
    box: opacity over one march step at each lattice point, max-pooled over
    ``pool``³ voxels, against the configuration's threshold.  Returns the
    mask dict a renderer takes ({'volume', 'aabb', 'pool'})."""
    dev = aabb.device
    us = []
    for g in mask_res:
        u = torch.arange(g, dtype=torch.float32, device=dev) * (1.0 / (g - 1))
        u[-1] = 1.0
        us.append(u)
    grid = torch.stack(torch.meshgrid(*us, indexing="ij"), -1).reshape(-1, 3)
    step = step_size(aabb, reso, cfg["step_ratio"])
    alpha = torch.empty(grid.shape[0], device=dev)
    for s in range(0, grid.shape[0], chunk):
        pts = aabb[0] * (1 - grid[s:s + chunk]) + aabb[1] * grid[s:s + chunk]
        xn = torch.clamp(normalize(aabb, pts), -1.0, 1.0)
        sig = density(cfg, features(cfg, p, xn, app=False)[0])
        alpha[s:s + chunk] = 1.0 - torch.exp(-sig * step)
    vol = torch.clamp(alpha.reshape(*mask_res), 0, 1).permute(2, 1, 0).contiguous()
    vol = F.max_pool3d(vol[None, None], pool, stride=1, padding=pool // 2)[0, 0]
    vol = (vol >= cfg["alpha_mask_thres"]).float()
    return {"volume": vol, "aabb": aabb, "pool": int(pool)}


@torch.no_grad()
def stamp_mask(mask, rays, depth, band_voxels: int = 2, z_samples: int = 5):
    """The training mask: ``mask`` with a band of ±``band_voxels`` around
    each supervised ray's depth point marked live (a power-of-two evenly
    spaced selection of the rays), dilated by the mask's pool radius."""
    n = rays.shape[0]
    k = min(1 << max(n - 1, 1).bit_length(), 1 << 20)
    sel = np.linspace(0, n - 1, k).astype(np.int64)
    vol, aabb = mask["volume"], mask["aabb"]
    dev = vol.device
    r = torch.as_tensor(np.ascontiguousarray(rays[sel]), device=dev)
    dep = torch.as_tensor(np.ascontiguousarray(depth[sel]), device=dev)
    dz, hz, wz = vol.shape
    vox = torch.max((aabb[1] - aabb[0]) / torch.tensor([wz, hz, dz], dtype=torch.float32,
                                                        device=dev))
    s = torch.arange(z_samples, dtype=torch.float32, device=dev) * (1.0 / (z_samples - 1))
    s[-1] = 1.0
    offs = -band_voxels * vox * (1 - s) + band_voxels * vox * s
    pts = r[:, None, :3] + r[:, None, 3:6] * (dep[:, None] + offs[None, :])[..., None]
    xn = torch.clamp(normalize(aabb, pts.reshape(-1, 3)), -1.0, 1.0)
    ix = torch.round((xn[:, 0] + 1) * 0.5 * (wz - 1)).long()
    iy = torch.round((xn[:, 1] + 1) * 0.5 * (hz - 1)).long()
    iz = torch.round((xn[:, 2] + 1) * 0.5 * (dz - 1)).long()
    stamped = torch.zeros(dz * hz * wz, device=dev)
    stamped[(iz * hz + iy) * wz + ix] = 1.0
    kk = 2 * (band_voxels + (mask["pool"] - 1) // 2) + 1
    stamped = F.max_pool3d(stamped.reshape(1, 1, dz, hz, wz), kk, stride=1, padding=kk // 2)
    return dict(mask, volume=torch.maximum(vol, stamped[0, 0]))
