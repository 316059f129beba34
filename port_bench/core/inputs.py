"""Inputs made from the seed: the field's weights (on the device, in a few
large calls), the camera path, rays, and the training pools with their
targets.  The program and the reference get the same tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..reference import field as F

#: the room shell's far-wall slab in world z, and its density line values
SHELL_Z = (2.5, 4.0)
SHELL_IN, SHELL_OUT = 2.0, -2.0


def derived_seed(seed: int, salt: int) -> int:
    """A 63-bit seed for one stream of a run, from the run's seed."""
    return int(np.random.SeedSequence([int(seed) % (1 << 64), salt]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def make_weights(cfg, reso, seed: int, device) -> dict:
    """The field's tensors (:func:`..reference.field.leaf_shapes`): factors
    N(0, 0.1²) (CP: 0.2²), the basis and the head's layers U(±1/sqrt(fan
    in)), the last bias 0; then the room shell (:func:`room_shell`)."""
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, 1))
    shapes = F.leaf_shapes(cfg, reso)
    tables = [(k, s) for k, s in shapes if k.startswith(("planes.", "lines."))]
    rest = [(k, s) for k, s in shapes if not k.startswith(("planes.", "lines."))]
    out = {}
    flat = torch.randn(sum(math.prod(s) for _, s in tables), generator=gen, device=device)
    flat.mul_(0.2 if cfg["model_name"] == "cp" else 0.1)
    at = 0
    for k, s in tables:
        out[k] = flat[at:at + math.prod(s)].view(s)
        at += math.prod(s)
    flat = torch.rand(sum(math.prod(s) for _, s in rest), generator=gen, device=device)
    flat.mul_(2.0).sub_(1.0)
    at = 0
    d_in, fc = dict(shapes)["mlp.w1"]
    fan_in = {"basis": dict(shapes)["basis"][0], "mlp.w1": d_in, "mlp.b1": d_in,
              "mlp.w2": fc, "mlp.b2": fc, "mlp.w3": fc, "mlp.b3": 1}
    for k, s in rest:
        out[k] = flat[at:at + math.prod(s)].view(s).mul_(1.0 / math.sqrt(fan_in[k]))
        at += math.prod(s)
    out["mlp.b3"].zero_()
    room_shell(cfg, out, reso)
    return out


def room_shell(cfg, w: dict, reso):
    """Density of a far-wall slab: line 0 (world z) holds +2 in the slab
    and -2 elsewhere on its density channels; the other density lines and
    all density planes hold |init| + 1.  In place."""
    nd, _ = F.components(cfg)
    zs = torch.linspace(-8, 8, reso[2], device=w["lines.0"].device)
    inside = (zs > SHELL_Z[0]) & (zs < SHELL_Z[1])
    w["lines.0"][:, : nd[0]] = torch.where(inside, SHELL_IN, SHELL_OUT)[:, None]
    for i in (1, 2):
        w[f"lines.{i}"][:, : nd[i]].abs_().add_(1.0)
    if cfg["model_name"] != "cp":
        for i in range(3):
            w[f"planes.{i}"][..., : nd[i]].abs_().add_(1.0)


def rot_y(theta):
    c, s = math.cos(theta), math.sin(theta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def circle_poses(n: int, radius: float) -> np.ndarray:
    """(n, 4, 4) camera-to-world poses of an orbit about y: pose i turned by
    -2πi/n, placed ``radius`` along its own viewing axis."""
    poses = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        rot = rot_y(-2 * math.pi * i / n)
        poses[i, :3, :3] = rot
        poses[i, :3, 3] = radius * rot[:3, 2] / np.linalg.norm(rot[:3, 2])
    return poses


def camera_dirs(h: int, w: int, device):
    """Unit camera-space directions (h·w, 3) of a pinhole camera with focal
    max(h, w) and centre (w // 2, h // 2), looking down +z."""
    f = float(max(h, w))
    j, i = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device) + 0.5,
                          torch.arange(w, dtype=torch.float32, device=device) + 0.5,
                          indexing="ij")
    d = torch.stack([(i - w // 2) / f, (j - h // 2) / f, torch.ones_like(i)], -1).reshape(-1, 3)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def rays_of(dirs, poses) -> torch.Tensor:
    """(V, N, 6) world rays [origin | direction] of the poses."""
    c2w = torch.as_tensor(np.asarray(poses), dtype=torch.float64, device=dirs.device)
    d = torch.einsum("nk,vjk->vnj", dirs.double(), c2w[:, :3, :3]).float()
    o = c2w[:, None, :3, 3].float().expand_as(d)
    return torch.cat([o, d], -1)


def near_face_depth(rays):
    """Distance along each (unit) ray to the shell's near face z = 2.5; 0
    (no depth supervision) for a ray that never reaches it."""
    dz = rays[..., 5]
    t = (SHELL_Z[0] - rays[..., 2]) / torch.where(dz > 1e-6, dz, torch.ones_like(dz))
    return torch.where((dz > 1e-6) & (t > 0), t, torch.zeros_like(t))


def smooth_rgb(h, w, views, seed, device):
    """(views, h·w, 3) smooth images: per view and channel, 0.5 + 0.35 ·
    sin(2π(a·u + b·v) + φ) over the image's unit square, the frequencies a,
    b in [0.5, 2] and the phases from the seed."""
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, 2))
    ab = torch.rand((views, 1, 3, 2), generator=gen, device=device) * 1.5 + 0.5
    phase = torch.rand((views, 1, 3), generator=gen, device=device) * 2 * math.pi
    v, u = torch.meshgrid(torch.linspace(0, 1, h, device=device),
                          torch.linspace(0, 1, w, device=device), indexing="ij")
    uv = torch.stack([u.reshape(-1), v.reshape(-1)], -1)[None, :, None, :]
    return 0.5 + 0.35 * torch.sin(2 * math.pi * (uv * ab).sum(-1) + phase)


def train_pools(traffic, seed, device):
    """(rays (N, 6), rgb (N, 3), depth (N,)) host numpy float32 arrays, the
    trainer's pools: the traffic's first views of its orbit, view-major."""
    h, w = traffic["hw"]
    poses = circle_poses(traffic["orbit_poses"], traffic["orbit_radius"])[: traffic["views"]]
    rays = rays_of(camera_dirs(h, w, device), poses)
    rgb = smooth_rgb(h, w, len(poses), seed, device)
    depth = near_face_depth(rays)
    return (np.ascontiguousarray(rays.reshape(-1, 6).cpu().numpy()),
            np.ascontiguousarray(rgb.reshape(-1, 3).cpu().numpy()),
            np.ascontiguousarray(depth.reshape(-1).cpu().numpy()))
