"""A deterministic synthetic field for driving the renderer and the
trainer without a trained checkpoint (the port's copy of the room shell of
``bench.py``), the serving configuration it is rendered in, and the
training configuration it is fitted in.

``chip_smoke.py``, ``profile_render.py`` and ``profile_train.py`` take the
fields, the masks and the settings from here, so each profile describes
the configuration whose numbers the smoke run reports.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine import trainer as TR
from ..models import tensorf as tf
from ..ops import rays as R
from ..ops import render as Rd
from . import trajectories as traj

#: the full-width field: TensoRFConfig() defaults on a 300^3 grid
N_VOXELS = 27_000_000
AABB = ((-8.0, -8.0, -8.0), (8.0, 8.0, 8.0))
#: the alpha mask the serving path renders with
MASK_RES = (200, 200, 200)
MASK_POOL = 5
VIEW_HW = (512, 512)
#: evaluation_path settings of the render-only flow
#: (text2nerf_tpu/tools/bench_render_only.py:68-73): the adaptive renderer
RENDER_KW = dict(compact_k=-1, chunk=65536, app_k=128, k_ladder=(16, 32, 64, 128),
                 white_bg=True)


def room_shell_field(cfg: tf.TensoRFConfig, reso, *, generator: torch.Generator,
                     device=None) -> tf.TensoRF:
    """Random init, then density factors of a far-wall slab: line 0 (which
    spans world z) is +2 for z in (2.5, 4) and -2 elsewhere, and the other
    density lines and all density planes are |init| + 1.  App factors,
    basis and head keep their random init."""
    field = tf.init_params(cfg, reso, generator=generator, device=device)
    nd = cfg.density_n_comp
    zs = np.linspace(-8, 8, reso[2])
    line_z = np.full((reso[2], nd[0]), -2.0, np.float32)
    line_z[(zs > 2.5) & (zs < 4.0)] = 2.0
    with torch.no_grad():
        field.lines[0][:, : nd[0]] = torch.from_numpy(line_z).to(field.lines[0].device)
        for i in (1, 2):
            field.lines[i][:, : nd[i]] = field.lines[i][:, : nd[i]].abs() + 1.0
        for i in range(3):
            field.planes[i][..., : nd[i]] = field.planes[i][..., : nd[i]].abs() + 1.0
    return field


def serving_shell(seed: int, device) -> tf.TensoRF:
    """The full-width room shell, from a seeded generator on ``device``."""
    reso = tf.n_to_reso(N_VOXELS, AABB)
    gen = torch.Generator(device=device).manual_seed(seed)
    field = room_shell_field(tf.TensoRFConfig(), reso, generator=gen, device=device)
    return field.requires_grad_(False)


def serving_mask(field: tf.TensoRF, aabb, device):
    """(alpha mask, new aabb) at the serving resolution and pool."""
    return tf.update_alpha_mask(field, aabb, MASK_RES, pool=MASK_POOL, device=device)


def serving_poses() -> np.ndarray:
    return traj.test_trajectory("circle0", np.eye(4), angle=0.2, trans_range=0.2)


def serving_render_kwargs(field: tf.TensoRF, mask, device) -> dict:
    """evaluation_path keyword arguments of the serving configuration."""
    n_samples = tf.default_n_samples(tf.grid_resolution(field), field.cfg.step_ratio)
    return dict(RENDER_KW, n_samples=n_samples, alpha_mask=mask, device=device)


#: training targets: views along serving_poses(), 4 x 512^2 rays
TRAIN_VIEWS = 4


def training_rays(device) -> torch.Tensor:
    """(N, 6) rays of the first TRAIN_VIEWS serving poses, view-major."""
    intr = R.default_intrinsics(*VIEW_HW)
    dirs = R.ray_directions(*VIEW_HW, intr[:2], intr[2:], device=device)
    poses = serving_poses()[:TRAIN_VIEWS]
    return torch.cat([torch.cat(R.rays_from_pose(dirs, p), -1) for p in poses])


def training_targets(device):
    """(rays (N, 6), rgb (N, 3), depth (N,)): the training views rendered
    by the serving path (render_chunked with the serving settings) from
    serving_shell(1)."""
    target = serving_shell(1, device)
    aabb = torch.tensor(AABB, device=device)
    mask, _ = serving_mask(target, aabb, device)
    rays = training_rays(device)
    out = Rd.render_chunked(target, aabb, rays, **serving_render_kwargs(target, mask, device))
    return rays, out.rgb, out.depth


def training_setup(device):
    """The field to train and how the trainer steps it: (field, aabb,
    mask, TrainConfig(), make_train_step keyword arguments).  The field is
    serving_shell(2): the same slab, another seed, so its app factors
    differ from the targets' and the rgb loss starts high; the mask is its
    serving 200^3 pool-5 mask; the step settings are the trainer's
    defaults at full width (300^3, 16/48 components, 259 samples, batch
    16384, compacted K 64 in groups of 2, depth-anchored band 6)."""
    field = serving_shell(2, device)
    aabb = torch.tensor(AABB, device=device)
    mask, _ = serving_mask(field, aabb, device)
    cfg = TR.TrainConfig()
    reso = tf.grid_resolution(field)
    n_samples = tf.default_n_samples(reso, field.cfg.step_ratio)
    group, block = TR._resolve_group(cfg, np.asarray(AABB, np.float32), reso,
                                     field.cfg.step_ratio)
    kw = TR._step_kwargs(cfg, n_samples=n_samples, group=group, block=block, white_bg=True)
    return field.requires_grad_(True), aabb, mask, cfg, kw
