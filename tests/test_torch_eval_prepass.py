"""The eval prepass's CPU side: the compacted eval renderer's select
(``ops/render.py``) and the kernel's wrapper
(``ops/kernels/eval_prepass.py``), on the CPU.

- On CPU tensors the renderer takes the plain select: under a profiler it
  counts ``select.plain_rays`` and never ``select.kernel_rays``, and
  launches no kernel.
- The kernel route's march step is ``tf.step_size``'s, memoized per box
  tensor, and rebuilt when the box is edited in place or the resolution
  changes.
- A CPU emulation of the kernel's walk (32 lanes a step, ballot prefix
  counts against a running count, the strided occupancy read at sample
  i - i % stride, the pad slots, the rung's binary search) gives the
  plain select's outputs element for element: K 16 to n_samples,
  n_samples 259 and under 32, occupancy stride 1 and 2, with and without
  a ladder, on rays that miss, leave or start in the box, run along the
  axes or cross only dead voxels.
- The wrapper refuses CPU tensors.

tests/test_torch_cuda.py holds the kernel against the plain select on the
card.  The module imports no JAX: the card tests take their scene from it.
"""

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from text2nerf_tpu_torch.engine import tracing
from text2nerf_tpu_torch.models import tensorf as tf
from text2nerf_tpu_torch.ops import render as Rd
from text2nerf_tpu_torch.ops.kernels import eval_prepass as ep
from text2nerf_tpu_torch.ops.rays import aabb_slab_entry

LADDER = (32, 64, 128)
EVAL_Z_MIN = -0.6
K_CASES = [16, 32, 64, 96, 128, "n"]


def prepass_scene(device, pool: int = 3, seed: int = 0):
    """(field, aabb, mask, rays): a field on a 64 x 60 x 56 grid, a
    pool-dilated random mask over a smaller box with a dead slab at low x,
    and rays from around and inside the box, along the axes and diagonals
    with zero direction components, rays that miss it, and rays that cross
    only the dead slab.  Data from a CPU generator, so both devices get
    the same scene."""
    cfg = tf.TensoRFConfig(density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8))
    gen = torch.Generator(device=device).manual_seed(seed)
    field = tf.init_params(cfg, (64, 60, 56), generator=gen, device=device).requires_grad_(False)
    aabb = torch.tensor([[-1.5, -1.2, -1.0], [1.5, 1.3, 1.1]])
    g = torch.Generator().manual_seed(seed)
    vol = (torch.rand((30, 34, 38), generator=g) < 0.02).float()
    vol = F.max_pool3d(vol[None, None], pool, stride=1, padding=pool // 2)[0, 0]
    vol[:, :, :10] = 0
    mask = {"volume": vol, "aabb": torch.tensor([[-1.4, -1.1, -0.9], [1.4, 1.2, 1.0]]),
            "pool": pool}

    n = 2900
    o = (torch.rand((n, 3), generator=g) * 2 - 1) * 3.0
    o[:400] = (torch.rand((400, 3), generator=g) * 2 - 1) * torch.tensor([1.4, 1.1, 0.9])
    target = (torch.rand((n, 3), generator=g) * 2 - 1) * torch.tensor([1.6, 1.4, 1.2])
    d = target - o
    d = d / d.norm(dim=-1, keepdim=True)
    axes = torch.tensor([[1.0, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
                         [0.6, 0, 0.8], [0, -0.6, 0.8], [0.8, 0.6, 0]])
    starts = (torch.rand((len(axes), 3), generator=g) * 2 - 1) * 0.5 - 2.5 * axes
    # misses: outside the box, heading away
    miss_o = torch.tensor([[5.0, 5, 5], [-4, 0, 0], [0, 3, 0.2]])
    miss_d = torch.tensor([[1.0, 0, 0], [-0.6, 0.8, 0], [0, 0.6, 0.8]])
    # along y through the dead slab only: every sample dead
    dead_o = torch.tensor([[-1.3, -3.0, 0.0], [-1.35, -3.0, 0.5], [-1.25, 3.0, -0.2]])
    dead_d = torch.tensor([[0.0, 1, 0], [0, 1, 0], [0, -1, 0]])
    rays = torch.cat([torch.cat([o, d], -1), torch.cat([starts, axes], -1),
                      torch.cat([miss_o, miss_d], -1), torch.cat([dead_o, dead_d], -1)])
    to = {"volume": mask["volume"].to(device), "aabb": mask["aabb"].to(device), "pool": pool}
    return field, aabb.to(device), to, rays.to(device)


def select_kwargs(k, n_samples, occ_stride, ladder):
    return dict(n_samples=n_samples, k=n_samples if k == "n" else min(k, n_samples),
                eval_z_min=EVAL_Z_MIN, occ_stride=occ_stride, select_impl="sort",
                need_ladder=ladder)


def _lower_bound(ladder, value):
    start, end = 0, len(ladder)
    while start < end:
        mid = start + ((end - start) >> 1)
        if not ladder[mid] >= value:
            start = mid + 1
        else:
            end = mid
    return start


def _emulated_select(field, aabb, rays, mask, *, n_samples, k, eval_z_min, occ_stride,
                     select_impl, need_ladder):
    """The kernel's walk over all rays at once, a step of 32 lanes at a
    time, each expression in the plain version's fp32 ops."""
    del select_impl
    b = rays.shape[0]
    o, d = rays[:, :3], rays[:, 3:6]
    step = tf.step_size(aabb, tf.grid_resolution(field), field.cfg.step_ratio)
    t_min = aabb_slab_entry(o, d, aabb, field.cfg.near, field.cfg.far)

    def point(i):
        z = t_min[:, None] + step * i.to(torch.float32)[None, :]
        return z, o[:, None] + d[:, None] * z[..., None]

    def norm(p):
        return torch.clamp(tf.normalize_coord(aabb, p), -1.0, 1.0)

    z_pad, p_pad = point(torch.tensor([n_samples - 1]))
    idx = torch.full((b, k), n_samples - 1, dtype=torch.int32)
    sel = torch.zeros((b, k), dtype=torch.bool)
    z_k = z_pad.expand(b, k).clone()
    xn_k = norm(p_pad).expand(b, k, 3).clone()
    count = torch.zeros(b, dtype=torch.int64)
    for base in range(0, n_samples, 32):
        i = base + torch.arange(32)
        z, p = point(i)
        live = (i < n_samples)[None, :] & Rd._in_aabb(p, aabb) & (p[..., 2] > eval_z_min)
        _, pj = point(i - i % occ_stride)
        occ = Rd._nearest_alpha_lookup(mask, pj.reshape(-1, 3)).reshape(b, 32)
        live = live & (occ > 0)
        before = torch.cumsum(live.to(torch.int64), 1) - live.to(torch.int64)
        pos = count[:, None] + before
        rows, lanes = torch.nonzero(live & (pos < k), as_tuple=True)
        slots = pos[rows, lanes]
        idx[rows, slots] = i[lanes].to(torch.int32)
        sel[rows, slots] = True
        z_k[rows, slots] = z[rows, lanes]
        xn_k[rows, slots] = norm(p[rows, lanes])
        count += live.sum(1)
    rung = None
    if need_ladder is not None:
        rung = torch.tensor([min(_lower_bound(need_ladder, int(c)), len(need_ladder) - 1)
                             for c in count], dtype=torch.int8)
    return step, idx, sel, z_k, xn_k, count, rung


def assert_same_select(got, want):
    """Element for element, int and rung dtypes aside."""
    names = ("step", "idx", "sel", "z_k", "xn_k", "n_live", "rung")
    for name, g, w in zip(names, got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            assert g.shape == w.shape, name
            if w.dtype.is_floating_point:
                assert g.dtype == w.dtype and torch.equal(g, w), name
            else:
                assert torch.equal(g.to(torch.int64), w.to(torch.int64)), name


@pytest.mark.parametrize("ladder", [None, LADDER], ids=["no_ladder", "ladder"])
@pytest.mark.parametrize("pool", [3, 5])
@pytest.mark.parametrize("n_samples", [259, 20])
@pytest.mark.parametrize("k", K_CASES)
def test_emulated_kernel_walk_matches_the_plain_select(k, n_samples, pool, ladder):
    field, aabb, mask, rays = prepass_scene("cpu", pool)
    stride = Rd._occ_stride(field, aabb, mask)
    assert stride == (pool - 1) // 2
    kw = select_kwargs(k, n_samples, stride, ladder)
    want = Rd._select_plain(field, aabb, rays, mask, **kw)
    assert_same_select(_emulated_select(field, aabb, rays, mask, **kw), want)
    n_live, kk = want[5], kw["k"]
    assert bool((n_live == 0).any()) and bool(((n_live > 0) & (n_live < kk)).any())
    if n_samples == 259 and kk <= 32:
        assert bool((n_live > kk).any())


def test_plain_select_counts_plain_rays_and_launches_nothing():
    field, aabb, mask, rays = prepass_scene("cpu")
    before = ep.LAUNCHES
    tracing.reset_counts()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            out, need = Rd.render_rays_compact_need(
                field, aabb, rays, mask, n_samples=64, compact_k=32, app_k=32,
                k_ladder=LADDER, eval_z_min=EVAL_Z_MIN, feature_dtype="fp32")
        assert tracing.counts() == {"select.plain_rays": rays.shape[0],
                                    "head.samples": rays.shape[0] * 32}
    finally:
        tracing.reset_counts()
    assert ep.LAUNCHES == before
    assert out.rgb.shape == (rays.shape[0], 3) and need.dtype == torch.int8


def test_eval_step_is_memoized_per_box():
    field, aabb, _, _ = prepass_scene("cpu")
    reso, ratio = tf.grid_resolution(field), field.cfg.step_ratio
    step = Rd._eval_step(field, aabb)
    assert torch.equal(step, tf.step_size(aabb, reso, ratio))
    assert Rd._eval_step(field, aabb) is step
    assert Rd._eval_step(field, aabb.clone()) is not step  # another box tensor
    aabb[1, 0] += 0.5  # edited in place: rebuilt
    moved = Rd._eval_step(field, aabb)
    assert torch.equal(moved, tf.step_size(aabb, reso, ratio)) and not torch.equal(moved, step)
    other = tf.init_params(field.cfg, (32, 30, 28), generator=torch.Generator().manual_seed(1),
                           device="cpu")
    assert torch.equal(Rd._eval_step(other, aabb),
                       tf.step_size(aabb, (32, 30, 28), other.cfg.step_ratio))


def test_the_wrapper_refuses_cpu_tensors():
    field, aabb, mask, rays = prepass_scene("cpu")
    step = tf.step_size(aabb, tf.grid_resolution(field), 1.0)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        ep.eval_prepass(rays, aabb, step, mask, n_samples=64, k=32, near=0.5, far=8.0,
                        eval_z_min=EVAL_Z_MIN, occ_stride=1, ladder=LADDER)
