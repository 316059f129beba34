"""The port's helpers that only tools and tests call, against the JAX
package on the CPU at tiny sizes, inputs from a numpy seed:

- rays: ``ray_directions_blender``, ``ray_marcher`` (JAX's perturbation
  uniforms injected) and ``sample_pdf`` (deterministic, and JAX's
  uniforms injected), fp32 within 1e-5;
- ``sample_alpha_mask`` within 1e-6;
- ``first_k_live`` / ``last_k_live`` under the ``topk`` and ``rank``
  names (the port's one sort), index for index against JAX's lowering of
  that name;
- ``count_live_samples`` (exact) and ``render_rays_compact_flagged`` in
  every ``select_impl`` (fp32 features, rgb / depth / acc within 1e-5,
  the flag count exact);
- every ported trajectory, poses within 1e-6 (``rng`` from a seed);
- ``hole_fill1`` and ``zbuffer_splat``, bit-equal to JAX's native library;
- an AVI written by the port and read back by both packages' readers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_render import AABB, AABB_T, _field, _masks, _rays
from text2nerf_tpu import native as JN
from text2nerf_tpu.data import trajectories as JT
from text2nerf_tpu.models import tensorf as tf
from text2nerf_tpu.ops import rays as JR
from text2nerf_tpu.ops import render as Rd
from text2nerf_tpu.utils import mjpeg_avi as JAVI
from text2nerf_tpu_torch import native as PN
from text2nerf_tpu_torch.data import trajectories as PT
from text2nerf_tpu_torch.models import tensorf as ptf
from text2nerf_tpu_torch.ops import rays as PR
from text2nerf_tpu_torch.ops import render as PRd
from text2nerf_tpu_torch.utils import mjpeg_avi as PAVI

torch.set_num_threads(1)


def _np(x):
    return np.asarray(x)


def _ray_batch(n=24, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    near = rng.uniform(0.2, 1.0, (n, 1)).astype(np.float32)
    far = near + rng.uniform(2.0, 6.0, (n, 1)).astype(np.float32)
    return np.concatenate([o, d, near, far], -1)


@pytest.mark.parametrize("case", ["blender", "marcher", "marcher_lindisp", "marcher_bbox",
                                  "marcher_perturb", "pdf", "pdf_uniforms"])
def test_ray_helpers_match_jax(case):
    if case == "blender":
        want = JR.ray_directions_blender(6, 8, (7.0, 9.0), (3.5, 2.5))
        got = PR.ray_directions_blender(6, 8, (7.0, 9.0), (3.5, 2.5), device="cpu")
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-6)
        want = JR.ray_directions_blender(6, 8, (7.0, 9.0))
        got = PR.ray_directions_blender(6, 8, (7.0, 9.0), device="cpu")
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-6)
        return
    rays = _ray_batch()
    if case.startswith("marcher"):
        kw, pkw, marcher = {}, {}, JR.ray_marcher
        if case == "marcher_lindisp":
            kw = pkw = dict(lindisp=True)
        if case == "marcher_bbox":
            # origins outside the box, every ray toward it
            kw = pkw = dict(bbox=np.array([[-0.5] * 3, [0.5] * 3], np.float32))
            o = 3.0 * rays[:, 3:6] + 0.1 * rays[:, :3]
            rays = np.concatenate([o, -rays[:, 3:6], rays[:, 6:]], -1)
        if case == "marcher_perturb":
            # JAX's jit traces perturb, which its `if perturb > 0` cannot
            # branch on: its function body runs eagerly here
            key = jax.random.PRNGKey(5)
            kw = dict(perturb=1.0, rng=key)
            pkw = dict(perturb=1.0, u=torch.tensor(_np(jax.random.uniform(key, (24, 16)))))
            marcher = JR.ray_marcher.__wrapped__
        want = marcher(jnp.asarray(rays), 16, **kw)
        got = PR.ray_marcher(torch.from_numpy(rays), 16, **pkw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), _np(w), rtol=0, atol=1e-5)
        return
    rng = np.random.default_rng(1)
    bins = np.sort(rng.uniform(0, 5, (24, 17)), -1).astype(np.float32)
    weights = rng.uniform(0, 1, (24, 16)).astype(np.float32)
    weights[::3, 4:] = 0.0  # rows with empty tails: the 1e-5 floor and the denom guard
    if case == "pdf":
        want = JR.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 12)
        got = PR.sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), 12)
    else:
        key = jax.random.PRNGKey(3)
        want = JR.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 12, key)
        u = _np(jax.random.uniform(key, (24, 12)))
        got = PR.sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), 12,
                            u=torch.tensor(u))
        # the generator route draws the same shape
        drawn = PR.sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), 12,
                              generator=torch.Generator().manual_seed(0))
        assert drawn.shape == (24, 12) and bool(torch.isfinite(drawn).all())
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)


def test_sample_alpha_mask_matches_jax():
    rng = np.random.default_rng(2)
    vol = (rng.uniform(size=(5, 6, 7)) > 0.5).astype(np.float32)
    aabb = np.array([[-2.0, -1.5, -3.0], [2.5, 1.0, 3.0]], np.float32)
    xyz = rng.uniform(-3.5, 3.5, (200, 3)).astype(np.float32)  # some outside: clamped
    want = tf.sample_alpha_mask({"volume": jnp.asarray(vol), "aabb": jnp.asarray(aabb)},
                                jnp.asarray(xyz))
    got = ptf.sample_alpha_mask({"volume": torch.from_numpy(vol),
                                 "aabb": torch.from_numpy(aabb)}, torch.from_numpy(xyz))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("impl", ["topk", "rank"])
@pytest.mark.parametrize("last", [False, True])
def test_select_lowerings_are_index_exact(impl, last):
    rng = np.random.default_rng(4)
    live = rng.uniform(size=(9, 37)) < 0.3
    live[0] = False  # a row with no live sample
    live[1] = True   # a row with more than k
    for k in (1, 6, 16):
        jfn, pfn = (Rd.last_k_live, PRd.last_k_live) if last else \
            (Rd.first_k_live, PRd.first_k_live)
        want_idx, want_sel = jfn(jnp.asarray(live), k, impl=impl)
        idx, sel = pfn(torch.from_numpy(live), k, impl=impl)
        np.testing.assert_array_equal(idx.numpy(), _np(want_idx))
        np.testing.assert_array_equal(sel.numpy(), _np(want_sel))
        # and the name gives the sort route's indices
        sidx, ssel = pfn(torch.from_numpy(live), k, impl="sort")
        assert torch.equal(idx, sidx) and torch.equal(sel, ssel)
    with pytest.raises(ValueError):
        PRd._resolve_select_impl("nativ")


@pytest.fixture(scope="module")
def fog():
    cfg, params, field, n_s = _field(0.01)
    mask, pmask = _masks(cfg, params, field, 3)
    rays = _rays()
    return cfg, params, field, n_s, mask, pmask, rays


@pytest.mark.parametrize("case", ["count", "sort", "topk", "rank"])
def test_count_live_and_flagged_render_match_jax(fog, case):
    cfg, params, field, n_s, mask, pmask, rays = fog
    rays_t = torch.from_numpy(np.array(rays))
    if case == "count":
        want = Rd.count_live_samples(cfg, params, AABB, rays, mask, n_samples=n_s,
                                     occ_stride=1)
        got = PRd.count_live_samples(field, AABB_T, rays_t, pmask, n_samples=n_s,
                                     occ_stride=1)
        np.testing.assert_array_equal(got.numpy(), _np(want))
        assert 0 < int(got.max()) < n_s
        return
    kw = dict(n_samples=n_s, compact_k=8, app_k=8, feature_dtype="fp32", select_impl=case)
    want, want_n = Rd.render_rays_compact_flagged(cfg, params, AABB, rays, mask, **kw)
    got, n = PRd.render_rays_compact_flagged(field, AABB_T, rays_t, pmask, **kw)
    for name in ("rgb", "depth", "acc"):
        np.testing.assert_allclose(getattr(got, name).numpy(), _np(getattr(want, name)),
                                   rtol=0, atol=1e-5, err_msg=name)
    assert int(n) == int(want_n) > 0


TRAJECTORIES = {
    "local_fixed_poses_v1": lambda m, b, rng: m.local_fixed_poses_v1(b, angle=0.25),
    "circle_poses": lambda m, b, rng: m.circle_poses(b, n_views=12, n_r=1),
    "circle_poses_rand": lambda m, b, rng: m.circle_poses(b, n_views=12, use_rand=True, rng=rng),
    "rocking_poses": lambda m, b, rng: m.rocking_poses(b, n_views=10, n_r=2),
    "pretraining_poses": lambda m, b, rng: m.pretraining_poses(b),
    "pretraining_poses_rand": lambda m, b, rng: m.pretraining_poses(b, use_rand=True, rng=rng),
    "circle_poses_from_basis_view": lambda m, b, rng: m.circle_poses_from_basis_view(b, 12, 1),
    "surround_poses": lambda m, b, rng: m.surround_poses(b, num_poses=6, range_center=0.3),
    "surround_poses_none": lambda m, b, rng: m.surround_poses(b, num_poses=0),
}


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_trajectories_match_jax(name):
    basis = np.eye(4)
    basis[:3, :3] = JT.euler_to_rotation(np.array([0.1, -0.2, 0.05]))
    basis[:3, 3] = [0.3, -0.1, 0.2]
    want = TRAJECTORIES[name](JT, basis, np.random.default_rng(7))
    got = TRAJECTORIES[name](PT, basis, np.random.default_rng(7))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("op", ["hole_fill1", "zbuffer_splat"])
def test_native_host_ops_bit_equal_to_jax(op):
    rng = np.random.default_rng(8)
    img = rng.uniform(0, 1, (21, 26, 3)).astype(np.float32)
    if op == "hole_fill1":
        mask = (rng.uniform(size=(21, 26)) > 0.45).astype(np.float32)
        mask[:, :3] = 0  # border columns to extend from
        for fill in (255.0, 0.5):
            got, want = PN.hole_fill1(img, mask, fill), JN.hole_fill1(img, mask, fill)
            for g, w in zip(got, want, strict=True):
                np.testing.assert_array_equal(g, w)
        return
    xs = rng.integers(-3, 29, (21, 26))
    ys = rng.integers(-3, 24, (21, 26))
    zs = rng.uniform(-0.5, 3.0, (21, 26)).astype(np.float32)
    got, want = PN.zbuffer_splat(xs, ys, zs, img), JN.zbuffer_splat(xs, ys, zs, img)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["rgb", "mjpeg"])
def test_avi_written_then_read_back(tmp_path, kind):
    rng = np.random.default_rng(9)
    frames = [rng.integers(0, 256, (7, 10, 3), dtype=np.uint8) for _ in range(3)]
    path = str(tmp_path / f"{kind}.avi")
    if kind == "rgb":
        PAVI.write_rgb_avi(path, frames, fps=12)
        back = PAVI.read_mjpeg_avi(path)
        assert len(back) == 3
        for f, b in zip(frames, back):
            np.testing.assert_array_equal(b, f)  # uncompressed: exact
        return
    pytest.importorskip("PIL")
    PAVI.write_mjpeg_avi(path, frames, fps=12)
    back, want = PAVI.read_mjpeg_avi(path), JAVI.read_mjpeg_avi(path)
    assert len(back) == len(want) == 3
    for b, w in zip(back, want):
        np.testing.assert_array_equal(b, w)
