"""The port's scene expansion against the JAX package, on the CPU, at tiny
size.  Every input is made from a seed with numpy; each check states its
tolerance (the worst seen on these inputs in brackets):

- the two warps of expansion (``warp_one_to_many_with_mask``,
  ``warp_many_to_one``): masks bit-equal; warped rgb within one uint8
  level on every pixel and equal on at least 99% of them (100%); depths
  within 1e-5 relative (equal);
- the native ``hole_fill2``: bit-equal; the JAX package's native library,
  in a test process, no older than its source;
- ``diffusion_fill_inpaint``: within 1e-5 (equal); ``histogram_rank``:
  equal scores, so equal argmax;
- the merge net: the U-Net forward (fp32, 64/4, the flax init carried
  over) within 1e-5 (2.1e-7); ``run_finetune`` of 3 iterations within
  1e-5 of the output's largest magnitude in fp32 (3.7e-7) and within
  2^-7 absolute in bf16 (two bf16 ulps in [0.5, 1); 2^-9 seen); the
  nearest resize of both directions and of sizes that are not powers of
  two, equal; a ``merge_model_sc.npz`` written by the JAX package, loaded
  by ``default_services`` and run as JAX runs it;
- the asynchronous artifact writer: PNGs decoding equal to the JAX
  writer's (imageio) for every conversion of the DIBR tree; an error
  re-raised by the flush of its own root only;
- the hermetic expansion step of the JAX package's dry run (hw 32,
  ``circle0_30``, 2 views, merge net 64/4 in fp32, 2 candidates, 2 merge
  iterations) on a slab field: the mask bits, the candidates' scores and
  the chosen one equal, the new view's rgb and depth within 1e-5
  (1.1e-6, 9.5e-7 at depths up to 5.1), its support pool's rays equal;
  the ``DIBR/`` file lists equal, the mask PNGs equal after decoding and
  every other PNG within one level;
- the same step with every other option of ExpansionConfig flipped (one
  candidate, stored views warped, no hole fill, no support set): masks,
  pool rays and file list equal, rgb and depth within 1e-5;
- the same step with ``update_known_views``: the eroded masks equal;
  both views' rgb within 1e-5 and depth within 1e-5 of the largest (the
  known view composited, its depth re-estimated and merged; 1.9e-7);
  both views' pools' rays equal, their rgbs within 1e-5 and depths within
  1e-5 of the largest on 97% of the rays (98.6%, 98.1%); the DIBR/ file
  lists (the ``warp2known`` artifacts among them) equal;
- the same step through the adaptive renderer (a pool-3 mask, compact_k
  -1): mask bits and the chosen candidate equal, scores within 1e-3
  relative (5.2e-5), the new view's rgb within one uint8 level (6.8e-4)
  and depth within 1e-4 of its largest (1.9e-5);
- the progressive fit (``reconstruction`` with ``n_stage2 = 1`` on 2
  views, the JAX trainer's jitter injected as in test_torch_trainer.py),
  uniform and ``tail_deficit`` stage 3: the sampler ids, the step count
  and the compacted steps equal, the per-step mse within 1e-5 relative
  (4e-7), the eval PSNRs within 1e-4 dB, the new view's pool equal.  Its
  evals and expansion render dense (``eval_compact_k=0``): through the
  adaptive renderer the new view moves by less than a uint8 level (the
  check above), which moves the mse of its batches by up to 6.5e-4.
"""

import contextlib
import dataclasses
import functools
import os

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_scene import CFG, slab_params
from test_torch_trainer import _jax_key_stream, _Recorder, _rows
from text2nerf_tpu import native as jnative
from text2nerf_tpu.data import scene_state as ss
from text2nerf_tpu.data import trajectories as jtraj
from text2nerf_tpu.engine import expansion as JE
from text2nerf_tpu.engine import io_async as JIO
from text2nerf_tpu.engine import train_step as JTS
from text2nerf_tpu.engine import trainer as JT
from text2nerf_tpu.engine.checkpoints import _flatten
from text2nerf_tpu.engine.checkpoints import save_checkpoint as jsave
from text2nerf_tpu.models import tensorf as tf
from text2nerf_tpu.models.pix2pix import UnetGenerator as JUnet
from text2nerf_tpu.ops import splat as JS
from text2nerf_tpu.services import fallbacks as jfb
from text2nerf_tpu.services import merge as JM
from text2nerf_tpu.services.registry import Services as JServices
from text2nerf_tpu_torch import native as pnative
from text2nerf_tpu_torch.data import scene_state as pss
from text2nerf_tpu_torch.engine import checkpoints as PC
from text2nerf_tpu_torch.engine import expansion as PE
from text2nerf_tpu_torch.engine import io_async as PIO
from text2nerf_tpu_torch.engine import train_step as PTS
from text2nerf_tpu_torch.engine import trainer as PT
from text2nerf_tpu_torch.models import pix2pix as PP
from text2nerf_tpu_torch.models import tensorf as ptf
from text2nerf_tpu_torch.ops import splat as PS
from text2nerf_tpu_torch.services import fallbacks as pfb
from text2nerf_tpu_torch.services import merge as PM
from text2nerf_tpu_torch.services import registry as preg
from text2nerf_tpu_torch.utils.png import read_png

torch.set_num_threads(2)

HW = (32, 32)
PROMPT = "an expansion test scene"


def _rgbd(seed, hw=HW):
    rng = np.random.default_rng(seed)
    img = jfb.procedural_text2img(f"warp {seed}", hw=hw)
    depth = (2.0 + 3.0 * rng.random(hw) ** 2).astype(np.float32)
    depth[hw[0] // 3: hw[0] // 2, 4: hw[1] // 2] -= 1.2  # a near box: disocclusions
    return img, depth


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _assert_rgb_levels(got, want):
    """Warped rgb: within one uint8 level everywhere, equal on ≥ 99%."""
    diff = np.abs(np.round(np.asarray(got) * 255) - np.round(np.asarray(want) * 255))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.99


# ---------------------------------------------------------------------------
# the warps, the hole fill, the fallback services
# ---------------------------------------------------------------------------


def test_warp_one_to_many_with_mask_matches_jax():
    img, depth = _rgbd(1)
    poses = jtraj.local_fixed_poses(np.eye(4, dtype=np.float32), angle=0, range_center=0.2,
                                    range_yaw=0.6, range_pitch=0.2)
    extra = (np.random.default_rng(2).random(HW) > 0.6).astype(np.float32)
    extra[8:20, 6:26] = 1.0
    intr = (32.0, 32.0, 16.0, 16.0)
    want = JS.warp_one_to_many_with_mask(img, depth, poses[0], poses[1:], intr, extra)
    got = PS.warp_one_to_many_with_mask(_t(img), _t(depth), _t(poses[0]), _t(poses[1:]), intr,
                                        _t(extra))
    _assert_rgb_levels(got[0].numpy(), want[0])
    for g, w in ((got[1], want[1]), (got[3], want[3])):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5, atol=0)
    # holes where nothing lands, and the extra mask covers less than all
    assert 0 < int(got[1].sum()) < got[1].numel()
    assert 0 < int(got[3].sum()) < int(got[1].sum())


@pytest.mark.parametrize("n_views", [1, 3])
def test_warp_many_to_one_matches_jax(n_views):
    views = [_rgbd(10 + v) for v in range(n_views)]
    poses = jtraj.training_trajectory("circle0_30", n_views + 1, 0.2, 0.2).astype(np.float32)
    intr = (32.0, 32.0, 16.0, 16.0)
    rgbs = np.stack([v[0] for v in views])
    depths = np.stack([v[1] for v in views])
    want = JS.warp_many_to_one(list(rgbs), list(depths), poses[:n_views], poses[n_views], intr)
    got = PS.warp_many_to_one(_t(rgbs), _t(depths), _t(poses[:n_views]), _t(poses[n_views]),
                              intr)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert 0 < int(got[0].sum()) < got[0].numel()
    _assert_rgb_levels(got[1].numpy(), want[1])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5, atol=0)


@pytest.mark.parametrize("with_depth", [True, False])
def test_hole_fill2_bit_equal_to_jax(with_depth):
    rng = np.random.default_rng(4)
    img = rng.random((40, 36, 3)).astype(np.float32)
    mask = (rng.random((40, 36)) > 0.35).astype(np.float32)
    mask[10:16, 10:30] = 0.0  # a hole wider than one pass fills
    depth = (2 + rng.random((40, 36))).astype(np.float32) if with_depth else None
    want = jnative.hole_fill2(img, mask, depth)
    got = pnative.hole_fill2(img, mask, depth)
    assert len(got) == len(want) == (3 if with_depth else 2)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert got[1].sum() > mask.sum() and (got[1] == 0).any()
    np.testing.assert_array_equal(mask, (mask > 0).astype(np.float32))  # input untouched


def test_jax_native_library_is_no_older_than_its_source():
    # the root conftest builds it in the pytest controller, before any
    # worker starts, so no test process rebuilds it while another loads it
    here = os.path.dirname(jnative.__file__)
    so, src = os.path.join(here, "libhost_ops.so"), os.path.join(here, "host_ops.cpp")
    assert os.path.getmtime(so) >= os.path.getmtime(src)


def test_inpaint_and_rank_match_jax():
    img, _ = _rgbd(5)
    holes = np.zeros(HW, np.float32)
    holes[6:20, 3:17] = 1.0
    holes[25:, 20:] = 1.0
    want = jfb.diffusion_fill_inpaint(img, holes, prompt=PROMPT, num_images=3, seed=107)
    got = pfb.diffusion_fill_inpaint(img, holes, prompt=PROMPT, num_images=3, seed=107,
                                     device="cpu")
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == img.shape
        assert np.abs(g - w).max() <= 1e-5
    np.testing.assert_array_equal(got[0][holes == 0], img[holes == 0])  # known kept
    ref = jfb.procedural_text2img("reference", hw=HW)
    ws, gs = jfb.histogram_rank(want, ref), pfb.histogram_rank(got, ref)
    np.testing.assert_array_equal(gs, ws)
    assert int(np.argmax(gs)) == int(np.argmax(ws)) and len(set(gs.tolist())) == 3


# ---------------------------------------------------------------------------
# the merge net
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _flax_unet(num_downs, size, seed=0):
    model = JUnet(1, 1, num_downs)
    return model, model.init(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 1)))["params"]


@pytest.mark.parametrize("num_downs", [4, 6])
def test_unet_forward_matches_flax(num_downs):
    model, params = _flax_unet(num_downs, 64)
    x = np.random.default_rng(num_downs).uniform(-1, 1, (1, 64, 64, 1)).astype(np.float32)
    want = np.asarray(model.apply({"params": params}, x))[..., 0]
    net = PP.UnetGenerator(1, 1, num_downs)
    net.load_state_dict(PP.state_from_flax(params))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))[:, 0].numpy()
    assert np.abs(got - want).max() <= 1e-5
    assert len(net.blocks) == max(num_downs, 5)


def test_unet_init_is_flax_lecun_normal():
    net = PP.UnetGenerator(1, 1, 6, generator=torch.Generator().manual_seed(3))
    _, params = _flax_unet(6, 64)
    for i, block in enumerate(net.blocks):
        for name, fan_in in (("down", block.down_weight.shape[1] * 16),
                             ("up", block.up_weight.shape[0] * 16)):
            w = getattr(block, f"{name}_weight").detach()
            std = (1.0 / fan_in) ** 0.5
            assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7
            if w.numel() > 4000:
                assert abs(float(w.std()) / std - 1) < 0.1
            assert float(getattr(block, f"{name}_bias").abs().max()) == 0.0
        # the same shapes as flax's, in torch's layouts
        sd = PP.state_from_flax(params)
        assert sd[f"blocks.{i}.down_weight"].shape == block.down_weight.shape
        assert sd[f"blocks.{i}.up_weight"].shape == block.up_weight.shape


def _merge_inputs(h=48, seed=0):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(-1, 1, (h, h)).astype(np.float32)
    src = (0.7 * ref + 0.1 + 0.05 * rng.standard_normal((h, h))).astype(np.float32)
    mask = (rng.random((h, h)) > 0.3).astype(np.float32)
    return ref * mask, src, mask


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_run_finetune_matches_jax(dtype):
    jdt, pdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm = JM.DepthMergeService(net_size=64, num_downs=4, seed=0, compute_dtype=jdt)
    pm = PM.DepthMergeService(net_size=64, num_downs=4, compute_dtype=pdt, device="cpu")
    pm.model.load_state_dict(PP.state_from_flax(jm.base_params))
    ref, src, mask = _merge_inputs()
    want = np.asarray(jm.run_finetune(ref, src, mask, outsize=48, lr=1e-5, iters=3),
                      np.float32)
    got = pm.run_finetune(ref, src, mask, outsize=48, lr=1e-5, iters=3)
    assert got.dtype == np.float32 and got.shape == (48, 48)
    err = np.abs(got - want).max()
    if dtype == "fp32":
        assert err <= 1e-5 * np.abs(want).max()
    else:
        assert err <= 2.0 ** -7
    # the base parameters are untouched: a second call gives the same
    np.testing.assert_array_equal(
        pm.run_finetune(ref, src, mask, outsize=48, lr=1e-5, iters=3), got)


@pytest.mark.parametrize("n_in,n_out", [(1024, 512), (512, 1024), (48, 64), (64, 48),
                                        (37, 100)])
def test_nearest_resize_matches_jax(n_in, n_out):
    x = np.random.default_rng(n_in).random((n_in, n_in)).astype(np.float32)
    want = np.asarray(JM._nearest_resize(jnp.asarray(x), n_out))
    np.testing.assert_array_equal(PM.nearest_resize(torch.from_numpy(x), n_out).numpy(), want)


def test_merge_weights_npz_from_jax(tmp_path):
    jm = JM.DepthMergeService(net_size=64, num_downs=4, seed=5, compute_dtype=jnp.float32)
    jm.save(str(tmp_path / "merge_model_sc.npz"))
    svc = preg.default_services(weights_dir=str(tmp_path), hw=HW, merge_net_size=64,
                                merge_num_downs=4, device="cpu")
    assert svc.resolution["merge"] == "real"
    svc.merge.compute_dtype = torch.float32
    src = _merge_inputs()[1]
    assert np.abs(svc.merge.run(src, outsize=48) - jm.run(src, outsize=48)).max() <= 1e-5
    init = preg.default_services(hw=HW, merge_net_size=64, merge_num_downs=4, device="cpu")
    assert init.resolution["merge"] == "init"
    assert not np.allclose(init.merge.run(src, outsize=48), svc.merge.run(src, outsize=48))


# ---------------------------------------------------------------------------
# the asynchronous artifact writer
# ---------------------------------------------------------------------------


def test_io_async_writes_as_the_jax_writer(tmp_path):
    rng = np.random.default_rng(7)
    arrays = {
        "rgb.png": rng.random((9, 7, 3)).astype(np.float32),          # → uint8 RGB
        "mask.png": (rng.random((9, 7)) > 0.5).astype(np.float32),    # → uint8 gray
        "depth.png": (2 + 3 * rng.random((9, 7))) * 12000,            # → uint16 (float64)
        "merged.png": ((rng.random((9, 7)) * 2 - 1 + 1.0) * 32768).astype(np.float32),
        "over.png": np.full((4, 5), 1e6, np.float32),                 # clipped to 65535
    }
    for name, a in arrays.items():
        JIO.write_async(str(tmp_path / "j" / "sub" / name), a)
        PIO.write_async(str(tmp_path / "p" / "sub" / name), a)
    JIO.flush(str(tmp_path / "j"))
    PIO.flush(str(tmp_path / "p"))
    for name in arrays:
        want = np.asarray(imageio.imread(tmp_path / "j" / "sub" / name))
        got = read_png(str(tmp_path / "p" / "sub" / name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want)


def test_io_async_reraises_on_its_own_flush(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "a" / "blocked").write_text("a file where a directory must go")
    PIO.write_async(str(tmp_path / "a" / "blocked" / "x.png"), np.zeros((2, 2), np.float32))
    PIO.write_async(str(tmp_path / "b" / "y.png"), np.zeros((2, 2), np.float32))
    PIO.flush(str(tmp_path / "b"))  # another root: no error
    assert (tmp_path / "b" / "y.png").exists()
    with pytest.raises(OSError):
        PIO.flush(str(tmp_path / "a"))
    PIO.flush(str(tmp_path / "a"))  # raised once


# ---------------------------------------------------------------------------
# the hermetic expansion step
# ---------------------------------------------------------------------------


def _scene_cfg(cls, datadir, **kw):
    return cls(datadir=str(datadir), prompt=PROMPT, pose_traj="circle0_30", num_training=2,
               hw=HW, num_filter_iter=2, filter_size=(3, 3), **kw)


class _RankSpy:
    def __init__(self, rank):
        self.rank, self.scores = rank, []

    def __call__(self, candidates, reference):
        out = self.rank(candidates, reference)
        self.scores.append(np.asarray(out))
        return out


def _services(merge_seed=0):
    """(JAX services, port services): the procedural ones, each merge net
    64/4 in fp32 from the one flax init."""
    jm = JM.DepthMergeService(net_size=64, num_downs=4, seed=merge_seed,
                              compute_dtype=jnp.float32)
    pm = PM.DepthMergeService(net_size=64, num_downs=4, compute_dtype=torch.float32,
                              device="cpu")
    pm.model.load_state_dict(PP.state_from_flax(jm.base_params))
    text2img = functools.partial(jfb.procedural_text2img, hw=HW)
    js = JServices(text2img=text2img, inpaint=jfb.diffusion_fill_inpaint,
                   estimate_depth=jfb.procedural_depth, rank=_RankSpy(jfb.histogram_rank),
                   merge=jm)
    ps = preg.Services(text2img=text2img, estimate_depth=pfb.procedural_depth,
                       inpaint=functools.partial(pfb.diffusion_fill_inpaint, device="cpu"),
                       rank=_RankSpy(pfb.histogram_rank), merge=pm)
    return js, ps


def _expansion_cfg(cls):
    return cls(prompt=PROMPT, n_candidates=2, candidates_per_round=2, merge_iters=2,
               chunk=256, app_k=8)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _expand_both(root, adaptive=False, **options):
    """The expansion step of view 1 on a slab field, in both packages:
    (JAX services, port services, the port's input scene, JAX result, port
    result).  ``adaptive`` renders through a pool-3 mask and the adaptive
    renderer (compact_k -1), as the trainer does; else dense.
    ``options`` override ExpansionConfig fields on both sides."""
    js, ps = _services()
    jscene = ss.bootstrap_scene(_scene_cfg(ss.SceneConfig, root / "jd"), "train",
                                js.text2img, js.estimate_depth)
    pscene = pss.bootstrap_scene(_scene_cfg(pss.SceneConfig, root / "pd"), "train",
                                 ps.text2img, ps.estimate_depth, device="cpu")
    params = slab_params((16, 16, 16))
    field = PC.params_from_jax(_flatten(params), CFG, device="cpu").requires_grad_(False)
    jkw, pkw = {}, {}
    if adaptive:
        aabb = np.array([[-8.0] * 3, [8.0] * 3], np.float32)
        jmask, _ = tf.update_alpha_mask(CFG, params, jnp.asarray(aabb), (16, 16, 16), pool=3)
        pmask, _ = ptf.update_alpha_mask(field, torch.tensor(aabb), (16, 16, 16), pool=3,
                                         device="cpu")
        np.testing.assert_array_equal(pmask["volume"].numpy(), np.asarray(jmask["volume"]))
        jkw, pkw = dict(alpha_mask=jmask, compact_k=-1), dict(alpha_mask=pmask, compact_k=-1)
    jcfg = dataclasses.replace(_expansion_cfg(JE.ExpansionConfig), **options)
    pcfg = dataclasses.replace(_expansion_cfg(PE.ExpansionConfig), **options)
    want = JE.expand_scene(1, CFG, params, jscene, js, jcfg, str(root / "jl"), n_samples=32,
                           seed=0, **jkw)
    JIO.flush(str(root / "jl"))
    got = PE.expand_scene(1, field, pscene, ps, pcfg, str(root / "pl"), n_samples=32, seed=0,
                          device="cpu", **pkw)
    PIO.flush(str(root / "pl"))
    return js, ps, pscene, want, got


@pytest.fixture(scope="module")
def expanded(tmp_path_factory):
    root = tmp_path_factory.mktemp("expansion")
    return (root, *_expand_both(root))


def test_expansion_step_matches_jax(expanded):
    _, js, ps, pscene, want, got = expanded
    assert got.rgbs_gen_split.shape[0] == want.rgbs_gen_split.shape[0] == 2
    mask = got.masks_gen_split[1]
    np.testing.assert_array_equal(mask, want.masks_gen_split[1])
    assert 0 < mask.sum() < mask.size  # a real disocclusion to inpaint
    assert len(ps.rank.scores) == len(js.rank.scores) == 1
    np.testing.assert_array_equal(ps.rank.scores[0], js.rank.scores[0])
    assert int(np.argmax(ps.rank.scores[0])) == int(np.argmax(js.rank.scores[0]))
    assert np.abs(got.rgbs_gen_split[1] - want.rgbs_gen_split[1]).max() <= 1e-5
    d_want = want.depth_gen_split[1]
    assert np.abs(got.depth_gen_split[1] - d_want).max() <= 1e-5 * np.abs(d_want).max()
    # the view's support pool: the same rays, rgbs and depths
    assert set(got.updates) == set(want.updates) == {"00000", "00001"}
    (gr, gc, gd), (wr, wc, wd) = got.updates["00001"], want.updates["00001"]
    assert 0 < len(gr) == len(wr)
    np.testing.assert_array_equal(gr, wr)
    assert np.abs(gc - wc).max() <= 1e-5 and np.abs(gd - wd).max() <= 1e-5 * np.abs(wd).max()
    # the scene the caller passed in keeps one view
    assert pscene.rgbs_gen_split.shape[0] == 1 and set(pscene.updates) == {"00000"}


def test_expansion_dibr_tree_matches_jax(expanded):
    root = expanded[0]
    files = _files(root / "pl")
    assert files == _files(root / "jl")
    assert "DIBR/mask/00001.png" in files and "DIBR/rgbs/00001_001.png" in files
    for name in files:
        got = read_png(str(root / "pl" / name))
        want = np.asarray(imageio.imread(root / "jl" / name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if "mask" in name:
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, name


def test_expansion_step_through_the_adaptive_renderer_matches_jax(tmp_path):
    # the renders' bf16 features agree with JAX's within half a bf16 ulp
    # (the adaptive renderer's density sums in another order), so the
    # rendered target moves the new view by less than one uint8 level
    js, ps, _, want, got = _expand_both(tmp_path, adaptive=True)
    np.testing.assert_array_equal(got.masks_gen_split[1], want.masks_gen_split[1])
    np.testing.assert_allclose(ps.rank.scores[0], js.rank.scores[0], rtol=1e-3)
    assert int(np.argmax(ps.rank.scores[0])) == int(np.argmax(js.rank.scores[0]))
    assert np.abs(got.rgbs_gen_split[1] - want.rgbs_gen_split[1]).max() <= 1.0 / 255
    d_want = want.depth_gen_split[1]
    assert np.abs(got.depth_gen_split[1] - d_want).max() <= 1e-4 * np.abs(d_want).max()
    np.testing.assert_array_equal(got.updates["00001"][0], want.updates["00001"][0])


def test_expansion_step_off_default_options_match_jax(tmp_path):
    # one inpainted candidate, the stored views warped instead of renders,
    # no hole fill, the view alone as its pool
    _, _, _, want, got = _expand_both(
        tmp_path, frame_select_type="first", use_rendered_img_to_warp=False,
        use_filter_filling_holes=False, use_support_set=False)
    np.testing.assert_array_equal(got.masks_gen_split[1], want.masks_gen_split[1])
    assert np.abs(got.rgbs_gen_split[1] - want.rgbs_gen_split[1]).max() <= 1e-5
    d_want = want.depth_gen_split[1]
    assert np.abs(got.depth_gen_split[1] - d_want).max() <= 1e-5 * np.abs(d_want).max()
    (gr, _, _), (wr, _, _) = got.updates["00001"], want.updates["00001"]
    np.testing.assert_array_equal(gr, wr)
    assert len(gr) == int(got.masks_gen_split[1].sum())  # the view's own rays only
    assert _files(tmp_path / "pl") == _files(tmp_path / "jl")


def test_update_known_views_matches_jax(tmp_path):
    # the eroded mask, then view 0 updated from view 1's new content: its
    # composite, its merged depth and its rebuilt pool
    _, _, pscene, want, got = _expand_both(tmp_path, update_known_views=True)
    np.testing.assert_array_equal(got.masks_gen_split, want.masks_gen_split)
    assert got.rgbs_gen_split.shape == want.rgbs_gen_split.shape == (2, *HW, 3)
    assert np.abs(got.rgbs_gen_split - want.rgbs_gen_split).max() <= 1e-5
    d_want = want.depth_gen_split
    assert np.abs(got.depth_gen_split - d_want).max() <= 1e-5 * np.abs(d_want).max()
    # view 0 changed where the back-warp landed, and its pool was rebuilt
    assert np.abs(got.rgbs_gen_split[0] - pscene.rgbs_gen_split[0]).max() > 0
    assert set(got.updates) == set(want.updates) == {"00000", "00001"}
    # the pools: the same rays; the values of the support warps equal on
    # 97% of them (a depth within 2e-7 of JAX's moves a splat across a
    # pixel edge here and there: 1.4% and 1.9% of view 0's rgbs and depths)
    for v in ("00000", "00001"):
        (gr, gc, gd), (wr, wc, wd) = got.updates[v], want.updates[v]
        assert 0 < len(gr) == len(wr)
        np.testing.assert_array_equal(gr, wr)
        assert (np.abs(gc - wc).max(-1) <= 1e-5).mean() >= 0.97
        assert (np.abs(gd - wd) <= 1e-5 * np.abs(wd).max()).mean() >= 0.97
    assert len(got.updates["00000"][0]) != len(pscene.updates["00000"][0])
    files = _files(tmp_path / "pl")
    assert files == _files(tmp_path / "jl")
    assert "DIBR/rgbs_support/00001_warp2known/00000_image_warp.png" in files
    assert "DIBR/mask/00001_expand.png" in files


# ---------------------------------------------------------------------------
# the progressive fit
# ---------------------------------------------------------------------------

MODEL = dict(density_n_comp=(2, 2, 2), app_n_comp=(4, 4, 4), app_dim=6, fea_pe=2,
             feature_c=16, step_ratio=0.5)
SCHEDULE = dict(n_stage1=2, n_stage2=1, n_stage3=1, batch_size=512, n_voxel_init=12 ** 3,
                n_voxel_final=20 ** 3, upsamp_list=(3,), update_alphamask_list=(6,), app_k=8,
                eval_every_epochs=10, seed=3, train_microbatch=4, eval_mask_pool=5,
                progress_refresh_rate=1, vis_support_views=False, eval_compact_k=0)


@contextlib.contextmanager
def _no_warmup():
    warmup, JT._start_train_step_warmup = JT._start_train_step_warmup, lambda *a: _Done()
    try:
        yield
    finally:
        JT._start_train_step_warmup = warmup


class _Done:
    def join(self, timeout=None):
        pass

    def is_alive(self):
        return False


def _fits(root, balance):
    reso = tf.n_to_reso(SCHEDULE["n_voxel_init"], np.array([[-8.0] * 3, [8.0] * 3]))
    init = str(root / "init.npz")
    jsave(init, tf.TensoRFConfig(**MODEL), slab_params(reso),
          jnp.asarray([[-8.0] * 3, [8.0] * 3]))
    sched = dict(SCHEDULE, stage3_balance=balance)
    js, ps = _services()
    with _no_warmup(), _Recorder(JTS.PermutationSampler) as jids:
        jres = JT.reconstruction(
            JT.TrainConfig(expname="j", basedir=str(root / "jl"), ckpt=init,
                           model=tf.TensoRFConfig(**MODEL), **sched),
            _scene_cfg(ss.SceneConfig, root / "jd"), js, _expansion_cfg(JE.ExpansionConfig))
    kinds = []
    with _Recorder(PTS.PermutationSampler) as pids, _jax_key_stream(sched["seed"], kinds):
        pres = PT.reconstruction(
            PT.TrainConfig(expname="p", basedir=str(root / "pl"), ckpt=init,
                           model=ptf.TensoRFConfig(**MODEL), **sched),
            _scene_cfg(pss.SceneConfig, root / "pd"), ps, _expansion_cfg(PE.ExpansionConfig),
            device="cpu")
    return jres, pres, jids.ids, pids.ids, kinds


@pytest.mark.parametrize("balance", ["uniform", "tail_deficit"])
def test_progressive_fit_follows_jax(tmp_path, balance):
    jres, pres, jids, pids, kinds = _fits(tmp_path, balance)
    assert len(jids) == len(pids) == len(kinds)
    for a, b in zip(jids, pids):
        np.testing.assert_array_equal(b, a)
    jrows, prows = _rows(jres[4]), _rows(pres[4])
    mj = np.array([r["mse"] for r in jrows if "mse" in r])
    mp = np.array([r["mse"] for r in prows if "mse" in r])
    assert len(mj) == len(mp) == len(kinds)
    assert float(np.abs(mp / mj - 1).max()) <= 1e-5
    ej = [(r["step"], r["eval_psnr"]) for r in jrows if "eval_psnr" in r]
    ep = [(r["step"], r["eval_psnr"]) for r in prows if "eval_psnr" in r]
    assert [s for s, _ in ep] == [s for s, _ in ej] and len(ep) == 3
    for (_, a), (_, b) in zip(ej, ep):
        assert abs(a - b) <= 1e-4
    # stage 1 dense; stages 2 and 3 compacted on the stamped mask
    n1 = 2 * next(r["iters_per_epoch"] for r in prows if "iters_per_epoch" in r)
    assert not any(kinds[:n1]) and all(kinds[n1:])
    # the new view's pool, sampled in stage 2
    (jr, _, _), (pr, _, _) = jres[3].updates["00001"], pres[3].updates["00001"]
    assert 0 < len(pr) == len(jr)
    np.testing.assert_array_equal(pr, jr)
    boundary = next(r for r in prows if "pool_new_rays" in r)
    assert boundary["pool_new_rays"] == len(pr) and boundary["view"] == 1
    assert any(len(ids) and ids.max() < len(pr) for ids in pids[n1:n1 + 5])
    assert any(k.startswith("phase/expand1_merge_finetune") for r in prows for k in r)
    assert os.path.exists(os.path.join(pres[4], "DIBR", "rgbs", "00001.png"))
    if balance == "tail_deficit":
        w = [r for r in prows if "stage3_weight_view0" in r]
        assert len(w) == 1 and w[0]["stage3_weight_view0"] < w[0]["stage3_weight_view1"]
