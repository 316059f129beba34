"""The merge net's weights tool, offline pretraining, PatchGAN
discriminator and ``align_depth_pair`` against the JAX package's, on
the CPU.

- The tool (``python -m text2nerf_tpu_torch.convert_weights``): from one
  seeded unet_1024 ``latest_net_G.pth`` it writes an npz with the same
  keys and the same values (bit for bit) as JAX's
  ``tools/convert_weights.py`` ``convert_merge``; the port's registry
  then says "real" and its service loads the checkpoint's values.  (The
  big inner entries are zero-stride views of seeded rows, so the file
  stays small; every entry of up to 2^20 values is seeded whole.)
- The npz through both services (64 / 4 downs, fp32): the port's service
  on the tool's npz against JAX's on the ``.pth`` (JAX's service does
  not read the ``generator/`` root its own tool writes; it reads the
  same values without the root), outputs within 1e-5 of the largest.
- ``synthetic_corruption`` is bit-equal to JAX's from one seed;
  ``pretrain_merge_model`` at 64 / 6 downs, 5 steps: losses within 1e-4
  relative of JAX's; ``save`` writes JAX's keys and values.
- ``PatchDiscriminator`` and ``gan_loss`` on seeded weights (from the
  flax init, and through the torch names of ``patchgan_name_map``):
  within 1e-5 of JAX's largest.
- ``align_depth_pair``: within 1e-5 of JAX's, absolute (depths ~4; the
  uncertainty is a residual, so a bound relative to it would measure
  cancellation).
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2nerf_tpu.engine import expansion as JE
from text2nerf_tpu.models import pix2pix as JP
from text2nerf_tpu.ops import rays as JR
from text2nerf_tpu.services import merge as JM
from text2nerf_tpu.services import weight_convert as WC
from text2nerf_tpu_torch import convert_weights as tool
from text2nerf_tpu_torch.engine import expansion as PE
from text2nerf_tpu_torch.models import pix2pix as PP
from text2nerf_tpu_torch.models.pix2pix import UnetGenerator
from text2nerf_tpu_torch.services import merge as PM
from text2nerf_tpu_torch.services import registry as preg
from text2nerf_tpu_torch.services import weights as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_convert_weights", os.path.join(REPO, "tools", "convert_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_state(num_downs, seed=0, whole_up_to=None):
    """Seeded values under the reference's names at torch's shapes;
    entries larger than ``whole_up_to`` (when given) are zero-stride views
    of seeded (O, 1, 4, 4) rows (a bias is always whole)."""
    rng = np.random.default_rng(seed)
    template = {k: tuple(v.shape) for k, v in
                UnetGenerator(1, 1, num_downs).to("meta").state_dict().items()}
    state = {}
    for tname, fpath in W.unet_generator_name_map(num_downs).items():
        shape = template[W.pix2pix_key(fpath)]
        if whole_up_to is None or int(np.prod(shape)) <= whole_up_to:
            v = torch.from_numpy((0.05 * rng.standard_normal(shape)).astype(np.float32))
        else:
            row = (0.05 * rng.standard_normal((shape[0], 1, *shape[2:]))).astype(np.float32)
            v = torch.from_numpy(row).expand(shape)
        state[tname] = v
    return state


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    root = tmp_path_factory.mktemp("merge_tool")
    weights = root / "weights"
    ckpt = weights / "merge_model_sc" / "checkpoints" / "latest_net_G.pth"
    ckpt.parent.mkdir(parents=True)
    torch.save(_reference_state(10, whole_up_to=1 << 20), ckpt)
    out = root / "port"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "text2nerf_tpu_torch.convert_weights",
                           "--weights_dir", str(weights), "--out_dir", str(out)],
                          capture_output=True, text=True, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    (root / "jax").mkdir()
    assert _jax_tool().convert_merge(str(weights), str(root / "jax"))
    return root, ckpt, proc.stdout


def test_tool_writes_the_jax_tools_npz(converted):
    root, ckpt, stdout = converted
    lines = [json.loads(l) for l in stdout.splitlines() if l.startswith("{")]
    assert lines == [{"family": "merge_model_sc", "status": "converted", "detail": str(ckpt)}]
    with np.load(root / "port" / "merge_model_sc.npz") as got, \
            np.load(root / "jax" / "merge_model_sc.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        assert all(k.startswith("generator/UnetSkipBlock_") for k in got.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_registry_reads_the_tools_npz(converted):
    root, ckpt, _ = converted
    services = preg.default_services(str(root / "port"), hw=(32, 32), device="cpu")
    assert services.resolution["merge"] == "real"
    got = services.merge.model.state_dict()
    want = PM.state_from_torch(str(ckpt), UnetGenerator(1, 1, 10), 10)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("status", ["absent", "error"])
def test_tool_status_lines(tmp_path, status, capsys):
    if status == "error":
        bad = tmp_path / "merge_model_sc" / "latest_net_G.pth"
        bad.parent.mkdir(parents=True)
        torch.save({"model.model.0.weight": torch.zeros(1)}, bad)
    rc = tool.main(["--weights_dir", str(tmp_path), "--out_dir", str(tmp_path / "o")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["family"] == "merge_model_sc" and line["status"] == status
    assert rc == (1 if status == "error" else 0)
    assert not (tmp_path / "o" / "merge_model_sc.npz").exists()


def test_tools_npz_through_both_services(tmp_path):
    pth = tmp_path / "latest_net_G.pth"
    torch.save(_reference_state(4, seed=2), pth)
    npz = tmp_path / "merge_model_sc.npz"
    tool.write_merge_npz(str(pth), str(npz), num_downs=4)
    with np.load(npz) as data:
        bare = {k[len("generator/"):]: data[k] for k in data.files}
    np.savez(tmp_path / "bare.npz", **bare)
    src = np.random.default_rng(3).uniform(-1, 1, (48, 48)).astype(np.float32)
    pm = PM.DepthMergeService(str(npz), net_size=64, num_downs=4, compute_dtype=torch.float32,
                              device="cpu")
    got = pm.run(src, outsize=48)
    for path in (pth, tmp_path / "bare.npz"):
        jm = JM.DepthMergeService(str(path), net_size=64, num_downs=4,
                                  compute_dtype=jnp.float32)
        want = jm.run(src, outsize=48)
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= TOL * np.abs(want).max(), path


def test_synthetic_corruption_bit_equal_to_jax():
    depth = np.random.default_rng(5).uniform(-1, 1, (40, 56))
    r_j, r_p = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(4):
        want = JM.synthetic_corruption(r_j, depth)
        got = PM.synthetic_corruption(r_p, depth)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_pretrain_merge_model_matches_jax(tmp_path):
    jm = JM.DepthMergeService(net_size=64, num_downs=6, compute_dtype=jnp.float32)
    pm = PM.DepthMergeService(net_size=64, num_downs=6, compute_dtype=torch.float32,
                              device="cpu")
    pm.model.load_state_dict(PP.state_from_flax(jm.base_params))
    jm.save(str(tmp_path / "j.npz"))
    pm.save(str(tmp_path / "p.npz"))
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "p.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
    rng = np.random.default_rng(7)
    clean = [rng.uniform(0.5, 4.0, (40, 40)) + np.linspace(0, 2, 40)[None] for _ in range(3)]
    want = JM.pretrain_merge_model(jm, clean, steps=5, outsize=48, seed=1)
    got = PM.pretrain_merge_model(pm, clean, steps=5, outsize=48, seed=1)
    assert len(got) == 5 and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    # the trained weights are the service's base parameters now
    src = np.random.default_rng(9).uniform(-1, 1, (48, 48)).astype(np.float32)
    w = jm.run(src, outsize=48)
    assert np.abs(pm.run(src, outsize=48) - w).max() <= 1e-4 * np.abs(w).max()


def _disc_input():
    return np.random.default_rng(4).uniform(-1, 1, (2, 64, 64, 2)).astype(np.float32)


@pytest.mark.parametrize("source", ["flax", "torch_names"])
def test_patch_discriminator_and_gan_loss_match_jax(source):
    net = JP.PatchDiscriminator()
    x = _disc_input()
    params = net.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    disc = PP.PatchDiscriminator()
    if source == "flax":
        state = PP.discriminator_state_from_flax(params)
    else:
        # the reference's torch layout and names, through JAX's converter
        # on the JAX side and the port's name map on the port's
        torch_state = {}
        for tname, fpath in W.patchgan_name_map(3).items():
            layer, leaf = fpath.split("/")
            v = np.asarray(params[layer][leaf])
            torch_state[tname] = torch.from_numpy(
                (v.transpose(3, 2, 0, 1) if leaf == "kernel" else v).copy())
        params = WC.convert_torch_state_dict({k: v.numpy() for k, v in torch_state.items()},
                                             WC.patchgan_name_map(3))
        state = PP.discriminator_state_from_torch(torch_state, 3)
    disc.load_state_dict(state)
    want = np.asarray(net.apply({"params": params}, jnp.asarray(x)))
    got = disc(torch.from_numpy(x).permute(0, 3, 1, 2)).detach().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 6, 6, 1)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    for mode in ("vanilla", "lsgan"):
        for real in (True, False):
            w = float(JP.gan_loss(jnp.asarray(want), real, mode))
            g = float(PP.gan_loss(torch.from_numpy(got), real, mode))
            assert abs(g - w) <= TOL * abs(w), (mode, real)
    with pytest.raises(ValueError):
        PP.gan_loss(torch.zeros(1), True, "wgan")


def test_align_depth_pair_matches_jax():
    h = w = 40
    rng = np.random.default_rng(6)
    yy, xx = np.mgrid[0:h, 0:w]
    depth_ref = (3.0 + 0.02 * xx + 0.01 * yy + 0.05 * rng.uniform(size=(h, w))).astype(np.float32)
    depth_src = (1.7 * depth_ref + 0.4 + 0.01 * rng.uniform(size=(h, w))).astype(np.float32)
    pose_ref = np.eye(4, dtype=np.float32)
    pose_src = np.eye(4, dtype=np.float32)
    pose_src[:3, 3] = [0.15, -0.05, 0.1]
    intrinsic = JR.default_intrinsics(h, w)
    want = JE.align_depth_pair(depth_ref, depth_src, pose_ref, pose_src, intrinsic, seed=2)
    got = PE.align_depth_pair(depth_ref, depth_src, pose_ref, pose_src, intrinsic, seed=2,
                              device="cpu")
    for g, x in zip(got, want):
        x = np.asarray(x)
        assert g.shape == x.shape and g.dtype == np.float32
        assert np.abs(g - x).max() <= TOL
