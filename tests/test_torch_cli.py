"""The port's command line (``config.py``, ``main.py``) and mesh export
against the JAX package, on the CPU:

- ``parse_args`` on the shipped config plus flags: the same namespace;
- ``to_configs``: every field of the train, scene, expansion and model
  configurations equal;
- ``main``'s reconstruction branch, ``trainer.reconstruction`` replaced
  on both sides: equal configurations (the production overrides and the
  datadir fallback applied) and the same service resolution;
- the render-only branch on a tiny port checkpoint writes the frames
  ``trainer.render_test`` writes;
- ``main`` runs on cuda unless asked: it raises without CUDA;
- the dense alpha volume of a tiny field carried across (the port's
  checkpoint, read by JAX): within 1e-6 [6e-8]; ``marching_tetrahedra``
  of one volume: equal faces and vertices; ``export_field_mesh``: equal
  faces, vertices within 1e-5 [6.5e-6: an edge crossing moves by the
  alpha's last-bit difference over the alpha's change along the edge].
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from text2nerf_tpu import config as JCFG
from text2nerf_tpu import main as JMAIN
from text2nerf_tpu.engine import checkpoints as JCK
from text2nerf_tpu.engine import trainer as JT
from text2nerf_tpu.models import tensorf as JTF
from text2nerf_tpu.utils import compilation_cache as JCC
from text2nerf_tpu.utils import mesh as JMESH
from text2nerf_tpu_torch import config as PCFG
from text2nerf_tpu_torch import main as PMAIN
from text2nerf_tpu_torch.engine import checkpoints as PCK
from text2nerf_tpu_torch.engine import trainer as PT
from text2nerf_tpu_torch.models import tensorf as PTF
from text2nerf_tpu_torch.utils import mesh as PMESH
from text2nerf_tpu_torch.utils.png import read_png, write_png

torch.set_num_threads(2)

CONFIG = os.path.join(os.path.dirname(__file__), os.pardir, "configs", "text2nerf_scenes.txt")

ARGVS = [
    [],
    ["--prompt", "a quiet street", "--hw", "256", "320", "--n_lamb_sigma", "8", "8", "8",
     "--no-use_support_set", "--update_AlphaMask_list", "30", "60", "--eval_compact_k", "-1"],
    ["--model_name", "TensorCP", "--render_only", "1", "--render_test", "1", "--ckpt", "x.npz",
     "--N_vis", "4", "--white_bkgd", "--train_compute_dtype", "bf16", "--seed", "11",
     "--update_known_views", "--upsamp_list", "10", "--type_depth_loss", "silog"],
]


@pytest.mark.parametrize("extra", ARGVS, ids=["config", "flags", "render"])
def test_parse_args_matches_jax(extra):
    argv = ["--config", CONFIG] + extra
    assert vars(PCFG.parse_args(argv)) == vars(JCFG.parse_args(argv))
    assert vars(PCFG.parse_args(extra)) == vars(JCFG.parse_args(extra))


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _assert_same_configs(got, want):
    """The same fields with equal values (the model configuration field
    by field)."""
    for g, w in zip(got, want):
        gf, wf = _fields(g), _fields(w)
        assert set(gf) == set(wf)
        for k, v in wf.items():
            if k == "model":
                assert _fields(gf[k]) == _fields(v)
            else:
                assert gf[k] == v, k


@pytest.mark.parametrize("extra", ARGVS, ids=["config", "flags", "render"])
def test_to_configs_matches_jax(extra):
    argv = ["--config", CONFIG] + extra
    got = PCFG.to_configs(PCFG.parse_args(argv))
    want = JCFG.to_configs(JCFG.parse_args(argv))
    _assert_same_configs(got, want)
    assert type(got[0].model) is PTF.TensoRFConfig


def test_main_reconstruction_branch_matches_jax(tmp_path, monkeypatch):
    calls = {}

    def recorder(side):
        def reconstruction(cfg, scene_cfg, services, expansion_cfg, **kw):
            calls[side] = (cfg, scene_cfg, expansion_cfg, dict(services.resolution))
            return None, None, None, None, str(tmp_path)
        return reconstruction

    monkeypatch.setattr(JT, "reconstruction", recorder("jax"))
    monkeypatch.setattr(PT, "reconstruction", recorder("port"))
    monkeypatch.setattr(JCC, "enable_persistent_compilation_cache", lambda *a, **k: "")
    argv = ["--config", CONFIG, "--datadir", str(tmp_path / "scene"), "--prompt", "a red barn",
            "--weights_dir", str(tmp_path / "none"), "--N_voxel_init", "1000",
            "--batch_size", "64", "--no-regen_pose", "--update_known_views", "--seed", "5"]
    assert JMAIN.main(argv) == 0
    assert PMAIN.main(argv, device="cpu") == 0
    got, want = calls["port"], calls["jax"]
    _assert_same_configs(got[:3], want[:3])
    assert got[0].n_voxel_init == 27_000_000 and got[0].batch_size == 16384
    assert got[1].datadir == str(tmp_path / "scene") + "_a_red_barn" and got[1].regen_pose
    assert not got[2].update_known_views
    assert got[3] == want[3]


def test_main_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: main runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PMAIN.main(["--config", CONFIG, "--basedir", str(tmp_path)])


def _tiny_checkpoint(path, aabb=((-2.0, -2.0, -1.0), (2.0, 2.0, 3.0)), seed=0):
    """A tiny field with live, varied density: the init's density factors
    scaled up, the density shift raised."""
    cfg = PTF.TensoRFConfig(density_n_comp=(2, 2, 2), app_n_comp=(4, 4, 4), density_shift=-2.0)
    field = PTF.init_params(cfg, (10, 11, 12), generator=torch.Generator().manual_seed(seed),
                            device="cpu")
    with torch.no_grad():
        for i, nd in enumerate(field.nd):
            field.planes[i][..., :nd] *= 10.0
            field.lines[i][..., :nd] *= 10.0
    aabb = torch.tensor(aabb)
    PCK.save_checkpoint(path, field, aabb)
    return field, aabb


def test_render_only_branch_writes_render_test_frames(tmp_path):
    scene = tmp_path / "scene"
    (scene / "rgbs").mkdir(parents=True)
    (scene / "depth").mkdir()
    rng = np.random.default_rng(0)
    write_png(str(scene / "rgbs" / "00000.png"),
              (rng.random((16, 16, 3)) * 255).astype(np.uint8))
    np.save(scene / "depth" / "00000.npy", (4 + rng.random((16, 16))).astype(np.float32))
    ckpt = str(tmp_path / "log" / "tiny.npz")
    os.makedirs(os.path.dirname(ckpt))
    _tiny_checkpoint(ckpt)
    argv = ["--config", CONFIG, "--datadir", str(scene), "--hw", "16", "16", "--render_only",
            "1", "--render_test", "1", "--ckpt", ckpt, "--N_vis", "3"]
    assert PMAIN.main(argv, device="cpu") == 0
    out = tmp_path / "log" / "imgs_test_all" / "rgbs"
    names = sorted(os.listdir(out))
    got = [read_png(str(out / n)) for n in names]
    os.rename(tmp_path / "log" / "imgs_test_all", tmp_path / "log" / "main_frames")
    train_cfg, scene_cfg, _ = PCFG.to_configs(PCFG.parse_args(argv))
    res = PT.render_test(train_cfg, scene_cfg, device="cpu")
    assert len(names) == 3 and len(res["test"]["rgb"]) == 3
    for n, g in zip(names, got):
        assert g.shape == (16, 16, 3)
        np.testing.assert_array_equal(g, read_png(str(out / n)))
    assert np.ptp(np.stack(got)) > 0


def test_export_field_mesh_matches_jax(tmp_path):
    path = str(tmp_path / "tiny.npz")
    field, aabb = _tiny_checkpoint(path, seed=3)
    jcfg, jparams, jaabb, _, _ = JCK.load_checkpoint(path)  # the port's checkpoint, read by JAX
    grid = (20, 18, 16)
    step = JTF.step_size(jaabb, JTF.grid_resolution(jcfg, jparams), jcfg.step_ratio)
    alpha = np.asarray(JTF.dense_alpha(jcfg, jparams, jaabb, grid, step)[0])
    level = float(np.quantile(alpha, 0.6))
    with torch.no_grad():
        got = PTF.dense_alpha(field, aabb, grid, PTF.step_size(aabb, PTF.grid_resolution(field),
                                                                field.cfg.step_ratio))[0]
    assert np.abs(got.numpy() - alpha).max() <= 1e-6
    # the isosurface of one volume: the same mesh
    spacing = (0.2, 0.25, 0.3)
    wv, wf = JMESH.marching_tetrahedra(alpha, level, spacing)
    gv, gf = PMESH.marching_tetrahedra(alpha, level, spacing)
    np.testing.assert_array_equal(gf, wf)
    np.testing.assert_array_equal(gv, wv)
    # the whole export: the alpha volumes differ in the last bits, which
    # can reorder the welded vertices, so the triangles are compared
    wv, wf = JMESH.export_field_mesh(jcfg, jparams, jaabb, str(tmp_path / "j.ply"),
                                     grid_size=grid, level=level)
    gv, gf = PMESH.export_field_mesh(field, aabb, str(tmp_path / "p.ply"), grid_size=grid,
                                     level=level)
    assert len(wf) > 50
    np.testing.assert_array_equal(gf, wf)
    assert np.abs(gv[gf] - wv[wf]).max() <= 1e-5
    rv, rf = PMESH.read_ply(str(tmp_path / "p.ply"))
    np.testing.assert_array_equal(rf, gf)
    np.testing.assert_array_equal(rv, gv.astype(np.float32))
