"""The port's directory checkpoints (``checkpoint_backend="orbax"``:
``engine/checkpoints.py`` ``save_orbax`` / ``load_orbax`` through
``torch.distributed.checkpoint``) against the npz backend and the JAX
package's orbax backend, on the CPU at tiny size.

Held, each with tolerance 0:
- (a) a one-process round trip of ``vm_split``, ``cp`` and ``vm``: the
  directory's leaves, read back by name, equal the npz file's of the
  same field, and so do the restored field, ``aabb`` and loop state;
- (b) the JAX package's ``save_orbax`` and the port's, on one state
  (carried across with ``params_to_jax``): equal ``cfg.json`` and
  ``loop_state.json`` once parsed, and the port's restored leaves equal
  those JAX's ``load_orbax`` restores;
- (c) on two gloo ranks (bodies in tests/test_torch_mesh_ranks.py), at
  model 2 and at data 2, for each decomposition: a sharded save whose
  sharded restore gives each rank ``shard_params(whole)``, and whose
  one-process restore gives ``whole``; at model 2 each rank wrote its
  own slices of the app tables, at data 2 the directory holds one copy
  (the bytes of the one-process save);
- (d) a directory JAX's ``save_orbax`` wrote (orbax's OCDBT format) makes
  the port's ``load_orbax`` raise the ``ValueError`` that names it;
- (e) a port fit with ``checkpoint_backend="orbax"`` writes
  ``<expname>_resume/`` and ``<expname>_final/`` (the latter equal to the
  ``_final.npz``); resumed mid-stage 2 through the directory it takes
  the steps a resume through the npz of the same point takes (sampler
  ids equal, per-step mse bit for bit), and a save interrupted before its
  rename leaves the previous point in force.
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed.checkpoint as dcp

from test_torch_mesh_ranks import ORBAX_MODELS, orbax_field
from test_torch_resume import EXPNAME, SCHEDULE, _logfolder, _port_fit
from test_torch_trainer import _Recorder, _rows
from text2nerf_tpu.engine import checkpoints as JC
from text2nerf_tpu.models import tensorf as jtf
from tools.rebuild_scene_snapshot import _resume_next_view as jax_resume_next_view
from text2nerf_tpu_torch.engine import checkpoints as PC
from text2nerf_tpu_torch.engine import train_step as PTS
from text2nerf_tpu_torch.parallel import dryrun
from text2nerf_tpu_torch.tools import rebuild_scene_snapshot as PRB

torch.set_num_threads(2)

TESTS = os.path.dirname(os.path.abspath(__file__))
AABB = torch.tensor([[-1.0, -1.5, -2.0], [1.0, 1.5, 2.0]])
LOOP = {"epoch": 3, "next_view": 2, "tv_decay": 0.5, "global_step": 17}


def _dir_leaves(path):
    """{name: ndarray} of every leaf in a port directory, read by name."""
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    state = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype) for k, m in meta.items()}
    with PC._one_process_quiet():
        dcp.load(state, storage_reader=dcp.FileSystemReader(path), no_dist=True)
    return {k: v.numpy() for k, v in state.items()}


def _assert_flat_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


@pytest.mark.parametrize("name", ORBAX_MODELS)
def test_round_trip_equals_the_npz_backend(tmp_path, name):
    field = orbax_field(name)
    PC.save_checkpoint(str(tmp_path / "f.npz"), field, AABB, loop_state=LOOP)
    path = str(tmp_path / "f")
    PC.save_orbax(path, field, AABB, extras={"step": np.int32(5)}, loop_state={"epoch": 0})
    PC.save_orbax(path, field, AABB, loop_state=LOOP)  # replaces the directory whole
    assert sorted(n for n in os.listdir(path)) == [".metadata", "__0_0.distcp", "cfg.json",
                                                   "loop_state.json"]
    assert not [n for n in os.listdir(tmp_path) if ".tmp." in n or ".old." in n]
    npz = dict(np.load(tmp_path / "f.npz"))
    leaves = _dir_leaves(path)
    _assert_flat_equal(leaves, {k: v for k, v in npz.items()
                                if k.startswith("params/") or k == "aabb"})
    cfg, got, aabb, loop = PC.load_orbax(path, device="cpu")
    cfg_n, got_n, aabb_n, _, loop_n = PC.load_checkpoint(str(tmp_path / "f.npz"), device="cpu")
    assert cfg.to_dict() == cfg_n.to_dict() == field.cfg.to_dict()
    _assert_flat_equal(PC.params_to_jax(got), PC.params_to_jax(got_n))
    assert torch.equal(aabb, aabb_n) and torch.equal(aabb, AABB)
    assert loop == loop_n == LOOP


@pytest.mark.parametrize("name", ORBAX_MODELS)
def test_jax_and_port_directories_hold_the_same_state(tmp_path, name):
    field = orbax_field(name)
    flat = PC.params_to_jax(field)
    jcfg = jtf.TensoRFConfig.from_dict(field.cfg.to_dict())
    JC.save_orbax(str(tmp_path / "j"), jcfg, JC._unflatten(flat), jnp.asarray(AABB.numpy()),
                  loop_state=LOOP)
    PC.save_orbax(str(tmp_path / "p"), field, AABB, loop_state=LOOP)
    for side in ("cfg.json", "loop_state.json"):
        want = json.loads((tmp_path / "j" / side).read_text())
        assert json.loads((tmp_path / "p" / side).read_text()) == want, side
    jcfg2, jparams, jaabb, jloop = JC.load_orbax(str(tmp_path / "j"))
    pcfg, pfield, paabb, ploop = PC.load_orbax(str(tmp_path / "p"), device="cpu")
    assert pcfg.to_dict() == jcfg2.to_dict() and ploop == jloop == LOOP
    _assert_flat_equal(PC.params_to_jax(pfield), JC._flatten(jparams))
    np.testing.assert_array_equal(paabb.numpy(), np.asarray(jaabb))


def test_a_jax_orbax_directory_is_refused_by_name(tmp_path):
    field = orbax_field("vm_split")
    path = str(tmp_path / "j")
    JC.save_orbax(path, jtf.TensoRFConfig.from_dict(field.cfg.to_dict()),
                  JC._unflatten(PC.params_to_jax(field)), jnp.asarray(AABB.numpy()))
    assert not os.path.exists(os.path.join(path, ".metadata"))
    with pytest.raises(ValueError, match=r"orbax's OCDBT format.*_final\.npz"):
        PC.load_orbax(path, device="cpu")
    with pytest.raises(FileNotFoundError, match=r"\.metadata"):
        PC.load_orbax(str(tmp_path), device="cpu")


# -- (c) sharded, on two gloo ranks -------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' reports and their working directory."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([TESTS, env.get("PYTHONPATH", "")])
    work = tmp_path_factory.mktemp("orbax_ranks")
    return dryrun.launch("test_torch_mesh_ranks:orbax_ranks", 2, work, timeout=300,
                         env=env), str(work)


CASES = [(n, t) for n in ORBAX_MODELS for t in ("model2", "data2")]


@pytest.mark.parametrize("name,tag", CASES)
def test_sharded_restore_gives_each_rank_its_shard(ranks, name, tag):
    reports, _ = ranks
    for rank, rep in enumerate(reports):
        r = rep[f"{name}_{tag}"]
        assert r["shard_equal"] and r["reduce"] and r["cfg_whole"] and r["aabb"], (rank, r)
        assert r["loop"] == {"epoch": 1}
        assert r["files"] == [".metadata", "__0_0.distcp", "__1_0.distcp", "cfg.json",
                              "loop_state.json"], r["files"]
    r0 = reports[0][f"{name}_{tag}"]
    assert r0["whole_equal"] and r0["whole_aabb"] and r0["whole_loop"] == {"epoch": 1}


@pytest.mark.parametrize("name,tag", CASES)
def test_sharded_save_writes_each_leaf_once(ranks, name, tag):
    reports, workdir = ranks
    r = reports[0][f"{name}_{tag}"]
    path = os.path.join(workdir, f"{name}_{tag}")
    storage = dcp.FileSystemReader(path).read_metadata().storage_data
    if tag == "data2":
        # replicas along data: the one-process save's bytes, split over the ranks
        assert sum(r["distcp"].values()) == sum(r["one_distcp"].values())
        assert not any(any(idx.offset) for idx in storage)
        return
    # model 2: each rank's app slices in its own file; the rest whole, once
    sizes = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    app = {}
    for idx, info in storage.items():
        if idx.fqn.startswith(("params/app_planes/", "params/app_lines/")):
            app.setdefault(idx.fqn, {})[idx.offset[-1]] = info.relative_path
        else:
            assert not any(idx.offset), idx
    # vm's stacks hold app and density channels in one leaf: gathered, whole
    assert len(app) == {"vm_split": 6, "cp": 3, "vm": 0}[name]
    for fqn, chunks in app.items():
        half = sizes[fqn].size[-1] // 2
        assert chunks == {0: "__0_0.distcp", half: "__1_0.distcp"}, (fqn, chunks)


# -- (e) the trainer --------------------------------------------------------------


def _orbax_files(path):
    names = sorted(os.listdir(path))
    assert names[0] == ".metadata" and "cfg.json" in names and "loop_state.json" in names
    assert any(n.endswith(".distcp") for n in names), names


@pytest.fixture(scope="module")
def orbax_run(tmp_path_factory):
    """The port fit of tests/test_torch_resume.py with the orbax backend,
    each resume point kept as its directory and as an npz of the same
    field, with the snapshot."""
    root = tmp_path_factory.mktemp("orbax_fit")
    kept = root / "points"
    save0 = PC.save_orbax

    def save(path, field, aabb, *args, loop_state=None, **kw):
        save0(path, field, aabb, *args, loop_state=loop_state, **kw)
        if path.endswith("_resume"):
            d = kept / str(loop_state["epoch"])  # a later save of an epoch replaces it
            shutil.rmtree(d / "resume", ignore_errors=True)
            shutil.copytree(path, d / "resume")
            PC.save_checkpoint(str(d / "resume.npz"), field, aabb, loop_state=loop_state)
            shutil.copy(os.path.join(os.path.dirname(path), "scene_snapshot.npz"),
                        d / "scene_snapshot.npz")

    PC.save_orbax = save
    try:
        res, _, _ = _port_fit(root, root / "log", jitter=False,
                              schedule=dict(SCHEDULE, checkpoint_backend="orbax"))
    finally:
        PC.save_orbax = save0
    return root, res


def test_the_fit_writes_orbax_directories(orbax_run):
    root, res = orbax_run
    folder = res[4]
    assert sorted(os.listdir(root / "points")) == ["1", "2", "3", "4"]
    assert not os.path.exists(os.path.join(folder, f"{EXPNAME}_resume.npz"))
    for name in ("resume", "final"):
        _orbax_files(os.path.join(folder, f"{EXPNAME}_{name}"))
    cfg, field, aabb, loop = PC.load_orbax(os.path.join(folder, f"{EXPNAME}_final"),
                                           device="cpu")
    cfg_n, field_n, aabb_n, _, loop_n = PC.load_checkpoint(
        os.path.join(folder, f"{EXPNAME}_final.npz"), device="cpu")
    assert cfg.to_dict() == cfg_n.to_dict() and loop == loop_n
    assert set(loop) == {"view_idx", "global_step"}
    _assert_flat_equal(PC.params_to_jax(field), PC.params_to_jax(field_n))
    assert torch.equal(aabb, aabb_n)
    _assert_flat_equal(PC.params_to_jax(field), PC.params_to_jax(res[1]))
    # the snapshot tool reads a directory's loop state as JAX's tool does
    assert PRB._resume_next_view(folder) == jax_resume_next_view(folder) is not None


def _plant(point, basedir, orbax):
    folder = _logfolder(basedir)
    os.makedirs(folder)
    if orbax:
        shutil.copytree(os.path.join(point, "resume"), os.path.join(folder, f"{EXPNAME}_resume"))
    else:
        shutil.copy(os.path.join(point, "resume.npz"), os.path.join(folder,
                                                                    f"{EXPNAME}_resume.npz"))
    shutil.copy(os.path.join(point, "scene_snapshot.npz"),
                os.path.join(folder, "scene_snapshot.npz"))
    return folder


def _resumed(root, basedir, orbax, n_rows=0):
    """The fit resumed in ``basedir``: (sampler ids, per-step mse, rows)."""
    schedule = dict(SCHEDULE, checkpoint_backend="orbax" if orbax else "npz")
    with _Recorder(PTS.PermutationSampler) as rec:
        res, _, _ = _port_fit(root, basedir, jitter=False, schedule=schedule)
    rows = _rows(res[4])[n_rows:]
    return rec.ids, np.array([r["mse"] for r in rows if "mse" in r]), rows


def test_orbax_resume_takes_the_npz_resume_steps(orbax_run, monkeypatch):
    root = orbax_run[0]
    point = str(root / "points" / "2")  # mid stage 2
    _plant(point, root / "npz", orbax=False)
    ids_n, mse_n, rows_n = _resumed(root, root / "npz", orbax=False)

    # the orbax run dies in its first save, before the rename: the planted
    # point stays in force, and the rerun resumes from it
    folder = _plant(point, root / "orbax", orbax=True)
    resume = os.path.join(folder, f"{EXPNAME}_resume")

    def dying_replace(tmp, path):
        raise RuntimeError("simulated crash before the rename")

    monkeypatch.setattr(PC, "replace_dir", dying_replace)
    with pytest.raises(RuntimeError, match="before the rename"):
        _resumed(root, root / "orbax", orbax=True)
    monkeypatch.undo()
    assert PC.load_orbax(resume, device="cpu")[-1]["epoch"] == 2
    assert [n for n in os.listdir(folder) if n.startswith(f"{EXPNAME}_resume.tmp.")]
    ids_o, mse_o, rows_o = _resumed(root, root / "orbax", orbax=True,
                                    n_rows=len(_rows(folder)))
    assert len(ids_o) == len(ids_n) > 0 and len(mse_n) > 0
    for a, b in zip(ids_n, ids_o):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(mse_o, mse_n)
    for rows in (rows_n, rows_o):
        assert [r["resume_epoch"] for r in rows if "resume_epoch" in r] == [2]
        assert not any(k.startswith("phase/bootstrap") for r in rows for k in r)
    # the rerun's saves took the dead attempt's directory over; its last
    # point is the fit's last
    assert not [n for n in os.listdir(folder) if ".tmp." in n or ".old." in n]
    assert PC.load_orbax(resume, device="cpu")[-1]["epoch"] == 4
