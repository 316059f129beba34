"""The harness finds every cell from its data files, and takes a new
configuration, traffic mix and metric as new files alone."""

import json
import re
import shutil

import pytest

from port_bench.core import spec
from port_bench.tests import tiny

BENCH = spec.load_benchmark()
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_resolves_from_its_files(workload):
    c = spec.cell(BENCH, workload)
    assert c["traffic"]["kind"] in ("train", "render")
    assert c["config"]["name"] == c["entry"]["config"]
    assert c["limits"]["limits"], "a cell compares at least one number"
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"], "a cell reports at least one per-layer metric"
    for m in c["per_layer"]:
        assert callable(spec.reader(c["bench_dir"], m["name"]))
        assert m["moves"] in names


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_benchmark_json_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert c["file"].startswith("port_bench/") and c["reduced"] == []
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) == 0
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        for x in BENCH[k]:
            assert NAME.match(x["name"]), x["name"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and _line(w["why"])
    for c in BENCH["configs"]:
        assert _line(c["why"]) and _line(c["source"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])
    assert all(_line(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"trainer loop", "train step", "renderer", "kernels", "device"}


def test_a_new_cell_is_new_files_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = dict(BENCH)
    before = {p.relative_to(root): p.read_bytes() for p in (root / "port_bench").rglob("*")
              if p.is_file()}
    # a new configuration, traffic mix, limits and metric, as a later change adds them
    cfg = json.loads((root / "port_bench/configs/vmsplit_300.json").read_text())
    cfg.update(tiny.CP, name="cp_200")
    cfg["N_voxel"] = 8_000_000
    (root / "port_bench/configs/cp_200.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "port_bench/traffic/render_view.json").read_text())
    traffic["render"]["feature_dtype"] = "bf16"
    (root / "port_bench/traffic/render_bf16.json").write_text(json.dumps(traffic))
    (root / "port_bench/limits/cp_200.render_bf16.json").write_text(
        json.dumps({"limits": {"rgb_mean_gap": 1e-3}}))
    (root / "port_bench/metrics/frames_seen.render.py").write_text(
        "def read(ctx):\n    return len(ctx.get('frames') or []) or None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "cp_200", "source": "x", "file": "port_bench/configs/cp_200.json",
                             "reduced": ["N_voxel"], "why": "x"})
    bench["workloads"].append({"name": "cp_200.render_bf16", "config": "cp_200",
                               "traffic": "render_bf16", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "frames_seen.render", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "renderer",
                               "moves": "render_rays_per_s", "workloads": ["cp_200.render_bf16"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("render_rays_per_s", "render_frame_ms_p95"):
            m["workloads"].append("cp_200.render_bf16")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.cell(spec.load_benchmark(root), "cp_200.render_bf16", root)
    assert c["config"]["N_voxel"] == 8_000_000
    assert c["traffic"]["render"]["feature_dtype"] == "bf16"
    assert [m["name"] for m in c["per_layer"]][-1] == "frames_seen.render"
    assert spec.reader(c["bench_dir"], "frames_seen.render")({"frames": [1, 2]}) == 2
    after = {p.relative_to(root): p.read_bytes() for p in (root / "port_bench").rglob("*")
             if p.is_file() and p.relative_to(root) in before}
    assert after == before, "no file the benchmark had was edited"


def test_an_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec.cell(BENCH, "no_such.cell")
