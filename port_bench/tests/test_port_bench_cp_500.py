"""The TensorCP cell ``cp_500.render_view`` at a size the CPU runs (24³,
16² frames, seeded weights) through the render runner and its reference
comparison, and the readers of its two kernel shares on synthetic traces
and counters: nothing where there is nothing to read (no trace, no
counter, no configuration, no launch), a share in (0, 100] otherwise."""

import pytest

from port_bench.core import spec
from port_bench.core.trace import Trace
from port_bench.tests import tiny
from port_bench.tests.test_port_bench_readers import EVENTS, X

CELL = "cp_500.render_view"


def test_the_configuration_keeps_the_published_widths():
    cfg = spec.cell(spec.load_benchmark(), CELL)["config"]
    assert (cfg["model_name"], cfg["n_lamb_sigma"], cfg["n_lamb_sh"]) == ("cp", [96], [288])
    assert (cfg["shadingMode"], cfg["fea_pe"], cfg["view_pe"], cfg["app_dim"],
            cfg["featureC"]) == ("MLP_Fea", 2, 2, 27, 128)
    assert cfg["N_voxel"] == 500 ** 3 and cfg["reduced"] == []


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_at_small_size_is_correct(trace):
    c = tiny.cell(CELL)
    out = tiny.run(c, trace=trace)
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == {"frame_mean_gap"}
    for v in out["checks"].values():
        assert v["value"] <= v["limit"]
    if not trace:
        assert set(out["metrics"]) == {"render_rays_per_s", "render_frame_ms_p95", "setup_s"}
    else:
        # the CPU runs the plain head and kernel C's plain version: the
        # kernels' shares find nothing to read
        assert "render_mfu" in out["metrics"] and "idle.render" in out["metrics"]
        assert not {"Bview_roofline.render", "C_roofline.render"} & set(out["metrics"])


#: one traced frame's launches: kernel B's view mode 200 us, kernel C
#: twice 500 us, beside the readers' common events
VIEW_EVENTS = EVENTS + [
    X("kernel", "(anonymous namespace)::shade_view_kernel(float const*, ...)", 7, 860, 40),
    X("kernel", "void (anonymous namespace)::cp_features_walk_kernel<float>(...)", 7, 900, 30),
    X("kernel", "void (anonymous namespace)::cp_features_walk_kernel<float>(...)", 7, 940, 20),
]


@pytest.fixture
def counted(monkeypatch):
    from text2nerf_tpu_torch.engine import tracing

    c = {"head.view_samples": 1000, "cp.sigma_samples": 2000, "cp.app_samples": 1000}
    monkeypatch.setattr(tracing, "counts", lambda: dict(c))
    monkeypatch.setattr("sys.argv", ["port_bench/run.py", "--workload", CELL, "--seed", "1"])
    return c


def read(name, events=VIEW_EVENTS):
    return spec.reader(spec.BENCH_DIR, name)({"trace": Trace(events), "traced_units": 1})


def test_the_view_heads_share(counted):
    # 1000 rows of 2 * (150*128 + 128*128 + 128*3) operations at the TF32
    # peak over the mode's 40 us (its 120 B a row at 3.35 TB/s take less)
    flops = 2 * (150 * 128 + 128 * 128 + 128 * 3)
    share = read("Bview_roofline.render")
    assert share == pytest.approx(100 * 1000 * flops / 495e12 / 40e-6)
    assert 0 < share <= 100


def test_kernel_cs_share(counted):
    # bytes bound: coordinates of the larger count, a float a density
    # sample, 288 an app sample, the 2.3 MB of lines once a launch
    moved = 12 * 2000 + 4 * 2000 + 4 * 288 * 1000 + 2 * 4 * 3 * 500 * 384
    ops = 12 * 96 * 2000 + 11 * 288 * 1000
    assert moved / 3.35e12 > ops / 67e12
    share = read("C_roofline.render")
    assert share == pytest.approx(100 * moved / 3.35e12 / 50e-6)
    assert 0 < share <= 100


@pytest.mark.parametrize("name", ["Bview_roofline.render", "C_roofline.render"])
def test_nothing_to_read(name, counted, monkeypatch):
    from text2nerf_tpu_torch.engine import tracing

    assert read(name, EVENTS) is None  # no launch of the kernel
    assert spec.reader(spec.BENCH_DIR, name)({"trace": None, "traced_units": 1}) is None
    monkeypatch.setattr("sys.argv", ["pytest"])  # no cell's configuration
    assert read(name) is None
    monkeypatch.setattr("sys.argv", ["port_bench/run.py", "--workload", CELL])
    counted.clear()  # a program that counts neither
    assert read(name) is None
    monkeypatch.delattr(tracing, "counts")  # a program without counters
    assert read(name) is None
