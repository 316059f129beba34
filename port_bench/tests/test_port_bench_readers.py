"""Each per-layer metric's reader takes its number from a small synthetic
trace (or span, or count), and returns nothing when there is nothing to
read."""

import types

import pytest

from port_bench.core import spec
from port_bench.core.trace import Trace, breakdown
from port_bench.roofline.kernel import share


def X(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "tid": tid, "ts": ts, "dur": dur, "args": args}


EVENTS = [
    X("user_annotation", "bench.window", 1, 0, 1000),
    X("user_annotation", "t2n.head", 1, 100, 100),
    X("cpu_op", "aten::mm", 1, 110, 20, **{"Sequence number": 5}),
    X("cuda_runtime", "cudaLaunchKernel", 1, 115, 5, correlation=1),
    X("kernel", "sgemm_x", 7, 200, 50, correlation=1),
    X("user_annotation", "t2n.select", 1, 300, 50),
    X("cuda_runtime", "cudaLaunchKernel", 1, 310, 5, correlation=3),
    X("kernel", "radixSortKernel", 7, 400, 40, correlation=3),
    X("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 2, 500, 50,
      **{"Sequence number": 5}),
    X("cuda_runtime", "cudaLaunchKernel", 2, 510, 5, correlation=2),
    X("kernel", "sgemm_y", 7, 600, 30, correlation=2),
    X("kernel", "factor_features_bwd_walk_kernel", 7, 700, 100, correlation=99),
    X("gpu_memset", "Memset (Device)", 7, 850, 10),
]


@pytest.fixture
def trace():
    return Trace(EVENTS)


def read(name, ctx):
    return spec.reader(spec.BENCH_DIR, name)(ctx)


def test_trace_attribution_and_busy_time(trace):
    layers = {d["name"]: trace.layer_of(d) for d in trace.in_window()}
    assert layers["sgemm_x"] == "t2n.head"
    assert layers["sgemm_y"] == "t2n.head backward"
    assert layers["radixSortKernel"] == "t2n.select"
    assert layers["factor_features_bwd_walk_kernel"] == "unattributed"
    assert trace.busy_us() == pytest.approx(50 + 40 + 30 + 100 + 10)
    assert trace.window_us() == 1000
    b = breakdown(trace)
    assert b["device_ops"][0] == ["factor_features_bwd_walk_kernel", pytest.approx(100e-6)]
    assert len(b["idle_gaps"]) <= 10
    assert sum(s for _, s in b["idle_gaps"]) == pytest.approx((1000 - 230) * 1e-6)


def test_device_readers(trace):
    ctx = {"trace": trace, "traced_units": 2}
    assert read("head_ms.train", ctx) == pytest.approx((50 + 30) / 1e3 / 2)
    assert read("select_ms.render", ctx) == pytest.approx(40 / 1e3 / 2)
    assert read("idle.train", ctx) == pytest.approx(100 * (1 - 230 / 1000))
    assert read("idle.render", ctx) == pytest.approx(100 * (1 - 230 / 1000))


def test_kernel_roofline_share(trace):
    stub = types.SimpleNamespace(KERNEL="factor_features_bwd",
                                 launch_least_s=lambda xn, ch, g, shapes: 10e-6)
    ctx = {"trace": trace, "traced_units": 2, "launches": [(None, None, 1)] * 3, "shapes": {}}
    assert share(ctx, stub) == pytest.approx(100 * 3 * 10e-6 * 2 / 100e-6)
    stub.KERNEL = "cp_features_bwd"
    assert share(ctx, stub) is None


def test_host_readers():
    assert read("batch_ms.train", {"batch_s": [0.002, 0.004]}) == pytest.approx(3.0)
    assert read("train_mfu", {"least_step_s": 0.001, "units": 30, "window_s": 10.0}) \
        == pytest.approx(0.3)
    ctx = {"frame_least_s": {0: 0.002, 1: 0.004}, "frames": [(0, 0.05), (1, 0.05), (0, 0.1)]}
    assert read("render_mfu", ctx) == pytest.approx(100 * 0.008 / 0.2)


@pytest.mark.parametrize("name", [m["name"] for m in spec.load_benchmark()["per_layer"]])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    assert read(name, {"trace": None, "traced_units": 1}) is None
