"""The readers of the program's spans and counters take their numbers from
a small synthetic trace and count dict, and return nothing when the
spans or counters are not there (a program without them)."""

import pytest

from port_bench.core import spans as S
from port_bench.core import spec
from port_bench.core.trace import Trace
from port_bench.tests.test_port_bench_readers import EVENTS, X

# One traced frame on host thread 1, device stream 7.  Device operations
# run 100-150 (launched in base), 300-320 (launched in base, inside
# t2n.select), 450-460 (the readback, in need), 700-760 and 800-900
# (launched in escalate, the second inside t2n.head) and 1300-1310 (the
# copy out).  The gaps open at 0 (no span yet), 150 (base, inside
# t2n.select: any depth), 320 (base), 460 (need), 760 (escalate, inside
# t2n.head), 900 and 1310 (out).
VIEW = [
    X("user_annotation", "bench.window", 1, 0, 1500),
    X("user_annotation", "t2n.view", 1, 10, 1480),
    X("user_annotation", "t2n.view.base", 1, 20, 380),
    X("user_annotation", "t2n.select", 1, 30, 250),
    X("cuda_runtime", "cudaLaunchKernel", 1, 40, 5, correlation=1),
    X("cuda_runtime", "cudaLaunchKernel", 1, 250, 5, correlation=2),
    X("user_annotation", "t2n.view.need", 1, 400, 300),
    X("cuda_runtime", "cudaMemcpyAsync", 1, 440, 5, correlation=6),
    X("user_annotation", "t2n.view.escalate", 1, 700, 190),
    X("cuda_runtime", "cudaLaunchKernel", 1, 705, 5, correlation=3),
    X("user_annotation", "t2n.head", 1, 750, 100),
    X("cuda_runtime", "cudaLaunchKernel", 1, 760, 5, correlation=4),
    X("user_annotation", "t2n.view.out", 1, 895, 505),
    X("cuda_runtime", "cudaMemcpyAsync", 1, 1290, 5, correlation=5),
    X("kernel", "factor_features_walk_kernel", 7, 100, 50, correlation=1),
    X("kernel", "radixSortKernel", 7, 300, 20, correlation=2),
    X("gpu_memcpy", "Memcpy DtoH", 7, 450, 10, correlation=6),
    X("kernel", "shade_kernel_float", 7, 700, 60, correlation=3),
    X("kernel", "shade_kernel_float", 7, 800, 100, correlation=4),
    X("gpu_memcpy", "Memcpy DtoH", 7, 1300, 10, correlation=5),
]

# Two traced steps: batch 0-100 and 500-600 (the copy 50-60, 550-560),
# step 100-450 and 600-950, each with one kernel launched in its
# sub-batch (200-300, 700-800) and Adam's (400-420, 900-920).
TRAIN = [X("user_annotation", "bench.window", 1, 0, 1000)]
for t0, c in ((0, 10), (500, 20)):
    TRAIN += [
        X("user_annotation", "t2n.batch", 1, t0, 100),
        X("cuda_runtime", "cudaMemcpyAsync", 1, t0 + 10, 5, correlation=c),
        X("gpu_memcpy", "Memcpy HtoD", 7, t0 + 50, 10, correlation=c),
        X("user_annotation", "t2n.step", 1, t0 + 100, 350),
        X("user_annotation", "t2n.subbatch", 1, t0 + 110, 250),
        X("cuda_runtime", "cudaLaunchKernel", 1, t0 + 120, 5, correlation=c + 1),
        X("kernel", "sgemm", 7, t0 + 200, 100, correlation=c + 1),
        X("cpu_op", "Optimizer.step#Adam.step", 1, t0 + 380, 60),
        X("cuda_runtime", "cudaLaunchKernel", 1, t0 + 390, 5, correlation=c + 2),
        X("kernel", "multi_tensor_apply_kernel", 7, t0 + 400, 20, correlation=c + 2),
    ]


def read(name, ctx):
    return spec.reader(spec.BENCH_DIR, name)(ctx)


@pytest.fixture
def view():
    return {"trace": Trace(VIEW), "traced_units": 1}


@pytest.fixture
def counted(monkeypatch):
    from text2nerf_tpu_torch.engine import tracing

    c = {"view.rays": 400, "view.rays_escalated": 30, "head.samples": 1000}
    monkeypatch.setattr(tracing, "counts", lambda: dict(c))
    monkeypatch.setattr("sys.argv", ["port_bench/run.py", "--workload",
                                     "vmsplit_300.render_view", "--seed", "1"])
    return c


def test_spans_around_an_instant():
    spans = S.Spans(Trace(VIEW))
    assert spans.around(150) == {"t2n.view", "t2n.view.base", "t2n.select"}
    assert spans.around(900) == {"t2n.view", "t2n.view.out"}
    assert spans.around(5) == set()
    trace = Trace(VIEW)
    assert [g for _, g in S.idle_gaps(trace)] == [us for _, us in trace.idle_gaps()]
    assert [t for t, _ in S.idle_gaps(trace)] == [0, 150, 320, 460, 760, 900, 1310]


def test_render_span_readers(view):
    # launch gaps: 150-300 (inside t2n.select, at depth), 320-450, 760-800
    assert read("idle_issue_ms.render", view) == pytest.approx((150 + 130 + 40) / 1e3)
    # sync gaps: 460-700 (need), 900-1300 and 1310-1500 (out)
    assert read("idle_sync_ms.render", view) == pytest.approx((240 + 400 + 190) / 1e3)
    # both kernels launched in escalate, the second inside t2n.head
    assert read("escalate_ms.render", view) == pytest.approx((60 + 100) / 1e3)
    view["traced_units"] = 2
    assert read("escalate_ms.render", view) == pytest.approx((60 + 100) / 2e3)


def test_render_idle_readers_within_the_idle_share(view):
    trace = view["trace"]
    idle_ms = (trace.window_us() - trace.busy_us()) / 1e3
    assert read("idle_issue_ms.render", view) + read("idle_sync_ms.render", view) <= idle_ms


def test_render_counter_readers(view, counted):
    assert read("escalated_share.render", view) == pytest.approx(100 * 30 / 400)
    # vmsplit_300's head: 27 + 2 * 6 * 27 inputs, 128 wide, 3 out; 1000
    # rows at the TF32 peak over kernel B's 160 us
    flops = 2 * (351 * 128 + 128 * 128 + 128 * 3)
    assert read("B_roofline.render", view) == pytest.approx(
        100 * 1000 * flops / 495e12 / 160e-6)


def test_train_span_readers():
    ctx = {"trace": Trace(TRAIN), "traced_units": 2}
    # gaps, by their opening instant: 0 (batch) 50, 60 (batch) 140, 300
    # (step, inside its sub-batch) 100, 420 (step) 130, 560 (batch) 140,
    # 800 (step) 100, 920 (step) 80
    assert read("idle_batch_ms.train", ctx) == pytest.approx((50 + 140 + 140) / 2e3)
    assert read("idle_step_ms.train", ctx) == pytest.approx((100 + 130 + 100 + 80) / 2e3)


@pytest.mark.parametrize("name", ["idle_issue_ms.render", "idle_sync_ms.render",
                                  "escalate_ms.render", "idle_batch_ms.train",
                                  "idle_step_ms.train"])
def test_span_readers_without_the_spans(name):
    assert read(name, {"trace": Trace(EVENTS), "traced_units": 1}) is None
    assert read(name, {"trace": None, "traced_units": 1}) is None


def test_counter_readers_without_the_counters(view, counted, monkeypatch):
    from text2nerf_tpu_torch.engine import tracing

    assert read("B_roofline.render", {"trace": Trace(EVENTS), "traced_units": 1}) is None
    counted.clear()
    assert read("escalated_share.render", view) is None
    assert read("B_roofline.render", view) is None
    monkeypatch.delattr(tracing, "counts")
    assert S.counters() == {}
    assert read("escalated_share.render", view) is None
    monkeypatch.setattr("sys.argv", ["pytest"])
    assert read("B_roofline.render", view) is None


def test_head_ms_keeps_its_reading_inside_a_step_span():
    ctx = {"traced_units": 2}
    before = read("head_ms.train", dict(ctx, trace=Trace(EVENTS)))
    wrapped = EVENTS + [X("user_annotation", "t2n.step", 1, 50, 800),
                        X("user_annotation", "t2n.subbatch", 2, 480, 100)]
    assert read("head_ms.train", dict(ctx, trace=Trace(wrapped))) == before
    assert before == pytest.approx((50 + 30) / 1e3 / 2)
