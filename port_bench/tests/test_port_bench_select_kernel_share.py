"""The reader of ``select_kernel_share.render`` takes the program's
``select.kernel_rays`` and ``select.plain_rays`` counters of the traced
window: 100 where every ray took the kernel, the kernel's share of mixed
counts, and nothing with no counter or no trace (a program without the
kernel route)."""

import pytest

from port_bench.core import spec
from port_bench.core.trace import Trace
from port_bench.tests.test_port_bench_readers import EVENTS

NAME = "select_kernel_share.render"


def _read(counts, monkeypatch, trace=True):
    from text2nerf_tpu_torch.engine import tracing

    monkeypatch.setattr(tracing, "counts", lambda: dict(counts))
    ctx = {"trace": Trace(EVENTS) if trace else None, "traced_units": 1}
    return spec.reader(spec.BENCH_DIR, NAME)(ctx)


@pytest.mark.parametrize("counts,share", [
    ({"select.kernel_rays": 262144, "view.rays": 262144}, 100.0),
    ({"select.kernel_rays": 300, "select.plain_rays": 100}, 75.0),
    ({"select.plain_rays": 50}, 0.0),
])
def test_the_kernel_share_of_the_selected_rays(counts, share, monkeypatch):
    assert _read(counts, monkeypatch) == pytest.approx(share)


def test_nothing_to_read_without_the_counters_or_a_trace(monkeypatch):
    assert _read({"view.rays": 400, "head.samples": 1000}, monkeypatch) is None
    assert _read({"select.kernel_rays": 300}, monkeypatch, trace=False) is None
    from text2nerf_tpu_torch.engine import tracing

    monkeypatch.delattr(tracing, "counts")
    assert spec.reader(spec.BENCH_DIR, NAME)({"trace": Trace(EVENTS), "traced_units": 1}) is None
