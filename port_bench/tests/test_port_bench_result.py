"""A run's last line: its keys, the compared numbers beside their limits
(last in the line and on standard error), and no result without the
card."""

import io
import json
import math
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

from port_bench import run as RUN
from port_bench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", [tiny.DENSE_CELL, "vmsplit_300.train_compact",
                                      "vmsplit_300.render_view"])
@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line(workload, trace):
    c = tiny.cell(workload)
    out = tiny.run(c, trace=trace)
    assert list(out)[: len(KEYS)] == KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = c["per_layer"] if trace else c["end_to_end"]
    assert set(out["metrics"]) <= {m["name"] for m in want}
    if not trace:
        assert set(out["metrics"]) == {m["name"] for m in want}
        assert all(v["value"] > 0 for v in out["metrics"].values())
    else:
        assert "window_s" in out["device"] and "busy_s" in out["device"]
        assert len(out["breakdown"]["device_ops"]) <= 10
        assert len(out["breakdown"]["idle_gaps"]) <= 10
    assert set(out["checks"]) == set(c["limits"]["limits"])
    for v in out["checks"].values():
        assert math.isfinite(v["value"]) and v["value"] <= v["limit"]

    err, std = io.StringIO(), io.StringIO()
    with redirect_stderr(err), redirect_stdout(std):
        RUN.report(out)
    assert json.loads(std.getvalue().strip().splitlines()[-1]) == json.loads(json.dumps(out))
    tail = err.getvalue().strip().splitlines()[-len(out["checks"]):]
    assert [line.split()[1] for line in tail] == list(out["checks"])


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert RUN.main(["--workload", "vmsplit_300.train_compact", "--seed", str(2 ** 32 + 5),
                     "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_names():
    assert RUN.forbidden_modules(["text2nerf_tpu_torch.ops", "torch", "numpy"]) == []
    assert RUN.forbidden_modules(["text2nerf_tpu.ops.render", "jaxlib.xla", "jaxtyping"]) \
        == ["jaxlib", "text2nerf_tpu"]
    assert RUN.forbidden_modules(["flax", "jax"]) == ["flax", "jax"]
