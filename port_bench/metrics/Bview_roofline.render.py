"""Kernel B's view-dependent mode's share of its roofline in the traced
frames: the least time of the rows the program handed it (its
``head.view_samples`` counter, ``roofline/Bview.py``) over the device time
of its launches, in percent."""

from port_bench.core.spans import counters
from port_bench.roofline import Bview
from port_bench.roofline.B import run_config


def read(ctx):
    trace, cfg = ctx.get("trace"), run_config()
    rows = counters().get("head.view_samples")
    if trace is None or cfg is None or not rows:
        return None
    device_s = sum(d["end"] - d["ts"] for d in trace.in_window()
                   if d["cat"] == "kernel" and Bview.KERNEL in d["name"]) * 1e-6
    return 100.0 * Bview.rows_least_s(cfg, rows) / device_s if device_s > 0 else None
