"""Kernel C's share of its roofline in the traced frames: the least time
of its eval launches' samples (the program's ``cp.sigma_samples`` and
``cp.app_samples`` counters, ``roofline/C.py``) over the device time of
its launches there, in percent."""

from port_bench.core.spans import counters
from port_bench.roofline import C
from port_bench.roofline.B import run_config


def read(ctx):
    trace, cfg = ctx.get("trace"), run_config()
    c = counters()
    sigma, app = c.get("cp.sigma_samples", 0), c.get("cp.app_samples", 0)
    if trace is None or cfg is None or not (sigma or app):
        return None
    launches = [d for d in trace.in_window()
                if d["cat"] == "kernel" and C.KERNEL in d["name"]]
    device_s = sum(d["end"] - d["ts"] for d in launches) * 1e-6
    if device_s <= 0:
        return None
    return 100.0 * C.least_s_of(cfg, sigma, app, len(launches)) / device_s
