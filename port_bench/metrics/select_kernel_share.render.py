"""Share of the traced frames' compacted-eval rays whose prepass (march,
occupancy, first-K selection, escalation rung) ran as the program's
kernel: ``select.kernel_rays`` over it plus ``select.plain_rays``, in
percent."""

from port_bench.core.spans import counters


def read(ctx):
    if ctx.get("trace") is None:
        return None
    c = counters()
    kernel, plain = c.get("select.kernel_rays", 0), c.get("select.plain_rays", 0)
    return 100.0 * kernel / (kernel + plain) if kernel + plain else None
