"""Share of the traced frames' rays that the ladder re-rendered at a
higher rung (the program's ``view.rays_escalated`` over ``view.rays``),
in percent."""

from port_bench.core.spans import counters


def read(ctx):
    if ctx.get("trace") is None:
        return None
    c = counters()
    rays = c.get("view.rays")
    return 100.0 * c.get("view.rays_escalated", 0) / rays if rays else None
