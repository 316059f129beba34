"""Device milliseconds a frame spends outside the feature gathers (kernel
A), the eval head (kernel B) and the basis products (GEMMs): the march,
the occupancy test, the first-K sort, compositing and the escalation
bookkeeping, per traced frame.  (The eval path has no ``t2n.*`` ranges, so
the kernels are told apart by name.)"""

OTHER = ("factor_features", "shade_kernel", "gemm", "gemv")


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    us = sum(d["end"] - d["ts"] for d in trace.in_window()
             if d["cat"] == "kernel" and not any(f in d["name"] for f in OTHER))
    return us / 1e3 / ctx["traced_units"] if us > 0 else None
