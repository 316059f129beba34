"""Device milliseconds a train step spends in the shading head: every
device operation launched inside the program's ``t2n.head`` range, and
inside the autograd backward of an operation launched there, per traced
step."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    us = sum(d["end"] - d["ts"] for d in trace.in_window()
             if trace.layer_of(d) in ("t2n.head", "t2n.head backward"))
    return us / 1e3 / ctx["traced_units"] if us > 0 else None
