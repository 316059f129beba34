"""A kernel's share of its roofline in a traced window: the least time of
its launches there over their device time."""

from __future__ import annotations


def share(ctx, kernel):
    """``kernel``: a module with ``KERNEL`` (a fragment of the device
    kernels' names) and ``launch_least_s(xn, channels, grads, shapes)``.
    The launches of one traced step are ``ctx['launches']`` ((xn,
    channels, grads) each); the traced window holds ``ctx['traced_units']``
    steps.  Only the kernel's own device time counts, not the memsets or
    copies its launcher issues beside it.  None when the trace holds no
    such kernel."""
    trace, launches = ctx.get("trace"), ctx.get("launches")
    if trace is None or not launches:
        return None
    device_s = sum(d["end"] - d["ts"] for d in trace.in_window()
                   if d["cat"] == "kernel" and kernel.KERNEL in d["name"]) * 1e-6
    if device_s <= 0:
        return None
    least = sum(kernel.launch_least_s(xn, ch, g, ctx["shapes"]) for xn, ch, g in launches)
    return 100.0 * least * ctx["traced_units"] / device_s
