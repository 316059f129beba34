"""Share of the traced window in which no kernel, copy or memset ran on
the device, in percent."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not trace.window_us():
        return None
    return 100.0 * (1.0 - trace.busy_us() / trace.window_us())
