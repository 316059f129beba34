"""The whole train step's share of the chip's peak: the least time of the
arithmetic the window's steps need (``roofline/train_step.py``) over the
window's time, in percent."""


def read(ctx):
    least = ctx.get("least_step_s")
    if not least or not ctx.get("window_s"):
        return None
    return 100.0 * least * ctx["units"] / ctx["window_s"]
