"""The whole frame's share of the chip's peak: the least time of the
arithmetic the window's frames need, from the reference's live-sample
counts of each pose (``roofline/render_frame.py``), over the frames'
time, in percent."""


def read(ctx):
    least = ctx.get("frame_least_s")
    frames = ctx.get("frames")
    if not least or not frames:
        return None
    return 100.0 * sum(least[pose] for pose, _ in frames) / sum(s for _, s in frames)
