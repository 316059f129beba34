"""Kernel A''s share of its roofline in the traced train steps: the least
time of one step's launches (``roofline/A_bwd.py``, from the first
step's samples) times the traced steps, over the device time of the
kernel's launches there, in percent."""

from port_bench.roofline import A_bwd as K
from port_bench.roofline.kernel import share


def read(ctx):
    return share(ctx, K)
