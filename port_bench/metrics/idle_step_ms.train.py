"""Device-idle milliseconds a traced step of the gaps that open while the
host is inside the train step (``t2n.step``, its optimizer step
included)."""

from port_bench.core.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, ("t2n.step",), "t2n.step")
