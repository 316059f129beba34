"""Device-idle milliseconds a traced step of the gaps that open while the
host is inside the trainer's batch source (``t2n.batch``: the gather
and the copy to the device)."""

from port_bench.core.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, ("t2n.batch",), "t2n.batch")
