"""Device-idle milliseconds a traced frame of the gaps that open while
the host is inside the escalation readback and its host work
(``t2n.view.need``) or the frame's copy to the host (``t2n.view.out``):
the frame's sync gaps."""

from port_bench.core.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, ("t2n.view.need", "t2n.view.out"), "t2n.view")
