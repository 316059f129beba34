"""Device-idle milliseconds a traced frame of the gaps that open while
the host is inside a base-rung chunk (``t2n.view.base``) or an
escalation group (``t2n.view.escalate``), at any depth: the frame's
launch gaps."""

from port_bench.core.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, ("t2n.view.base", "t2n.view.escalate"), "t2n.view")
