"""Device milliseconds a traced frame of the operations launched inside
an escalation group (``t2n.view.escalate``, at any depth): the ladder's
second pass."""

from port_bench.core.spans import launched_ms


def read(ctx):
    return launched_ms(ctx, "t2n.view.escalate", "t2n.view")
