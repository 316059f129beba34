"""The program's ``t2n.*`` spans in a traced window, and what opens or
launches inside them.

The spans are the program's own ``torch.profiler`` ranges
(``text2nerf_tpu_torch.engine.tracing.span``), read from
:attr:`Trace.ranges`, on the device trace's clock.  An instant lies
inside every span around it, on any thread and at any depth.  A device
idle gap opens at the instant the device falls idle, as
:meth:`Trace.idle_gaps` takes it; an operation is launched at its launch
call on the host.  The program's counters of the traced window come from
``engine.tracing.counts``.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

PREFIX = "t2n."


class Spans:
    """The time each ``t2n.*`` span name covers, merged over threads."""

    def __init__(self, trace):
        by_name = defaultdict(list)
        for iv in trace.ranges.values():
            for start, end, name in iv.items:
                if name.startswith(PREFIX):
                    by_name[name].append((start, end))
        self._covered = {}
        for name, items in by_name.items():
            merged = []
            for start, end in sorted(items):
                if merged and start <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], end)
                else:
                    merged.append([start, end])
            self._covered[name] = ([s for s, _ in merged], [e for _, e in merged])

    def names(self) -> set:
        return set(self._covered)

    def around(self, ts) -> set:
        """The names of the spans around the instant ``ts``."""
        out = set()
        for name, (starts, ends) in self._covered.items():
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ends[i] >= ts:
                out.add(name)
        return out


def idle_gaps(trace):
    """[(the instant the device fell idle, us)] of every gap between device
    operations in the window, as :meth:`Trace.idle_gaps` finds them."""
    lo, hi = trace.window
    busy = sorted((max(d["ts"], lo), min(d["end"], hi)) for d in trace.in_window())
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s - t))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi - t))
    return gaps


def _spans(ctx, marker):
    """The window's spans, or None where the trace holds no ``marker`` span
    (a program without these spans)."""
    trace = ctx.get("trace")
    if trace is None or trace.window is None:
        return None
    spans = Spans(trace)
    return spans if marker in spans.names() else None


def idle_ms(ctx, opening, marker):
    """Device-idle ms a traced unit of the gaps that open inside any span
    named in ``opening``; None without a ``marker`` span."""
    spans = _spans(ctx, marker)
    if spans is None:
        return None
    opening = set(opening)
    us = sum(g for t, g in idle_gaps(ctx["trace"]) if spans.around(t) & opening)
    return us / 1e3 / ctx["traced_units"]


def launched_ms(ctx, inside, marker):
    """Device ms a traced unit of the operations launched inside a span
    named ``inside``; None without a ``marker`` span."""
    spans = _spans(ctx, marker)
    if spans is None:
        return None
    trace = ctx["trace"]
    us = 0.0
    for d in trace.in_window():
        launch = trace.launch.get(d["corr"])
        if launch is not None and inside in spans.around(launch[1]):
            us += d["end"] - d["ts"]
    return us / 1e3 / ctx["traced_units"]


def counters() -> dict:
    """The program's counters (``engine.tracing.counts()``), or {} where
    the program has none."""
    try:
        from text2nerf_tpu_torch.engine import tracing
    except ImportError:
        return {}
    read = getattr(tracing, "counts", None)
    return read() if read is not None else {}
