"""The device trace of a short traced window, and its reduction.

:func:`capture` runs a function under ``torch.profiler`` inside the
range :data:`WINDOW`, writes the Chrome trace into a temporary directory
and reads it back as a :class:`Trace`.  A device operation (kernel, copy,
memset) is tied to the host by the correlation id of its launch, and
belongs to a layer by the ranges of the program around that launch
(``t2n.select``, ``t2n.features``, ``t2n.head``, ``t2n.composite``,
``t2n.loss``, ``t2n.reg``, ``Optimizer.step``): a launch inside an
autograd backward function belongs to the range around the forward
operation with the same sequence number, as that range's backward.  This
counts every device operation, linked to a host operation or not: what
has no launch, or no range, is counted as unattributed.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
RANGES = ("t2n.", "Optimizer.step")
BACKWARD = "autograd::engine::evaluate_function"


class _Intervals:
    """Host ranges of one thread, for the innermost range around a time."""

    def __init__(self, items):
        self.items = sorted(items, key=lambda e: e[0])
        self.starts = [e[0] for e in self.items]

    def innermost(self, ts):
        i = bisect.bisect_right(self.starts, ts) - 1
        while i >= 0:
            start, end, payload = self.items[i]
            if end >= ts:
                return payload
            i -= 1
        return None


class Trace:
    """Device operations, host ranges and launches of one traced window."""

    def __init__(self, events):
        self.device, self.launch, host = [], {}, defaultdict(list)
        backward, forward_seq, ops, window = defaultdict(list), {}, defaultdict(list), None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, args = e.get("cat"), e.get("args") or {}
            ts, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                self.device.append({"name": e["name"], "cat": cat, "ts": ts, "end": end,
                                    "corr": args.get("correlation")})
            elif cat in LAUNCH_CATS:
                if "correlation" in args:
                    self.launch[args["correlation"]] = (e["tid"], ts, e["name"])
                ops[e["tid"]].append((ts, end, e["name"]))
            elif cat in ("cpu_op", "user_annotation"):
                name = e["name"]
                if name == WINDOW and cat == "user_annotation":
                    window = (ts, end)
                elif name.startswith(BACKWARD):
                    backward[e["tid"]].append((ts, end, args.get("Sequence number")))
                elif name.startswith(RANGES):
                    host[e["tid"]].append((ts, end, name))
                if cat == "cpu_op" and not name.startswith(BACKWARD) \
                        and args.get("Sequence number", -1) >= 0:
                    forward_seq.setdefault(args["Sequence number"], []).append((e["tid"], ts))
                ops[e["tid"]].append((ts, end, name))
        self.window = window
        self.ranges = {t: _Intervals(v) for t, v in host.items()}
        self.backward = {t: _Intervals(v) for t, v in backward.items()}
        # a forward op is one outside every backward function
        self.forward = {}
        for seq, items in forward_seq.items():
            for tid, ts in items:
                bw = self.backward.get(tid)
                if bw is None or bw.innermost(ts) is None:
                    self.forward[seq] = (tid, ts)
                    break
        self.ops = {t: _Intervals(v) for t, v in ops.items()}

    # -- the window ---------------------------------------------------------

    def in_window(self):
        lo, hi = self.window
        return [d for d in self.device if d["end"] > lo and d["ts"] < hi]

    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def busy_us(self) -> float:
        """Time in the window in which some device operation ran."""
        lo, hi = self.window
        spans = sorted((max(d["ts"], lo), min(d["end"], hi)) for d in self.in_window())
        busy, cur_s, cur_e = 0.0, None, None
        for s, e in spans:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    # -- attribution --------------------------------------------------------

    def _range_at(self, tid, ts):
        iv = self.ranges.get(tid)
        return iv.innermost(ts) if iv is not None else None

    def layer_of(self, op) -> str:
        """The range an operation's launch lies in ('<range> backward' for a
        launch in an autograd backward function), or 'unattributed'."""
        launch = self.launch.get(op["corr"])
        if launch is None:
            return "unattributed"
        tid, ts, _ = launch
        bw = self.backward.get(tid)
        seq = bw.innermost(ts) if bw is not None else None
        if seq is not None:
            fwd = self.forward.get(seq)
            name = self._range_at(*fwd) if fwd is not None else None
            return f"{name} backward" if name else "unattributed backward"
        return self._range_at(tid, ts) or "unattributed"

    def host_op_at(self, ts):
        """The innermost host operation running at ``ts`` on any thread (the
        latest started), or 'host idle'."""
        best = None
        for iv in self.ops.values():
            i = bisect.bisect_right(iv.starts, ts) - 1
            while i >= 0:
                s, e, name = iv.items[i]
                if e >= ts:
                    if best is None or s > best[0]:
                        best = (s, name)
                    break
                i -= 1
        return best[1] if best else "host idle"

    def idle_gaps(self):
        """[(what the host was doing when the device fell idle, us)] of every
        gap between device operations in the window."""
        lo, hi = self.window
        spans = sorted((max(d["ts"], lo), min(d["end"], hi)) for d in self.in_window())
        gaps, t = [], lo
        for s, e in spans:
            if s > t:
                gaps.append((self.host_op_at(t), s - t))
            t = max(t, e)
        if hi > t:
            gaps.append((self.host_op_at(t), hi - t))
        return gaps


def capture(fn, device_sync):
    """Runs ``fn()`` under the profiler inside :data:`WINDOW` (``device_sync``
    before and after) and returns (``fn``'s result, :class:`Trace`, seconds
    the trace took to write and read)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        device_sync()
        with record_function(WINDOW):
            out = fn()
            device_sync()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return out, Trace(events), time.perf_counter() - t0


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps by what the host was doing, in seconds."""
    ops = defaultdict(float)
    for d in trace.in_window():
        ops[d["name"]] += (d["end"] - d["ts"]) * 1e-6
    gaps = defaultdict(float)
    for name, us in trace.idle_gaps():
        gaps[name] += us * 1e-6
    first = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    longest = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in first], "idle_gaps": [[k, v] for k, v in longest]}
