"""One run of one cell: set-up, the measured window, the traced window
(``--trace 1``), the comparison with the reference, and the result."""

from __future__ import annotations

import time

import numpy as np
import torch

from ..reference import field as F
from ..reference import render as RR
from ..roofline import render_frame, train_step
from . import render_cell, spec, train_cell
from . import trace as T

CELLS = {"train": train_cell.TrainCell, "render": render_cell.RenderCell}
#: every how many pixel rows and columns the live samples of a pose are counted
COUNT_STRIDE = 4


def _sync(dev):
    return torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)


def drive(cell, seed: int, seconds: float, trace: bool, dev, t0: float):
    """Runs the cell once; returns the result dict (the result line's keys,
    and 'checks' with each compared number and its limit).  ``t0``: the
    process's start on the host clock (set-up counts from there)."""
    sync = _sync(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = cell["traffic"]["kind"]
    c = CELLS[kind](cell, seed, dev, sync)
    setup_s = time.perf_counter() - t0
    units, failed, window_s = c.window(seconds)
    clock = {"setup_s": setup_s, "window_s": window_s}
    ctx = {"units": units, "window_s": window_s, "trace": None}
    if kind == "train":
        ctx["batch_s"] = list(c.batch_s)
    else:
        ctx["frames"] = [(pose, s) for pose, s, _, _ in c.frames]
        frame_ms = c.frame_ms()
    tr = None
    if trace:
        ctx["traced_units"] = cell["traffic"]["trace_units"]
        t1 = time.perf_counter()
        _, tr, clock["trace_read_s"] = T.capture(lambda: c.traced(ctx["traced_units"]), sync)
        clock["traced_s"] = time.perf_counter() - t1
        ctx["trace"] = tr
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if trace and kind == "render":
        ctx["frame_least_s"] = frame_least_s(c, {p for p, _ in ctx["frames"]})
    c.release()
    t1 = time.perf_counter()
    if kind == "train":
        ref = c.reference(probe=_probe(c, ctx) if trace else None)
        nums = train_cell.numbers(c.program, ref)
        if trace:
            ctx["least_step_s"] = train_step.least_s(c.cfg, c.traffic, c.n)
            ctx["shapes"] = dict(F.leaf_shapes(c.cfg, c.reso))
    else:
        nums = render_cell.numbers(c.checked, c.reference(), c.cfg["far"])
    clock["reference_s"] = time.perf_counter() - t1
    limits = cell["limits"]["limits"]
    checks = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    correct = units > 0 and failed == 0 and all(v["value"] <= v["limit"] for v in checks.values())

    metrics = {}
    if trace:
        for m in cell["per_layer"]:
            value = spec.reader(cell["bench_dir"], m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        e2e = {"setup_s": setup_s}
        if kind == "train":
            e2e["train_rays_per_s"] = units * c.rays_per_step() / window_s
        else:
            e2e["render_rays_per_s"] = units * c.rays_per_frame() / window_s
            e2e["render_frame_ms_p95"] = float(np.percentile(frame_ms, 95))
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    device = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": cell["entry"]["chips"],
        "memory_peak_bytes": int(peak),
    }
    out = {"correct": bool(correct), "attempted": int(units), "failed": int(failed),
           "metrics": metrics, "device": device}
    if tr is not None:
        device["busy_s"] = tr.busy_us() * 1e-6
        device["window_s"] = tr.window_us() * 1e-6
        out["breakdown"] = T.breakdown(tr)
    out["clock"] = clock
    out["checks"] = checks
    return out


def _probe(c, ctx):
    """Collects one train step's kernel launches, (sample coordinates, the
    mode's channels per axis, the output-gradient floats a sample), from
    the reference's first step: the dense step launches the backward once
    for the density samples (one d_sigma each) and once for the shaded
    ones (a d_app a channel) per sub-batch, the compacted step once for
    its fused samples (both) per sub-batch."""
    from text2nerf_tpu_torch.engine import train_step as ts

    nd, na = F.components(c.cfg)
    tc = c.traffic["train_config"]
    compact = bool(c.traffic.get("mask")) and tc["train_compact_k"] > 0
    r = ts.effective_microbatch(tc["batch_size"], tc["train_microbatch_compact"] if compact
                                else tc["train_microbatch"])
    sub = tc["batch_size"] // r
    launches = ctx.setdefault("launches", [])

    def probe(xn_d, xn_a):
        for s in range(0, xn_d.shape[0], sub):
            if compact:
                both = [a + b for a, b in zip(nd, na)]
                launches.append((xn_d[s:s + sub].reshape(-1, 3), both, 1 + sum(na)))
            else:
                launches.append((xn_d[s:s + sub].reshape(-1, 3), list(nd), 1))
                launches.append((xn_a[s:s + sub].reshape(-1, 3), list(na), sum(na)))
    return probe


def frame_least_s(c, poses) -> dict:
    """{pose: least seconds of its frame}, from the reference's live-sample
    counts on every COUNT_STRIDE-th pixel row and column."""
    h, w = c.hw
    stride = RR.occupancy_stride(c.cfg, c.aabb, c.reso, c.mask)
    pick = torch.arange(h * w, device=c.dev).reshape(h, w)[::COUNT_STRIDE, ::COUNT_STRIDE]
    scale = h * w / pick.numel()
    z_min = c.traffic["render"]["eval_z_min"]
    out = {}
    for pose in sorted(poses):
        rays = c.rays[pose][pick.reshape(-1)]
        *_, live = RR.live_samples(c.cfg, c.aabb, rays, c.reso, c.n, c.mask, z_min, stride)
        out[pose] = render_frame.least_s(c.cfg, c.traffic, live.sum(-1), scale)
    return out
