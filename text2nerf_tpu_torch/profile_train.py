"""Where the time of a full-width train step goes on the GPU.

    python3 -m text2nerf_tpu_torch.profile_train

Builds the training configuration of ``data/synthetic.py`` (the room-shell
targets, the second shell to train with its 200³ pool-5 mask, the
trainer's step settings: batch 16384, compacted K 64 in groups of 2,
depth-anchored band 6), the one ``chip_smoke.py`` phase 5 drives, takes 3
warm-up steps, then STEPS steps under torch.profiler.  Prints the card,
the wall time per step, the device's busy share of that wall time, and
the device time per step by layer, largest first, then by kernel.

Layers come from the ``t2n.*`` profiler ranges of the train renders and
the step (selection, features, head, composite, losses, TV), from the
optimizer's own ``Optimizer.step`` range (Adam), and from the kernels'
names (kernels A, A', C, C' and torch.topk's).  A backward kernel
belongs to the layer of the forward op its autograd node was made by
(the profiler's sequence numbers link the two), and is listed as that
layer's backward.
Needs one GPU.
"""

from __future__ import annotations

import subprocess
import sys
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType

STEPS = 5
TOP_KERNELS = 20

#: range name prefix -> layer
RANGES = (
    ("t2n.select", "selection (march, occupancy, live sort)"),
    ("t2n.features", "features (basis product, glue)"),
    ("t2n.head", "head (PE, 3 layers)"),
    ("t2n.composite", "composite (alpha, cumprod, rgb/depth)"),
    ("t2n.loss", "losses"),
    ("t2n.reg", "TV regularizers"),
    ("Optimizer.step", "Adam"),
)
#: kernel-name fragment -> layer, before the ranges
KERNELS = (
    ("factor_features_bwd", "kernel A': factor features backward"),
    ("factor_features", "kernel A: factor features"),
    ("cp_features_bwd", "kernel C': CP features backward"),
    ("cp_features", "kernel C: CP features"),
    ("topk", "topk (a dense step's app samples)"),
)
BACKWARD = "autograd::engine::evaluate_function"
#: autograd node name fragment -> layer, for nodes no forward range owns
NODES = (
    ("FactorFeaturesBackward", "kernel A': factor features backward"),
    ("CPFeaturesBackward", "kernel C': CP features backward"),
    ("AccumulateGrad", "gradient accumulation"),
)


def _range_layer(evt):
    """The layer of the innermost known range around ``evt`` (or None)."""
    e = evt
    while e is not None:
        for prefix, layer in RANGES:
            if e.name.startswith(prefix):
                return layer
        e = e.cpu_parent
    return None


def layer_of(evt, forward_ops) -> str:
    """The layer a CPU op's kernels count to.  ``forward_ops`` maps
    (thread, sequence number) to the forward op that made an autograd
    node."""
    e = evt
    while e is not None:
        if e.name.startswith(BACKWARD):
            for frag, layer in NODES:
                if frag in e.name:
                    return layer
            fwd = forward_ops.get((e.fwd_thread, e.sequence_nr))
            layer = _range_layer(fwd) if fwd is not None else None
            return f"{layer or 'other'} backward"
        e = e.cpu_parent
    return _range_layer(evt) or "other (batch gather, host copies)"


def forward_index(events) -> dict:
    """(thread, sequence number) -> the forward op with that number."""
    index = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.sequence_nr >= 0 and not any(
            a.name.startswith(BACKWARD) for a in _ancestors(e)
        ):
            index.setdefault((e.thread, e.sequence_nr), e)
    return index


def _ancestors(evt):
    e = evt
    while e is not None:
        yield e
        e = e.cpu_parent


def device_time_by_layer(events):
    """({layer: device us}, {kernel name: (us, count)}) of the kernels
    the events launched."""
    fwd = forward_index(events)
    layers, kernels = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        base = None
        for k in e.kernels:
            layer = next((lay for frag, lay in KERNELS if frag in k.name), None)
            if layer is None:
                base = base or layer_of(e, fwd)
                layer = base
            layers[layer] += k.duration
            kernels[k.name][0] += k.duration
            kernels[k.name][1] += 1
    return dict(layers), {k: tuple(v) for k, v in kernels.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_train: CUDA is not available", file=sys.stderr)
        return 2
    from .data import synthetic as syn
    from .engine import train_step as ts

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    rays, rgb, depth = syn.training_targets(dev)
    field, aabb, mask, cfg, kw = syn.training_setup(dev)
    state, opt = ts.make_train_state(field, cfg.lr_init, cfg.lr_basis, runtime_decay=True)
    step = ts.make_train_step(field.cfg, opt, device=dev, **kw)
    sampler = ts.PermutationSampler(rays.shape[0], cfg.batch_size, seed=cfg.seed)
    gen = torch.Generator(device=dev).manual_seed(0)

    def one(state):
        ids = torch.as_tensor(sampler.next_ids(), device=dev)
        batch = {"rays": rays[ids], "rgb": rgb[ids], "depth": depth[ids]}
        return step(state, aabb, batch, gen, alpha_mask=mask)

    for _ in range(3):
        state, _ = one(state)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state, _ = one(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    layers, kernels = device_time_by_layer(events)
    # every kernel, copy and memset on the device, whether or not the
    # profiler linked it to an op (not the ranges it mirrors onto the
    # device timeline)
    busy_us = sum(e.time_range.end - e.time_range.start for e in events
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                  and not e.name.startswith(("t2n.", "Optimizer.")))
    unlinked = busy_us - sum(layers.values())
    if unlinked > 0:
        layers["not linked to an op"] = unlinked
    print(card)
    print(f"{STEPS} train steps of {cfg.batch_size} rays: {wall / STEPS * 1e3:.2f} ms/step "
          f"(profiled), device busy {busy_us / 1e3 / STEPS:.2f} ms/step = "
          f"{busy_us / 1e6 / wall:.3f} of the wall time")
    if not layers:
        print("the profiler recorded no device time: busy share not measured")
        return 0
    for layer, us in sorted(layers.items(), key=lambda g: -g[1]):
        print(f"{us / 1e3 / STEPS:10.3f} ms/step {us / busy_us:7.3f}  {layer}")
    print("by kernel:")
    for name, (us, count) in sorted(kernels.items(), key=lambda g: -g[1][0])[:TOP_KERNELS]:
        print(f"{us / 1e3 / STEPS:10.3f} ms/step {us / busy_us:7.3f}  x{count:<6d} {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
