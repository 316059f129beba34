"""Where the time of a full-width 512² render goes on the GPU.

    python3 -m text2nerf_tpu_torch.profile_render [--bf16]

Builds the serving configuration of ``data/synthetic.py`` (the room-shell
field at full width, its 200³ pool-5 alpha mask, evaluation_path with
compact_k=-1, chunk 65536, app_k 128, ladder 16/32/64/128), the one
``chip_smoke.py`` drives, renders one warm-up frame, then renders 4 frames
along test_trajectory("circle0") under torch.profiler.  Prints the card,
the wall time per frame, the device's busy share of that wall time (the
sum of kernel times over the wall clock; one stream, so kernels do not
overlap), and the device time by layer and by kernel, largest first.
``--bf16`` renders with bf16 features (``feature_dtype="bf16"``, the
default of ``render_chunked`` that expansions and ``bench.py``'s renders
take) and also counts the casts of an (N, Σ app channels) ``app_raw``
to bf16 ahead of the basis product, with their device time.
Needs one GPU.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

from .data import synthetic as syn
from .engine.renderer import evaluation_path
from .ops import rays as R

FRAMES = 4
TOP_KERNELS = 20

#: kernel-name fragment → the layer it belongs to
LAYERS = (
    ("shade_kernel", "kernel B: shading head"),
    ("factor_features", "kernel A: factor features"),  # walk and generic kernels
    ("radixSort", "first-K selection sort"),
    ("sort", "first-K selection sort"),
    ("gemm", "basis product (torch.matmul)"),
    ("Memcpy", "host copies"),
    ("scan", "compositing cumprod"),
)


def _self_device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _app_raw_casts(prof, width: int):
    """(count, device µs) of the aten::_to_copy ops on (N, width) inputs."""
    casts = [e for e in prof.events() if e.name == "aten::_to_copy" and e.input_shapes
             and len(e.input_shapes[0]) == 2 and e.input_shapes[0][1] == width]
    return len(casts), sum(float(getattr(e, "device_time_total", 0.0)) for e in casts)


def main(argv=()) -> int:
    if list(argv) not in ([], ["--bf16"]):
        print("usage: python3 -m text2nerf_tpu_torch.profile_render [--bf16]", file=sys.stderr)
        return 2
    bf16 = bool(argv)
    if not torch.cuda.is_available():
        print("profile_render: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    field = syn.serving_shell(1, dev)
    aabb = torch.tensor(syn.AABB, device=dev)
    mask, _ = syn.serving_mask(field, aabb, dev)
    hw = syn.VIEW_HW
    intr = R.default_intrinsics(*hw)
    poses = syn.serving_poses()
    kw = syn.serving_render_kwargs(field, mask, dev)
    if bf16:
        kw["feature_dtype"] = "bf16"
    evaluation_path(field, aabb, poses[8:9], hw, intr, **kw)  # warm-up

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True, record_shapes=bf16) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluation_path(field, aabb, poses[:FRAMES], hw, intr, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies): the CPU ops that launched
    # them report the same time again
    rows = sorted(
        ((e.key, _self_device_us(e), e.count) for e in prof.key_averages()
         if getattr(e, "device_type", None) == DeviceType.CUDA),
        key=lambda r: -r[1],
    )
    rows = [r for r in rows if r[1] > 0]
    busy_us = sum(r[1] for r in rows)
    print(card)
    print(f"{FRAMES} frames {hw[0]}x{hw[1]} ({'bf16' if bf16 else 'fp32'} features): "
          f"{wall / FRAMES * 1e3:.2f} ms/frame (profiled), device busy {busy_us / 1e3:.2f} ms = "
          f"{busy_us / 1e6 / wall:.3f} of the wall time")
    if bf16:
        na = sum(p.shape[2] - d for p, d in zip(field.planes, field.nd))
        n, us = _app_raw_casts(prof, na)
        print(f"app_raw casts to bf16 (N x {na}) ahead of the basis product: {n}, "
              f"{us / 1e3 / FRAMES:.3f} ms/frame")
    if not rows:
        print("the profiler recorded no device time: busy share not measured")
    groups: dict = {}
    for key, us, _ in rows:
        group = next((g for pat, g in LAYERS if pat in key), "plain torch elementwise/reduce")
        groups[group] = groups.get(group, 0.0) + us
    for group, us in sorted(groups.items(), key=lambda g: -g[1]):
        print(f"{us / 1e3 / FRAMES:10.3f} ms/frame {us / busy_us:7.3f}  {group}")
    print("by kernel:")
    for key, us, count in rows[:TOP_KERNELS]:
        print(f"{us / 1e3 / FRAMES:10.3f} ms/frame {us / busy_us:7.3f}  x{count:<6d} {key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
