#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero before the last line):

1. card: name and power limit from nvidia-smi;
2. build: both CUDA kernels from text2nerf_tpu_torch/csrc, nvcc started
   for all sources together;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   same CUDA inputs at the main path's shapes (kernel A: 1M samples of the
   full-width 300^3 room shell in the main path's layout, 65536 rays x 16
   consecutive steps, fp32 and bf16, three output modes, held bit for bit;
   kernel B: 1M rows), with times, the library yardstick and the bound
   (kernel B's on the 3xTF32 tensor-core route it takes, the fp32
   CUDA-core bound printed beside it);
4. main path: the serving configuration of text2nerf_tpu_torch/data/
   synthetic.py, a full-width room-shell field from a seeded generator, saved
   and loaded through the npz checkpoint, a 200^3 pool-5 alpha mask, then
   8 frames of 512^2 along test_trajectory("circle0") through
   evaluation_path(compact_k=-1): the adaptive renderer with chunk 65536,
   app_k 128 and ladder (16, 32, 64, 128).  Both kernels' launch counts
   must rise in that run.  One view is also rendered untruncated
   (compact_k = app_k = 160) for max_dev, and a 4096-ray crop is rendered
   again by the plain versions on the CPU as the reference.

Prints a JSON line of per-kernel numbers, then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Needs one GPU and no network.  Exits nonzero without CUDA, or without the
text2nerf_tpu_torch package beside it.
"""

import dataclasses
import json
import subprocess
import sys
import time

# published H100 SXM peaks (dense): HBM bytes/s, fp32 CUDA-core and TF32
# tensor-core FLOP/s
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12

FULL_RESO = (300, 300, 300)  # TensoRFConfig defaults: 259 samples
K_A = 16  # the base rung's K: consecutive samples per ray
N_SAMPLES_A = 1 << 20  # 65536-ray chunk x K=16 base rung
N_ROWS_B = 1 << 20
FRAMES = 8
FOG_DISTANCE_SCALE = 0.1  # vs 25: the shell's wall needs ~17 live samples
TOL = {
    # kernel A, both compute types: the plain version's operations in its
    # order (no FMA contraction, bf16 rounding at every op, density sums
    # exact in fp64), so the two agree bit for bit
    "fp32": 0.0,
    "bf16": 0.0,
    # head: 351 + 128 + 128 term sums in another order, products in 3xTF32
    # (about 2^-21 relative each), the kernel's sin/cos (within 1.5 ulp) vs
    # torch.sin/cos at arguments up to 32|f|
    "head": 1e-4,
    # GPU kernels vs the CPU plain path, whole render (fp32)
    "render": 1e-4,
    # adaptive vs untruncated: the acc-gate lets a saturated ray drop up
    # to acc_tol = 1e-3 of tail, rays past the top rung keep its truncation
    "max_dev": 1e-2,
}


def _require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps, flush=None):
    """Mean ms per call over ``reps`` calls, CUDA events around each call,
    after one warm-up call; ``flush`` runs between calls, outside the
    timed window (an L2 flush: the main path finds the tables cold)."""
    import torch

    fn()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _bound(bytes_moved, flops, peak_flops=FP32_FLOPS):
    t_bytes = bytes_moved / HBM_BPS * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _chunk_samples(rays, aabb, field, n, gen):
    """xn at the main path's sample layout: 65536 rays x 16 consecutive
    march steps each, from a seeded start step per ray."""
    import torch
    from text2nerf_tpu_torch.models import tensorf as tf
    from text2nerf_tpu_torch.ops.rays import aabb_slab_entry

    k = K_A
    r = rays[: n // k]
    reso = tf.grid_resolution(field)
    step = tf.step_size(aabb, reso, field.cfg.step_ratio)
    n_samples = tf.default_n_samples(reso, field.cfg.step_ratio)
    t_min = aabb_slab_entry(r[:, :3], r[:, 3:], aabb, field.cfg.near, field.cfg.far)
    s0 = torch.randint(0, n_samples - k, (r.shape[0], 1), generator=gen, device=r.device)
    steps = (s0 + torch.arange(k, device=r.device)).float()
    z = t_min[:, None] + step * steps
    pts = r[:, None, :3] + r[:, None, 3:] * z[..., None]
    return torch.clamp(tf.normalize_coord(aabb, pts), -1, 1).reshape(-1, 3).contiguous()


def _unique_row_bytes(xn, field, want_sigma, want_app):
    """Bytes of the table rows these samples touch, each counted once."""
    import torch
    from text2nerf_tpu_torch.ops.fused_gather import _coords
    from text2nerf_tpu_torch.ops.kernels.factor_features import MAT_MODE, VEC_MODE

    total = 0
    for i in range(3):
        h, w, c = field.planes[i].shape
        nd = field.cfg.density_n_comp[i]
        width = (nd if want_sigma else 0) + ((c - nd) if want_app else 0)
        m0, m1 = MAT_MODE[i]
        x0, _ = _coords(xn[:, m0], w)
        y0, _ = _coords(xn[:, m1], h)
        x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)
        rows = torch.cat([y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1])
        l0, _ = _coords(xn[:, VEC_MODE[i]], field.lines[i].shape[0])
        lrows = torch.cat([l0, torch.clamp(l0 + 1, max=field.lines[i].shape[0] - 1)])
        total += (torch.unique(rows).numel() + torch.unique(lrows).numel()) * width * 4
    return total


def _grid_sample_features(xn, planes_nchw, lines_nc1, nd):
    """Library yardstick of kernel A: F.grid_sample (align_corners=True)
    over the three planes and lines, then product, density sum, concat."""
    import torch
    import torch.nn.functional as F
    from text2nerf_tpu_torch.ops.kernels.factor_features import MAT_MODE, VEC_MODE

    n = xn.shape[0]
    sigma, feats = 0.0, []
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        gp = xn[:, [m0, m1]].view(1, n, 1, 2)
        gl = torch.stack([torch.zeros_like(xn[:, 0]), xn[:, VEC_MODE[i]]], -1).view(1, n, 1, 2)
        pf = F.grid_sample(planes_nchw[i], gp, align_corners=True).view(-1, n)
        lf = F.grid_sample(lines_nc1[i], gl, align_corners=True).view(-1, n)
        prod = pf * lf
        sigma = sigma + prod[: nd[i]].sum(0)
        feats.append(prod[nd[i]:])
    return sigma, torch.cat(feats, 0).T


def phase_kernels(dev, report):
    """Kernels A and B against their plain versions, on the serving
    field (real density magnitudes) at the main path's shapes."""
    import torch
    from text2nerf_tpu_torch.data import synthetic as syn
    from text2nerf_tpu_torch.ops import rays as R
    from text2nerf_tpu_torch.ops.kernels import factor_features as ff
    from text2nerf_tpu_torch.ops.kernels import shading_mlp as sm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    field = syn.serving_shell(0, dev)
    cfg = field.cfg
    aabb = torch.tensor(syn.AABB, device=dev)
    planes, lines, nd = tuple(field.planes), tuple(field.lines), field.nd
    pose = syn.serving_poses()[0]
    intr = R.default_intrinsics(*syn.VIEW_HW)
    dirs = R.ray_directions(*syn.VIEW_HW, intr[:2], intr[2:], device=dev)
    rays = torch.cat(R.rays_from_pose(dirs, pose), -1)
    xn = _chunk_samples(rays, aabb, field, N_SAMPLES_A, gen)
    n = xn.shape[0]
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_

    # --- kernel A: every mode and compute type against the plain version
    for dtype_name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        for mode, sig, app in (("fused", True, True), ("density", True, False),
                               ("app", False, True)):
            got = ff.factor_features(xn, planes, lines, nd, sigma=sig, app=app, dtype=dtype)
            ref = ff.factor_features_plain(xn, planes, lines, nd, sigma=sig, app=app, dtype=dtype)
            torch.cuda.synchronize()
            err = max(float((g - r).abs().max()) for g, r in zip(got, ref) if g is not None)
            tol = TOL[dtype_name]
            scale = max(float(r.abs().max()) for r in ref if r is not None)
            print(f"kernel A {dtype_name:4s} {mode:7s} max_abs_err {err:.3e} (tol {tol:g}) "
                  f"at max |value| {scale:.4g}", flush=True)
            _require(err <= tol, f"kernel A {dtype_name} {mode}: {err} > {tol}")
            if dtype is None and mode == "fused":
                err_a = err

    ms_a = _time_ms(lambda: ff.factor_features(xn, planes, lines, nd), 10, flush)
    plain_a = _time_ms(lambda: ff.factor_features_plain(xn, planes, lines, nd), 3, flush)
    planes_nchw = [p.permute(2, 0, 1)[None].contiguous() for p in planes]
    lines_nc1 = [l.T[None, :, :, None].contiguous() for l in lines]
    lib_sig, lib_app = _grid_sample_features(xn, planes_nchw, lines_nc1, nd)
    ref_sig, ref_app = ff.factor_features_plain(xn, planes, lines, nd)
    lib_err = max(float((lib_sig - ref_sig).abs().max()), float((lib_app - ref_app).abs().max()))
    print(f"kernel A library (grid_sample) vs plain max_abs_err {lib_err:.3e}", flush=True)
    lib_a = _time_ms(lambda: _grid_sample_features(xn, planes_nchw, lines_nc1, nd), 3, flush)
    c_total = sum(p.shape[2] for p in planes)
    bytes_a = n * 12 + n * 4 * (1 + sum(p.shape[2] - d for p, d in zip(planes, nd)))
    bytes_a += _unique_row_bytes(xn, field, True, True)
    flops_a = n * c_total * 14
    bound_a, by_a = _bound(bytes_a, flops_a)
    out_a = n * 4 * (1 + c_total - sum(nd))
    rows_a = bytes_a - n * 12 - out_a
    print(f"kernel A fused fp32: {ms_a:.3f} ms, plain {plain_a:.3f} ms, grid_sample "
          f"{lib_a:.3f} ms, bound {bound_a:.3f} ms by {by_a} ({bytes_a / 1e6:.1f} MB: "
          f"{out_a / 1e6:.1f} MB output, {n * 12 / 1e6:.1f} MB xn, {rows_a / 1e6:.1f} MB "
          f"unique rows; {flops_a / 1e9:.2f} GFLOP) for {n} samples", flush=True)
    report["factor_features"] = dict(
        name="factor_features", route="cuda",
        source="text2nerf_tpu_torch/csrc/factor_features.cu",
        replaces="text2nerf_tpu/models/tensorf.py:538",
        max_abs_err=err_a, ms=ms_a, plain_ms=plain_a, bound_ms=bound_a,
        bound_by=by_a, library_ms=lib_a,
    )

    # --- kernel B: the head at 1M rows -------------------------------
    head = field.mlp
    feats = 2.0 * torch.randn(N_ROWS_B, cfg.app_dim, generator=gen, device=dev)
    got = sm.shade_fea_noview(head, feats, cfg.fea_pe)
    ref = sm.shade_fea_noview_plain(head, feats, cfg.fea_pe)
    torch.cuda.synchronize()
    err_b = float((got - ref).abs().max())
    print(f"kernel B max_abs_err {err_b:.3e} (tol {TOL['head']:g})", flush=True)
    _require(err_b <= TOL["head"], f"kernel B: {err_b} > {TOL['head']}")
    ms_b = _time_ms(lambda: sm.shade_fea_noview(head, feats, cfg.fea_pe), 10, flush)
    plain_b = _time_ms(lambda: sm.shade_fea_noview_plain(head, feats, cfg.fea_pe), 3, flush)
    from text2nerf_tpu_torch.models.mlp import positional_encoding

    x = torch.cat([feats, positional_encoding(feats, cfg.fea_pe)], -1)

    def addmm3():
        h = torch.addmm(head.b1, x, head.w1).relu_()
        h = torch.addmm(head.b2, h, head.w2).relu_()
        return torch.addmm(head.b3, h, head.w3).sigmoid_()

    lib_b = _time_ms(addmm3, 5, flush)
    in_dim, fc = head.w1.shape
    flops_12 = N_ROWS_B * 2 * (in_dim * fc + fc * fc)  # layers 1 and 2
    flops_b = flops_12 + N_ROWS_B * 2 * fc * 3
    bytes_b = N_ROWS_B * (cfg.app_dim + 3) * 4 + sum(
        head[k].numel() * 4 for k in ("w1", "b1", "w2", "b2", "w3", "b3"))
    # the kernel's route: layers 1 and 2 as three TF32 products each
    # (3xTF32) on the tensor cores
    bound_b, by_b = _bound(bytes_b, 3 * flops_12, TF32_FLOPS)
    fp32_bound = _bound(bytes_b, flops_b)[0]
    print(f"kernel B: {ms_b:.3f} ms, plain {plain_b:.3f} ms, 3x addmm (TF32 off) "
          f"{lib_b:.3f} ms, bound {bound_b:.3f} ms by {by_b} (3xTF32: 3 x "
          f"{flops_12 / 1e9:.1f} GFLOP at 495 TFLOP/s); fp32 CUDA-core bound "
          f"{fp32_bound:.3f} ms ({flops_b / 1e9:.1f} GFLOP at 67 TFLOP/s)", flush=True)
    report["shading_mlp"] = dict(
        name="shading_mlp", route="cuda",
        source="text2nerf_tpu_torch/csrc/shading_mlp.cu",
        replaces="text2nerf_tpu/ops/pallas/shading_mlp.py:89",
        max_abs_err=err_b, ms=ms_b, plain_ms=plain_b, bound_ms=bound_b,
        bound_by=by_b, library_ms=lib_b,
    )
    del field, flush_buf, x
    torch.cuda.empty_cache()


def _adaptive_vs_untruncated(field, aabb, rays, mask, n_samples, dev, name):
    """max_dev of the adaptive render (main-path settings, fp32 features as
    evaluation_path's) against the untruncated compact render
    (compact_k = app_k = 160) of one view."""
    import torch
    from text2nerf_tpu_torch.data.synthetic import RENDER_KW
    from text2nerf_tpu_torch.ops import render as Rd

    ada, ks = Rd.render_chunked_adaptive(
        field, aabb, rays, mask, n_samples=n_samples, chunk=RENDER_KW["chunk"],
        app_k=RENDER_KW["app_k"], k_ladder=RENDER_KW["k_ladder"], feature_dtype="fp32",
        device=dev)
    k_full = min(160, n_samples)
    full = Rd.render_chunked(
        field, aabb, rays, n_samples=n_samples, chunk=16384, app_k=k_full,
        alpha_mask=mask, compact_k=k_full, feature_dtype="fp32", device=dev)
    for out in (ada, full):
        _require(bool(torch.isfinite(out.rgb).all()), f"{name}: non-finite rgb")
        _require(float(out.rgb.min()) >= 0 and float(out.rgb.max()) <= 1,
                 f"{name}: rgb outside [0, 1]")
    max_dev = float((ada.rgb - full.rgb).abs().max())
    print(f"{name}: max_dev adaptive vs untruncated K={k_full}: {max_dev:.3e} (tol "
          f"{TOL['max_dev']:g}), ks {ks}", flush=True)
    _require(max_dev <= TOL["max_dev"], f"{name}: max_dev {max_dev}")
    return max_dev, ks


def phase_main_path(dev, card, report, workdir):
    """The serving path: checkpoint → mask → 8 adaptive 512^2 frames."""
    import numpy as np
    import torch
    from text2nerf_tpu_torch.data import synthetic as syn
    from text2nerf_tpu_torch.engine import checkpoints as ckpt
    from text2nerf_tpu_torch.engine.renderer import evaluation_path
    from text2nerf_tpu_torch.models import tensorf as tf
    from text2nerf_tpu_torch.ops import rays as R
    from text2nerf_tpu_torch.ops import render as Rd
    from text2nerf_tpu_torch.ops.kernels import factor_features as ff
    from text2nerf_tpu_torch.ops.kernels import shading_mlp as sm

    shell = syn.serving_shell(1, dev)
    reso = tf.grid_resolution(shell)
    path = f"{workdir}/room_shell.npz"
    t0 = time.perf_counter()
    ckpt.save_checkpoint(path, shell, syn.AABB)
    cfg_l, field, aabb_t, _, _ = ckpt.load_checkpoint(path, device=dev)
    field.requires_grad_(False)
    for a, b in zip(shell.parameters(), field.parameters()):
        _require(torch.equal(a, b), "checkpoint round trip changed the params")
    del shell
    mask, new_aabb = syn.serving_mask(field, aabb_t, dev)
    torch.cuda.synchronize()
    occ = float(mask["volume"].mean())
    kw = syn.serving_render_kwargs(field, mask, dev)
    n_samples = kw["n_samples"]
    print(f"field {reso} n_samples {n_samples}: checkpoint + mask "
          f"{time.perf_counter() - t0:.1f} s, mask occupancy {occ:.3f}, "
          f"new_aabb {new_aabb.cpu().numpy().round(3).tolist()}", flush=True)
    _require(reso == FULL_RESO, f"grid {reso} is not the full-width {FULL_RESO}")

    poses = syn.serving_poses()
    hw = syn.VIEW_HW
    intr = R.default_intrinsics(*hw)
    evaluation_path(field, aabb_t, poses[8:9], hw, intr, **kw)  # warm-up

    ff.LAUNCHES = 0
    sm.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames, _ = evaluation_path(field, aabb_t, poses[:FRAMES], hw, intr, **kw)
    dt = time.perf_counter() - t0
    launches = {"factor_features": ff.LAUNCHES, "shading_mlp": sm.LAUNCHES}
    print(f"main path launches {launches}", flush=True)
    for name, count in launches.items():
        _require(count > 0, f"{name} was not launched on the main path")
        report[name]["launches"] = count
    frames = np.stack(frames)
    _require(frames.shape == (FRAMES, *hw, 3), f"frames {frames.shape}")
    fg = float((frames != 255).any(-1).mean())
    _require(fg > 0.01, f"frames are background only ({fg:.4f} non-white)")
    rays_s = FRAMES * hw[0] * hw[1] / dt
    print(f"rays/s {rays_s:.1f} ({FRAMES} frames {hw[0]}x{hw[1]} in {dt:.3f} s, "
          f"{fg:.3f} non-background) on {card}", flush=True)

    # one view rendered adaptive and untruncated
    dirs = R.ray_directions(*hw, intr[:2], intr[2:], device=dev)
    rays = torch.cat(R.rays_from_pose(dirs, poses[10]), -1)
    max_dev, _ = _adaptive_vs_untruncated(field, aabb_t, rays, mask, n_samples, dev, "shell")

    # the escalation pass at full width: the same factors under a smaller
    # distance_scale, so rays cross the wall unsaturated at the base rung
    fog_cfg = dataclasses.replace(cfg_l, distance_scale=FOG_DISTANCE_SCALE)
    fog = ckpt.params_from_jax(ckpt.params_to_jax(field), fog_cfg, device=dev)
    _, ks = _adaptive_vs_untruncated(fog.requires_grad_(False), aabb_t, rays, mask,
                                     n_samples, dev, "fog shell")
    _require(max(ks) > kw["k_ladder"][0], f"no ray escalated on the fog shell: ks {ks}")
    del fog

    # a 4096-ray crop again through the plain versions on the CPU
    h, w = hw
    crop = rays.view(h, w, 6)[h // 2 - 32: h // 2 + 32, w // 2 - 32: w // 2 + 32]
    crop = crop.reshape(-1, 6)
    field_cpu = ckpt.params_from_jax(ckpt.params_to_jax(field), cfg_l, device="cpu")
    mask_cpu = {"volume": mask["volume"].cpu(), "aabb": mask["aabb"].cpu(), "pool": mask["pool"]}
    k_full = min(160, n_samples)
    kw_ref = dict(n_samples=n_samples, chunk=4096, app_k=k_full, compact_k=k_full,
                  feature_dtype="fp32")
    gpu = Rd.render_chunked(field, aabb_t, crop, alpha_mask=mask, device=dev, **kw_ref)
    with torch.no_grad():
        cpu = Rd.render_chunked(field_cpu.requires_grad_(False), aabb_t.cpu(), crop.cpu(),
                                alpha_mask=mask_cpu, device="cpu", **kw_ref)
    err = max(float((g.cpu() - c).abs().max()) for g, c in
              ((gpu.rgb, cpu.rgb), (gpu.acc, cpu.acc)))
    print(f"GPU kernels vs CPU plain render, 4096 rays: max_abs_err {err:.3e} "
          f"(tol {TOL['render']:g})", flush=True)
    _require(err <= TOL["render"], f"GPU render differs from the CPU reference: {err}")
    return rays_s, max_dev


def main():
    import os

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from text2nerf_tpu_torch.ops.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the text2nerf_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = _card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    _build.build()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "C7512" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    report = {}
    phase_kernels(dev, report)
    workdir = str(_build.BUILD_DIR / "smoke")
    os.makedirs(workdir, exist_ok=True)
    try:
        rays_s, max_dev = phase_main_path(dev, card, report, workdir)
    finally:
        for f in os.listdir(workdir):
            os.remove(os.path.join(workdir, f))
    print(json.dumps({"rays_per_s": rays_s, "max_dev": max_dev, "card": card}), flush=True)
    kernels = [report[k] for k in ("factor_features", "shading_mlp")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
