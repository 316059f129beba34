#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero before the last line):

1. card: name and power limit from nvidia-smi;
2. build: every CUDA kernel from text2nerf_tpu_torch/csrc, nvcc started
   for all sources together;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   same CUDA inputs at the main paths' shapes (kernel A: 1M samples of the
   full-width 300^3 room shell in the serving layout, 65536 rays x 16
   consecutive steps, fp32 and bf16, three output modes, held bit for bit;
   kernel B: 1M rows; kernel A': adversarial inputs (a run inside one
   cell, every upper edge, runs that cross rays, a ragged n, zero
   gradients, accumulation, both of its routes), then 1M samples at
   the train step's shape, 16384 rays x 64 consecutive steps, in three
   layouts (neighbouring rays, the train sampler's random rays, the
   neighbours shuffled), random output gradients, fp32, held to a
   tolerance relative to each table's largest gradient, with the
   reductions it issues counted on the host), with times, the library
   yardstick and the bound (kernel B's on the 3xTF32 tensor-core route it
   takes, the fp32 CUDA-core bound printed beside it);
4. serving path: the serving configuration of text2nerf_tpu_torch/data/
   synthetic.py, a full-width room-shell field from a seeded generator,
   saved and loaded through the npz checkpoint, a 200^3 pool-5 alpha mask,
   then 8 frames of 512^2 along test_trajectory("circle0") through
   evaluation_path(compact_k=-1): the adaptive renderer with chunk 65536,
   app_k 128 and ladder (16, 32, 64, 128).  Kernels A and B must be
   launched in that run.  One view is also rendered untruncated
   (compact_k = app_k = 160) for max_dev, and a 4096-ray crop is rendered
   again by the plain versions on the CPU as the reference;
5. training path: the training configuration of data/synthetic.py (targets
   of 4 views rendered from one shell, a second shell trained toward them
   with its 200^3 pool-5 mask) stepped by the trainer's own step
   (trainer._step_kwargs: batch 16384, compacted K 64 in groups of 2,
   depth-anchored band 6, two-group Adam with runtime decay).  First one
   compacted step on a 1024-ray crop on the card and again on the CPU
   through the plain versions, from the same (untrained) params and
   jitter; then 3 warm-up steps and 20 timed steps, sampler and step
   inside the window, which ends in a device sync.  mse must fall, and
   kernels A and A' must be launched in that run.  Then 2 steps of the
   dense branch (no mask, R = 32, A' launched in its density-only and
   app-only modes);
6. seed fit: trainer.reconstruction at the full model width on the
   procedural services, the JAX package's benchmark fit (bench.py
   fit_seed_scene) at 512^2: the seed image and its 8 warped support
   views, 150^3 -> 300^3 at step 10, the alpha mask and the AABB shrink at
   step 30, 2 stage-1 epochs of dense steps, 1 stage-3 epoch of compacted
   steps on the pool-5 stamped mask (K 256 from the first live sample, all
   shaded), batch 16384.  Each step is timed between device syncs (so
   the fit's wall is that of a loop whose steps do not overlap); one
   dense step runs under torch.profiler for the device's busy time.  The
   milestones must fire at their steps, kernels A, A' (fused in stage 3)
   and B must be launched, the final eval PSNR must beat the untrained
   field's by 5 dB, and the final checkpoint, reloaded, must render the
   seed view at the logged PSNR.  The inputs of the first launch of each
   kernel and mode in a dense step on the 300^3 grid, in the first
   compacted step on the shrunk grid and in the evals after it are
   captured and held against the plain versions at phase 3's tolerances;
7. progressive fit: trainer.reconstruction on a two-view trajectory
   (circle0_30, a real disocclusion) with phase 6's configuration and
   n_stage1 1, n_stage2 1, n_stage3 1, on default_services: procedural
   text2img and depth, diffusion_fill_inpaint, histogram_rank, and the
   merge net at its production shape (unet_1024, 10 downs, bf16, seeded
   random init), with ExpansionConfig's defaults (20 candidates, 500
   merge iterations).  Every phase/expand1_* row must be logged, the
   DIBR/ tree complete when reconstruction returns, the new view's pool
   non-empty and sampled by most stage-2 steps; kernels A and B must be
   launched in the expansion's renders and A' in the first stage-2 step,
   each held against its plain version on inputs captured there; the
   seed view's final PSNR must beat the untrained field's by 5 dB.  The
   expansion's merge call runs again, fp32 with TF32 off and 2
   iterations, on the card and on the CPU, held within a relative bound.
   Prints the wall of each expansion sub-phase, ms per merge iteration
   and per inpaint call, and the fit's wall and step ms;
8. generative fit: phase 7's fit on default_services(weights_dir) whose stable-diffusion-2-1-base/,
   stable-diffusion-2-inpainting/ and clip-vit-base-patch32/ exist and hold
   no checkpoint: the SD 2 UNets, the VAE, the OpenCLIP-H text tower and
   the CLIP ViT-B/32 ranker at their published widths and seeded random
   init, bf16 compute.  The services must resolve "real"; the seed image
   come from 50 Euler evaluations of the 4-channel UNet at batch 2; the
   expansion make 4 inpaint calls of 5 candidates, each 51 PNDM
   evaluations of the 9-channel UNet at batch 10; every candidate be a
   finite 512x512x3 image in [0, 1] and the chosen one the argmax of the
   CLIP scores; every phase/expand1_* row be logged and kernels A, A' and
   B launched (held as in phase 7); the seed view's final PSNR beat the
   untrained field's.  Then ms per UNet evaluation (batch 10 and 2), per
   VAE encode and decode, the UNet's FLOPs from its shapes and its share
   of the bf16 peak, one inpaint call under torch.profiler (busy share,
   attention / convolution / GroupNorm / linear shares), and one forward
   of the full-width inpainting UNet (batch 2) and of CLIP ViT-B/32 on the
   card and the CPU (fp32, TF32 off), held within a relative bound.

Prints a JSON line of per-kernel numbers, then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Needs one GPU and no network.  Exits nonzero without CUDA, or without the
text2nerf_tpu_torch package beside it.

    python3 chip_smoke.py --seed-fit-variants [NAME ...]

builds the kernels, then runs only the seed fit at 256^2 under each of
SEED_FIT_VARIANTS' stage-3 compaction settings (all when none is named),
with no device sync between steps, and prints a line for each.
"""

import dataclasses
import json
import os
import shutil
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
K_TRAIN = 64  # train_compact_k: samples per ray of the compacted train step
N_RAYS_TRAIN = 16384  # batch_size
TRAIN_WARMUP, TRAIN_STEPS, DENSE_STEPS = 3, 20, 2
CROP_RAYS = 1024
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
    # kernel A' vs its plain version (index_add_), relative to each table's
    # largest gradient: both add fp32 terms with atomics in an order that
    # changes from run to run; a row gathers up to thousands of terms
    "bwd": 1e-4,
    # one train step on the card vs the CPU plain versions: the loss (its
    # sums in another order), and each gradient leaf relative to its
    # largest (atomics, matmul and reduction order)
    "train_loss": 1e-5,
    "train_grad": 1e-4,
    # adaptive vs untruncated: the acc-gate lets a saturated ray drop up
    # to acc_tol = 1e-3 of tail, rays past the top rung keep its truncation
    "max_dev": 1e-2,
    # the seed view rendered from the reloaded final checkpoint vs the
    # trainer's logged eval (dB): the same field and mask, the adaptive
    # renderer's base rung chosen afresh
    "reload_psnr": 0.01,
    # the merge net's finetune (fp32, TF32 off) on the card vs the CPU, of
    # the largest output: conv sums in other orders, and Adam's first steps
    # move every weight by about lr whatever its gradient's size
    "merge": 1e-3,
    # one evaluation of the full-width inpainting UNet (fp32, TF32 off) and
    # one CLIP ViT-B/32 forward, card vs CPU, of the largest output: ~20
    # resnets and 16 transformers (12 layers for CLIP) of conv and matmul
    # sums in other orders, through GroupNorms that renormalize each
    # block's error
    "unet": 1e-3,
    "clip": 1e-4,
}
SEED_FIT_HW = (512, 512)
SEED_FIT_EPOCHS = (2, 1)  # n_stage1, n_stage3
SEED_FIT_VOXELS = (150 ** 3, 27_000_000)  # n_voxel_init, n_voxel_final
SEED_FIT_UPSAMPLE, SEED_FIT_ALPHA_MASK = 10, 30  # global steps, inside stage 1
# stage 3's compacted steps: K covering every sample of the march, from the
# first live one, all of them shaded (one fused pass of kernel A and A'):
# the trainer's default depth-anchored window collapses a 2-epoch field, the
# JAX trainer's as the port's (PERF.md, PR 5)
SEED_FIT_COMPACT = dict(train_compact_k=256, app_k=256, train_depth_cap_band=0)


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


def _chunk_samples(rays, aabb, field, n, gen, k=K_A):
    """xn at a main path's sample layout: n / k rays of k consecutive
    march steps each, from a seeded start step per ray."""
    import torch
    from text2nerf_tpu_torch.models import tensorf as tf
    from text2nerf_tpu_torch.ops.rays import aabb_slab_entry

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
    phase_backward(field, aabb, rays, gen, flush, report)
    del field, flush_buf, x
    torch.cuda.empty_cache()


def _bwd_layouts(field, aabb, rays, gen):
    """Kernel A''s samples at the compacted train step's shape, 16384 rays
    x 64 consecutive steps of the full-width shell: "coherent", the first
    16384 rays of one view (neighbours, phase 3's layout since kernel A'
    was ported); "random", 16384 rays of the training views drawn by the
    train step's PermutationSampler; "shuffled", the coherent samples in a
    random order (the same row updates without a ray's run)."""
    import torch
    from text2nerf_tpu_torch.data import synthetic as syn
    from text2nerf_tpu_torch.engine.train_step import PermutationSampler

    n = N_RAYS_TRAIN * K_TRAIN
    coherent = _chunk_samples(rays, aabb, field, n, gen, K_TRAIN)
    pool = syn.training_rays(rays.device)
    ids = torch.as_tensor(PermutationSampler(pool.shape[0], N_RAYS_TRAIN, seed=0).next_ids(),
                          device=rays.device)
    batch = _chunk_samples(pool[ids], aabb, field, n, gen, K_TRAIN)
    order = torch.randperm(n, generator=gen, device=rays.device)
    return {"coherent": coherent, "random": batch, "shuffled": coherent[order].contiguous()}


def _bwd_rel_err(got, ref, what):
    """Largest |got - ref| over each table's largest |ref|; a table whose
    reference is all zero must come out all zero."""
    err = 0.0
    for g, r in zip((*got[0], *got[1]), (*ref[0], *ref[1])):
        _require(g.shape == r.shape and g.dtype == r.dtype, f"{what}: table {tuple(g.shape)}")
        scale = float(r.abs().max())
        if scale > 0:
            err = max(err, float((g - r).abs().max()) / scale)
        else:
            _require(float(g.abs().max()) == 0, f"{what}: gradient where none")
    return err


def _bwd_cases(dev, gen):
    """Adversarial inputs for kernel A' (name, planes, lines, nd, xn, d_sigma,
    d_app, route the dispatcher must take, accumulate into given tables)."""
    import torch
    from text2nerf_tpu_torch.models import tensorf as tf

    def field(reso, dens=(16, 16, 16), app=(48, 48, 48)):
        cfg = tf.TensoRFConfig(density_n_comp=dens, app_n_comp=app)
        f = tf.init_params(cfg, reso, generator=gen, device=dev).requires_grad_(False)
        return tuple(f.planes), tuple(f.lines), f.nd, sum(app)

    def rays(n_rays, k, reso):  # ray-major, one-voxel steps
        o = torch.rand(n_rays, 1, 3, generator=gen, device=dev) * 1.6 - 0.8
        d = torch.randn(n_rays, 1, 3, generator=gen, device=dev)
        steps = torch.arange(k, device=dev, dtype=torch.float32)[None, :, None]
        x = o + d / d.norm(dim=-1, keepdim=True) * steps * (2.0 / (reso - 1))
        return torch.clamp(x, -1, 1).reshape(-1, 3).contiguous()

    def grads(n, na):
        return (torch.randn(n, generator=gen, device=dev),
                torch.randn(n, na, generator=gen, device=dev))

    main = field((48, 40, 56))
    planes, lines, nd, na = main
    cases = []
    # 64 samples inside one cell of every plane and line
    cell = torch.full((64, 3), 0.1, device=dev) + 1e-3 * torch.rand(64, 3, generator=gen,
                                                                     device=dev)
    cases.append(("one cell", *main[:3], cell, *grads(64, na), "shared", False))
    # every upper edge and corner: coincident corner and line rows
    edge = torch.rand(4096, 3, generator=gen, device=dev) * 2 - 1
    edge[:8] = torch.tensor([[1.0, 1, 1], [-1, -1, -1], [1, -1, 1], [-1, 1, -1],
                             [1, 0.3, -0.2], [0.1, 1, 0.4], [-0.6, 0.2, 1], [1, 1, -1]])
    for a in range(3):
        edge[8 + 64 * a: 8 + 64 * (a + 1), a] = 1.0
    edge[200:264] = torch.tensor([1.0, 1.0, 1.0], device=dev)  # a whole run on the corner
    cases.append(("upper edges", *main[:3], edge, *grads(4096, na), "shared", False))
    # rays of 5 samples: every run holds parts of several rays; n = 32 * 156 + 20
    x = rays(1000, 5, 48)
    cases.append(("runs cross rays, ragged n", *main[:3], x, *grads(x.shape[0], na), "shared",
                  False))
    # zero gradients: whole samples, one axis's app slice, d_sigma alone
    x = rays(128, 64, 48)
    d_sig, d_app = grads(x.shape[0], na)
    coin = torch.rand(x.shape[0], generator=gen, device=dev)
    d_sig[coin < 0.5] = 0.0
    d_app[coin < 0.4] = 0.0
    d_app[(coin > 0.6) & (coin < 0.8), 48:96] = 0.0
    d_app[2048:2048 + 96] = 0.0
    d_sig[2048:2048 + 96] = 0.0  # three whole runs of nothing
    cases.append(("zero gradients mixed in", *main[:3], x, d_sig, d_app, "shared", False))
    cases.append(("all gradients zero", *main[:3], x, torch.zeros_like(d_sig),
                  torch.zeros_like(d_app), "shared", False))
    cases.append(("accumulate (out=)", *main[:3], x, *grads(x.shape[0], na), "shared", True))
    # a line too long for shared memory (L = 1000 x 64 fp32 = 256 KB)
    long = field((24, 20, 1000))
    x = rays(64, 64, 1000)
    cases.append(("generic route (L = 1000)", *long[:3], x, *grads(x.shape[0], long[3]),
                  "generic", False))
    # 12-wide tables
    narrow = field((21, 17, 30), (4, 4, 4), (8, 8, 8))
    x = rays(64, 40, 30)
    cases.append(("generic route (12 wide)", *narrow[:3], x, *grads(x.shape[0], narrow[3]),
                  "generic", False))
    return cases


def _bwd_reductions(xn, lines, nd, d_sig, d_app, blocks):
    """A host count of the global reductions the shared route issues, by
    its rules rather than by the card: per axis, one float2 per touched
    lane pair and corner row of each sample whose gradient is not all zero
    there; then at most one float4 per group of four channels of each line
    row a kept sample touches, from each of the grid's blocks.  Returns
    (plane float2 count, bound on the line float4 count)."""
    import torch
    from text2nerf_tpu_torch.ops.fused_gather import _coords
    from text2nerf_tpu_torch.ops.kernels.factor_features import VEC_MODE

    plane = line = app_off = 0
    for i, ln in enumerate(lines):
        length, c = ln.shape
        keep = (d_sig != 0) | (d_app[:, app_off: app_off + c - nd[i]] != 0).any(1)
        app_off += c - nd[i]
        plane += 4 * (c // 2) * int(keep.sum())
        l0, _ = _coords(xn[keep, VEC_MODE[i]], length)
        touched = torch.unique(torch.cat([l0, torch.clamp(l0 + 1, max=length - 1)])).numel()
        line += blocks * touched * (c // 4)
    return plane, line


def phase_backward(field, aabb, rays, gen, flush, report):
    """Kernel A' against its plain version on adversarial inputs and at the
    compacted train step's shape (16384 rays x 64 consecutive steps of the
    full-width shell, random output gradients) in three layouts, with a
    host count of the reductions it issues."""
    import torch
    from text2nerf_tpu_torch.ops.kernels import factor_features as ff

    routes0 = dict(ff.BWD_ROUTES)
    worst = 0.0
    for name, planes_c, lines_c, nd_c, x, ds_all, da_all, route, acc in _bwd_cases(
            rays.device, gen):
        case_err = 0.0
        for mode, ds, da in (("fused", ds_all, da_all), ("density", ds_all, None),
                             ("app", None, da_all)):
            ref = ff.factor_features_backward_plain(x, planes_c, lines_c, nd_c, ds, da)
            if acc:
                base = tuple(tuple(0.5 * t for t in part) for part in ref)
                out = tuple(tuple(t.clone() for t in part) for part in base)
                for _ in range(2):
                    ff.factor_features_backward(x, planes_c, lines_c, nd_c, ds, da, out=out)
                got = out
                ref = tuple(tuple(b + 2 * r for b, r in zip(bp, rp)) for bp, rp in zip(base, ref))
            else:
                got = ff.factor_features_backward(x, planes_c, lines_c, nd_c, ds, da)
            torch.cuda.synchronize()
            _require(ff.BWD_LAST_GRID[0] == route,
                     f"kernel A' {name}: route {ff.BWD_LAST_GRID[0]}, not {route}")
            err = _bwd_rel_err(got, ref, f"kernel A' {name} {mode}")
            case_err = max(case_err, err)
            _require(err <= TOL["bwd"], f"kernel A' {name} {mode}: {err} > {TOL['bwd']}")
        worst = max(worst, case_err)
        print(f"kernel A' {name} ({x.shape[0]} samples, {route} route): within "
              f"{case_err:.3e} of each table's largest in three modes", flush=True)
    routes = {k: ff.BWD_ROUTES[k] - routes0[k] for k in routes0}
    _require(all(v > 0 for v in routes.values()), f"a kernel A' route was not checked: {routes}")
    print(f"kernel A' adversarial cases: worst {worst:.3e} of each table's largest over three "
          f"modes (tol {TOL['bwd']:g}); launches by route {routes}", flush=True)

    planes, lines, nd = tuple(field.planes), tuple(field.lines), field.nd
    layouts = _bwd_layouts(field, aabb, rays, gen)
    n = N_RAYS_TRAIN * K_TRAIN
    na = sum(p.shape[2] - d for p, d in zip(planes, nd))
    d_sig = torch.randn(n, generator=gen, device=rays.device)
    d_app = torch.randn(n, na, generator=gen, device=rays.device)
    c_total = sum(p.shape[2] for p in planes)
    table_bytes = sum(t.numel() * 4 for t in (*planes, *lines))
    bytes_in = n * (12 + 4 + 4 * na)
    flops = n * c_total * 28
    abs_err, times, bounds = 0.0, {}, {}
    for layout, xn in layouts.items():
        for mode, ds, da in (("fused", d_sig, d_app), ("density", d_sig, None),
                             ("app", None, d_app)):
            got = ff.factor_features_backward(xn, planes, lines, nd, ds, da)
            ref = ff.factor_features_backward_plain(xn, planes, lines, nd, ds, da)
            torch.cuda.synchronize()
            err = _bwd_rel_err(got, ref, f"kernel A' {layout} {mode}")
            if mode == "fused":
                grid = ff.BWD_LAST_GRID
                abs_err = max(abs_err, max(float((g - r).abs().max()) for g, r in
                                           zip((*got[0], *got[1]), (*ref[0], *ref[1]))))
            print(f"kernel A' {layout:9s} {mode:7s} max_abs_err {err:.3e} of each table's "
                  f"largest (tol {TOL['bwd']:g})", flush=True)
            _require(err <= TOL["bwd"], f"kernel A' {layout} {mode}: {err} > {TOL['bwd']}")
        del got, ref
        times[layout] = _time_ms(
            lambda: ff.factor_features_backward(xn, planes, lines, nd, d_sig, d_app), 10, flush)
        rows = _unique_row_bytes(xn, field, True, True)
        bounds[layout] = _bound(bytes_in + rows + table_bytes, flops)
        plane_red, line_red = _bwd_reductions(xn, lines, nd, d_sig, d_app, grid[1])
        print(f"kernel A' {layout}: {times[layout]:.3f} ms, bound {bounds[layout][0]:.3f} ms by "
              f"{bounds[layout][1]} ({rows / 1e6:.1f} MB unique rows); {grid[0]} route, "
              f"{grid[1]} blocks x {grid[2]} threads; reductions by the host's count of the "
              f"kernel's rules: {plane_red / 1e9:.4f} G float2 (plane) + at most "
              f"{line_red / 1e9:.4f} G float4 (line) vs {576 * n / 1e9:.4f} G float2 with "
              f"every row of every sample reduced into the tables", flush=True)

    xn = layouts["coherent"]
    plain = _time_ms(lambda: ff.factor_features_backward_plain(xn, planes, lines, nd, d_sig,
                                                                d_app), 3, flush)
    # library yardstick: the backward alone of F.grid_sample's features
    planes_nchw = [p.permute(2, 0, 1)[None].contiguous().requires_grad_(True) for p in planes]
    lines_nc1 = [l.T[None, :, :, None].contiguous().requires_grad_(True) for l in lines]
    with torch.enable_grad():
        lib_sig, lib_app = _grid_sample_features(xn, planes_nchw, lines_nc1, nd)
    lib_grads = torch.autograd.grad((lib_sig, lib_app), (*planes_nchw, *lines_nc1),
                                    (d_sig, d_app), retain_graph=True)
    ref = ff.factor_features_backward_plain(xn, planes, lines, nd, d_sig, d_app)
    lib_err = max(
        float((g[0].permute(1, 2, 0) - r).abs().max()) / float(r.abs().max())
        for g, r in zip(lib_grads[:3], ref[0]))
    print(f"kernel A' library (grid_sample backward) vs plain: {lib_err:.3e} of the "
          f"largest", flush=True)
    lib = _time_ms(lambda: torch.autograd.grad((lib_sig, lib_app), (*planes_nchw, *lines_nc1),
                                               (d_sig, d_app), retain_graph=True), 3, flush)
    del lib_sig, lib_app, lib_grads, planes_nchw, lines_nc1, ref
    bound, by = bounds["coherent"]
    print(f"kernel A' fused fp32, coherent: {times['coherent']:.3f} ms, plain {plain:.3f} ms, "
          f"grid_sample backward {lib:.3f} ms, bound {bound:.3f} ms by {by} (of which "
          f"{bytes_in / 1e6:.1f} MB xn and output gradients, {table_bytes / 1e6:.1f} MB "
          f"gradient tables written; {flops / 1e9:.2f} GFLOP) for {n} samples", flush=True)
    report["factor_features_bwd"] = dict(
        name="factor_features_bwd", route="cuda",
        source="text2nerf_tpu_torch/csrc/factor_features_bwd.cu",
        replaces="text2nerf_tpu/models/tensorf.py:538",
        max_abs_err=abs_err, ms=times["coherent"], plain_ms=plain, bound_ms=bound, bound_by=by,
        library_ms=lib, ms_by_layout=times,
        bound_ms_by_layout={k: v[0] for k, v in bounds.items()},
    )


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
        report[name]["launches_by_path"] = {"serve": count}
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


def crop_step_check(field, aabb, mask, batch, cfg, kw, dev):
    """One train step from the same params and jitter on the card and on
    the CPU (plain versions), each on a copy of ``field``: (relative error
    of the loss, {leaf: error relative to the leaf's largest gradient},
    the card's metrics)."""
    import numpy as np
    import torch
    from text2nerf_tpu_torch.engine import checkpoints as ckpt
    from text2nerf_tpu_torch.engine import train_step as ts

    n = batch["rays"].shape[0]
    jitter = torch.rand((n, 1), generator=torch.Generator().manual_seed(5))
    flat = ckpt.params_to_jax(field)
    mask_cpu = {"volume": mask["volume"].cpu(), "aabb": mask["aabb"].cpu(),
                "pool": mask["pool"]}
    w = kw["weights"]
    out = {}
    for d, m in ((dev, mask), ("cpu", mask_cpu)):
        f = ckpt.params_from_jax(flat, field.cfg, device=d)
        st, o = ts.make_train_state(f, cfg.lr_init, cfg.lr_basis, runtime_decay=True)
        stp = ts.make_train_step(f.cfg, o, device=d, **kw)
        _, met = stp(st, aabb.to(d), {k: v.to(d) for k, v in batch.items()}, alpha_mask=m,
                     jitter=jitter)
        met = {k: float(v) for k, v in met.items()}
        loss = (met["mse"] + w.depth * met["depth_loss"] + w.transmittance * met["transmit_loss"]
                + met.get("reg_tv_density", 0.0) + met.get("reg_tv_app", 0.0))
        out[str(d)] = (loss, ckpt.grads_to_jax(f), met)
        del f, st, o
    (loss_g, g_gpu, m_gpu), (loss_c, g_cpu, _) = out[str(dev)], out["cpu"]
    errs = {k: float(np.abs(g_gpu[k] - g_cpu[k]).max()) / max(float(np.abs(g_cpu[k]).max()), 1e-30)
            for k in g_cpu}
    return abs(loss_g - loss_c) / abs(loss_c), errs, m_gpu


def phase_train(dev, card, report):
    """The training path: the trainer's step on the training configuration
    (compacted, then dense), and one crop step held against the CPU."""
    import numpy as np
    import torch
    from text2nerf_tpu_torch.data import synthetic as syn
    from text2nerf_tpu_torch.engine import train_step as ts
    from text2nerf_tpu_torch.ops.kernels import factor_features as ff
    from text2nerf_tpu_torch.ops.kernels import shading_mlp as sm

    t0 = time.perf_counter()
    rays, rgb, depth = syn.training_targets(dev)
    field, aabb, mask, cfg, kw = syn.training_setup(dev)
    torch.cuda.synchronize()
    print(f"training setup {time.perf_counter() - t0:.1f} s: {rays.shape[0]} target rays, "
          f"mask occupancy {float(mask['volume'].mean()):.3f}, step settings "
          f"{ {k: v for k, v in kw.items() if k != 'weights'} }", flush=True)
    _require(tuple(field.planes[0].shape[:2]) == FULL_RESO[:2], "field is not full width")
    _require(kw["compact_k"] == K_TRAIN and kw["density_group"] == 2
             and kw["depth_cap_band"] == 6 and cfg.batch_size == N_RAYS_TRAIN,
             f"the step settings are not the trainer's defaults: {kw}")
    sampler = ts.PermutationSampler(rays.shape[0], cfg.batch_size, seed=cfg.seed)
    # one compacted step on a crop, on the card and on the CPU, from the
    # untrained params (as the fit converges, its gradients become sums
    # that cancel, and any summation order moves them relatively more)
    ids = torch.as_tensor(sampler.next_ids()[:CROP_RAYS], device=dev)
    batch = {"rays": rays[ids], "rgb": rgb[ids], "depth": depth[ids]}
    loss_err, grad_errs, m_gpu = crop_step_check(field, aabb, mask, batch, cfg, kw, dev)
    grad_err = max(grad_errs.values())
    worst = sorted(grad_errs.items(), key=lambda kv: -kv[1])[:4]
    print(f"train step on the card vs the CPU plain versions, {CROP_RAYS} rays: loss within "
          f"{loss_err:.3e} relative (tol {TOL['train_loss']:g}), gradients within "
          f"{grad_err:.3e} of each leaf's largest (tol {TOL['train_grad']:g}; worst "
          f"{[(k, f'{v:.2e}') for k, v in worst]}); mse {m_gpu['mse']:.6f}", flush=True)
    _require(loss_err <= TOL["train_loss"], f"train loss differs: {loss_err}")
    _require(grad_err <= TOL["train_grad"], f"train gradients differ: {grad_errs}")

    state, opt = ts.make_train_state(field, cfg.lr_init, cfg.lr_basis, runtime_decay=True)
    step = ts.make_train_step(field.cfg, opt, device=dev, **kw)
    gen = torch.Generator(device=dev).manual_seed(0)

    def one(state, alpha_mask=mask):
        ids = torch.as_tensor(sampler.next_ids(), device=dev)
        batch = {"rays": rays[ids], "rgb": rgb[ids], "depth": depth[ids]}
        return step(state, aabb, batch, gen, alpha_mask=alpha_mask)

    for _ in range(TRAIN_WARMUP):
        state, m = one(state)
    torch.cuda.synchronize()
    ff.LAUNCHES = ff.BWD_LAUNCHES = sm.LAUNCHES = 0
    routes0 = dict(ff.BWD_ROUTES)
    t0 = time.perf_counter()
    mses = []
    for _ in range(TRAIN_STEPS):
        state, m = one(state)
        mses.append(m["mse"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"factor_features": ff.LAUNCHES, "factor_features_bwd": ff.BWD_LAUNCHES}
    routes = {k: ff.BWD_ROUTES[k] - routes0[k] for k in routes0}
    print(f"train path launches {launches} (kernel B: {sm.LAUNCHES}, eval only; kernel A' by "
          f"route {routes})", flush=True)
    for name, count in launches.items():
        _require(count > 0, f"{name} was not launched on the training path")
        report[name]["launches"] = report[name].get("launches", 0) + count
        report[name].setdefault("launches_by_path", {})["train"] = count
    mses = [float(v) for v in mses]
    _require(all(np.isfinite(mses)), f"non-finite mse {mses}")
    _require(mses[-1] < mses[0], f"mse did not fall over the timed steps: {mses}")
    ms_step = dt / TRAIN_STEPS * 1e3
    psnr = [float(-10 * np.log10(v)) for v in (mses[0], mses[-1])]
    print(f"train ms/step {ms_step:.2f} ({TRAIN_STEPS} steps of {cfg.batch_size} rays in "
          f"{dt:.3f} s after {TRAIN_WARMUP} warm-up) on {card}; mse {mses[0]:.5f} -> "
          f"{mses[-1]:.5f}, psnr {psnr[0]:.3f} -> {psnr[1]:.3f}; step {state.step}, last "
          f"metrics { {k: round(float(v), 6) for k, v in m.items()} }", flush=True)

    # the dense branch: the trainer's regime before its first mask, R = 32
    modes0 = dict(ff.BWD_MODES)
    t0 = time.perf_counter()
    for _ in range(DENSE_STEPS):
        state, m = one(state, alpha_mask=None)
    torch.cuda.synchronize()
    dense = {k: float(v) for k, v in m.items()}
    modes = {k: ff.BWD_MODES[k] - modes0[k] for k in modes0}
    print(f"dense branch (R = {kw['microbatch']}): {DENSE_STEPS} steps in "
          f"{time.perf_counter() - t0:.2f} s, kernel A' launches by mode {modes}, last "
          f"metrics {dense}", flush=True)
    _require(all(np.isfinite(list(dense.values()))), f"dense step not finite: {dense}")
    _require(modes["density"] > 0 and modes["app"] > 0,
             f"the dense branch did not run kernel A' in both modes: {modes}")

    return {"train_ms_per_step": ms_step, "train_mse_first": mses[0], "train_mse_last": mses[-1],
            "train_psnr_first": psnr[0], "train_psnr_last": psnr[1]}


class _StepProbe:
    """Wraps ``train_step.make_train_step`` for the seed fit and records
    whether each step the trainer builds ran dense (no mask) or compacted
    (a stamped mask).  With ``measure`` it also
    - times each step on the host clock between device syncs (the step
      alone, and end to end from the previous step's end, the sampler and
      the batch copy included), so the fit's steps do not overlap;
    - counts the step's kernel launches by kind;
    - runs one dense step, end to end, under torch.profiler for the
      device's busy time;
    - captures the inputs of the first launch of each kernel and mode in
      the ``CAPTURED_DENSE``-th dense step (on the upsampled grid), in the
      first compacted step (on the shrunk grid) and in the evals after it,
      cloned at launch, for :func:`_hold_seed_fit_kernels`."""

    PROFILED_DENSE = 20  # counted from 1: dense steps 11-30 run on 300^3
    CAPTURED_DENSE = 15

    def __init__(self, ts, ff, sm, measure=True):
        self.ts, self.ff, self.sm, self.measure = ts, ff, sm, measure
        self.make0 = ts.make_train_step
        self.launch0 = (ff._launch, ff._launch_backward, sm._launch)
        self.kinds = []
        self.ms = {"dense": [], "compact": []}
        self.loop_ms = {"dense": [], "compact": []}
        self.modes = {"dense": {}, "compact": {}}
        self.routes = {"dense": {}, "compact": {}}
        self.fwd = {"dense": 0, "compact": 0}
        self.busy = None
        self.captured = {}  # (where, kernel, mode) -> the launch's inputs
        self._tag = None  # where launches are captured now, or None
        self.tag_next = None  # where the next step's launches are captured
        self._last_end = None
        self._prof = None

    def __enter__(self):
        self.ts.make_train_step = self.make_step
        if self.measure:
            self.ff._launch, self.ff._launch_backward, self.sm._launch = (
                self._tap_a, self._tap_a_bwd, self._tap_b)
        return self

    def __exit__(self, *exc):
        self.ts.make_train_step = self.make0
        self.ff._launch, self.ff._launch_backward, self.sm._launch = self.launch0
        if self._prof is not None:
            self._prof.stop()

    def _capture(self, kernel, mode, **inputs):
        import torch

        def copy(v):
            if isinstance(v, tuple):
                return tuple(copy(t) for t in v)
            if isinstance(v, dict):
                return {k: copy(t) for k, t in v.items()}
            return v.detach().clone() if isinstance(v, torch.Tensor) else v

        key = (self._tag, kernel, mode)
        if self._tag is None or key in self.captured:
            return
        with torch.no_grad():
            self.captured[key] = {k: copy(v) for k, v in inputs.items()}

    def _tap_a(self, xn, planes, lines, nd, sigma, app, bf16):
        import torch

        mode = "fused" if sigma and app else ("density" if sigma else "app")
        self._capture("A", f"{mode} {'bf16' if bf16 else 'fp32'}", xn=xn, planes=tuple(planes),
                      lines=tuple(lines), nd=nd, sigma=sigma, app=app,
                      dtype=torch.bfloat16 if bf16 else None)
        return self.launch0[0](xn, planes, lines, nd, sigma, app, bf16)

    def _tap_a_bwd(self, xn, planes, lines, nd, d_sigma, d_app_raw, out):
        mode = "fused" if d_sigma is not None and d_app_raw is not None else (
            "density" if d_sigma is not None else "app")
        self._capture("A'", mode, xn=xn, planes=tuple(planes), lines=tuple(lines), nd=nd,
                      d_sigma=d_sigma, d_app_raw=d_app_raw)
        return self.launch0[1](xn, planes, lines, nd, d_sigma, d_app_raw, out)

    def _tap_b(self, mlp, features, fea_pe):
        weights = {k: mlp[k] for k in ("w1", "b1", "w2", "b2", "w3", "b3")}
        self._capture("B", "fp32", mlp=weights, features=features, fea_pe=fea_pe)
        return self.launch0[2](mlp, features, fea_pe)

    def make_step(self, mcfg, opt, **kw):
        step = self.make0(mcfg, opt, **kw)

        def probed(state, aabb, batch, rng=None, tv_decay=None, alpha_mask=None, lr_decay=1.0):
            kind = "compact" if alpha_mask is not None and kw["compact_k"] > 0 else "dense"
            self.kinds.append(kind)
            args = (state, aabb, batch, rng, tv_decay)
            if not self.measure:
                return step(*args, alpha_mask=alpha_mask, lr_decay=lr_decay)
            return self._measured(step, kind, args, alpha_mask, lr_decay)

        return probed

    def _measured(self, step, kind, args, alpha_mask, lr_decay):
        import torch

        ff = self.ff
        n_dense = self.kinds.count("dense")
        first_compact = kind == "compact" and "compact" not in self.kinds[:-1]
        captured = (kind == "dense" and n_dense == self.CAPTURED_DENSE) or first_compact
        self._tag = kind if captured else None
        if self.tag_next is not None:
            self._tag, self.tag_next = self.tag_next, None
        modes0, routes0, fwd0 = dict(ff.BWD_MODES), dict(ff.BWD_ROUTES), ff.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*args, alpha_mask=alpha_mask, lr_decay=lr_decay)
        torch.cuda.synchronize()
        end = time.perf_counter()
        # past the first compacted step, the launches outside steps are evals
        self._tag = "eval" if "compact" in self.kinds else None
        self.ms[kind].append((end - t0) * 1e3)
        if self._last_end is not None:
            self.loop_ms[kind].append((end - self._last_end) * 1e3)
        for acc, now, before in ((self.modes[kind], ff.BWD_MODES, modes0),
                                 (self.routes[kind], ff.BWD_ROUTES, routes0)):
            for k in now:
                acc[k] = acc.get(k, 0) + now[k] - before[k]
        self.fwd[kind] += ff.LAUNCHES - fwd0
        if self._prof is not None:
            self._prof.stop()
            self.busy = (_busy_ms(self._prof.events()), (end - self._last_end) * 1e3)
            self._prof = None
        elif kind == "dense" and n_dense == self.PROFILED_DENSE - 1:
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
        self._last_end = time.perf_counter()
        return out


def _busy_ms(events):
    """Device ms of every kernel, copy and memset the profiler recorded."""
    from torch.autograd import DeviceType

    return sum(e.time_range.end - e.time_range.start for e in events
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation
               and not e.name.startswith(("t2n.", "Optimizer."))) / 1e3


def _median(xs):
    import numpy as np

    return float(np.median(xs)) if xs else float("nan")


# the launches of the seed fit that must have been captured and held
SEED_FIT_HELD = (("dense", "A'", "density"), ("dense", "A'", "app"),
                 ("compact", "A", "fused fp32"), ("compact", "A'", "fused"),
                 ("eval", "B", "fp32"))


def _hold_seed_fit_kernels(captured, report, held=SEED_FIT_HELD, label="seed fit"):
    """Each launch _StepProbe captured in a fit (``held`` must be among
    them), again through its wrapper and through its plain version, at
    phase 3's tolerances."""
    import torch
    from text2nerf_tpu_torch.ops.kernels import factor_features as ff
    from text2nerf_tpu_torch.ops.kernels import shading_mlp as sm

    names = {"A": "factor_features", "A'": "factor_features_bwd", "B": "shading_mlp"}
    missing = [k for k in held if k not in captured]
    _require(not missing, f"the {label}'s launches were not captured: {missing}; have "
             f"{sorted(captured)}")
    for (where, kernel, mode), c in sorted(captured.items()):
        if kernel == "A":
            args = (c["xn"], c["planes"], c["lines"], c["nd"])
            kw = dict(sigma=c["sigma"], app=c["app"], dtype=c["dtype"])
            got, ref = ff.factor_features(*args, **kw), ff.factor_features_plain(*args, **kw)
            torch.cuda.synchronize()
            err = max(float((g - r).abs().max()) for g, r in zip(got, ref) if g is not None)
            tol, n, what = TOL["bf16" if c["dtype"] else "fp32"], c["xn"].shape[0], "max_abs_err"
        elif kernel == "A'":
            args = (c["xn"], c["planes"], c["lines"], c["nd"], c["d_sigma"], c["d_app_raw"])
            got = ff.factor_features_backward(*args)
            ref = ff.factor_features_backward_plain(*args)
            torch.cuda.synchronize()
            err = _bwd_rel_err(got, ref, f"{label} {where} kernel A' {mode}")
            tol, n, what = TOL["bwd"], c["xn"].shape[0], "of each table's largest"
            mode += f", {ff.BWD_LAST_GRID[0]} route"
        else:
            args = (c["mlp"], c["features"], c["fea_pe"])
            got, ref = sm.shade_fea_noview(*args), sm.shade_fea_noview_plain(*args)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            tol, n, what = TOL["head"], c["features"].shape[0], "max_abs_err"
        grid = tuple(c["lines"][i].shape[0] for i in (2, 1, 0)) if "lines" in c else None
        print(f"{label} {where:7s} kernel {kernel:2s} {mode}: {n} {'rows' if grid is None else 'samples'}"
              f"{'' if grid is None else f' on grid {grid}'}, {err:.3e} {what} (tol {tol:g})",
              flush=True)
        _require(err <= tol, f"{label} {where} kernel {kernel} {mode}: {err} > {tol}")
        report[names[kernel]].setdefault(f"{label.replace(' ', '_')}_err", {})[
            f"{where} {mode}"] = err
        del got, ref
    torch.cuda.empty_cache()


def phase_seed_fit(dev, card, report, workdir):
    """The seed fit through trainer.reconstruction at full width (see the
    module docstring), then the final checkpoint reloaded and its render of
    the seed view held to the logged PSNR."""
    import numpy as np
    import torch
    from text2nerf_tpu_torch.data import scene_state as ss
    from text2nerf_tpu_torch.engine import checkpoints as ckpt
    from text2nerf_tpu_torch.engine import renderer, trainer
    from text2nerf_tpu_torch.engine import train_step as ts
    from text2nerf_tpu_torch.models import tensorf as tf
    from text2nerf_tpu_torch.ops.kernels import factor_features as ff
    from text2nerf_tpu_torch.ops.kernels import shading_mlp as sm

    cfg, scene_cfg = _seed_fit_configs(workdir, SEED_FIT_HW, eval_every_epochs=sum(
        SEED_FIT_EPOCHS), **SEED_FIT_COMPACT)
    _require(cfg.model == tf.TensoRFConfig(), "the seed fit is not at the full model width")
    print(f"seed fit: hw {SEED_FIT_HW}, epochs {SEED_FIT_EPOCHS}, grid {SEED_FIT_VOXELS[0]} -> "
          f"{SEED_FIT_VOXELS[1]} voxels at step {SEED_FIT_UPSAMPLE}, alpha mask and shrink at "
          f"step {SEED_FIT_ALPHA_MASK}, batch {cfg.batch_size}, eval mask pool "
          f"{cfg.eval_mask_pool}, stage 3 {SEED_FIT_COMPACT}", flush=True)
    torch.cuda.synchronize()
    ff.LAUNCHES = ff.BWD_LAUNCHES = sm.LAUNCHES = 0
    t0 = time.perf_counter()
    with _StepProbe(ts, ff, sm) as probe:
        mcfg, field, aabb, scene, logfolder = trainer.reconstruction(cfg, scene_cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"factor_features": ff.LAUNCHES, "factor_features_bwd": ff.BWD_LAUNCHES,
                "shading_mlp": sm.LAUNCHES}
    print(f"seed fit launches {launches}; wall {wall:.3f} s with a device sync around every "
          f"step, on {card}", flush=True)
    for name, count in launches.items():
        _require(count > 0, f"{name} was not launched on the seed fit")
        report[name]["launches"] = report[name].get("launches", 0) + count
        report[name].setdefault("launches_by_path", {})["seed_fit"] = count
    _require(any(k[:2] == ("dense", "A") for k in probe.captured),
             f"no dense kernel A launch was captured: {sorted(probe.captured)}")
    _hold_seed_fit_kernels(probe.captured, report)
    probe.captured.clear()

    rows = [json.loads(line) for line in open(f"{logfolder}/metrics.jsonl")]
    for row in rows:
        for k, v in row.items():
            if k.startswith("phase/"):
                print(f"  {k} {v:.4f}", flush=True)
    logged = {k: (row["step"], v) for row in rows for k, v in row.items()
              if k not in ("step", "t", "eval_psnr") and not k.startswith("phase/")}
    evals = [(row["step"], row["eval_psnr"]) for row in rows if "eval_psnr" in row]
    pool, up, shrink = logged["pool_rays"][1], logged.get("upsample_grid"), logged.get("shrink_aabb")
    print(f"pool {pool} rays, {logged['iters_per_epoch'][1]} steps an epoch; grid "
          f"{logged['grid'][1]} -> {up} at step {up and up[0]}; aabb {scene.scene_bbox.tolist()} -> "
          f"{shrink} at step {shrink and shrink[0]}, grid {logged.get('shrink_grid')}; pool after "
          f"the mask {logged.get('alpha_mask_pool_rays')}", flush=True)
    _require(up is not None and up[0] == SEED_FIT_UPSAMPLE, f"upsample did not fire: {up}")
    _require(shrink is not None and shrink[0] == SEED_FIT_ALPHA_MASK, f"shrink did not fire: {shrink}")
    want_up = tf.n_to_reso(SEED_FIT_VOXELS[1], scene.scene_bbox)
    _require(tuple(up[1]) == want_up, f"upsampled grid {up[1]} is not n_to_reso's {want_up}")
    grid = tf.grid_resolution(field)
    _require(tuple(logged["shrink_grid"][1]) == grid, f"final grid {grid} is not the shrunk one")
    _require(np.allclose(aabb.cpu().numpy(), np.asarray(shrink[1])), "final aabb is not the shrunk one")

    for kind in ("dense", "compact"):
        print(f"{kind} steps: {len(probe.ms[kind])}, step alone median "
              f"{_median(probe.ms[kind]):.2f} ms (min {min(probe.ms[kind], default=0):.2f}), end "
              f"to end median {_median(probe.loop_ms[kind]):.2f} ms; kernel A launches "
              f"{probe.fwd[kind]}, A' by mode {probe.modes[kind]}, by route "
              f"{probe.routes[kind]}", flush=True)
    _require(probe.modes["compact"].get("fused", 0) > 0,
             f"stage 3 did not run kernel A' in fused mode: {probe.modes}")
    _require(probe.modes["dense"].get("density", 0) > 0 and probe.modes["dense"].get("app", 0) > 0,
             f"stage 1 did not run kernel A' in both dense modes: {probe.modes}")
    idle = float("nan")
    if probe.busy is None:
        print("profiled dense step: not measured", flush=True)
    else:
        # the profiler's own host work slows the step it traces: the idle
        # share is the device's busy time over an unprofiled step's wall
        busy, wall_prof = probe.busy
        wall_step = _median(probe.loop_ms["dense"])
        idle = 1 - busy / wall_step
        print(f"dense step: device busy {busy:.2f} ms (one step under torch.profiler, which took "
              f"{wall_prof:.2f} ms of wall time, {wall_prof - wall_step:.2f} ms over the median) "
              f"of the median {wall_step:.2f} ms end to end: idle share {idle:.3f}", flush=True)

    # the untrained field the fit started from, upsampled as the fit did
    h, w = scene.hw
    z_floor = ss.supervised_z_floor(scene)
    gt = scene.rgbs_gen_split
    eval_kw = dict(chunk=cfg.batch_size, app_k=cfg.app_k, white_bg=scene.white_bg,
                   push_depth=scene_cfg.push_depth, near_far=scene.near_far,
                   eval_z_min=z_floor, device=dev)
    _, f0, _, _ = trainer.init_field(cfg, scene, device=dev)
    f0 = tf.upsample_volume_grid(f0, want_up).requires_grad_(False)
    psnr0 = renderer.evaluation(
        f0, torch.as_tensor(scene.scene_bbox, device=dev), scene.rays_gen_split[:1], (h, w),
        gt_rgbs=gt, n_samples=tf.default_n_samples(want_up, f0.cfg.step_ratio), **eval_kw,
    )["psnr"][0]
    del f0
    _require(len(evals) == 2 and all(np.isfinite(p) for _, p in evals),
             f"eval PSNRs at the stage-1 boundary and the end: {evals}")
    final = evals[-1][1]
    print(f"eval PSNR of the seed view: untrained (upsampled) {psnr0:.4f} dB, stage-1 boundary "
          f"{evals[0][1]:.4f} dB (step {evals[0][0]}), end {final:.4f} dB (step {evals[1][0]})",
          flush=True)
    _require(final >= psnr0 + 5.0, f"final PSNR {final} is not 5 dB above the untrained {psnr0}")

    # the final checkpoint, reloaded, renders the seed view as logged
    _, f1, aabb1, mask1, loop = ckpt.load_checkpoint(f"{logfolder}/{cfg.expname}_final.npz",
                                                     device=dev)
    f1.requires_grad_(False)
    _require(mask1 is not None and mask1["pool"] == cfg.eval_mask_pool,
             "the final checkpoint holds no pool-5 mask")
    res = renderer.evaluation(
        f1, aabb1, scene.rays_gen_split[:1], (h, w), gt_rgbs=gt,
        n_samples=logged["n_samples"][1],  # the trainer's, set at the upsample
        alpha_mask=mask1, compact_k=cfg.eval_compact_k, **eval_kw)
    reload_psnr = res["psnr"][0]
    print(f"reloaded checkpoint (step {loop['global_step']}): {reload_psnr:.4f} dB vs logged "
          f"{final:.4f} dB", flush=True)
    _require(abs(reload_psnr - final) <= TOL["reload_psnr"],
             f"reloaded render {reload_psnr} differs from the logged {final}")
    return {"seed_fit_wall_s": wall, "seed_fit_pool_rays": pool,
            "seed_fit_psnr_untrained": psnr0, "seed_fit_psnr_stage1": evals[0][1],
            "seed_fit_psnr_final": final, "seed_fit_psnr_reloaded": reload_psnr,
            "seed_fit_dense_ms": _median(probe.ms["dense"]),
            "seed_fit_compact_ms": _median(probe.ms["compact"]),
            "seed_fit_dense_loop_ms": _median(probe.loop_ms["dense"]),
            "seed_fit_compact_loop_ms": _median(probe.loop_ms["compact"]),
            "seed_fit_dense_idle_share": idle}


def _seed_fit_configs(workdir, hw, scene=None, **overrides):
    """(TrainConfig, SceneConfig) of the JAX benchmark's seed fit (module
    docstring, phase 6) under ``workdir``, with SceneConfig (``scene``)
    and TrainConfig overrides."""
    from text2nerf_tpu_torch.data import scene_state as ss
    from text2nerf_tpu_torch.engine import trainer

    scene_cfg = ss.SceneConfig(**{**dict(
        datadir=f"{workdir}/scene", prompt="a beautiful garden with flowers",
        pose_traj="local_fixed", num_training=1, hw=hw), **(scene or {})})
    cfg = trainer.TrainConfig(**{**dict(
        expname="seed", basedir=f"{workdir}/log", n_stage1=SEED_FIT_EPOCHS[0], n_stage2=0,
        n_stage3=SEED_FIT_EPOCHS[1], batch_size=N_RAYS_TRAIN, seed=11,
        n_voxel_init=SEED_FIT_VOXELS[0], n_voxel_final=SEED_FIT_VOXELS[1],
        upsamp_list=(SEED_FIT_UPSAMPLE,), update_alphamask_list=(SEED_FIT_ALPHA_MASK,),
        eval_mask_pool=5), **overrides})
    return cfg, scene_cfg


# phase 7: the progressive fit (stage 1, one expansion, stage 2, stage 3)
PROGRESSIVE_EPOCHS = (1, 1, 1)  # n_stage1, n_stage2, n_stage3 of phases 7 and 8
PROGRESSIVE_SCENE = dict(pose_traj="circle0_30", num_training=2)
# every sub-phase expand_scene logs for view 1, and the view's DIBR tree
EXPAND_PHASES = ("render_filter_known", "dibr_warp", "dibr_holefill", "render_target",
                 "inpaint_rank", "depth_align", "merge_finetune", "filter_new",
                 "support_pool")
N_CANDIDATES = 20  # ExpansionConfig's default
DIBR_FILES = sorted(["warped/00001.png", "mask/00001.png", "mask_inv/00001.png",
                     "rendered/00001_ori.png", "rgbs/00001.png",
                     "depth/00001_depth_finetuning2.png", "depth/00001_new.png"]
                    + [f"rgbs/00001_{i:03d}.png" for i in range(N_CANDIDATES)])
# the launches held: B and every mode of A that ran in the expansion's
# renders, every mode of A' that ran in the first stage-2 step, and the
# compacted step's fused A and A' in the first compacted step
PROGRESSIVE_HELD = (("expand", "B", "fp32"), ("compact", "A", "fused fp32"),
                    ("compact", "A'", "fused"))
MERGE_CHECK_ITERS = 2


class _Timed:
    """Wraps a callable, keeping the wall clock of each call (ms), the
    device synchronized around it; ``keep`` keeps the first call's
    arguments."""

    def __init__(self, fn, keep=False):
        self.fn, self.keep, self.ms, self.args = fn, keep, [], None

    def __call__(self, *args, **kw):
        import torch

        if self.keep and self.args is None:
            self.args = (args, kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args, **kw)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


def _merge_card_vs_cpu(dev, merge, args, kw):
    """The expansion's own merge call again, fp32 with TF32 off and
    MERGE_CHECK_ITERS iterations, at its net's size on the card and on
    the CPU from the same init: (max |difference| over the largest |output|,
    card ms, CPU ms)."""
    import torch
    from text2nerf_tpu_torch.services.merge import DepthMergeService

    kw = dict(kw, iters=MERGE_CHECK_ITERS)
    outs, ms = [], []
    for device in (dev, "cpu"):
        svc = DepthMergeService(net_size=merge.net_size, num_downs=merge.num_downs,
                                seed=merge.seed, compute_dtype=torch.float32, device=device)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            t0 = time.perf_counter()
            outs.append(svc.run_finetune(*args, **kw))
            ms.append((time.perf_counter() - t0) * 1e3)
    import numpy as np

    return float(np.abs(outs[0] - outs[1]).max() / np.abs(outs[1]).max()), ms[0], ms[1]


def _progressive_fit(dev, card, report, workdir, services, epochs, label, margin_db):
    """trainer.reconstruction on the two-view trajectory with ``services``
    and phase 6's configuration at ``epochs`` (n_stage1, n_stage2,
    n_stage3), the kernel counts set to 0 just before and read just after,
    then the checks phases 7 and 8 share (module docstring).  Returns the
    fit's records."""
    import numpy as np
    import torch
    from text2nerf_tpu_torch.data import scene_state as ss
    from text2nerf_tpu_torch.engine import checkpoints as ckpt
    from text2nerf_tpu_torch.engine import expansion, renderer, trainer
    from text2nerf_tpu_torch.engine import train_step as ts
    from text2nerf_tpu_torch.models import tensorf as tf
    from text2nerf_tpu_torch.ops.kernels import factor_features as ff
    from text2nerf_tpu_torch.ops.kernels import shading_mlp as sm
    from text2nerf_tpu_torch.utils.png import read_png

    n1, n2, n3 = epochs
    cfg, scene_cfg = _seed_fit_configs(
        workdir, SEED_FIT_HW, scene=PROGRESSIVE_SCENE, n_stage1=n1, n_stage2=n2, n_stage3=n3,
        eval_every_epochs=sum(epochs), **SEED_FIT_COMPACT)
    ex = expansion.ExpansionConfig(prompt=scene_cfg.prompt, push_depth=scene_cfg.push_depth,
                                   trans_range=scene_cfg.trans_range)
    _require(ex.n_candidates == N_CANDIDATES, "the expansion does not run its defaults")
    merge = services.merge
    _require((merge.net_size, merge.num_downs, merge.compute_dtype)
             == (1024, 10, torch.bfloat16), "the merge net is not unet_1024 in bf16")
    print(f"{label}: hw {SEED_FIT_HW}, {scene_cfg.pose_traj} x {scene_cfg.num_training} views, "
          f"epochs {epochs}, the seed fit's grid and milestones, stage 2 and 3 "
          f"{SEED_FIT_COMPACT}; expansion {ex}; merge net {merge.net_size}/{merge.num_downs} "
          f"bf16; services {services.resolution}", flush=True)

    expand0, batch0 = expansion.expand_scene, trainer._batch_from_pool
    drawn = []  # the pool size of every batch the trainer drew

    def batch_from_pool(pool, ids, device):
        drawn.append(len(pool[0]))
        return batch0(pool, ids, device)

    with _StepProbe(ts, ff, sm) as probe:
        def expand(*args, **kw):
            launches = (ff.LAUNCHES, sm.LAUNCHES)
            probe._tag = "expand"
            try:
                return expand0(*args, **kw)
            finally:
                probe._tag, probe.tag_next = None, "stage2"
                probe.expand_launches = (ff.LAUNCHES - launches[0], sm.LAUNCHES - launches[1])

        expansion.expand_scene, trainer._batch_from_pool = expand, batch_from_pool
        try:
            torch.cuda.synchronize()
            ff.LAUNCHES = ff.BWD_LAUNCHES = sm.LAUNCHES = 0
            t0 = time.perf_counter()
            mcfg, field, aabb, scene, logfolder = trainer.reconstruction(
                cfg, scene_cfg, services, ex, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            expansion.expand_scene, trainer._batch_from_pool = expand0, batch0
    launches = {"factor_features": ff.LAUNCHES, "factor_features_bwd": ff.BWD_LAUNCHES,
                "shading_mlp": sm.LAUNCHES}
    path = label.replace(" ", "_")
    print(f"{label} launches {launches}, in the expansion's renders A "
          f"{probe.expand_launches[0]} and B {probe.expand_launches[1]}; wall {wall:.3f} s "
          f"with a device sync around every step, on {card}", flush=True)
    for name, count in launches.items():
        _require(count > 0, f"{name} was not launched on the {label}")
        report[name]["launches"] = report[name].get("launches", 0) + count
        report[name].setdefault("launches_by_path", {})[path] = count
    _require(min(probe.expand_launches) > 0
             and any(k[:2] == ("expand", "A") for k in probe.captured),
             f"kernels A and B did not run in the expansion: {sorted(probe.captured)}")
    _require(any(k[:2] == ("stage2", "A'") for k in probe.captured),
             f"kernel A' did not run in the first stage-2 step: {sorted(probe.captured)}")
    _hold_seed_fit_kernels(probe.captured, report, PROGRESSIVE_HELD, label)
    probe.captured.clear()

    rows = [json.loads(line) for line in open(f"{logfolder}/metrics.jsonl")]
    phases = {k[len("phase/"):-2]: v for row in rows for k, v in row.items()
              if k.startswith("phase/")}
    names = ("expand_view_1", *(f"expand1_{p}" for p in EXPAND_PHASES))
    missing = [p for p in names if p not in phases]
    _require(not missing, f"expansion phases not logged: {missing}")
    for name in names:
        print(f"  phase/{name}_s {phases[name]:.4f}", flush=True)
    dibr = f"{logfolder}/DIBR"
    files = sorted(os.path.relpath(os.path.join(d, f), dibr)
                   for d, _, fs in os.walk(dibr) for f in fs)
    _require(files == DIBR_FILES, f"DIBR tree {files} is not {DIBR_FILES}")
    mask = read_png(f"{dibr}/mask/00001.png")
    _require(mask.shape == tuple(SEED_FIT_HW) and 0 < int((mask == 0).sum()) < mask.size,
             "the warped mask has no holes to inpaint")

    boundary = next(r for r in rows if "pool_new_rays" in r)
    n_new = boundary["pool_new_rays"]
    n_steps2 = boundary["iters_per_epoch"] * n2
    kinds = probe.kinds
    stage2 = drawn[boundary["step"]:boundary["step"] + n_steps2]
    from_new = sum(1 for n in stage2 if n == n_new)
    print(f"new view: pool {n_new} rays (replay {boundary['pool_replay_rays']}), stage 2 "
          f"{n_steps2} steps at step {boundary['step']}, {from_new} of them from the new pool; "
          f"steps {len(kinds)}: {kinds.count('dense')} dense, {kinds.count('compact')} "
          f"compacted", flush=True)
    _require(n_new > 0 and len(scene.updates["00001"][0]) == n_new, "the new view's pool is empty")
    _require(from_new >= n_steps2 // 2, f"stage 2 drew {from_new} of {n_steps2} batches from the "
             "new view's pool")
    for kind in ("dense", "compact"):
        print(f"{kind} steps: {len(probe.ms[kind])}, step alone median "
              f"{_median(probe.ms[kind]):.2f} ms, end to end median "
              f"{_median(probe.loop_ms[kind]):.2f} ms; A' by mode {probe.modes[kind]}",
              flush=True)

    # the untrained field the fit started from, upsampled as the fit did
    want_up = tf.n_to_reso(SEED_FIT_VOXELS[1], scene.scene_bbox)
    eval_kw = dict(chunk=cfg.batch_size, app_k=cfg.app_k, white_bg=scene.white_bg,
                   push_depth=scene_cfg.push_depth, near_far=scene.near_far, device=dev)
    _, f0, _, _ = trainer.init_field(cfg, scene, device=dev)
    f0 = tf.upsample_volume_grid(f0, want_up).requires_grad_(False)
    z_floor = ss.supervised_z_floor(scene)
    psnr0 = renderer.evaluation(
        f0, torch.as_tensor(scene.scene_bbox, device=dev), scene.rays_gen_split[:1],
        scene.hw, gt_rgbs=scene.rgbs_gen_split, eval_z_min=z_floor,
        n_samples=tf.default_n_samples(want_up, f0.cfg.step_ratio), **eval_kw)["psnr"][0]
    del f0
    _, f1, aabb1, mask1, loop = ckpt.load_checkpoint(f"{logfolder}/{cfg.expname}_final.npz",
                                                     device=dev)
    f1.requires_grad_(False)
    n_samples = next(r["n_samples"] for r in rows if "n_samples" in r)
    psnr = renderer.evaluation(
        f1, aabb1, scene.rays_gen_split[:2], scene.hw, gt_rgbs=scene.rgbs_gen_split,
        n_samples=n_samples, alpha_mask=mask1, compact_k=cfg.eval_compact_k,
        eval_z_min=z_floor, **eval_kw)["psnr"]
    evals = [(r["step"], r["eval_psnr"]) for r in rows if "eval_psnr" in r]
    print(f"eval PSNR: seed view untrained (upsampled) {psnr0:.4f} dB, final {psnr[0]:.4f} dB; "
          f"generated view final {psnr[1]:.4f} dB; logged means by step {evals} (step "
          f"{loop['global_step']}, view {loop['view_idx']})", flush=True)
    _require(loop["view_idx"] == 1 and all(np.isfinite(psnr)), f"final state {loop}, {psnr}")
    _require(psnr[0] > psnr0 + margin_db,
             f"seed view PSNR {psnr[0]} is not {margin_db} dB above {psnr0}")
    return dict(wall=wall, phases=phases, n_new=n_new, psnr0=psnr0, psnr=psnr, dibr=dibr,
                compact_ms=_median(probe.ms["compact"]), dense_ms=_median(probe.ms["dense"]))


def phase_progressive_fit(dev, card, report, workdir):
    """The progressive fit on the procedural services (module docstring,
    phase 7)."""
    from text2nerf_tpu_torch.services.registry import default_services

    services = default_services(hw=SEED_FIT_HW, device=dev)
    services.inpaint = _Timed(services.inpaint)
    merge = services.merge
    merge.run_finetune = _Timed(merge.run_finetune, keep=True)
    fit = _progressive_fit(dev, card, report, workdir, services, PROGRESSIVE_EPOCHS,
                           "progressive fit", 5.0)
    inpaint_ms, merge_ms = services.inpaint.ms, merge.run_finetune.ms
    iters = merge.run_finetune.args[1]["iters"]
    print(f"inpaint: {len(inpaint_ms)} calls, {_median(inpaint_ms):.2f} ms median; merge "
          f"finetune: {iters} iterations in {merge_ms[0]:.1f} ms, "
          f"{merge_ms[0] / iters:.3f} ms per iteration", flush=True)

    # the merge net on the card against the CPU, on the expansion's inputs
    err, ms_card, ms_cpu = _merge_card_vs_cpu(dev, merge, *merge.run_finetune.args)
    print(f"merge finetune card vs CPU ({MERGE_CHECK_ITERS} iterations, fp32, TF32 off, "
          f"{merge.net_size}/{merge.num_downs}): max |diff| {err:.3e} of the largest output "
          f"(tol {TOL['merge']:g}); {ms_card:.0f} ms on the card, {ms_cpu:.0f} ms on the CPU",
          flush=True)
    _require(err <= TOL["merge"], f"merge finetune card vs CPU: {err} > {TOL['merge']}")
    return {"progressive_wall_s": fit["wall"], "progressive_pool_new_rays": fit["n_new"],
            "progressive_expand_s": fit["phases"]["expand_view_1"],
            "progressive_merge_ms_per_iter": merge_ms[0] / iters,
            "progressive_inpaint_ms": _median(inpaint_ms),
            "progressive_psnr_seed_untrained": fit["psnr0"], "progressive_psnr_seed": fit["psnr"][0],
            "progressive_psnr_generated": fit["psnr"][1],
            "progressive_compact_ms": fit["compact_ms"], "progressive_dense_ms": fit["dense_ms"],
            "progressive_merge_card_vs_cpu": err}


# phase 8: the progressive fit on the generative services at random init
GENERATIVE_WEIGHTS = ("stable-diffusion-2-1-base", "stable-diffusion-2-inpainting",
                      "clip-vit-base-patch32")
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
# the profiler's op names, by what they compute in the UNet and the VAE
PROFILE_GROUPS = {
    "attention": ("aten::baddbmm", "aten::bmm", "aten::_softmax"),
    "convolution": ("aten::cudnn_convolution", "aten::_convolution", "aten::convolution"),
    "group_norm": ("aten::native_group_norm",),
    "linear": ("aten::addmm", "aten::mm"),
}


class _Evals:
    """Counts a UNet's evaluations (batch, input channels) through its
    forward."""

    def __init__(self, unet):
        self.unet, self.forward0, self.calls = unet, unet.forward, []
        unet.forward = self

    def __call__(self, x, *args, **kw):
        self.calls.append((x.shape[0], x.shape[1]))
        return self.forward0(x, *args, **kw)

    def close(self):
        del self.unet.forward


class _Recorded(_Timed):
    """_Timed that keeps every call's output."""

    def __init__(self, fn, keep=False):
        super().__init__(fn, keep)
        self.outs = []

    def __call__(self, *args, **kw):
        out = super().__call__(*args, **kw)
        self.outs.append(out)
        return out


def _flops(make, *shapes):
    """Matmul and convolution FLOPs of one call, counted from the shapes on
    the meta device (torch.utils.flop_counter)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        module = make()
        with FlopCounterMode(display=False) as fc:
            module(*[torch.empty(s) for s in shapes])
    return fc.get_total_flops()


def _profile_shares(fn, dev):
    """fn() under torch.profiler: (device busy ms, {group: share of the
    busy time}, the profiled wall ms), the groups PROFILE_GROUPS' ops'
    self device time."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
    busy = _busy_ms(prof.events())
    self_us = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        self_us[e.key] = self_us.get(e.key, 0.0) + us
    shares = {g: sum(self_us.get(k, 0.0) for k in keys) / 1e3 / busy if busy > 0 else float("nan")
              for g, keys in PROFILE_GROUPS.items()}
    return busy, shares, wall


def _card_vs_cpu(make, state, inputs, dev):
    """One forward of ``make()`` from ``state`` in fp32 (TF32 off) on the
    card and on the CPU: (max |difference| over the largest |CPU output|,
    card ms, CPU ms)."""
    import torch
    from text2nerf_tpu_torch.models.diffusion import materialize

    outs, ms = [], []
    for device in (dev, torch.device("cpu")):
        net = materialize(make, device)
        net.load_state_dict(state, strict=True)
        args = [a.to(device) for a in inputs]
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            t0 = time.perf_counter()
            out = net(*args)
            out = (out["embeds"] if isinstance(out, dict) else out).float().cpu()
            ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
        del net
    torch.cuda.empty_cache()
    return float((outs[0] - outs[1]).abs().max() / outs[1].abs().max()), ms[0], ms[1]


def phase_generative_fit(dev, card, report, workdir):
    """The progressive fit on the diffusion and CLIP services at their
    published widths and seeded random init (module docstring, phase 8),
    then the services' own timings, FLOPs, profile and card-vs-CPU
    checks."""
    import numpy as np
    import torch
    from text2nerf_tpu_torch.models import clip as C
    from text2nerf_tpu_torch.models import diffusion as D
    from text2nerf_tpu_torch.services.registry import default_services
    from text2nerf_tpu_torch.utils.png import read_png

    wdir = os.path.join(workdir, "gen_weights")
    for sub in GENERATIVE_WEIGHTS:
        os.makedirs(os.path.join(wdir, sub))
    t0 = time.perf_counter()
    services = default_services(weights_dir=wdir, hw=SEED_FIT_HW, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    res = services.resolution
    _require(all(res[k] == "real" for k in ("text2img", "inpaint", "rank")),
             f"the generative services did not resolve to their nets: {res}")
    t2i, inp = services.text2img.pipeline, services.inpaint.pipeline
    ranker = services.rank.model
    _require((t2i.unet_cfg, inp.unet_cfg, t2i.vae_cfg, t2i.text_cfg, ranker.cfg)
             == (D.UNetConfig.sd21_base(), D.UNetConfig.sd2_inpaint(), D.VAEConfig(),
                 C.CLIPTextConfig.sd2_text(), C.CLIPVisionConfig.vit_b32()),
             "the services are not at SD 2 / OpenCLIP-H / ViT-B/32 widths")
    _require((t2i.scheduler, t2i.num_steps, inp.scheduler, inp.num_steps)
             == ("euler", 50, "pndm", 50), "the schedulers are not Euler / PNDM at 50 steps")
    n_params = {k: sum(p.numel() for p in m.parameters()) for k, m in (
        ("unet", t2i.unet), ("inpaint_unet", inp.unet), ("vae", t2i.vae), ("text", t2i.text),
        ("clip_vision", ranker))}
    print(f"generative services built in {build_s:.2f} s on {card}: {res}; parameters "
          f"{n_params}; text2img euler x {t2i.num_steps}, inpaint pndm x {inp.num_steps} "
          f"({len(inp._make_schedule().timesteps)} evaluations), bf16 compute", flush=True)

    evals_t2i, evals_inp = _Evals(t2i.unet), _Evals(inp.unet)
    services.text2img = _Recorded(services.text2img)
    services.inpaint = _Recorded(services.inpaint, keep=True)
    services.rank = _Recorded(services.rank, keep=True)
    services.merge.run_finetune = _Timed(services.merge.run_finetune)
    try:
        fit = _progressive_fit(dev, card, report, workdir, services, PROGRESSIVE_EPOCHS,
                               "generative fit", 0.0)
    finally:
        evals_t2i.close()
        evals_inp.close()

    # the seed image: SD 2.1-base, Euler, 50 evaluations of the doubled batch
    _require(evals_t2i.calls == [(2, 4)] * 50, f"text2img evaluations {evals_t2i.calls[:3]}... "
             f"({len(evals_t2i.calls)})")
    seed_img = services.text2img.outs[0]
    _require(seed_img.shape == (*SEED_FIT_HW, 3) and np.isfinite(seed_img).all()
             and 0 <= seed_img.min() <= seed_img.max() <= 1, "the seed image is not an image")
    # 4 inpaint rounds x 5 candidates, each PNDM: 51 evaluations at batch 10
    rounds = services.inpaint.outs
    n_cand = [len(r) for r in rounds]
    _require(n_cand == [5] * 4 and evals_inp.calls == [(10, 9)] * 204,
             f"inpaint rounds {n_cand}, evaluations {len(evals_inp.calls)} "
             f"{set(evals_inp.calls)}")
    cands = [c for r in rounds for c in r]
    for c in cands:
        _require(c.shape == (*SEED_FIT_HW, 3) and c.dtype == np.float32 and np.isfinite(c).all()
                 and 0 <= c.min() <= c.max() <= 1, "a candidate is not a finite [0, 1] image")
    scores = np.asarray(services.rank.outs[0])
    best = int(np.argmax(scores))
    chosen = read_png(f"{fit['dibr']}/rgbs/00001.png")
    _require(scores.shape == (N_CANDIDATES,) and np.isfinite(scores).all()
             and np.array_equal(chosen, read_png(f"{fit['dibr']}/rgbs/00001_{best:03d}.png")),
             f"the chosen view is not candidate {best}, the argmax of the CLIP scores")
    spread = float(np.mean([np.abs(c - cands[0]).mean() for c in cands[1:]]))
    print(f"seed image: 50 Euler evaluations at batch 2, mean {seed_img.mean():.4f}; "
          f"{len(cands)} candidates finite in [0, 1] (mean |c - c0| {spread:.4f}); CLIP scores "
          f"{np.round(scores, 3).tolist()}, argmax {best} chosen", flush=True)

    t2i_ms, inp_ms = services.text2img.ms, services.inpaint.ms
    rank_ms, merge_ms = services.rank.ms, services.merge.run_finetune.ms
    print(f"calls on {card}: text2img {t2i_ms[0]:.1f} ms; inpaint {len(inp_ms)} calls, "
          f"{_median(inp_ms):.1f} ms median ({[round(m, 1) for m in inp_ms]}); rank "
          f"{rank_ms[0]:.1f} ms ({N_CANDIDATES + 1} images); merge finetune {merge_ms[0]:.1f} ms",
          flush=True)

    # ms per UNet evaluation (the inpainting UNet, bf16) and per VAE call,
    # and the UNet's FLOPs counted from its shapes
    lat = SEED_FIT_HW[0] // 8
    gen = torch.Generator(device=dev).manual_seed(3)
    ctx = t2i.encode_text("a beautiful garden with flowers")[0]
    unet_ms = {}
    with torch.no_grad():
        for b in (10, 2):
            x = torch.randn(b, 9, lat, lat, generator=gen, device=dev)
            t = torch.full((b,), 501.0, device=dev)
            c = ctx.expand(b, -1, -1)
            unet_ms[b] = _time_ms(lambda: inp.unet(x, t, c), 3)
        img = torch.rand(1, 3, *SEED_FIT_HW, generator=gen, device=dev) * 2 - 1
        z = torch.randn(5, 4, lat, lat, generator=gen, device=dev)
        enc_ms = _time_ms(lambda: inp.vae.encode(img), 3)
        dec_ms = _time_ms(lambda: inp.vae.decode(z), 2)
    flops = {b: _flops(lambda: D.UNet(D.UNetConfig.sd2_inpaint(), torch.bfloat16),
                       (b, 9, lat, lat), (b,), (b, 77, 1024)) for b in (10, 2)}
    share = {b: flops[b] / (unet_ms[b] * 1e-3) / BF16_FLOPS for b in (10, 2)}
    print(f"UNet evaluation (9 channels, bf16, {lat}^2 latents): batch 10 {unet_ms[10]:.2f} ms "
          f"({flops[10] / 1e12:.3f} TFLOP, {share[10]:.3f} of the {BF16_FLOPS / 1e12:.0f} TFLOP/s "
          f"bf16 peak), batch 2 {unet_ms[2]:.2f} ms ({flops[2] / 1e12:.3f} TFLOP, "
          f"{share[2]:.3f}); VAE encode 1x{SEED_FIT_HW[0]}^2 {enc_ms:.2f} ms, decode 5x{lat}^2 "
          f"{dec_ms:.2f} ms; on {card}", flush=True)

    # one inpaint call under torch.profiler, on the expansion's first inputs
    args, kw = services.inpaint.args
    busy, shares, wall_prof = _profile_shares(lambda: services.inpaint.fn(*args, **kw), dev)
    busy_share = busy / _median(inp_ms)
    print(f"one inpaint call under torch.profiler on {card}: device busy {busy:.1f} ms of the "
          f"unprofiled median {_median(inp_ms):.1f} ms (busy share {busy_share:.3f}; "
          f"{wall_prof:.1f} ms profiled); of the busy time: "
          + ", ".join(f"{g} {v:.3f}" for g, v in shares.items()), flush=True)

    # the full-width inpainting UNet and CLIP ViT-B/32 on the card and the CPU
    g = torch.Generator().manual_seed(4)
    ux = (torch.randn(2, 9, lat, lat, generator=g), torch.full((2,), 501.0),
          torch.randn(2, 77, 1024, generator=g))
    u_err, u_card, u_cpu = _card_vs_cpu(lambda: D.UNet(D.UNetConfig.sd2_inpaint()),
                                        {k: v.cpu() for k, v in inp.unet.state_dict().items()},
                                        ux, dev)
    from text2nerf_tpu_torch.services.clip_rank import preprocess

    cx = (torch.from_numpy(preprocess(services.rank.args[0][0] + [services.rank.args[0][1]]))
          .permute(0, 3, 1, 2).contiguous(),)
    c_err, c_card, c_cpu = _card_vs_cpu(lambda: C.CLIPVisionEncoder(C.CLIPVisionConfig.vit_b32()),
                                        {k: v.cpu() for k, v in ranker.state_dict().items()},
                                        cx, dev)
    print(f"{card} vs CPU (fp32, TF32 off): inpainting UNet batch 2 at {lat}^2 {u_err:.3e} of the "
          f"largest output (tol {TOL['unet']:g}; {u_card:.0f} / {u_cpu:.0f} ms); CLIP ViT-B/32 on "
          f"{cx[0].shape[0]} images {c_err:.3e} (tol {TOL['clip']:g}; {c_card:.0f} / {c_cpu:.0f} "
          f"ms)", flush=True)
    _require(u_err <= TOL["unet"], f"the inpainting UNet card vs CPU: {u_err} > {TOL['unet']}")
    _require(c_err <= TOL["clip"], f"CLIP ViT-B/32 card vs CPU: {c_err} > {TOL['clip']}")
    return {"generative_wall_s": fit["wall"], "generative_expand_s": fit["phases"]["expand_view_1"],
            "generative_inpaint_rank_s": fit["phases"]["expand1_inpaint_rank"],
            "generative_text2img_ms": t2i_ms[0], "generative_inpaint_ms": _median(inp_ms),
            "generative_rank_ms": rank_ms[0], "generative_unet_b10_ms": unet_ms[10],
            "generative_unet_b2_ms": unet_ms[2], "generative_unet_b10_tflop": flops[10] / 1e12,
            "generative_unet_b10_peak_share": share[10], "generative_vae_encode_ms": enc_ms,
            "generative_vae_decode5_ms": dec_ms, "generative_inpaint_busy_share": busy_share,
            "generative_inpaint_shares": shares, "generative_psnr_seed": fit["psnr"][0],
            "generative_psnr_seed_untrained": fit["psnr0"],
            "generative_psnr_generated": fit["psnr"][1], "generative_unet_card_vs_cpu": u_err,
            "generative_clip_card_vs_cpu": c_err}


# stage 3's compaction settings tried on the seed fit (TrainConfig overrides)
SEED_FIT_VARIANTS = {
    "defaults": {},  # compacted K 64, depth-anchored band 6
    "stage3_dense": dict(train_compact_k=0),
    "first_k64": dict(train_depth_cap_band=0),
    "k256_first": dict(train_compact_k=256, train_depth_cap_band=0),
    "k256_band6": dict(train_compact_k=256),
    "smoke": SEED_FIT_COMPACT,
}


def phase_seed_fit_variants(dev, names, hw=(256, 256)):
    """The seed fit at the JAX benchmark's 256^2 once per variant of stage
    3's compaction settings, with an eval of the seed view after every
    epoch and the train metrics logged every step, no device sync between
    steps.  Prints, per variant: the wall time, the eval PSNRs, the train
    PSNR of the last dense step and of the first and last compacted ones."""
    import torch
    from text2nerf_tpu_torch.engine import trainer
    from text2nerf_tpu_torch.engine import train_step as ts
    from text2nerf_tpu_torch.ops.kernels import _build
    from text2nerf_tpu_torch.ops.kernels import factor_features as ff
    from text2nerf_tpu_torch.ops.kernels import shading_mlp as sm

    for name in names:
        root = _build.BUILD_DIR / f"seed_fit_{name}"
        shutil.rmtree(root, ignore_errors=True)
        cfg, scene_cfg = _seed_fit_configs(
            str(root), hw, eval_every_epochs=1, progress_refresh_rate=1, vis_support_views=False,
            **SEED_FIT_VARIANTS[name])
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _StepProbe(ts, ff, sm, measure=False) as probe:
                logfolder = trainer.reconstruction(cfg, scene_cfg, device=dev)[4]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rows = [json.loads(line) for line in open(f"{logfolder}/metrics.jsonl")]
        finally:
            shutil.rmtree(root, ignore_errors=True)
        psnr = [r["psnr"] for r in rows if "psnr" in r]
        evals = [(r["step"], round(r["eval_psnr"], 3)) for r in rows if "eval_psnr" in r]
        compact = [p for p, k in zip(psnr, probe.kinds) if k == "compact"] or [float("nan")]
        dense = [p for p, k in zip(psnr, probe.kinds) if k == "dense"]
        print(f"seed fit variant {name} {SEED_FIT_VARIANTS[name]}: {wall:.1f} s, {len(dense)} "
              f"dense and {probe.kinds.count('compact')} compacted steps; eval PSNR by step "
              f"{evals}; train PSNR "
              f"last dense {dense[-1]:.2f}, compacted first {compact[0]:.2f} last "
              f"{compact[-1]:.2f}", flush=True)


def main(argv):

    import torch

    variants = None
    if argv:
        variants = argv[1:] or list(SEED_FIT_VARIANTS)
        unknown = [n for n in variants if n not in SEED_FIT_VARIANTS]
        if argv[0] != "--seed-fit-variants" or unknown:
            print(f"usage: chip_smoke.py [--seed-fit-variants [NAME ...]], NAME in "
                  f"{list(SEED_FIT_VARIANTS)}", file=sys.stderr)
            return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from text2nerf_tpu_torch.ops.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the text2nerf_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
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
    if variants is not None:
        phase_seed_fit_variants(dev, variants)
        return 0

    report = {}
    phase_kernels(dev, report)
    workdir = str(_build.BUILD_DIR / "smoke")
    os.makedirs(workdir, exist_ok=True)
    try:
        rays_s, max_dev = phase_main_path(dev, card, report, workdir)
    finally:
        for f in os.listdir(workdir):
            os.remove(os.path.join(workdir, f))
    train = phase_train(dev, card, report)
    seed_dir = _build.BUILD_DIR / "seed_fit"
    shutil.rmtree(seed_dir, ignore_errors=True)
    try:
        seed = phase_seed_fit(dev, card, report, str(seed_dir))
    finally:
        shutil.rmtree(seed_dir, ignore_errors=True)
    prog_dir = _build.BUILD_DIR / "progressive_fit"
    shutil.rmtree(prog_dir, ignore_errors=True)
    try:
        prog = phase_progressive_fit(dev, card, report, str(prog_dir))
    finally:
        shutil.rmtree(prog_dir, ignore_errors=True)
    gen_dir = _build.BUILD_DIR / "generative_fit"
    shutil.rmtree(gen_dir, ignore_errors=True)
    try:
        gen = phase_generative_fit(dev, card, report, str(gen_dir))
    finally:
        shutil.rmtree(gen_dir, ignore_errors=True)
    print(json.dumps({"rays_per_s": rays_s, "max_dev": max_dev, **train, **seed, **prog, **gen,
                      "card": card, "wall_s": time.perf_counter() - t_start}), flush=True)
    kernels = [report[k] for k in ("factor_features", "shading_mlp", "factor_features_bwd")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
