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
   consecutive steps, fp32 and bf16 (the tables' bf16 copy, a bf16
   app_raw), three output modes, held bit for bit, and timed in bf16 in
   each mode beside its plain version, F.grid_sample on bf16 tables and
   the bound for the bf16 bytes;
   kernel B: 1M rows, and in its view-dependent mode (TensoRF's MLP_Fea
   head, 32 rows a ray) 1M rows with its registers and spills; the eval
   prepass: one 512^2 view of the serving
   shell through a 200^3 pool-3 mask, 16 chunks of 16384 rays at 259
   samples, K 32, held element for element to the plain select and timed
   with its launches queued and as the host issues them; kernel A':
   adversarial inputs (a run inside one
   cell, every upper edge, runs that cross rays, a ragged n, zero
   gradients, accumulation, both of its routes), then 1M samples at
   the train step's shape, 16384 rays x 64 consecutive steps, in three
   layouts (neighbouring rays, the train sampler's random rays, the
   neighbours shuffled), random output gradients, fp32, held to a
   tolerance relative to each table's largest gradient, with the
   reductions it issues counted on the host); kernel A' in bf16 (a bf16
   d_app_raw) on the same adversarial inputs and at the train step's
   shape in the three layouts, each timed; kernels C and
   C' on adversarial inputs (every edge, one cell, a 1-component CP, rays
   of 259 steps with an odd n, whole runs of zero gradient, each ray's
   samples shuffled, no gradient at all, accumulation, the generic
   route), then on a TensorCP field at its published widths (96 / 288)
   on the 300^3 grid at three shapes: 1M samples at the train step's
   shape, and a TensorCP dense step's two launches (density-only over
   16384 rays x 259 ray-ordered samples, app-only over each ray's top 64
   samples by weight), fp32 and bf16 (the lines' bf16 copy, a bf16
   app_raw and d_app_raw), three output modes, C bit for bit reported
   (and required in bf16), each shape timed in its own mode in both
   compute types with the line traffic worked out from the samples and
   the bound for each type's bytes; then C and C' beside their second
   design (tools/kernel_baselines/cp_features_v2.cu and its wrapper,
   fp32 lines and gradients in bf16), both compute types timed by
   tools/kernel_variants.py in one run; C and C' in bf16 at the fused
   shape beside their plain versions and F.grid_sample on bf16 lines;
   with times, the library yardstick and the bound (kernel B's on the
   3xTF32 tensor-core route it takes, the fp32 CUDA-core bound printed
   beside it);
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
   step 30, 1 stage-1 epoch of dense steps (cut from 2 to keep the smoke's
   wall under 1000 s), 1 stage-3 epoch of compacted
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
   (circle0_30, a real disocclusion) with phase 6's configuration but no
   alpha-mask milestone (as in the shipped config, so the grid stays
   300^3 and its box unshrunk), and n_stage1 1, n_stage2 1, n_stage3 1,
   on default_services: procedural
   text2img and depth, diffusion_fill_inpaint, histogram_rank, and the
   merge net at its production shape (unet_1024, 10 downs, bf16, seeded
   random init), with ExpansionConfig's defaults (20 candidates, 500
   merge iterations), and one sub-batch a dense step (the phase's cut:
   the trainer's default is 32 host-bound sub-batches, which phase 6
   still times; phases 10 and 12 inherit it).  Every phase/expand1_* row
   must be logged, the
   DIBR/ tree complete when reconstruction returns, the new view's pool
   non-empty and sampled by most stage-2 steps; kernels A and B must be
   launched in the expansion's renders and A' in the first stage-2 step,
   each held against its plain version on inputs captured there; the
   seed view's final PSNR must beat the untrained field's by 5 dB.  The
   fit runs with resume on and a resume point every epoch, and must
   leave its last resume point and scene snapshot in its log folder.  The
   expansion's merge call runs again, fp32 with TF32 off and 2
   iterations, on the card and on the CPU, held within a relative bound.
   Prints the wall of each expansion sub-phase, ms per merge iteration
   and per inpaint call, and the fit's wall and step ms;
8. generative fit through the command line: text2nerf_tpu_torch.main.main
   on configs/text2nerf_scenes.txt with flags for phase 7's fit (512^2,
   circle0_30, 2 views, 1 / 1 / 1 epochs, seed 11, stage 3 at K 256,
   app_k 256, band 0; the adaptive eval renderer; 4 test frames; no
   alpha-mask milestone, as in the shipped config; --train_microbatch 1,
   phase 7's cut), under the CLI's
   production overrides (a 300^3 grid from the first step, batch 16384;
   the masks' default pool 3 keeps every step dense), on a weights
   directory whose
   stable-diffusion-2-1-base/, stable-diffusion-2-inpainting/ and
   clip-vit-base-patch32/ exist and hold no checkpoint, and whose leres/
   holds a res101.pth: the SD 2 UNets, the VAE, the OpenCLIP-H text
   tower, the CLIP ViT-B/32 ranker and the boosted ResNeXt-101 LeReS at
   their published widths and seeded random init, bf16 compute.  The
   smoke wraps registry.default_services (to count and time the
   services' calls) and trainer.reconstruction (to read its result).
   main must return 0; the services must resolve "real"; the seed image
   come from 50 Euler evaluations of the 4-channel UNet at batch 2; both
   depth calls (the bootstrap's, the expansion's) return finite counts
   spanning [0, 65535]; the expansion make 4 inpaint calls of 5
   candidates, each 51 PNDM evaluations of the 9-channel UNet at batch
   10; every candidate be a finite 512x512x3 image in [0, 1] and the
   chosen one the argmax of the CLIP scores; every phase/expand1_* row be
   logged and kernels A, A' and B launched (held as in phase 7); the seed
   view's final PSNR beat the untrained field's.  Then the render-only
   branch (--render_only 1 --render_test 1 --ckpt <the fit's
   checkpoint>, the fit's scene snapshot beside it) must write the fit's
   test frames again; then ms per UNet evaluation (batch 10 and 2), per
   VAE encode and decode, the UNet's FLOPs from its shapes and its share
   of the bf16 peak, one inpaint call under torch.profiler (busy share,
   attention / convolution / GroupNorm / linear shares), and one forward
   of the full-width inpainting UNet (batch 2) and of CLIP ViT-B/32 on the
   card and the CPU (fp32, TF32 off), held within a relative bound;
9. depth family: one boosted estimate of the fit's seed image and one of
   the procedural seed image (wall, device-busy share under
   torch.profiler, LeReS evaluations by size, patches), ms per LeReS
   evaluation at 448, 896 and each processing size (CUDA events), its
   device-busy ms under torch.profiler, its FLOPs and share of the bf16
   peak, the fallback merge's ms, one
   pix2pix merge_double at 1024 (unet_1024, random init), the MiDaS,
   SGRNet (ResNet-50) and RelDepthNet stand-in forwards once each in
   bf16, and the ResNeXt-101 LeReS at 448^2 on the card against the CPU
   (fp32, TF32 off) within 1e-3 of the largest output;
10. resume, at phase 7's configuration: (a) phase 7's fit again with
   checkpoint_backend="orbax" (directory checkpoints through
   torch.distributed.checkpoint) and an inpaint service that raises on
   its second call (after the stage-2 boundary's resume point is
   written; the point's loop state, read from <expname>_resume/, must be
   the boundary's), then rerun with resume: it must log its resume
   epoch, not bootstrap, launch kernels A, A' and B, end with per-view
   PSNRs within 0.5 dB of phase 7's (both final checkpoints rendered at
   phase 7's sample count) and write <expname>_final/ equal to its
   _final.npz bit for bit; the directory saves' ms, the npz saves' of the
   same run and the field's bytes are printed beside phase 7's npz
   resume saves; (b) phase 7's last
   resume point (the entry of stage 3) resumed in a copy of its log
   folder, its PSNRs printed beside phase 7's; (c) view 1 expanded again
   with update_known_views on phase 7's final field and its scene cut
   back to view 0: the warp2known artifacts written, view 0's pool
   rebuilt and non-empty, its image changed only where the back-warp's
   mask is set; (d) evaluation(compute_extra_metrics=True) of phase 6's
   final field at 512^2 with LPIPS alex and vgg at a seeded random init
   in the torch originals' layout, then SSIM and LPIPS of its render on
   the card against the CPU (SSIM within 1e-6, LPIPS within 1e-4 of the
   value, fp32 with TF32 off), with ms per call on the card.  The kernel
   counts are set to 0 before and read after each of (a) to (d);
11. the TensoRF family through the command line: four runs of
   text2nerf_tpu_torch.main.main on phase 7's fit (512^2, circle0_30, 2
   views, 1 / 1 / 1 epochs, seed 11, the adaptive eval renderer, 4 test
   frames; the CLI's masks keep every step dense, at its app_k 64) on the
   procedural services, with one sub-batch a dense step
   (--train_microbatch 1: the phase's one cut), each with the kernel
   counts set to 0 just before and
   read just after, every step timed between device syncs: (1) TensorCP
   at TensoRF's published widths (--n_lamb_sigma 96 --n_lamb_sh 288,
   MLP_Fea, fea_pe / view_pe 2, L1 1e-5): kernels C and C' launched, the
   seed view 5 dB above the untrained field, the render-only branch's
   frames equal to the fit's, its profiled dense step's device time
   split into kernels C and C', the head, topk and the rest; then, in
   a count window of its own (family_cp_bf16_step, opened once the
   field and targets are made), the run's configuration trained in bf16
   on the 300^3 grid toward phase 5's targets: one dense crop step on
   the card held against the CPU, and the dense step timed in turns
   fp32, bf16, bf16, fp32 with the lines' bf16 copies counted per step
   (C and C' in bf16 must be launched); (2)
   TensorVM (16 / 48, SH on the cubic
   300^3 grid): kernels A and A' launched, the same PSNR gate; (3) the
   shipped config with --train_compute_dtype bf16: kernels A, A' in bf16
   and B launched, the same PSNR gate, then phase 5's configuration in
   bf16 and fp32, in turns, ms per step printed beside phase 5's, and one
   bf16 crop step on the card held against the CPU; (4) --ndc_ray 1:
   finite frames, the seed view above the untrained field.  Prints each
   run's wall, ms per step and PSNRs;
12. the scene farm: parallel.scene_farm.run_farm_parallel over two
   prompts on [cuda:0, cuda:0] (two worker threads on the one card),
   each scene progressive_runner's whole pipeline on its own
   default_services (procedural services, the merge net unet_1024 at
   random init): phase 7's configuration (full model width, 300^3,
   circle0_30, two views, 1 / 1 / 1 epochs, stage 3 at K 256) with two
   cuts, 256^2 views and 100 merge iterations (of 500).  Kernels A, A'
   and B must be launched, and every scene's seed view must end 5 dB
   above its untrained field (rendered as the runner evaluates).  Prints
   the farm's wall, each scene's wall_s, device_idle_s and PSNRs, and the
   sum of the scene walls over the farm's wall (how far two workers
   overlap on one card); then scene 0 again alone (run_farm, a folder of
   its own: twice its wall over the farm's is the workers' speed-up).
   Then run_farm over the same prompts must be
   served from the completion markers (equal wall_s, no launch).  Then
   fit_scenes_mesh: two full-width fields (serving shells 2 and 3) toward
   phase 5's targets, 10 dense steps each (batch 16384, R = 32): kernels
   A and A' launched, every scene's mse falling;
13. the mesh: two gloo ranks on the one card (NCCL refuses two ranks on
   one GPU; gloo all-reduces the CUDA tensors, and the phase fails if it
   cannot), each a process started by parallel.dryrun.launch: one
   full-width dense train step (16384 rays, R = 1) at data 2 x model 1
   and one at data 1 x model 2 (shards of 16 density + 24 app channels),
   each against the one-process step over the same batch, gradients
   within 1e-4 of each leaf's largest; each sharded step's own launches
   (counted from 0 after its reference step) must hold kernels A and A',
   per case and rank, and are added to the report;
14. merge pretraining at unet_1024 (bf16) for 20 steps on two procedural
   seed depths after 2 warm-up steps (finite losses, ms per step), the
   PatchGAN discriminator
   at 512^2 on the card against the CPU (fp32, TF32 off, 1e-4 of the
   largest logit), and the sparse bilateral filter's device backend on
   the card against the native library on the bootstrap's 512^2 inputs
   (bit for bit), with the ms of each;
15. the full-schedule quality tool at a cut depth:
   text2nerf_tpu_torch.tools.run_full_schedule.main at the field's full
   width (300^3 after 150^3 -> 300^3 at steps 8 and 16, inside stage 1)
   with 256^2 views, 2 views, 1 / 1 / 1 epochs and 2 candidates (the
   cuts): its JSON line must hold every key of the
   JAX tool's, kernels A, A' and B must be launched; then compute_metrics
   on its renders, report_phases on its log, and rebuild_scene_snapshot
   on a copy of its log folder, whose views 0 and 1 must match the fit's
   scene within the PNGs' quantization; then render_rays_compact_flagged
   on the fit's field and seed view under each select_impl name (sort,
   topk, rank: one sort in the port; kernels A and B launched), topk and
   rank equal to sort.

Prints the smoke's wall, a JSON line of per-kernel numbers, then as the
last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Needs one GPU and no network.  Exits nonzero without CUDA, or without the
text2nerf_tpu_torch package beside it.

    python3 chip_smoke.py --seed-fit-variants [NAME ...]

builds the kernels, then runs only the seed fit at 256^2 under each of
SEED_FIT_VARIANTS' stage-3 compaction settings (all when none is named),
with no device sync between steps, and prints a line for each.

    python3 chip_smoke.py --microbatch R

runs the whole smoke with phases 7, 8, 10 and 12 at R sub-batches a
dense step instead of their cut's one (R = 32, the trainer's default,
is the uncut run; its phase clock gives what the cut saves).
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
    # kernel C vs its plain version, of the largest value: the same
    # operations in the same order (no FMA contraction, bf16 rounding at
    # every op); the density sum in fp64 is order-free unless its terms
    # span more than 2^29, then rounded once
    "cp": 1e-6,
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
    # the render-only branch's test frames vs the fit's (8-bit PNGs): the
    # same field, mask, z-floor and renderer, so the same bytes
    "render_only": 1e-6,
    # the mesh's train step (phase 13) vs the one-process step over the
    # same batch, each gradient leaf relative to its largest: the data
    # split changes the loss's sums, the model split the basis product's,
    # and both run kernels A' whose atomics add in a changing order
    "mesh": 1e-4,
    # the PatchGAN discriminator (fp32, TF32 off), card vs CPU, of the
    # largest logit: five convolutions of up to 4096-term sums
    "disc": 1e-4,
    # the sparse bilateral filter's device backend vs the native library:
    # the same comparisons, 0/1 weights and float32 prefix sums in order
    "filter": 0.0,
    # ResNeXt-101 LeReS at 448^2 (fp32, TF32 off), card vs CPU, of the
    # largest output: 33 residual blocks of conv sums in other orders
    "leres": 1e-3,
    # SSIM at 512^2 in float64, card vs CPU: the same window sums in the
    # same order, a mean of 0.25M terms in another
    "ssim": 1e-6,
    # LPIPS (fp32, TF32 off), card vs CPU, of the value: 5 or 13 convs in
    # other orders, then channel norms and a mean over each layer
    "lpips": 1e-4,
}
SEED_FIT_HW = (512, 512)
SEED_FIT_EPOCHS = (1, 1)  # n_stage1, n_stage3
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
    march steps each, from a seeded start step per ray (the first step
    when k is the whole march)."""
    import torch
    from text2nerf_tpu_torch.models import tensorf as tf
    from text2nerf_tpu_torch.ops.rays import aabb_slab_entry

    r = rays[: n // k]
    reso = tf.grid_resolution(field)
    step = tf.step_size(aabb, reso, field.cfg.step_ratio)
    n_samples = tf.default_n_samples(reso, field.cfg.step_ratio)
    t_min = aabb_slab_entry(r[:, :3], r[:, 3:], aabb, field.cfg.near, field.cfg.far)
    if k < n_samples:
        s0 = torch.randint(0, n_samples - k, (r.shape[0], 1), generator=gen, device=r.device)
    else:
        s0 = torch.zeros((r.shape[0], 1), dtype=torch.int64, device=r.device)
    steps = (s0 + torch.arange(k, device=r.device)).float()
    z = t_min[:, None] + step * steps
    pts = r[:, None, :3] + r[:, None, 3:] * z[..., None]
    return torch.clamp(tf.normalize_coord(aabb, pts), -1, 1).reshape(-1, 3).contiguous()


def _unique_row_bytes(xn, field, want_sigma, want_app, elem=4):
    """Bytes of the table rows these samples touch, each counted once, at
    ``elem`` bytes a channel (4: the fp32 tables, 2: their bf16 copy)."""
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
        total += (torch.unique(rows).numel() + torch.unique(lrows).numel()) * width * elem
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


def _time_a_bf16(field, xn, flush, err):
    """Kernel A in bf16 at phase 3's 1M samples, in its three output
    modes: ms, the plain version's ms, F.grid_sample on the tables' bf16
    copy (bf16 grid) and the bound for the bf16 bytes (xn, fp32
    sigma_feat, bf16 app_raw, the unique rows of the bf16 copy).  Returns
    the kernels-line entry."""
    import torch
    from text2nerf_tpu_torch.ops.kernels import factor_features as ff

    bf = torch.bfloat16
    planes, lines, nd = tuple(field.planes), tuple(field.lines), field.nd
    n = xn.shape[0]
    ff.bf16_tables((*planes, *lines))  # the copy a render call makes once
    rep = dict(name="factor_features_bf16", route="cuda",
               source="text2nerf_tpu_torch/csrc/factor_features.cu",
               replaces="text2nerf_tpu/models/tensorf.py:538",
               max_abs_err=err, ms_by_mode={}, plain_ms_by_mode={}, library_ms_by_mode={},
               bound_ms_by_mode={})
    for mode, sig, app in (("fused", True, True), ("density", True, False),
                           ("app", False, True)):
        ms = _time_ms(lambda: ff.factor_features(xn, planes, lines, nd, sigma=sig, app=app,
                                                 dtype=bf), 10, flush)
        plain = _time_ms(lambda: ff.factor_features_plain(xn, planes, lines, nd, sigma=sig,
                                                          app=app, dtype=bf), 3, flush)
        lo = [0 if sig else d for d in nd]
        hi = [p.shape[2] if app else d for p, d in zip(planes, nd)]
        pn = [p[..., a:b].permute(2, 0, 1)[None].to(bf).contiguous()
              for p, a, b in zip(planes, lo, hi)]
        ln = [l[:, a:b].T[None, :, :, None].to(bf).contiguous() for l, a, b in zip(lines, lo, hi)]
        nd_m = list(nd) if sig else [0, 0, 0]
        lib = _time_ms(lambda: _grid_sample_features(xn.to(bf), pn, ln, nd_m), 3, flush)
        del pn, ln
        width = sum(b - a for a, b in zip(lo, hi))
        na = sum(p.shape[2] - d for p, d in zip(planes, nd)) if app else 0
        out_b = n * (4 if sig else 0) + n * 2 * na
        rows = _unique_row_bytes(xn, field, sig, app, elem=2)
        bound, by = _bound(n * 12 + out_b + rows, n * width * 14)  # ops at the fp32 peak
        rep["ms_by_mode"][mode], rep["plain_ms_by_mode"][mode] = ms, plain
        rep["library_ms_by_mode"][mode], rep["bound_ms_by_mode"][mode] = lib, bound
        moved = n * 12 + out_b + rows
        print(f"kernel A {mode} bf16: {ms:.3f} ms, plain {plain:.3f} ms, grid_sample (bf16 "
              f"tables) {lib:.3f} ms, bound {bound:.3f} ms by {by} ({moved / 1e6:.1f} MB: "
              f"{out_b / 1e6:.1f} MB output, {n * 12 / 1e6:.1f} MB xn, {rows / 1e6:.1f} MB "
              f"unique bf16 rows; {n * width * 14 / 1e9:.2f} GFLOP), {bound / ms:.3f} of the "
              f"bound, for {n} samples", flush=True)
        if mode == "fused":
            rep.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by)
    return rep


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
            _require(all(g is None or g.dtype == r.dtype for g, r in zip(got, ref)),
                     f"kernel A {dtype_name} {mode}: output dtypes differ from the plain "
                     f"version's")
            err = max(float((g.float() - r.float()).abs().max())
                      for g, r in zip(got, ref) if g is not None)
            tol = TOL[dtype_name]
            scale = max(float(r.abs().max()) for r in ref if r is not None)
            print(f"kernel A {dtype_name:4s} {mode:7s} max_abs_err {err:.3e} (tol {tol:g}) "
                  f"at max |value| {scale:.4g}; app_raw "
                  f"{'-' if got[1] is None else str(got[1].dtype).split('.')[-1]}", flush=True)
            _require(err <= tol, f"kernel A {dtype_name} {mode}: {err} > {tol}")
            if mode == "fused":
                err_a = err if dtype is None else err_a
                err_a16 = err if dtype is not None else None

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
    report["factor_features_bf16"] = _time_a_bf16(field, xn, flush, err_a16)
    del planes_nchw, lines_nc1, lib_sig, lib_app, ref_sig, ref_app

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
    report["shading_mlp_view"] = phase_view_head(dev, gen, flush)
    report["eval_prepass"] = phase_prepass(dev, field, aabb, rays, flush)
    phase_backward(field, aabb, rays, gen, flush, report)
    phase_cp_kernels(dev, report, rays, aabb, gen, flush, field)
    del field, flush_buf, x
    torch.cuda.empty_cache()


#: rows a ray of kernel B's view mode in phase 3: the eval's base rung
VIEW_ROWS_A_RAY = 32


def _kernel_registers(name, kernel):
    """ptxas's registers, stack and spills of ``kernel`` (a fragment of its
    mangled name) from this process's build log of ``csrc/<name>.cu``."""
    from text2nerf_tpu_torch.ops.kernels import _build

    lines = (_build.BUILD_LOGS.get(name) or "").splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line and kernel in line:
            return " ".join(x.strip().replace("ptxas info    : ", "") for x in lines[i + 1:i + 3])
    return "not in this process's build log (built earlier)"


def phase_view_head(dev, gen, flush):
    """Kernel B's view-dependent mode (the eval MLP_Fea head) at TensoRF's
    CP head (27 features, fea_pe 2, view_pe 2, 128 wide) on 1M rows, 32 a
    ray, against its plain version, timed beside it and three
    ``torch.addmm`` (TF32 off) on the head input made beforehand, with the
    bound of its 3xTF32 route."""
    import torch
    from text2nerf_tpu_torch.models import tensorf as tf
    from text2nerf_tpu_torch.models.mlp import positional_encoding
    from text2nerf_tpu_torch.ops.kernels import shading_mlp as sm

    cfg = tf.TensoRFConfig(model_name="cp", density_n_comp=(96,), app_n_comp=(288,),
                           shading_mode="MLP_Fea", fea_pe=2, view_pe=2)
    head = tf.init_params(cfg, (4, 4, 4), generator=gen, device=dev).requires_grad_(False).mlp
    k = VIEW_ROWS_A_RAY
    feats = 2.0 * torch.randn(N_ROWS_B, cfg.app_dim, generator=gen, device=dev)
    dirs = torch.nn.functional.normalize(
        torch.randn(N_ROWS_B // k, 3, generator=gen, device=dev))
    args = (head, feats, dirs, k, cfg.fea_pe, cfg.view_pe)
    got, ref = sm.shade_fea(*args), sm.shade_fea_plain(*args)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    print(f"kernel B view mode max_abs_err {err:.3e} (tol {TOL['head']:g})", flush=True)
    _require(err <= TOL["head"], f"kernel B view mode: {err} > {TOL['head']}")
    ms = _time_ms(lambda: sm.shade_fea(*args), 10, flush)
    plain = _time_ms(lambda: sm.shade_fea_plain(*args), 3, flush)
    d = torch.repeat_interleave(dirs, k, 0)
    x = torch.cat([feats, d, positional_encoding(feats, cfg.fea_pe),
                   positional_encoding(d, cfg.view_pe)], -1)

    def addmm3():
        h = torch.addmm(head.b1, x, head.w1).relu_()
        h = torch.addmm(head.b2, h, head.w2).relu_()
        return torch.addmm(head.b3, h, head.w3).sigmoid_()

    lib = _time_ms(addmm3, 5, flush)
    in_dim, fc = head.w1.shape
    flops_12 = N_ROWS_B * 2 * (in_dim * fc + fc * fc)
    moved = N_ROWS_B * (cfg.app_dim + 3) * 4 + dirs.numel() * 4 + sum(
        head[n].numel() * 4 for n in ("w1", "b1", "w2", "b2", "w3", "b3"))
    bound, by = _bound(moved, 3 * flops_12, TF32_FLOPS)
    regs = _kernel_registers("shading_mlp", "shade_view_kernel")
    print(f"kernel B view mode ({in_dim} in, {k} rows a ray): {ms:.3f} ms, plain {plain:.3f} ms, "
          f"3x addmm (TF32 off) {lib:.3f} ms, bound {bound:.3f} ms by {by} (3xTF32: 3 x "
          f"{flops_12 / 1e9:.1f} GFLOP at 495 TFLOP/s); {regs}", flush=True)
    del x, d
    return dict(name="shading_mlp_view", route="cuda",
                source="text2nerf_tpu_torch/csrc/shading_mlp.cu",
                replaces="text2nerf_tpu/models/mlp.py:101",  # XLA's head: no Pallas kernel
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=lib, registers=regs)


PREPASS_CHUNK, PREPASS_K, PREPASS_LADDER = 16384, 32, (32, 64, 128)


def _queued_ms(fn, reps, flush):
    """Mean device ms of ``fn``'s launches, as :func:`_time_ms`, but issued
    while the device sleeps: the window holds the launches' own time and
    not the host's time to issue them.  ``fn`` must not synchronize."""
    import torch

    fn()
    total = 0.0
    for _ in range(reps):
        flush()
        torch.cuda._sleep(100_000_000)  # ~50 ms: the host queues fn meanwhile
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _prepass_bytes(field, aabb, rays, mask, n_samples):
    """Bytes the eval prepass of one 512^2 view must move: the rays in,
    each slot's outputs out (idx 4, sel 1, z 4, xn 12 B), n_live and the
    rung (9 B) a ray, and each mask value a sample in the box reads, once
    (the kernel reads the mask only there)."""
    import torch
    from text2nerf_tpu_torch.models import tensorf as tf
    from text2nerf_tpu_torch.ops import render as Rd

    volume = mask["volume"]
    touched = []
    for s in range(0, rays.shape[0], PREPASS_CHUNK):
        part = rays[s:s + PREPASS_CHUNK]
        rays_o, rays_d, _, _, z = Rd._march(field.cfg, field, aabb, part, n_samples)
        pts = rays_o[:, None] + rays_d[:, None] * z[..., None]
        valid = Rd._in_aabb(pts, aabb) & (pts[..., 2] > 2.0)
        xn = torch.clamp(tf.normalize_coord(mask["aabb"], pts[valid]), -1.0, 1.0)
        d, h, w = volume.shape
        ix, iy, iz = (torch.round((xn[:, c] + 1) * 0.5 * (n - 1)).to(torch.int64)
                      for c, n in enumerate((w, h, d)))
        touched.append(torch.unique((iz * h + iy) * w + ix))
    voxels = int(torch.unique(torch.cat(touched)).numel())
    n = rays.shape[0]
    return n * rays.shape[1] * 4 + n * PREPASS_K * 21 + n * 9 + voxels * volume.element_size()


def phase_prepass(dev, field, aabb, rays, flush):
    """The eval prepass kernel against the plain select on one 512^2 view
    of the serving field through a 200^3 pool-3 mask (the render cell's
    shape: 16 chunks of 16384 rays, 259 samples, K 32, ladder 32/64/128),
    element for element, then a view's 16 launches timed, L2 flushed
    before each view, beside the plain select and the bound."""
    import torch
    from text2nerf_tpu_torch.models import tensorf as tf
    from text2nerf_tpu_torch.ops import render as Rd
    from text2nerf_tpu_torch.ops.kernels import eval_prepass as ep

    mask, _ = tf.update_alpha_mask(field, aabb, (200, 200, 200), pool=3, device=dev)
    n_samples = tf.default_n_samples(tf.grid_resolution(field), field.cfg.step_ratio)
    kw = dict(n_samples=n_samples, k=PREPASS_K, eval_z_min=2.0, occ_stride=1,
              select_impl="sort", need_ladder=PREPASS_LADDER)
    chunks = [rays[s:s + PREPASS_CHUNK] for s in range(0, rays.shape[0], PREPASS_CHUNK)]
    live = 0
    for part in chunks:
        got = Rd._select_kernel(field, aabb, part, mask, **kw)
        want = Rd._select_plain(field, aabb, part, mask, **kw)
        for name, g, w in zip(("step", "idx", "sel", "z_k", "xn_k", "n_live", "rung"), got, want):
            _require(torch.equal(g.to(w.dtype), w),
                     f"eval prepass: {name} differs from the plain select")
        live += int(want[5].sum())
    print(f"eval prepass: {len(chunks)} chunks equal to the plain select element for element "
          f"({live} live samples, n_samples {n_samples})", flush=True)

    def view(select):
        for part in chunks:
            select(field, aabb, part, mask, **kw)

    before = ep.LAUNCHES
    ms = _queued_ms(lambda: view(Rd._select_kernel), 10, flush)
    paced = _time_ms(lambda: view(Rd._select_kernel), 10, flush)
    launches = ep.LAUNCHES - before
    plain = _time_ms(lambda: view(Rd._select_plain), 3, flush)
    # about 60 operations a sample: the point, the box test, the mask index
    moved = _prepass_bytes(field, aabb, rays, mask, n_samples)
    ops = 60 * rays.shape[0] * n_samples
    bound, by = _bound(moved, ops)
    print(f"eval prepass: {ms:.3f} ms a view ({len(chunks)} launches queued; {paced:.3f} ms "
          f"as the host issues them), plain select {plain:.3f} ms, bound {bound:.4f} ms by "
          f"{by} (bytes {moved / 1e6:.1f} MB: {moved / HBM_BPS * 1e3:.4f} ms; operations "
          f"{ops / FP32_FLOPS * 1e3:.4f} ms); {launches} launches timed", flush=True)
    return dict(name="eval_prepass", route="cuda",
                source="text2nerf_tpu_torch/csrc/eval_prepass.cu",
                replaces="text2nerf_tpu/ops/render.py:589", max_abs_err=0.0, ms=ms,
                host_paced_ms=paced, plain_ms=plain, bound_ms=bound, bound_by=by)


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
    phase_backward_bf16(field, aabb, rays, gen, flush, report, layouts)


def phase_backward_bf16(field, aabb, rays, gen, flush, report, layouts):
    """Kernel A' in bf16 (the bf16 train step's backward: the tables' bf16
    copy, a bf16 d_app_raw as autograd hands it back for kernel A's bf16
    app_raw) against its plain version: the adversarial cases in three
    modes, then 1M samples at the train step's shape in phase 3's three
    layouts, each timed, the coherent one beside the plain version and
    F.grid_sample's backward on bf16 tables.  Both add the same
    bf16-rounded terms in fp32, in another order: TOL["bwd"]."""
    import torch
    from text2nerf_tpu_torch.ops.kernels import factor_features as ff

    bf = torch.bfloat16
    worst = 0.0
    for name, planes_c, lines_c, nd_c, x, ds_all, da_all, route, acc in _bwd_cases(
            rays.device, gen):
        da_all = da_all.to(bf)
        for mode, ds, da in (("fused", ds_all, da_all), ("density", ds_all, None),
                             ("app", None, da_all)):
            ref = ff.factor_features_backward_plain(x, planes_c, lines_c, nd_c, ds, da, bf)
            got = ff.factor_features_backward(x, planes_c, lines_c, nd_c, ds, da, dtype=bf)
            torch.cuda.synchronize()
            _require(ff.BWD_LAST_GRID[0] == route,
                     f"kernel A' bf16 {name}: route {ff.BWD_LAST_GRID[0]}, not {route}")
            err = _bwd_rel_err(got, ref, f"kernel A' bf16 {name} {mode}")
            worst = max(worst, err)
            _require(err <= TOL["bwd"], f"kernel A' bf16 {name} {mode}: {err} > {TOL['bwd']}")
    print(f"kernel A' bf16 adversarial cases: worst {worst:.3e} of each table's largest over "
          f"three modes (tol {TOL['bwd']:g}), bf16 d_app_raw", flush=True)

    planes, lines, nd = tuple(field.planes), tuple(field.lines), field.nd
    n = N_RAYS_TRAIN * K_TRAIN
    na = sum(p.shape[2] - d for p, d in zip(planes, nd))
    c_total = sum(p.shape[2] for p in planes)
    # the output gradients of a bf16 step: d_app_raw comes out of a bf16
    # matrix product, d_sigma is fp32 (the kernel rounds it)
    d_sig = torch.randn(n, generator=gen, device=rays.device)
    d_app = torch.randn(n, na, generator=gen, device=rays.device).to(bf)
    table_bytes = sum(t.numel() * 4 for t in (*planes, *lines))
    bytes_in = n * (12 + 4 + 2 * na)
    flops = n * c_total * 28
    times, bounds, errs, abs_err = {}, {}, {}, 0.0
    for layout, xn in layouts.items():
        got = ff.factor_features_backward(xn, planes, lines, nd, d_sig, d_app, dtype=bf)
        ref = ff.factor_features_backward_plain(xn, planes, lines, nd, d_sig, d_app, bf)
        torch.cuda.synchronize()
        errs[layout] = _bwd_rel_err(got, ref, f"kernel A' bf16 {layout}")
        _require(errs[layout] <= TOL["bwd"],
                 f"kernel A' bf16 {layout}: {errs[layout]} > {TOL['bwd']}")
        abs_err = max(abs_err, max(float((g - r).abs().max()) for g, r in
                                   zip((*got[0], *got[1]), (*ref[0], *ref[1]))))
        if layout == "coherent":
            f32 = ff.factor_features_backward(xn, planes, lines, nd, d_sig, d_app.float())
            off32 = _bwd_rel_err(got, f32, "kernel A' bf16 vs fp32")
            del f32
        del got, ref
        times[layout] = _time_ms(lambda: ff.factor_features_backward(
            xn, planes, lines, nd, d_sig, d_app, dtype=bf), 10, flush)
        rows = _unique_row_bytes(xn, field, True, True, elem=2)
        bounds[layout] = _bound(bytes_in + rows + table_bytes, flops)
        print(f"kernel A' bf16 {layout:9s}: {times[layout]:.3f} ms, bound {bounds[layout][0]:.3f} "
              f"ms by {bounds[layout][1]} ({bounds[layout][0] / times[layout]:.3f} of it; "
              f"{rows / 1e6:.1f} MB unique bf16 rows); within {errs[layout]:.3e} of the plain "
              f"version's largest (tol {TOL['bwd']:g})", flush=True)
    xn = layouts["coherent"]
    plain = _time_ms(lambda: ff.factor_features_backward_plain(xn, planes, lines, nd, d_sig,
                                                               d_app, bf), 3, flush)
    planes_nchw = [p.permute(2, 0, 1)[None].to(bf).contiguous().requires_grad_(True)
                   for p in planes]
    lines_nc1 = [l.T[None, :, :, None].to(bf).contiguous().requires_grad_(True) for l in lines]
    with torch.enable_grad():
        lib_sig, lib_app = _grid_sample_features(xn.to(bf), planes_nchw, lines_nc1, nd)
    cot = (d_sig.to(bf), d_app)
    lib = _time_ms(lambda: torch.autograd.grad((lib_sig, lib_app), (*planes_nchw, *lines_nc1),
                                               cot, retain_graph=True), 3, flush)
    del lib_sig, lib_app, planes_nchw, lines_nc1
    bound, by = bounds["coherent"]
    print(f"kernel A' fused bf16, coherent: {times['coherent']:.3f} ms, plain {plain:.3f} ms, "
          f"grid_sample backward (bf16 tables) {lib:.3f} ms, bound {bound:.3f} ms by {by} "
          f"({bytes_in / 1e6:.1f} MB xn and output gradients, fp32 d_sigma and bf16 d_app_raw, "
          f"{table_bytes / 1e6:.1f} MB gradient tables written); {off32:.3e} from the fp32 "
          f"backward", flush=True)
    report["factor_features_bwd_bf16"] = dict(
        name="factor_features_bwd_bf16", route="cuda",
        source="text2nerf_tpu_torch/csrc/factor_features_bwd.cu",
        replaces="text2nerf_tpu/models/tensorf.py:538",
        max_abs_err=abs_err, ms=times["coherent"], plain_ms=plain, bound_ms=bound, bound_by=by,
        library_ms=lib, ms_by_layout=times,
        bound_ms_by_layout={k: v[0] for k, v in bounds.items()}, max_rel_err_by_layout=errs,
    )


CP_WIDTHS = (96, 288)  # TensorCP's published n_lamb_sigma, n_lamb_sh
CP_APP_K = 64  # the CLI's app_k: a dense step shades each ray's top 64 samples by weight
CP_PLAIN_CHUNK = 1 << 19  # samples per call of a plain version at the large shapes
# the output modes kernels C and C' take at each shape of phase 3: the
# fused 1M samples, then a TensorCP dense step's two launches
CP_SHAPE_MODES = {"fused": (True, True), "density": (True, False), "app": (False, True)}
CP_MODES = (("fused", True, True), ("density", True, False), ("app", False, True))
# the second design of kernels C and C' (fp32 lines and gradients in bf16),
# timed beside this one by tools/kernel_variants.py: the package with
# csrc/cp_features.cu and its wrapper replaced
CP_BASELINE = ("v2:csrc/cp_features.cu=tools/kernel_baselines/cp_features_v2.cu"
               ":ops/kernels/cp_features.py=tools/kernel_baselines/cp_features_v2.py")


def _grid_sample_cp(xn, lines_nc1, nd):
    """Library yardstick of kernel C: F.grid_sample (align_corners=True)
    over the three lines as [1, C, L, 1] images, then the product, the
    density sum and the app channels."""
    import torch
    import torch.nn.functional as F
    from text2nerf_tpu_torch.ops.kernels.cp_features import VEC_MODE

    n = xn.shape[0]
    prod = None
    for i in range(3):
        gl = torch.stack([torch.zeros_like(xn[:, 0]), xn[:, VEC_MODE[i]]], -1).view(1, n, 1, 2)
        lf = F.grid_sample(lines_nc1[i], gl, align_corners=True).view(-1, n)
        prod = lf if prod is None else prod * lf
    return prod[:nd].sum(0), prod[nd:].T


def _cp_field(dev, gen):
    """A TensorCP field at the published widths (96 density and 288 app
    components, MLP_Fea) on the 300^3 grid, seeded random weights."""
    from text2nerf_tpu_torch.models import tensorf as tf

    cfg = tf.TensoRFConfig(model_name="cp", density_n_comp=(CP_WIDTHS[0],),
                           app_n_comp=(CP_WIDTHS[1],), shading_mode="MLP_Fea", fea_pe=2)
    return tf.init_params(cfg, FULL_RESO, generator=gen, device=dev).requires_grad_(False)


def _cp_shapes(field, shell, aabb, rays, gen):
    """Kernels C and C''s samples at three shapes, {name: xn}: "fused",
    1M samples at the compacted train step's shape (16384 rays of one view
    x 64 consecutive steps); "density", a TensorCP dense step's
    density-only launches (ops/render.py render_rays_train, one
    sub-batch): 16384 rays of the train sampler, each with every one of
    its 259 march steps, in ray order; "app", its app-only launches: each
    of those rays' top CP_APP_K samples by weight in torch.topk's order
    (ops/render.py:228), the weights composited from the room shell's
    density (phase 3's serving field, a far wall), so a ray's top samples
    gather at a surface as a fitted scene's do."""
    import torch
    from text2nerf_tpu_torch.data import synthetic as syn
    from text2nerf_tpu_torch.engine.train_step import PermutationSampler
    from text2nerf_tpu_torch.models import tensorf as tf
    from text2nerf_tpu_torch.ops.kernels import factor_features as ff
    from text2nerf_tpu_torch.ops.render import raw2alpha

    dev = rays.device
    shapes = {"fused": _chunk_samples(rays, aabb, field, N_RAYS_TRAIN * K_TRAIN, gen, K_TRAIN)}
    pool = syn.training_rays(dev)
    ids = torch.as_tensor(PermutationSampler(pool.shape[0], N_RAYS_TRAIN, seed=1).next_ids(),
                          device=dev)
    reso = tf.grid_resolution(field)
    n_samples = tf.default_n_samples(reso, field.cfg.step_ratio)
    xn = _chunk_samples(pool[ids], aabb, field, N_RAYS_TRAIN * n_samples, gen, n_samples)
    shapes["density"] = xn
    planes, lines, nd = tuple(shell.planes), tuple(shell.lines), shell.nd
    feat = torch.cat([ff.factor_features_plain(x, planes, lines, nd, app=False)[0]
                      for x in xn.split(CP_PLAIN_CHUNK)])
    sigma = tf.feature2density(shell.cfg, feat)
    sigma = torch.where((xn.abs() < 1.0).all(1), sigma, 0.0).view(N_RAYS_TRAIN, n_samples)
    step = float(tf.step_size(aabb, reso, field.cfg.step_ratio))
    dists = torch.full_like(sigma, step * shell.cfg.distance_scale)
    dists[:, -1] = 0.0
    _, weights, _ = raw2alpha(sigma, dists)
    idx = torch.topk(weights, CP_APP_K, dim=-1)[1]
    shapes["app"] = torch.gather(xn.view(N_RAYS_TRAIN, n_samples, 3), 1,
                                 idx[..., None].expand(-1, -1, 3)).reshape(-1, 3).contiguous()
    return shapes


def _cp_grads(xn, na, gen, shape):
    """Random output gradients (d_sigma, d_app_raw); at a dense step's
    shapes zero on the samples clamped to a face of the box (the step's
    samples outside it, which it leaves out of sigma)."""
    import torch

    n = xn.shape[0]
    d_sig = torch.randn(n, generator=gen, device=xn.device)
    d_app = torch.randn(n, na, generator=gen, device=xn.device)
    if shape != "fused":
        outside = (xn.abs() == 1.0).any(1)
        d_sig[outside] = 0.0
        d_app[outside] = 0.0
    return d_sig, d_app


def _cp_plain(xn, lines, nd, sig, app, dtype=None):
    """cp_features_plain over chunks of the samples (each sample's values
    are its own, so the same bits)."""
    import torch
    from text2nerf_tpu_torch.ops.kernels import cp_features as cpk

    parts = [cpk.cp_features_plain(x, lines, nd, sigma=sig, app=app, dtype=dtype)
             for x in xn.split(CP_PLAIN_CHUNK)]
    return tuple(None if parts[0][k] is None else torch.cat([p[k] for p in parts])
                 for k in range(2))


def _cp_plain_backward(xn, lines, nd, d_sig, d_app, dtype=None):
    """cp_features_backward_plain summed over chunks of the samples."""
    from text2nerf_tpu_torch.ops.kernels import cp_features as cpk

    total = None
    for lo in range(0, xn.shape[0], CP_PLAIN_CHUNK):
        sl = slice(lo, lo + CP_PLAIN_CHUNK)
        part = cpk.cp_features_backward_plain(
            xn[sl], lines, nd, None if d_sig is None else d_sig[sl],
            None if d_app is None else d_app[sl], dtype)
        total = part if total is None else tuple(t.add_(p) for t, p in zip(total, part))
    return total


def _cp_hold(what, xn, lines, nd, d_sig, d_app, route, accumulate=False):
    """Kernel C against its plain version (bit for bit is reported; the gate
    is TOL["cp"] of the largest value in fp32, bit for bit in bf16, where
    app_raw must be bf16) and kernel C' within TOL["bwd"] of each line's
    largest gradient (from a bf16 d_app_raw in bf16), in both compute
    types and three modes,
    C' on ``route``; with ``accumulate`` C' adds twice into tables that
    hold half the plain gradient.  Returns (C's worst |error|, C' worst relative error, C bit-equal
    everywhere)."""
    import torch
    from text2nerf_tpu_torch.ops.kernels import cp_features as cpk

    worst_c = worst_b = 0.0
    exact = True
    for dtype_name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        for mode, sig, app in CP_MODES:
            got = cpk.cp_features(xn, lines, nd, sigma=sig, app=app, dtype=dtype)
            ref = _cp_plain(xn, lines, nd, sig, app, dtype)
            torch.cuda.synchronize()
            scale = max(float(r.abs().max()) for r in ref if r is not None)
            err = max(float((g - r).abs().max()) for g, r in zip(got, ref) if g is not None)
            equal = all(torch.equal(g, r) for g, r in zip(got, ref) if g is not None)
            exact = exact and equal
            _require(err <= TOL["cp"] * scale,
                     f"kernel C {what} {dtype_name} {mode}: {err} > {TOL['cp']} x {scale}")
            if dtype is not None:
                _require(equal and (not app or got[1].dtype == dtype),
                         f"kernel C {what} bf16 {mode}: not bit-equal ({err}) or app_raw "
                         f"{None if got[1] is None else got[1].dtype}")
            worst_c = max(worst_c, err)
            del got, ref
            ds = d_sig if sig else None
            da = None if not app else d_app if dtype is None else d_app.to(dtype)
            ref = _cp_plain_backward(xn, lines, nd, ds, da, dtype)
            if accumulate:
                base = tuple(0.5 * t for t in ref)
                out = tuple(t.clone() for t in base)
                for _ in range(2):
                    cpk.cp_features_backward(xn, lines, nd, ds, da, dtype=dtype, out=out)
                got = out
                ref = tuple(b + 2 * r for b, r in zip(base, ref))
            else:
                got = cpk.cp_features_backward(xn, lines, nd, ds, da, dtype=dtype)
            torch.cuda.synchronize()
            _require(cpk.BWD_LAST_GRID[0] == route,
                     f"kernel C' {what}: route {cpk.BWD_LAST_GRID[0]}, not {route}")
            err = _bwd_rel_err(((), got), ((), ref), f"kernel C' {what} {dtype_name} {mode}")
            _require(err <= TOL["bwd"], f"kernel C' {what} {dtype_name} {mode}: {err}")
            worst_b = max(worst_b, err)
            del got, ref
    return worst_c, worst_b, exact


def _cp_cases(cfg, dev, gen):
    """Adversarial inputs for kernels C and C' (name, lines, nd, xn,
    d_sigma, d_app, C''s route, accumulate into given tables)."""
    import torch
    from text2nerf_tpu_torch.models import tensorf as tf

    def cp_lines(reso, dens, app):
        f = tf.init_params(dataclasses.replace(cfg, density_n_comp=(dens,), app_n_comp=(app,)),
                           reso, generator=gen, device=dev).requires_grad_(False)
        return tuple(f.lines)

    def grads(m, width):
        return (torch.randn(m, generator=gen, device=dev),
                torch.randn(m, width, generator=gen, device=dev))

    def rays(n_rays, k, reso):  # ray-major, half-voxel steps
        o = torch.rand(n_rays, 1, 3, generator=gen, device=dev) * 1.6 - 0.8
        d = torch.randn(n_rays, 1, 3, generator=gen, device=dev)
        steps = torch.arange(k, device=dev, dtype=torch.float32)[None, :, None]
        x = o + d / d.norm(dim=-1, keepdim=True) * steps * (1.0 / (reso - 1))
        return torch.clamp(x, -1, 1).reshape(-1, 3).contiguous()

    edge = torch.rand(4096, 3, generator=gen, device=dev) * 2 - 1
    edge[:8] = torch.tensor([[1.0, 1, 1], [-1, -1, -1], [1, -1, 1], [-1, 1, -1],
                             [1, 0.3, -0.2], [0.1, 1, 0.4], [-0.6, 0.2, 1], [1, 1, -1]])
    edge[200:264] = 1.0
    cell = torch.full((300, 3), 0.1, device=dev) + 1e-3 * torch.rand(300, 3, generator=gen,
                                                                      device=dev)
    zero_sig, zero_app = grads(4096, 13)
    zero_sig[::3] = 0.0
    zero_app[::2] = 0.0
    # rays of 259 steps, 37 of them: odd n, rays and warps' spans ending mid-run
    walk = rays(37, 259, 56)
    walk_sig, walk_app = grads(walk.shape[0], 13)
    run_sig, run_app = walk_sig.clone(), walk_app.clone()
    run_sig[64:96] = 0.0  # a whole run with no gradient, and a ragged stretch
    run_app[64:96] = 0.0
    run_sig[1000:1100] = 0.0
    run_app[1000:1100] = 0.0
    # each ray's samples in a random order (top-weight order)
    perm = torch.argsort(torch.rand(37, 259, generator=gen, device=dev), dim=1)
    shuffled = torch.gather(walk.view(37, 259, 3), 1, perm[..., None].expand(-1, -1, 3))
    main = cp_lines((48, 40, 56), 5, 13)
    wide = cp_lines((48, 40, 56), 8, 24)
    return [
        ("upper edges, 5/13", main, 5, edge, *grads(4096, 13), "shared", False),
        ("one cell", main, 5, cell, *grads(300, 13), "shared", False),
        ("1-component CP, odd n", cp_lines((33, 35, 37), 1, 1), 1, edge[:4093],
         *grads(4093, 1), "shared", False),
        ("zero gradients mixed in", main, 5, edge, zero_sig, zero_app, "shared", False),
        ("rays of 259 steps, odd n", main, 5, walk, walk_sig, walk_app, "shared", False),
        ("a whole run of zero gradients", main, 5, walk, run_sig, run_app, "shared", False),
        ("each ray's samples shuffled, 8/24 (16-byte lanes)", wide, 8,
         shuffled.reshape(-1, 3).contiguous(), *grads(walk.shape[0], 24), "shared", False),
        ("all gradients zero", main, 5, walk, torch.zeros_like(walk_sig),
         torch.zeros_like(walk_app), "shared", False),
        ("accumulate (out=)", main, 5, walk, walk_sig, walk_app, "shared", True),
        ("generic route (3 x 700 rows)", cp_lines((700, 700, 700), 3, 29), 3, edge,
         *grads(4096, 29), "generic", False),
    ]


def _cp_row_traffic(xn, lines, width):
    """(bytes of line rows a launch requests through L1: 6 rows x width
    fp32 per sample; bytes of the rows distinct within each run of 32
    consecutive samples: what reaches L1 from L2 if L1 keeps a run's rows
    and nothing longer)."""
    import torch
    from text2nerf_tpu_torch.ops.fused_gather import _coords
    from text2nerf_tpu_torch.ops.kernels.cp_features import VEC_MODE

    n = xn.shape[0]
    runs = (n + 31) // 32
    distinct = 0
    for i, ln in enumerate(lines):
        length = ln.shape[0]
        l0, _ = _coords(xn[:, VEC_MODE[i]], length)
        rows = torch.stack([l0, torch.clamp(l0 + 1, max=length - 1)], 1)
        rows = torch.nn.functional.pad(rows.view(-1), (0, 64 * runs - 2 * n), value=-1)
        srt = rows.view(runs, 64).sort(dim=1).values
        distinct += int(((srt[:, 1:] != srt[:, :-1]) & (srt[:, 1:] >= 0)).sum()
                        + (srt[:, 0] >= 0).sum())
    return n * 6 * width * 4, distinct * width * 4


def _cp_shared_adds(xn, lines):
    """Shared-memory adds per channel of kernel C''s shared route, by the
    host's count of its rules (every sample kept, the samples in one
    sequence): six per sample without the window; with it, one per row a
    window leaves (two when it jumps) and two per axis at the end."""
    from text2nerf_tpu_torch.ops.fused_gather import _coords
    from text2nerf_tpu_torch.ops.kernels.cp_features import VEC_MODE

    window = 0
    for i, ln in enumerate(lines):
        l0, _ = _coords(xn[:, VEC_MODE[i]], ln.shape[0])
        step = (l0[1:] - l0[:-1]).abs()
        window += int((step == 1).sum()) + 2 * int((step > 1).sum()) + 2
    return 6 * xn.shape[0], window


def _cp_vs_baseline():
    """tools/kernel_variants.py on kernels C and C' in both compute types:
    this checkout and the package with CP_BASELINE's source and wrapper,
    timed in one run (this, baseline, baseline, this).  Returns its JSON
    result."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, os.path.join(here, "tools", "kernel_variants.py"), "--kernels", "cp",
         CP_BASELINE],
        capture_output=True, text=True, cwd=here, timeout=900)
    if out.returncode:
        print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
        raise RuntimeError(f"kernel_variants exited {out.returncode}")
    for line in out.stdout.splitlines():
        if not line.startswith("{"):
            print(f"  {line}", flush=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _cp_bf16_rows(xn, lines, nd, d_sig, d_app, flush, times, bound_c, bound_b):
    """The kernels-line entries of kernels C and C' in bf16 at the fused
    shape: their times (``times``, phase 3's), their largest errors
    against the plain versions, the plain versions' and F.grid_sample's
    (and its backward's) times on the lines' bf16 copy.  Both read the
    lines' bf16 copy and write or read a bf16 app_raw / d_app_raw, so
    their bounds (``bound_c``, ``bound_b``) are on the bf16 bytes."""
    import torch
    from text2nerf_tpu_torch.ops.kernels import cp_features as cpk

    bf = torch.bfloat16
    d_app = d_app.to(bf)
    got = cpk.cp_features(xn, lines, nd, dtype=bf)
    ref = _cp_plain(xn, lines, nd, True, True, bf)
    err_c = max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref))
    got = cpk.cp_features_backward(xn, lines, nd, d_sig, d_app, dtype=bf)
    ref = _cp_plain_backward(xn, lines, nd, d_sig, d_app, bf)
    err_b = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    del got, ref
    plain_c = _time_ms(lambda: _cp_plain(xn, lines, nd, True, True, bf), 3, flush)
    plain_b = _time_ms(lambda: _cp_plain_backward(xn, lines, nd, d_sig, d_app, bf), 3, flush)
    sub = [l.T[None, :, :, None].to(bf).contiguous() for l in lines]
    x16 = xn.to(bf)
    lib_c = _time_ms(lambda: _grid_sample_cp(x16, sub, nd), 3, flush)
    sub_g = [t.requires_grad_(True) for t in sub]
    with torch.enable_grad():
        lib_sig, lib_app = _grid_sample_cp(x16, sub_g, nd)
    cots = (d_sig.to(bf), d_app)
    lib_b = _time_ms(lambda: torch.autograd.grad((lib_sig, lib_app), sub_g, cots,
                                                 retain_graph=True), 3, flush)
    del lib_sig, lib_app, sub, sub_g, x16
    base = dict(route="cuda", source="text2nerf_tpu_torch/csrc/cp_features.cu",
                replaces="text2nerf_tpu/models/tensorf.py:548")
    rows = []
    for name, key, err, plain, lib, bound in (("cp_features_bf16", "C bf16", err_c, plain_c,
                                               lib_c, bound_c),
                                              ("cp_features_bwd_bf16", "C' bf16", err_b, plain_b,
                                               lib_b, bound_b)):
        rows.append(dict(base, name=name, max_abs_err=err, ms=times[key], plain_ms=plain,
                         library_ms=lib, bound_ms=bound[0], bound_by=bound[1]))
        print(f"kernel {key} fused: {times[key]:.3f} ms, plain {plain:.3f} ms, grid_sample"
              f"{'' if key == 'C bf16' else ' backward'} (bf16 lines) {lib:.3f} ms, bound "
              f"{bound[0]:.4f} ms by {bound[1]} (bf16 lines and app channels), "
              f"{bound[0] / times[key]:.3f} of it; max_abs_err {err:.3e}", flush=True)
    return rows


def phase_cp_kernels(dev, report, rays, aabb, gen, flush, shell):
    """Kernels C and C' against their plain versions on a TensorCP field at
    the published widths on the 300^3 grid: adversarial cases (C' in
    both routes), then the three shapes of _cp_shapes in both compute
    types and three output modes; each shape timed in its own mode, fp32
    and bf16, beside the plain version, the grid_sample yardstick, the
    bounds and the line traffic; then the second design of the two
    kernels and this one timed by tools/kernel_variants.py in one run."""
    import torch
    from text2nerf_tpu_torch.ops.kernels import cp_features as cpk

    field = _cp_field(dev, gen)
    lines, nd = tuple(field.lines), CP_WIDTHS[0]
    c = lines[0].shape[1]
    na = c - nd
    bf = torch.bfloat16

    routes0 = dict(cpk.BWD_ROUTES)
    worst_c = worst_b = 0.0
    for name, lc, ndc, x, ds, da, route, acc in _cp_cases(field.cfg, dev, gen):
        err_c, err_b, _ = _cp_hold(name, x, lc, ndc, ds, da, route, acc)
        worst_c, worst_b = max(worst_c, err_c), max(worst_b, err_b)
    routes = {k: cpk.BWD_ROUTES[k] - routes0[k] for k in routes0}
    _require(all(v > 0 for v in routes.values()), f"a kernel C' route was not checked: {routes}")
    print(f"kernels C / C' adversarial cases: C within {worst_c:.3e}, C' within {worst_b:.3e} "
          f"of each line's largest (tols {TOL['cp']:g} of the largest value, "
          f"{TOL['bwd']:g}) over two compute types and three modes; C' launches by route "
          f"{routes}", flush=True)

    shapes = _cp_shapes(field, shell, aabb, rays, gen)
    grads = {k: _cp_grads(x, na, gen, k) for k, x in shapes.items()}
    line_bytes = sum(l.numel() * 4 for l in lines)
    rep_c = dict(name="cp_features", route="cuda",
                 source="text2nerf_tpu_torch/csrc/cp_features.cu",
                 replaces="text2nerf_tpu/models/tensorf.py:548")
    rep_b = dict(rep_c, name="cp_features_bwd")
    for key in ("ms_by_shape", "ms_bf16_by_shape", "plain_ms_by_shape", "library_ms_by_shape",
                "bound_ms_by_shape", "bound_ms_bf16_by_shape"):
        rep_c[key], rep_b[key] = {}, {}
    rep_c["bit_equal_by_shape"], rep_b["max_rel_err_by_shape"] = {}, {}
    for shape, xn in shapes.items():
        n = xn.shape[0]
        d_sig, d_app = grads[shape]
        err_c, err_b, exact = _cp_hold(shape, xn, lines, nd, d_sig, d_app, "shared")
        rep_c["bit_equal_by_shape"][shape] = exact
        rep_b["max_rel_err_by_shape"][shape] = err_b
        print(f"kernels C / C' at {shape} ({n} samples): C within {err_c:.3e} (bit-equal "
              f"{exact}), C' within {err_b:.3e} of each line's largest, both compute types, "
              f"three modes", flush=True)
        sig, app = CP_SHAPE_MODES[shape]
        ds, da = (d_sig if sig else None), (d_app if app else None)
        da16 = None if da is None else da.to(bf)
        if shape == "fused":
            got = cpk.cp_features(xn, lines, nd)
            ref = _cp_plain(xn, lines, nd, True, True)
            rep_c["max_abs_err"] = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            got = cpk.cp_features_backward(xn, lines, nd, d_sig, d_app)
            ref = _cp_plain_backward(xn, lines, nd, d_sig, d_app)
            rep_b["max_abs_err"] = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            del got, ref
        lo, hi = (0 if sig else nd), (c if app else nd)
        width = hi - lo
        times = {
            "C": _time_ms(lambda: cpk.cp_features(xn, lines, nd, sigma=sig, app=app), 10, flush),
            "C bf16": _time_ms(lambda: cpk.cp_features(xn, lines, nd, sigma=sig, app=app,
                                                       dtype=bf), 10, flush),
            "C'": _time_ms(lambda: cpk.cp_features_backward(xn, lines, nd, ds, da), 10, flush),
        }
        grid = cpk.BWD_LAST_GRID
        times["C' bf16"] = _time_ms(lambda: cpk.cp_features_backward(xn, lines, nd, ds, da16,
                                                                     dtype=bf), 10, flush)
        grid16 = cpk.BWD_LAST_GRID
        plain_c = _time_ms(lambda: _cp_plain(xn, lines, nd, sig, app), 3, flush)
        plain_b = _time_ms(lambda: _cp_plain_backward(xn, lines, nd, ds, da), 3, flush)
        # the yardstick on the mode's channels only
        sub = [l[:, lo:hi].T[None, :, :, None].contiguous() for l in lines]
        nd_sub = nd if sig else 0
        if shape == "fused":
            lib_sig, lib_app = _grid_sample_cp(xn, sub, nd_sub)
            ref_sig, ref_app = _cp_plain(xn, lines, nd, True, True)
            lib_err = max(float((lib_sig - ref_sig).abs().max()),
                          float((lib_app - ref_app).abs().max()))
            print(f"kernel C library (grid_sample) vs plain at fused: {lib_err:.3e}", flush=True)
            del lib_sig, lib_app, ref_sig, ref_app
        lib_c = _time_ms(lambda: _grid_sample_cp(xn, sub, nd_sub), 3, flush)
        sub_g = [t.requires_grad_(True) for t in sub]
        with torch.enable_grad():
            lib_sig, lib_app = _grid_sample_cp(xn, sub_g, nd_sub)
        outs = ([lib_sig] if sig else []) + ([lib_app] if app else [])
        cots = ([d_sig] if sig else []) + ([d_app] if app else [])
        lib_b = _time_ms(lambda: torch.autograd.grad(outs, sub_g, cots, retain_graph=True), 3,
                         flush)
        del lib_sig, lib_app, outs, sub, sub_g
        mode_lines = line_bytes * width // c
        out_bytes = n * 4 * ((1 if sig else 0) + (na if app else 0))
        bound_c = _bound(n * 12 + out_bytes + mode_lines, n * width * 14)
        # C': xn, the output gradients and the lines read, the gradient lines
        # written; the forward's 14 operations, the chain's 4 products, 6 row
        # terms and 6 adds per channel
        bound_b = _bound(n * 12 + out_bytes + 2 * mode_lines, n * width * 32)
        # bf16: the lines' bf16 copy read and bf16 app channels; sigma,
        # d_sigma and the gradient lines stay fp32
        out16 = n * ((4 if sig else 0) + (2 * na if app else 0))
        bound_c16 = _bound(n * 12 + out16 + mode_lines // 2, n * width * 14)
        bound_b16 = _bound(n * 12 + out16 + mode_lines // 2 + mode_lines, n * width * 32)
        requested, distinct = _cp_row_traffic(xn, lines, width)
        per_channel, windowed = _cp_shared_adds(xn, lines)
        print(f"kernel C {shape} ({n} samples, {width} channels): {times['C']:.3f} ms (bf16 "
              f"{times['C bf16']:.3f}, bound {bound_c16[0]:.4f} ms by {bound_c16[1]}, "
              f"{bound_c16[0] / times['C bf16']:.3f} of it), plain {plain_c:.3f} ms, grid_sample "
              f"{lib_c:.3f} ms, bound {bound_c[0]:.4f} ms by {bound_c[1]} "
              f"({bound_c[0] / times['C']:.3f} of it); "
              f"line rows through L1 {requested / 1e9:.3f} GB in {6 * n * -(-width // 128)} "
              f"16-byte-lane loads (the first design: {6 * n * -(-width // 32)} 4-byte-lane "
              f"loads), rows distinct within a run {distinct / 1e6:.1f} MB", flush=True)
        ms_b, ms_b_bf = times["C'"], times["C' bf16"]
        print(f"kernel C' {shape}: {ms_b:.3f} ms (bf16 {ms_b_bf:.3f}, bound "
              f"{bound_b16[0]:.4f} ms by {bound_b16[1]}, {bound_b16[0] / ms_b_bf:.3f} of it; "
              f"{grid16[1]} blocks x {grid16[2]} threads), plain "
              f"{plain_b:.3f} ms, "
              f"grid_sample backward {lib_b:.3f} ms, bound {bound_b[0]:.4f} ms by {bound_b[1]} "
              f"({bound_b[0] / ms_b:.3f} of it); {grid[0]} route, {grid[1]} "
              f"blocks x {grid[2]} threads; shared adds per channel by the host's count of the "
              f"window's rules {windowed} vs {per_channel} without it", flush=True)
        rep_c["ms_by_shape"][shape], rep_c["ms_bf16_by_shape"][shape] = times["C"], times["C bf16"]
        rep_b["ms_by_shape"][shape] = times["C'"]
        rep_b["ms_bf16_by_shape"][shape] = times["C' bf16"]
        rep_c["plain_ms_by_shape"][shape], rep_b["plain_ms_by_shape"][shape] = plain_c, plain_b
        rep_c["library_ms_by_shape"][shape], rep_b["library_ms_by_shape"][shape] = lib_c, lib_b
        rep_c["bound_ms_by_shape"][shape] = bound_c[0]
        rep_b["bound_ms_by_shape"][shape] = bound_b[0]
        rep_c["bound_ms_bf16_by_shape"][shape] = bound_c16[0]
        rep_b["bound_ms_bf16_by_shape"][shape] = bound_b16[0]
        if shape == "fused":
            rep_c16, rep_b16 = _cp_bf16_rows(xn, lines, nd, d_sig, d_app, flush, times,
                                             bound_c16, bound_b16)
        if shape == "fused":
            for rep, key, plain, lib, bound in ((rep_c, "C", plain_c, lib_c, bound_c),
                                                (rep_b, "C'", plain_b, lib_b, bound_b)):
                rep.update(ms=times[key], ms_bf16=times[key + " bf16"], plain_ms=plain,
                           library_ms=lib, bound_ms=bound[0], bound_by=bound[1])
    del shapes, grads, field
    torch.cuda.empty_cache()

    res = _cp_vs_baseline()
    for r in res["runs"]:
        if r["name"] == "this checkout":
            _require(all(r["cp_exact"].values()), f"kernel C in kernel_variants: {r['cp_exact']}")
            _require(max(r["cp_bwd_err"].values()) <= TOL["bwd"],
                     f"kernel C' in kernel_variants: {r['cp_bwd_err']}")
    for kernel, rep, bounds in (("C", rep_c, rep_c["bound_ms_by_shape"]),
                                ("C'", rep_b, rep_b["bound_ms_by_shape"]),
                                ("C bf16", rep_c16, rep_c["bound_ms_bf16_by_shape"]),
                                ("C' bf16", rep_b16, rep_b["bound_ms_bf16_by_shape"])):
        rep["baseline_ms_by_shape"], rep["variants_ms_by_shape"] = {}, {}
        for shape in CP_SHAPE_MODES:
            runs = {name: [r["cp_ms"][shape][kernel] for r in res["runs"] if r["name"] == name]
                    for name in ("this checkout", "v2")}
            rep["baseline_ms_by_shape"][shape] = runs["v2"]
            rep["variants_ms_by_shape"][shape] = runs["this checkout"]
            print(f"kernel {kernel} {shape}, one kernel_variants run: second design "
                  f"{[round(v, 4) for v in runs['v2']]} ms, this design "
                  f"{[round(v, 4) for v in runs['this checkout']]} ms; bound "
                  f"{bounds[shape]:.4f} ms, share of the bound "
                  f"{bounds[shape] / min(runs['v2']):.3f} -> "
                  f"{bounds[shape] / min(runs['this checkout']):.3f}", flush=True)
    report["cp_features"], report["cp_features_bwd"] = rep_c, rep_b
    report["cp_features_bf16"], report["cp_features_bwd_bf16"] = rep_c16, rep_b16


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

    _counts_zeroed()
    t0 = time.perf_counter()
    frames, _ = evaluation_path(field, aabb_t, poses[:FRAMES], hw, intr, **kw)
    dt = time.perf_counter() - t0
    launches = _read_counts(report, "serve", ("factor_features", "shading_mlp", "eval_prepass"))
    print(f"main path launches {launches}", flush=True)
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
    mask_cpu = None if mask is None else {"volume": mask["volume"].cpu(),
                                          "aabb": mask["aabb"].cpu(), "pool": mask["pool"]}
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
    _counts_zeroed()
    t0 = time.perf_counter()
    mses = []
    for _ in range(TRAIN_STEPS):
        state, m = one(state)
        mses.append(m["mse"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    routes = dict(ff.BWD_ROUTES)
    launches = _read_counts(report, "train", ("factor_features", "factor_features_bwd"))
    print(f"train path launches {launches} (kernel B eval only; kernel A' by route {routes})",
          flush=True)
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
      first compacted step not captured under ``tag_next`` (in phase 6 on
      the shrunk grid) and in the evals after it,
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
        self.split = None  # the profiled step's device ms by part (_step_split)
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

    def _tap_a_bwd(self, xn, planes, lines, nd, d_sigma, d_app_raw, bf16, out):
        import torch

        mode = "fused" if d_sigma is not None and d_app_raw is not None else (
            "density" if d_sigma is not None else "app")
        self._capture("A'", mode + (" bf16" if bf16 else ""), xn=xn, planes=tuple(planes),
                      lines=tuple(lines), nd=nd, d_sigma=d_sigma, d_app_raw=d_app_raw,
                      dtype=torch.bfloat16 if bf16 else None)
        return self.launch0[1](xn, planes, lines, nd, d_sigma, d_app_raw, bf16, out)

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
        # the first compacted step not captured under another tag
        first_compact = kind == "compact" and not any(k[0] == "compact" for k in self.captured)
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
            events = self._prof.events()
            self.busy = (_busy_ms(events), (end - self._last_end) * 1e3)
            self.split = _step_split(events)
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


def _step_split(events):
    """Device ms of one profiled step by part: kernels A, A', C, C', the
    head (forward and backward), torch.topk and the rest, by
    text2nerf_tpu_torch/profile_train.py's rules."""
    from text2nerf_tpu_torch import profile_train as pt

    layers, _ = pt.device_time_by_layer(events)
    parts = (("kernel A'", "A'"), ("kernel A:", "A"), ("kernel C'", "C'"), ("kernel C:", "C"),
             ("head", "head"), ("topk", "topk"))
    split = {name: 0.0 for _, name in parts}
    split["rest"] = max(0.0, _busy_ms(events) * 1e3 - sum(layers.values()))
    for layer, us in layers.items():
        split[next((p for frag, p in parts if layer.startswith(frag)), "rest")] += us
    return {k: v / 1e3 for k, v in split.items()}


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
            _require(all(g is None or g.dtype == r.dtype for g, r in zip(got, ref)),
                     f"{label} {where} kernel A {mode}: output dtypes differ")
            err = max(float((g.float() - r.float()).abs().max())
                      for g, r in zip(got, ref) if g is not None)
            tol, n, what = TOL["bf16" if c["dtype"] else "fp32"], c["xn"].shape[0], "max_abs_err"
        elif kernel == "A'":
            args = (c["xn"], c["planes"], c["lines"], c["nd"], c["d_sigma"], c["d_app_raw"])
            got = ff.factor_features_backward(*args, dtype=c["dtype"])
            ref = ff.factor_features_backward_plain(*args, c["dtype"])
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


def phase_seed_fit(dev, card, report, workdir, keep_dir=None):
    """The seed fit through trainer.reconstruction at full width (see the
    module docstring), then the final checkpoint reloaded and its render of
    the seed view held to the logged PSNR.  Returns what phase 10
    evaluates again (the final checkpoint, copied to ``keep_dir`` when one
    is given; the seed view's rays and image; the render settings) and the
    fit's records."""
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
    _counts_zeroed()
    t0 = time.perf_counter()
    with _StepProbe(ts, ff, sm) as probe:
        mcfg, field, aabb, scene, logfolder = trainer.reconstruction(cfg, scene_cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts(report, "seed_fit", ("factor_features", "factor_features_bwd",
                                                  "shading_mlp"))
    print(f"seed fit launches {launches}; wall {wall:.3f} s with a device sync around every "
          f"step, on {card}", flush=True)
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
    if keep_dir:
        os.makedirs(keep_dir, exist_ok=True)
    kept = dict(ckpt=keep_dir and shutil.copy(f"{logfolder}/{cfg.expname}_final.npz", keep_dir),
                rays=scene.rays_gen_split[:1], gt=gt[:1], hw=(h, w),
                n_samples=logged["n_samples"][1], compact_k=cfg.eval_compact_k, eval_kw=eval_kw)
    return kept, {"seed_fit_wall_s": wall, "seed_fit_pool_rays": pool,
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
# phase 7 writes a resume point at its stage-2 boundary and after every
# epoch (the last one at the entry of stage 3): phase 10 resumes from them.
# No alpha-mask milestone, as in the shipped config: a run resumed after
# the shrink marches the shrunk grid's sample count, the JAX trainer's
# rule (ROADMAP section 3)
# The cut of phases 7 and 8 (and of 10 and 12, which take phase 7's
# configuration), phase 11's: one sub-batch a dense step.  The trainer's
# default, 32 sub-batches, gives the same step in 273-485 ms of host-bound
# time (PERF.md), about 0.9 of the two fits' dense steps; phase 6 still
# times it.  --microbatch sets it for one run.
PROGRESSIVE_OVERRIDES = dict(resume=True, resume_every_epochs=1, update_alphamask_list=(),
                             train_microbatch=1)
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
# the CLI's fit (phase 8) builds its masks at the default pool 3, which
# cannot license the group-2 strided occupancy test, so every step is
# dense: B and A in the expansion's renders, A and A' in the first stage-2
# step, held
CLI_HELD = (("expand", "B", "fp32"), ("expand", "A", "fused bf16"),
            ("stage2", "A", "density fp32"), ("stage2", "A", "app fp32"),
            ("stage2", "A'", "density"), ("stage2", "A'", "app"))
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


def _progressive_fit(dev, card, report, workdir, services, epochs, label, margin_db, run=None,
                     held=PROGRESSIVE_HELD, overrides=None):
    """The progressive fit on the two-view trajectory, the kernel counts
    set to 0 just before and read just after, then the checks phases 7
    and 8 share (module docstring).  By default trainer.reconstruction with
    ``services`` and phase 6's configuration at ``epochs`` (n_stage1,
    n_stage2, n_stage3), with TrainConfig ``overrides``; ``run()`` instead
    drives the fit its own way and returns (reconstruction's result,
    TrainConfig, SceneConfig, ExpansionConfig, services); ``held`` names
    the launches held against the plain versions.  Returns the fit's
    records."""
    import numpy as np
    import torch
    from text2nerf_tpu_torch.data import scene_state as ss
    from text2nerf_tpu_torch.engine import expansion, renderer, trainer
    from text2nerf_tpu_torch.engine import train_step as ts
    from text2nerf_tpu_torch.models import tensorf as tf
    from text2nerf_tpu_torch.ops.kernels import factor_features as ff
    from text2nerf_tpu_torch.ops.kernels import shading_mlp as sm
    from text2nerf_tpu_torch.utils.png import read_png

    n1, n2, n3 = epochs
    if run is None:
        cfg, scene_cfg = _seed_fit_configs(
            workdir, SEED_FIT_HW, scene=PROGRESSIVE_SCENE, n_stage1=n1, n_stage2=n2,
            n_stage3=n3, eval_every_epochs=sum(epochs), **SEED_FIT_COMPACT,
            **(overrides or {}))
        ex = expansion.ExpansionConfig(prompt=scene_cfg.prompt, push_depth=scene_cfg.push_depth,
                                       trans_range=scene_cfg.trans_range)
        print(f"{label}: hw {SEED_FIT_HW}, {scene_cfg.pose_traj} x {scene_cfg.num_training} "
              f"views, epochs {epochs}, the seed fit's grid, upsample at {cfg.upsamp_list}, alpha-mask "
              f"milestones {cfg.update_alphamask_list}, stage 2 and 3 "
              f"{SEED_FIT_COMPACT}; expansion {ex}; services {services.resolution}", flush=True)

        def run():
            return (trainer.reconstruction(cfg, scene_cfg, services, ex, device=dev), cfg,
                    scene_cfg, ex, services)

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
            _counts_zeroed()
            t0 = time.perf_counter()
            (mcfg, field, aabb, scene, logfolder), cfg, scene_cfg, ex, services = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            expansion.expand_scene, trainer._batch_from_pool = expand0, batch0
    _require(ex.n_candidates == N_CANDIDATES, "the expansion does not run its defaults")
    merge = services.merge
    _require((merge.net_size, merge.num_downs, merge.compute_dtype)
             == (1024, 10, torch.bfloat16), "the merge net is not unet_1024 in bf16")
    # the expansion's renders run kernel A in bf16 (render_chunked's default)
    launches = _read_counts(report, label.replace(" ", "_"), (
        "factor_features", "factor_features_bf16", "factor_features_bwd", "shading_mlp"))
    print(f"{label} launches {launches}, in the expansion's renders A "
          f"{probe.expand_launches[0]} and B {probe.expand_launches[1]}; wall {wall:.3f} s "
          f"with a device sync around every step, on {card}", flush=True)
    _require(min(probe.expand_launches) > 0
             and any(k[:2] == ("expand", "A") for k in probe.captured),
             f"kernels A and B did not run in the expansion: {sorted(probe.captured)}")
    _require(any(k[:2] == ("stage2", "A'") for k in probe.captured),
             f"kernel A' did not run in the first stage-2 step: {sorted(probe.captured)}")
    _hold_seed_fit_kernels(probe.captured, report, held, label)
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
    eval_kw = _eval_kw(cfg, scene_cfg, scene, dev)
    _, f0, _, _ = trainer.init_field(cfg, scene, device=dev)
    f0 = tf.upsample_volume_grid(f0, want_up).requires_grad_(False)
    z_floor = ss.supervised_z_floor(scene)
    psnr0 = renderer.evaluation(
        f0, torch.as_tensor(scene.scene_bbox, device=dev), scene.rays_gen_split[:1],
        scene.hw, gt_rgbs=scene.rgbs_gen_split, eval_z_min=z_floor,
        n_samples=tf.default_n_samples(want_up, f0.cfg.step_ratio), **eval_kw)["psnr"][0]
    del f0
    # the fit's n_samples: set at the c2f upsample, else the initial grid's
    n_samples = next((r["n_samples"] for r in rows if "n_samples" in r), tf.default_n_samples(
        tf.n_to_reso(cfg.n_voxel_init, scene.scene_bbox), mcfg.step_ratio, cfg.n_samples_cap))
    psnr, loop = _final_psnrs(cfg, scene, logfolder, n_samples, eval_kw)
    evals = [(r["step"], r["eval_psnr"]) for r in rows if "eval_psnr" in r]
    print(f"eval PSNR: seed view untrained (upsampled) {psnr0:.4f} dB, final {psnr[0]:.4f} dB; "
          f"generated view final {psnr[1]:.4f} dB; logged means by step {evals} (step "
          f"{loop['global_step']}, view {loop['view_idx']})", flush=True)
    _require(loop["view_idx"] == 1 and all(np.isfinite(psnr)), f"final state {loop}, {psnr}")
    _require(psnr[0] > psnr0 + margin_db,
             f"seed view PSNR {psnr[0]} is not {margin_db} dB above {psnr0}")
    return dict(wall=wall, phases=phases, n_new=n_new, psnr0=psnr0, psnr=psnr, dibr=dibr,
                compact_ms=_median(probe.ms["compact"]), dense_ms=_median(probe.ms["dense"]),
                logfolder=logfolder, scene=scene, cfg=cfg, scene_cfg=scene_cfg, ex=ex,
                n_samples=n_samples, eval_kw=eval_kw)


def _eval_kw(cfg, scene_cfg, scene, dev):
    """The evaluation's settings of a fit's final renders."""
    return dict(chunk=cfg.batch_size, app_k=cfg.app_k, white_bg=scene.white_bg,
                push_depth=scene_cfg.push_depth, near_far=scene.near_far, device=dev)


def _final_psnrs(cfg, scene, logfolder, n_samples, eval_kw):
    """(per-view PSNRs, loop state) of the final checkpoint in ``logfolder``
    over the scene's generated views, at ``n_samples``, culled at the
    scene's supervised z-floor, through its mask's adaptive renderer."""
    from text2nerf_tpu_torch.data import scene_state as ss
    from text2nerf_tpu_torch.engine import checkpoints as ckpt
    from text2nerf_tpu_torch.engine import renderer

    _, f1, aabb1, mask1, loop = ckpt.load_checkpoint(f"{logfolder}/{cfg.expname}_final.npz",
                                                     device=eval_kw["device"])
    f1.requires_grad_(False)
    n_gen = scene.rgbs_gen_split.shape[0]
    psnr = renderer.evaluation(
        f1, aabb1, scene.rays_gen_split[:n_gen], scene.hw, gt_rgbs=scene.rgbs_gen_split,
        n_samples=n_samples, alpha_mask=mask1, compact_k=cfg.eval_compact_k,
        eval_z_min=ss.supervised_z_floor(scene), ndc=cfg.ndc_ray, **eval_kw)["psnr"]
    return psnr, loop


def phase_progressive_fit(dev, card, report, workdir):
    """The progressive fit on the procedural services (module docstring,
    phase 7)."""
    from text2nerf_tpu_torch.services.registry import default_services

    from text2nerf_tpu_torch.engine import trainer

    services = default_services(hw=SEED_FIT_HW, device=dev)
    services.inpaint = _Timed(services.inpaint)
    merge = services.merge
    merge.run_finetune = _Timed(merge.run_finetune, keep=True)
    save0 = trainer._save_resume
    trainer._save_resume = saves = _Timed(save0)
    try:
        fit = _progressive_fit(dev, card, report, workdir, services, PROGRESSIVE_EPOCHS,
                               "progressive fit", 5.0, overrides=PROGRESSIVE_OVERRIDES)
    finally:
        trainer._save_resume = save0
    names = [f"{fit['cfg'].expname}_resume.npz", "scene_snapshot.npz"]
    _require(all(os.path.exists(f"{fit['logfolder']}/{n}") for n in names),
             f"the fit wrote no resume point ({names}) in {fit['logfolder']}")
    size = sum(os.path.getsize(f"{fit['logfolder']}/{n}") for n in names)
    fit["resume_save_ms"] = saves.ms
    print(f"resume points: {len(saves.ms)} saves, {sum(saves.ms) / 1e3:.3f} s of the fit's "
          f"{fit['wall']:.3f} s ({[round(x, 1) for x in saves.ms]} ms; {size / 2 ** 20:.1f} MiB "
          f"a point), on {card}", flush=True)
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
    return fit, {"progressive_wall_s": fit["wall"], "progressive_pool_new_rays": fit["n_new"],
            "progressive_resume_save_s": sum(saves.ms) / 1e3,
            "progressive_expand_s": fit["phases"]["expand_view_1"],
            "progressive_merge_ms_per_iter": merge_ms[0] / iters,
            "progressive_inpaint_ms": _median(inpaint_ms),
            "progressive_psnr_seed_untrained": fit["psnr0"], "progressive_psnr_seed": fit["psnr"][0],
            "progressive_psnr_generated": fit["psnr"][1],
            "progressive_compact_ms": fit["compact_ms"], "progressive_dense_ms": fit["dense_ms"],
            "progressive_merge_card_vs_cpu": err}


# phase 8: the progressive fit through the CLI on the networks at random init
GENERATIVE_WEIGHTS = ("stable-diffusion-2-1-base", "stable-diffusion-2-inpainting",
                      "clip-vit-base-patch32")
CLI_TEST_FRAMES = 4  # --N_vis: the test frames the fit and the render-only branch write
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
    the meta device."""
    import torch

    with torch.device("meta"):
        module = make()
        return _flops_of(lambda: module(*[torch.empty(s) for s in shapes]))


def _flops_of(fn):
    """Matmul and convolution FLOPs of one call of ``fn``, counted from the
    shapes it runs (torch.utils.flop_counter)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
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


def _write_leres_checkpoint(path):
    """The port's RelDepthModel(resnext101) at a seeded random init, saved
    in the reference's {"depth_model": state_dict} container (res101.pth)."""
    import torch
    from text2nerf_tpu_torch.models import diffusion as D
    from text2nerf_tpu_torch.models import leres as L

    net = D.materialize(lambda: L.RelDepthModel(L.LeReSConfig.resnext101()), "cpu",
                        torch.Generator().manual_seed(5))
    torch.save({"depth_model": net.state_dict()}, path)
    return sum(p.numel() for p in net.parameters())


def _cli_argv(workdir, wdir):
    """Phase 8's configuration as the port's command line: the shipped
    config file and flags for what phase 7 ran (module docstring), but no
    alpha-mask milestone, as in the shipped config: after its shrink
    render_test marches the default sample count of the shrunk grid (half
    the fit's, in both packages), and the render-only frames could not
    equal the fit's."""
    return ["--config", "configs/text2nerf_scenes.txt", "--expname", "seed",
            "--basedir", f"{workdir}/log", "--datadir", f"{workdir}/scene",
            "--prompt", "a beautiful garden with flowers", "--weights_dir", wdir,
            "--hw", str(SEED_FIT_HW[0]), str(SEED_FIT_HW[1]),
            "--pose_traj", PROGRESSIVE_SCENE["pose_traj"],
            "--num_training", str(PROGRESSIVE_SCENE["num_training"]),
            "--n_stage1", str(PROGRESSIVE_EPOCHS[0]), "--n_stage2", str(PROGRESSIVE_EPOCHS[1]),
            "--n_stage3", str(PROGRESSIVE_EPOCHS[2]), "--seed", "11",
            "--train_compact_k", str(SEED_FIT_COMPACT["train_compact_k"]),
            "--app_k", str(SEED_FIT_COMPACT["app_k"]),
            "--train_depth_cap_band", str(SEED_FIT_COMPACT["train_depth_cap_band"]),
            "--eval_compact_k", "-1", "--N_vis", str(CLI_TEST_FRAMES),
            "--train_microbatch", str(PROGRESSIVE_OVERRIDES["train_microbatch"])]


class _DepthCalls:
    """Wraps the depth service: per call its wall (ms, device synchronized),
    the base-net evaluations by size, the merged patches, the processing
    size and the counts."""

    def __init__(self, estimate):
        self.fn, self.booster, self.calls = estimate, estimate.__self__, []
        self.base0 = self.booster.base_estimate
        self.sizes = []
        self.booster.base_estimate = self._base

    def _base(self, img, size):
        self.sizes.append(int(size))
        return self.base0(img, size)

    def __call__(self, img, *args, **kw):
        import collections

        import torch

        self.sizes = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(img, *args, **kw)
        torch.cuda.synchronize()
        self.calls.append(dict(
            ms=(time.perf_counter() - t0) * 1e3, evals=dict(collections.Counter(self.sizes)),
            patches=self.booster.last["patches"], optimal=self.booster.last["optimal"],
            img_big=self.booster.last["img_big"], counts=out, image=img))
        return out

    def close(self):
        self.booster.base_estimate = self.base0


def phase_generative_fit(dev, card, report, workdir):
    """The progressive fit through the port's command line on every
    network at its published width and seeded random init (module
    docstring, phase 8), the render-only branch on its checkpoint, then
    the services' own timings, FLOPs, profile and card-vs-CPU checks.
    Returns (records, the depth booster, the fit's seed image)."""
    import numpy as np
    import torch
    from text2nerf_tpu_torch import main as cli
    from text2nerf_tpu_torch.data import scene_state as ss
    from text2nerf_tpu_torch.engine import trainer
    from text2nerf_tpu_torch.models import clip as C
    from text2nerf_tpu_torch.models import diffusion as D
    from text2nerf_tpu_torch.ops import render as render_ops
    from text2nerf_tpu_torch.services import registry
    from text2nerf_tpu_torch.utils.png import read_png

    wdir = os.path.join(workdir, "gen_weights")
    for sub in GENERATIVE_WEIGHTS:
        os.makedirs(os.path.join(wdir, sub))
    os.makedirs(os.path.join(wdir, "leres"))
    n_leres = _write_leres_checkpoint(os.path.join(wdir, "leres", "res101.pth"))
    argv = _cli_argv(workdir, wdir)
    print(f"generative fit: python -m text2nerf_tpu_torch.main {' '.join(argv)} (leres/res101.pth: "
          f"RelDepthModel(resnext101), {n_leres} parameters, seeded random init)", flush=True)

    built = {}
    default_services0, recon0 = registry.default_services, trainer.reconstruction

    def default_services(*args, **kw):
        t0 = time.perf_counter()
        svc = default_services0(*args, **kw)
        torch.cuda.synchronize()
        built["build_s"] = time.perf_counter() - t0
        built.update(t2i=svc.text2img.pipeline, inp=svc.inpaint.pipeline, ranker=svc.rank.model,
                     evals_t2i=_Evals(svc.text2img.pipeline.unet),
                     evals_inp=_Evals(svc.inpaint.pipeline.unet))
        svc.estimate_depth = built["depth"] = _DepthCalls(svc.estimate_depth)
        svc.text2img = _Recorded(svc.text2img)
        svc.inpaint = _Recorded(svc.inpaint, keep=True)
        svc.rank = _Recorded(svc.rank, keep=True)
        svc.merge.run_finetune = _Timed(svc.merge.run_finetune)
        return svc

    def reconstruction(cfg, scene_cfg, services, ex, *, device=None):
        built["args"] = (cfg, scene_cfg, ex, services)
        built["out"] = recon0(cfg, scene_cfg, services, ex, device=device)
        return built["out"]

    def run():
        registry.default_services, trainer.reconstruction = default_services, reconstruction
        try:
            rc = cli.main(argv, device=dev)
        finally:
            registry.default_services, trainer.reconstruction = default_services0, recon0
        _require(rc == 0, f"main returned {rc}")
        cfg, scene_cfg, ex, svc = built["args"]
        return built["out"], cfg, scene_cfg, ex, svc

    try:
        fit = _progressive_fit(dev, card, report, workdir, None, PROGRESSIVE_EPOCHS,
                               "generative fit", 0.0, run=run, held=CLI_HELD)
    finally:
        for k in ("evals_t2i", "evals_inp", "depth"):
            if k in built:
                built[k].close()
    cfg, scene_cfg, ex, services = built["args"]
    t2i, inp, ranker = built["t2i"], built["inp"], built["ranker"]
    res = services.resolution
    _require(all(v == "real" for k, v in res.items() if k != "merge"),
             f"the services did not resolve to their nets: {res}")
    _require((t2i.unet_cfg, inp.unet_cfg, t2i.vae_cfg, t2i.text_cfg, ranker.cfg)
             == (D.UNetConfig.sd21_base(), D.UNetConfig.sd2_inpaint(), D.VAEConfig(),
                 C.CLIPTextConfig.sd2_text(), C.CLIPVisionConfig.vit_b32()),
             "the services are not at SD 2 / OpenCLIP-H / ViT-B/32 widths")
    _require((t2i.scheduler, t2i.num_steps, inp.scheduler, inp.num_steps)
             == ("euler", 50, "pndm", 50), "the schedulers are not Euler / PNDM at 50 steps")
    from text2nerf_tpu_torch.models import leres as L

    booster = built["depth"].booster
    _require(isinstance(booster.model, L.RelDepthModel)
             and booster.model.cfg == L.LeReSConfig.resnext101()
             and (booster.rf, booster.pix2pix_size) == (448, 1024),
             "the depth service is not the boosted ResNeXt-101 LeReS")
    _require((cfg.n_voxel_init, cfg.n_voxel_final, cfg.batch_size, cfg.eval_compact_k, cfg.seed)
             == (27_000_000, 27_000_000, 16384, -1, 11), f"the CLI's configuration: {cfg}")
    n_params = {k: sum(p.numel() for p in m.parameters()) for k, m in (
        ("unet", t2i.unet), ("inpaint_unet", inp.unet), ("vae", t2i.vae), ("text", t2i.text),
        ("clip_vision", ranker), ("leres", booster.model))}
    print(f"services built in {built['build_s']:.2f} s on {card}: {res}; parameters {n_params}; "
          f"text2img euler x {t2i.num_steps}, inpaint pndm x {inp.num_steps} "
          f"({len(inp._make_schedule().timesteps)} evaluations), bf16 compute; the CLI's "
          f"TrainConfig {cfg}", flush=True)

    # the depth calls: the bootstrap's and the expansion's, each the boosted
    # LeReS, finite counts spanning [0, 65535]
    calls = built["depth"].calls
    _require(len(calls) == 2, f"{len(calls)} depth calls, not the bootstrap's and the expansion's")
    for i, c in enumerate(calls):
        counts = c["counts"]
        _require(counts.dtype == np.float64 and counts.shape == tuple(SEED_FIT_HW)
                 and np.isfinite(counts).all() and counts.min() == 0 and counts.max() == 65535,
                 f"depth call {i}: counts {counts.dtype} {counts.shape} in "
                 f"[{counts.min()}, {counts.max()}]")
        print(f"depth call {i} ({'bootstrap' if i == 0 else 'expansion'}): {c['ms']:.1f} ms on "
              f"{card}; processing size {c['optimal']}, enlarged image {c['img_big']}, "
              f"{c['patches']} patches merged; LeReS evaluations by size {c['evals']} "
              f"({sum(c['evals'].values())})", flush=True)

    # the seed image: SD 2.1-base, Euler, 50 evaluations of the doubled batch
    evals_t2i, evals_inp = built["evals_t2i"], built["evals_inp"]
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
          f"{rank_ms[0]:.1f} ms ({N_CANDIDATES + 1} images); merge finetune {merge_ms[0]:.1f} ms; "
          f"depth {[round(c['ms'], 1) for c in calls]} ms", flush=True)

    # the render-only branch on the fit's checkpoint: the fit's final test
    # frames again.  render_test culls at the z-floor of a scene snapshot
    # beside the checkpoint (else at the reference's 2.0); the CLI's fit,
    # not resumable, writes none, so the snapshot of its scene is written
    # here.  The adaptive renderer's rung memo starts empty, as in a new
    # process.
    logfolder, scene = fit["logfolder"], fit["scene"]
    test_dir = f"{logfolder}/imgs_test_all"
    names = sorted(os.listdir(f"{test_dir}/rgbs"))
    _require(len(names) == CLI_TEST_FRAMES, f"the fit wrote test frames {names}")
    fit_frames = [read_png(f"{test_dir}/rgbs/{n}") for n in names]
    shutil.move(test_dir, f"{logfolder}/imgs_test_fit")
    snap = f"{logfolder}/scene_snapshot.npz"
    ss.save_scene_snapshot(snap, scene)
    z_fit, z_snap = ss.supervised_z_floor(scene), ss.supervised_z_floor(ss.load_scene_snapshot(snap))
    _require(z_fit == z_snap, f"the snapshot's z-floor {z_snap} is not the fit's {z_fit}")
    render_ops._ADAPTIVE_PROBE_CACHE.clear()
    ckpt_path = f"{logfolder}/{cfg.expname}_final.npz"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(argv + ["--render_only", "1", "--render_test", "1", "--ckpt", ckpt_path],
                  device=dev)
    torch.cuda.synchronize()
    ro_s = time.perf_counter() - t0
    _require(rc == 0 and sorted(os.listdir(f"{test_dir}/rgbs")) == names,
             f"render-only returned {rc} with frames {os.listdir(test_dir)}")
    ro_dev = max(float(np.abs(read_png(f"{test_dir}/rgbs/{n}").astype(np.float64)
                              - f.astype(np.float64)).max()) / 255.0
                 for n, f in zip(names, fit_frames))
    print(f"render-only: {len(names)} test frames from {os.path.basename(ckpt_path)} in "
          f"{ro_s:.2f} s, max |frame - fit's frame| {ro_dev:.3e} (tol {TOL['render_only']:g}); "
          f"z-floor {z_fit:.4f} (no snapshot: 2.0)", flush=True)
    _require(ro_dev <= TOL["render_only"], f"render-only frames differ by {ro_dev}")

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
    rec = {"generative_wall_s": fit["wall"], "generative_expand_s": fit["phases"]["expand_view_1"],
           "generative_inpaint_rank_s": fit["phases"]["expand1_inpaint_rank"],
           "generative_text2img_ms": t2i_ms[0], "generative_inpaint_ms": _median(inp_ms),
           "generative_rank_ms": rank_ms[0], "generative_depth_ms": [c["ms"] for c in calls],
           "generative_depth_evals": [c["evals"] for c in calls],
           "generative_depth_patches": [c["patches"] for c in calls],
           "generative_unet_b10_ms": unet_ms[10],
           "generative_unet_b2_ms": unet_ms[2], "generative_unet_b10_tflop": flops[10] / 1e12,
           "generative_unet_b10_peak_share": share[10], "generative_vae_encode_ms": enc_ms,
           "generative_vae_decode5_ms": dec_ms, "generative_inpaint_busy_share": busy_share,
           "generative_inpaint_shares": shares, "generative_psnr_seed": fit["psnr"][0],
           "generative_psnr_seed_untrained": fit["psnr0"],
           "generative_psnr_generated": fit["psnr"][1], "generative_unet_card_vs_cpu": u_err,
           "generative_clip_card_vs_cpu": c_err, "render_only_s": ro_s,
           "render_only_max_dev": ro_dev}
    return rec, booster, calls[0]["image"]


# phase 9: the depth family at full width
DEPTH_FAMILY_SIZES = (448, 896)


def phase_depth_family(dev, card, booster, fit_seed_image):
    """The depth family at full width (module docstring, phase 9)."""
    import numpy as np
    import torch
    from text2nerf_tpu_torch.models import diffusion as D
    from text2nerf_tpu_torch.models import leres as L
    from text2nerf_tpu_torch.models import midas as M
    from text2nerf_tpu_torch.models import monodepth as MD
    from text2nerf_tpu_torch.models import pix2pix as P
    from text2nerf_tpu_torch.services import depth_service as DS
    from text2nerf_tpu_torch.services import fallbacks

    model = booster.model
    gen = torch.Generator(device=dev).manual_seed(9)
    rec, sizes = {}, set(DEPTH_FAMILY_SIZES)
    images = (("fit seed image", fit_seed_image),
              ("procedural seed image",
               fallbacks.procedural_text2img("a beautiful garden with flowers", hw=SEED_FIT_HW)))
    for name, img in images:
        calls = _DepthCalls(booster.estimate)
        try:
            counts = calls(img)
            busy, _, wall_prof = _profile_shares(lambda: booster.estimate(img), dev)
        finally:
            calls.close()
        c = calls.calls[0]
        _require(np.isfinite(counts).all() and counts.min() == 0 and counts.max() == 65535,
                 f"{name}: counts in [{counts.min()}, {counts.max()}]")
        sizes.add(min(c["optimal"], DS.GPU_THRESHOLD))
        key = name.split()[0]
        rec[f"depth_{key}_ms"], rec[f"depth_{key}_busy_share"] = c["ms"], busy / c["ms"]
        rec[f"depth_{key}_evals"], rec[f"depth_{key}_patches"] = c["evals"], c["patches"]
        print(f"boosted estimate of the {name} on {card}: {c['ms']:.1f} ms, device busy "
              f"{busy:.1f} ms under torch.profiler ({wall_prof:.1f} ms profiled; busy share "
              f"{busy / c['ms']:.3f}); processing size {c['optimal']}, enlarged image "
              f"{c['img_big']}, {c['patches']} patches merged; LeReS evaluations by size "
              f"{c['evals']} ({sum(c['evals'].values())})", flush=True)

    # ms per LeReS evaluation (bf16, CUDA events) and its FLOPs and peak share
    with torch.no_grad():
        for sz in sorted(sizes):
            x = torch.randn(1, 3, sz, sz, generator=gen, device=dev)
            ms = _time_ms(lambda: model(x), 3)
            busy, _, _ = _profile_shares(lambda: model(x), dev)
            flops = _flops_of(lambda: model(x))
            rec[f"leres_{sz}_ms"], rec[f"leres_{sz}_tflop"] = ms, flops / 1e12
            rec[f"leres_{sz}_busy_ms"] = busy
            print(f"LeReS ResNeXt-101 evaluation at {sz}^2 (bf16): {ms:.2f} ms, device busy "
                  f"{busy:.2f} ms of it under torch.profiler, {flops / 1e12:.4f} TFLOP, "
                  f"{flops / (ms * 1e-3) / BF16_FLOPS:.3f} of the {BF16_FLOPS / 1e12:.0f} "
                  f"TFLOP/s bf16 peak, on {card}", flush=True)
        p = booster.pix2pix_size
        a = torch.rand(p, p, generator=gen, device=dev)
        b = torch.rand(p, p, generator=gen, device=dev)
        rec["fallback_merge_ms"] = _time_ms(lambda: booster._fallback_merge(a, b), 5)
        unet = P.UnetGenerator(2, 1, 10, generator=torch.Generator().manual_seed(0))
        merge = DS.make_merge_double(unet.to(dev).requires_grad_(False), dev)
        m = merge(a, b)
        _require(m.shape == (p, p) and bool(torch.isfinite(m).all()), "the pix2pix merge")
        rec["pix2pix_merge_ms"] = _time_ms(lambda: merge(a, b), 3)
        mflops = _flops_of(lambda: merge(a, b))
        del unet, merge
        print(f"fallback merge at {p}^2: {rec['fallback_merge_ms']:.2f} ms; pix2pix merge_double "
              f"(unet_1024, 10 downs, fp32, seeded random init) at {p}^2: "
              f"{rec['pix2pix_merge_ms']:.2f} ms, {mflops / 1e12:.3f} TFLOP "
              f"({mflops / (rec['pix2pix_merge_ms'] * 1e-3) / TF32_FLOPS:.3f} of the "
              f"{TF32_FLOPS / 1e12:.0f} TFLOP/s TF32 peak), on {card}", flush=True)

        # the other nets of the family, once each in bf16 at their sizes
        others = (("MiDaS v2.1", lambda: M.MidasNet(L.LeReSConfig.resnext101(),
                                                    dtype=torch.bfloat16),
                   M.midas_resize_shape(*SEED_FIT_HW, 384)),
                  ("SGRNet (ResNet-50)", lambda: L.SGRNetDepth(L.LeReSConfig.resnet50(),
                                                               torch.bfloat16), (448, 448)),
                  ("RelDepthNet (leres stand-in)",
                   lambda: MD.RelDepthNet(MD.DepthNetConfig.leres(), torch.bfloat16), (448, 448)))
        for name, make, hw in others:
            net = D.materialize(make, dev, torch.Generator(device=dev).manual_seed(1))
            x = torch.randn(1, 3, *hw, generator=gen, device=dev)
            out = net(x)
            _require(out.shape == (1, *hw) and bool(torch.isfinite(out).all()),
                     f"{name}: output {tuple(out.shape)} not finite")
            ms = _time_ms(lambda: net(x), 1)
            flops = _flops_of(lambda: net(x))
            key = name.split()[0].lower()
            rec[f"{key}_ms"], rec[f"{key}_tflop"] = ms, flops / 1e12
            print(f"{name} forward at {hw} (bf16, random init): {ms:.2f} ms, "
                  f"{flops / 1e12:.4f} TFLOP, {flops / (ms * 1e-3) / BF16_FLOPS:.3f} of the "
                  f"bf16 peak, on {card}", flush=True)
            del net

    # ResNeXt-101 LeReS on the card against the CPU, fp32, TF32 off
    x = (torch.rand(1, 3, 448, 448, generator=torch.Generator().manual_seed(6)),)
    err, ms_card, ms_cpu = _card_vs_cpu(lambda: L.RelDepthModel(L.LeReSConfig.resnext101()),
                                        {k: v.cpu() for k, v in model.state_dict().items()},
                                        x, dev)
    print(f"LeReS ResNeXt-101 at 448^2, {card} vs CPU (fp32, TF32 off): {err:.3e} of the largest "
          f"output (tol {TOL['leres']:g}; {ms_card:.0f} / {ms_cpu:.0f} ms)", flush=True)
    _require(err <= TOL["leres"], f"LeReS card vs CPU: {err} > {TOL['leres']}")
    rec["leres_card_vs_cpu"] = err
    return rec


# phase 10: resume, update_known_views and the evaluation's extra metrics
RESUME_PSNR_DB = 0.5  # the JAX package's crash-resume test bound
EXTRA_METRIC_REPS = 5
LPIPS_FILES = {"alex": "alexnet-owt-7be5be79.pth", "vgg": "vgg16-397923af.pth"}


def _counts_zeroed():
    import torch
    from text2nerf_tpu_torch.ops.kernels import reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()


def _read_counts(report, path, need):
    """The kernel counts of the run just driven, added to the report under
    ``path``; each kernel of ``need`` must have been launched (kernels A,
    A', C and C' counted by compute type: fp32 as factor_features, bf16 as
    factor_features_bf16, and so on)."""
    import torch
    from text2nerf_tpu_torch.ops.kernels import launch_counts

    torch.cuda.synchronize()
    launches = launch_counts()
    for name, count in launches.items():
        _require(count > 0 or name not in need, f"{name} was not launched on {path}")
        if count:
            report[name]["launches"] = report[name].get("launches", 0) + count
            report[name].setdefault("launches_by_path", {})[path] = count
    return launches


def _rows_of(logfolder, skip=0):
    return [json.loads(line) for line in open(f"{logfolder}/metrics.jsonl")][skip:]


def _write_lpips_weights(d):
    """LPIPS alex and vgg at a seeded random init in the torch originals'
    layout: torchvision's ``features.*`` and lpips' heads."""
    import torch
    from text2nerf_tpu_torch.models import lpips as PL

    os.makedirs(d, exist_ok=True)
    for net, name in LPIPS_FILES.items():
        torch.manual_seed(7)
        feats = PL.alex_features() if net == "alex" else PL.vgg16_features()
        torch.save({f"features.{k}": v for k, v in feats.state_dict().items()}, f"{d}/{name}")
        torch.save({f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1)
                    for i, c in enumerate(PL.CHANNELS[net])}, f"{d}/{net}.pth")


def phase_resume(dev, card, report, workdir, prog, seed_kept):
    """Phase 10 (module docstring): (a) phase 7's fit crashed in its
    expansion and resumed, (b) phase 7's last resume point resumed, (c)
    one expansion with update_known_views on phase 7's field and scene,
    (d) the evaluation's SSIM and LPIPS on phase 6's final field."""
    import numpy as np
    import torch
    from text2nerf_tpu_torch.data import scene_state as ss
    from text2nerf_tpu_torch.engine import checkpoints as ckpt
    from text2nerf_tpu_torch.engine import expansion, metrics, renderer, trainer
    from text2nerf_tpu_torch.ops import splat
    from text2nerf_tpu_torch.services.registry import default_services
    from text2nerf_tpu_torch.utils.png import read_png

    cfg, scene_cfg, ex = prog["cfg"], prog["scene_cfg"], prog["ex"]
    out = {}

    # (a) the crash after the boundary's save, and the rerun
    services = default_services(hw=SEED_FIT_HW, device=dev)
    inpaint, calls = services.inpaint, [0]

    def dying_inpaint(*args, **kw):
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("simulated crash in the expansion")
        return inpaint(*args, **kw)

    services.inpaint = dying_inpaint
    # through the directory backend (torch.distributed.checkpoint); (b)
    # keeps npz, so both backends resume on the card
    cfg_a = dataclasses.replace(cfg, basedir=f"{workdir}/a/log", checkpoint_backend="orbax")
    scene_a = dataclasses.replace(scene_cfg, datadir=f"{workdir}/a/scene")
    saves0 = ckpt.save_orbax, ckpt.save_checkpoint
    ckpt.save_orbax, ckpt.save_checkpoint = orbax_saves, npz_saves = tuple(map(_Timed, saves0))
    try:
        t0 = time.perf_counter()
        try:
            trainer.reconstruction(cfg_a, scene_a, services, ex, device=dev)
            _require(False, "the crashing inpaint did not stop the fit")
        except RuntimeError as e:
            _require("simulated crash" in str(e), f"the fit failed otherwise: {e}")
        crash_s = time.perf_counter() - t0
        folder = trainer.log_folder(cfg_a, scene_a)
        _require(not os.path.exists(f"{folder}/{cfg.expname}_resume.npz"),
                 "the orbax fit wrote an npz resume point")
        loop = ckpt.load_orbax(f"{folder}/{cfg.expname}_resume", device=dev)[-1]
        _require(loop["epoch"] == cfg.n_stage1 and loop["next_view"] == 1,
                 f"the crashed fit's resume point is not the boundary's: {loop}")
        n_rows = len(_rows_of(folder))
        services.inpaint = inpaint
        _counts_zeroed()
        t0 = time.perf_counter()
        _, _, _, scene_r, _ = trainer.reconstruction(cfg_a, scene_a, services, ex, device=dev)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        launches = _read_counts(report, "resume", ("factor_features", "factor_features_bwd",
                                                    "shading_mlp"))
    finally:
        ckpt.save_orbax, ckpt.save_checkpoint = saves0
    final = f"{folder}/{cfg.expname}_final"
    _, f_dir, aabb_dir, loop_dir = ckpt.load_orbax(final, device=dev)
    _, f_npz, aabb_npz, _, loop_npz = ckpt.load_checkpoint(f"{final}.npz", device=dev)
    leaves_dir, leaves_npz = ckpt.params_to_jax(f_dir), ckpt.params_to_jax(f_npz)
    _require(leaves_dir.keys() == leaves_npz.keys()
             and all(np.array_equal(leaves_dir[k], leaves_npz[k]) for k in leaves_npz)
             and torch.equal(aabb_dir, aabb_npz) and loop_dir == loop_npz,
             f"{final}/ does not hold its _final.npz's field")
    field_mib = sum(v.nbytes for v in leaves_npz.values()) / 2 ** 20
    dir_mib = sum(os.path.getsize(f"{final}/{n}") for n in os.listdir(final)) / 2 ** 20
    print(f"(a) orbax directories: {len(orbax_saves.ms)} saves "
          f"({[round(x, 1) for x in orbax_saves.ms]} ms, the last the final directory), "
          f"{sum(orbax_saves.ms) / 1e3:.3f} s; the npz saves of the same run "
          f"{[round(x, 1) for x in npz_saves.ms]} ms (the final .npz, with its mask); the "
          f"field {field_mib:.1f} MiB of leaves, the final directory {dir_mib:.1f} MiB, its "
          f".npz {os.path.getsize(f'{final}.npz') / 2 ** 20:.1f} MiB; {final}/ equal to its "
          f".npz bit for bit; phase 7's npz resume points (field and snapshot) "
          f"{[round(x, 1) for x in prog['resume_save_ms']]} ms, "
          f"{sum(prog['resume_save_ms']) / 1e3:.3f} s, on {card}", flush=True)
    rows = _rows_of(folder, n_rows)
    _require([r["resume_epoch"] for r in rows if "resume_epoch" in r] == [cfg.n_stage1],
             "the rerun did not log its resume epoch")
    _require(not any(k.startswith("phase/bootstrap") for r in rows for k in r),
             "the rerun bootstrapped the scene again")
    psnr_a, _ = _final_psnrs(cfg, scene_r, folder, prog["n_samples"], prog["eval_kw"])
    gap = max(abs(a - b) for a, b in zip(psnr_a, prog["psnr"]))
    view1_diff = float(np.abs(scene_r.rgbs_gen_split[1] - prog["scene"].rgbs_gen_split[1]).max())
    print(f"(a) crash and resume: crashed after {crash_s:.3f} s (inpaint call {calls[0]}, "
          f"after the boundary's save at epoch {loop['epoch']}, step {loop['global_step']}); "
          f"the rerun {resume_s:.3f} s (phase 7 uninterrupted {prog['wall']:.3f} s, both with a "
          f"device sync around every step), launches {launches}; per-view PSNRs "
          f"{[round(p, 4) for p in psnr_a]} dB vs phase 7's "
          f"{[round(p, 4) for p in prog['psnr']]} dB (at phase 7's {prog['n_samples']} "
          f"samples): largest gap {gap:.4f} dB (tol {RESUME_PSNR_DB}); the regenerated view 1 "
          f"within {view1_diff:.3e} of phase 7's, on {card}", flush=True)
    _require(len(psnr_a) == len(prog["psnr"]) and gap <= RESUME_PSNR_DB,
             f"the resumed fit's PSNRs {psnr_a} are not within {RESUME_PSNR_DB} dB of "
             f"{prog['psnr']}")
    out.update(resume_crash_s=crash_s, resume_rerun_s=resume_s, resume_psnr=psnr_a,
               resume_psnr_gap_db=gap, resume_orbax_save_ms=orbax_saves.ms,
               resume_npz_save_ms=npz_saves.ms, resume_field_mib=field_mib)

    # (b) phase 7's last resume point (the entry of stage 3), resumed
    folder_b = trainer.log_folder(dataclasses.replace(cfg, basedir=f"{workdir}/b/log"),
                                  scene_cfg)
    shutil.copytree(prog["logfolder"], folder_b)
    cfg_b = dataclasses.replace(cfg, basedir=f"{workdir}/b/log")
    loop_b = ckpt.load_checkpoint(f"{folder_b}/{cfg.expname}_resume.npz", device=dev)[-1]
    n_rows = len(_rows_of(folder_b))
    _counts_zeroed()
    t0 = time.perf_counter()
    _, _, _, scene_b, _ = trainer.reconstruction(cfg_b, scene_cfg, services, ex, device=dev)
    torch.cuda.synchronize()
    resume_b_s = time.perf_counter() - t0
    launches = _read_counts(report, "resume_stage3", ("factor_features", "factor_features_bwd",
                                                       "shading_mlp"))
    rows = _rows_of(folder_b, n_rows)
    _require([r["resume_epoch"] for r in rows if "resume_epoch" in r] == [loop_b["epoch"]],
             "the resumed stage 3 did not log its resume epoch")
    psnr_b, _ = _final_psnrs(cfg, scene_b, folder_b, prog["n_samples"], prog["eval_kw"])
    print(f"(b) resumed at phase 7's last point (epoch {loop_b['epoch']}, step "
          f"{loop_b['global_step']}): {resume_b_s:.3f} s, launches {launches}; per-view PSNRs "
          f"{[round(p, 4) for p in psnr_b]} dB beside phase 7's "
          f"{[round(p, 4) for p in prog['psnr']]} dB", flush=True)
    _require(all(np.isfinite(psnr_b)), f"the resumed stage 3 ended at {psnr_b}")
    out.update(resume_stage3_s=resume_b_s, resume_stage3_psnr=psnr_b)

    # (c) view 1 expanded again with update_known_views, on phase 7's final
    # field and its scene cut back to view 0
    _, field, _, mask, _ = ckpt.load_checkpoint(f"{prog['logfolder']}/{cfg.expname}_final.npz",
                                                device=dev)
    field.requires_grad_(False)
    scene = prog["scene"]
    scene0 = dataclasses.replace(
        scene, rgbs_gen_split=scene.rgbs_gen_split[:1], depth_gen_split=scene.depth_gen_split[:1],
        masks_gen_split=scene.masks_gen_split[:1], updates={"00000": scene.updates["00000"]})
    ex_c = dataclasses.replace(ex, update_known_views=True)
    _counts_zeroed()
    t0 = time.perf_counter()
    got = expansion.expand_scene(
        1, field, scene0, services, ex_c, f"{workdir}/c", n_samples=prog["n_samples"],
        white_bg=scene.white_bg, seed=cfg.seed + 1,
        alpha_mask=mask if cfg.eval_compact_k != 0 else None, compact_k=cfg.eval_compact_k,
        eval_z_min=ss.supervised_z_floor(scene0), device=dev)
    torch.cuda.synchronize()
    expand_s = time.perf_counter() - t0
    launches = _read_counts(report, "update_known_views", ("factor_features_bf16",
                                                            "shading_mlp"))
    from text2nerf_tpu_torch.engine import io_async

    io_async.flush(f"{workdir}/c")
    sup = f"{workdir}/c/DIBR/rgbs_support/00001_warp2known"
    names = sorted(os.listdir(sup)) if os.path.isdir(sup) else []
    want = sorted(f"00000_{k}.png" for k in ("image_pre", "image_warp", "depth_pre",
                                             "depth_warp"))
    _require(names == want, f"warp2known artifacts {names} are not {want}")
    # the back-warp's mask: view 1's new content warped into view 0
    my_map = read_png(f"{workdir}/c/DIBR/mask/00001_expand.png").astype(np.float32) / 255.0

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    back = splat.warp_one_to_many_with_mask(
        t(got.rgbs_gen_split[1]), t(got.depth_gen_split[1]), t(scene.poses_gen[1]),
        t(scene.poses_gen[:1]), scene.intrinsic, extra_mask=t(1.0 - my_map))[3][0].cpu().numpy()
    changed = np.abs(got.rgbs_gen_split[0] - scene0.rgbs_gen_split[0]).max(-1) > 0
    pool0 = got.updates["00000"]
    print(f"(c) update_known_views: {expand_s:.3f} s, launches {launches}; view 0 changed on "
          f"{int(changed.sum())} pixels, the back-warp covers {int(back.sum())}, changed outside "
          f"it {int((changed & (back == 0)).sum())}; view 0's pool {len(pool0[0])} rays (was "
          f"{len(scene0.updates['00000'][0])})", flush=True)
    _require(pool0 is not scene0.updates["00000"] and len(pool0[0]) > 0,
             "view 0's pool was not rebuilt")
    _require(changed.any() and not (changed & (back == 0)).any(),
             "view 0 changed outside the back-warp's mask, or nowhere")
    out.update(update_known_views_s=expand_s, update_known_views_changed_px=int(changed.sum()))

    # (d) SSIM and LPIPS of phase 6's final field at 512^2, card vs CPU
    _, f6, aabb6, mask6, _ = ckpt.load_checkpoint(seed_kept["ckpt"], device=dev)
    f6.requires_grad_(False)
    lp_dir = f"{workdir}/lpips_weights"
    _write_lpips_weights(lp_dir)
    kw = dict(seed_kept["eval_kw"], n_samples=seed_kept["n_samples"], alpha_mask=mask6,
              compact_k=seed_kept["compact_k"])
    _counts_zeroed()
    res = renderer.evaluation(f6, aabb6, seed_kept["rays"], seed_kept["hw"],
                              gt_rgbs=seed_kept["gt"], compute_extra_metrics=True,
                              lpips_weights_dir=lp_dir, **kw)
    launches = _read_counts(report, "extra_metrics", ("factor_features", "shading_mlp"))
    _require(len(res.get("ssim", [])) == 1 and len(res.get("lpips_alex", [])) == 1,
             f"the evaluation gave no ssim or lpips: {sorted(res)}")
    kw.pop("device")
    rgb, _ = renderer.render_view(f6, aabb6, seed_kept["rays"][0], seed_kept["hw"], device=dev,
                                  **{k: kw[k] for k in ("n_samples", "chunk", "app_k", "white_bg",
                                                        "alpha_mask", "compact_k", "eval_z_min")})
    gt = np.asarray(seed_kept["gt"][0]).reshape(rgb.shape)

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(EXTRA_METRIC_REPS):
            v = fn()
        torch.cuda.synchronize()
        return v, (time.perf_counter() - t0) * 1e3 / EXTRA_METRIC_REPS

    s_card, ssim_ms = timed(lambda: metrics.ssim(rgb, gt, device=dev))
    s_cpu = metrics.ssim(rgb, gt, device="cpu")
    line = (f"(d) extra metrics at {seed_kept['hw'][0]}x{seed_kept['hw'][1]}: evaluation psnr "
            f"{res['psnr'][0]:.4f} dB, ssim {res['ssim'][0]:.6f}, lpips_alex "
            f"{res['lpips_alex'][0]:.6f}, launches {launches}; SSIM card {s_card:.9f} vs CPU "
            f"{s_cpu:.9f} (|diff| {abs(s_card - s_cpu):.3e}, tol {TOL['ssim']:g}), "
            f"{ssim_ms:.3f} ms a call on the card")
    _require(abs(s_card - s_cpu) <= TOL["ssim"], f"SSIM card vs CPU: {s_card} vs {s_cpu}")
    out.update(ssim_ms=ssim_ms, ssim_card_vs_cpu=abs(s_card - s_cpu))
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for net in LPIPS_FILES:
            d_card, ms = timed(lambda: metrics.lpips(rgb, gt, net, lp_dir, device=dev))
            d_cpu = metrics.lpips(rgb, gt, net, lp_dir, device="cpu")
            rel = abs(d_card - d_cpu) / abs(d_cpu)
            line += (f"; LPIPS-{net} card {d_card:.7f} vs CPU {d_cpu:.7f} ({rel:.3e} of the "
                     f"value, tol {TOL['lpips']:g}), {ms:.3f} ms a call on the card")
            _require(rel <= TOL["lpips"], f"LPIPS-{net} card vs CPU: {d_card} vs {d_cpu}")
            out.update({f"lpips_{net}_ms": ms, f"lpips_{net}_card_vs_cpu": rel})
    print(line + f", on {card}", flush=True)
    return out



# stage 3's compaction settings tried on the seed fit (TrainConfig overrides)
SEED_FIT_VARIANTS = {
    "defaults": {},  # compacted K 64, depth-anchored band 6
    "stage3_dense": dict(train_compact_k=0),
    "first_k64": dict(train_depth_cap_band=0),
    "k256_first": dict(train_compact_k=256, train_depth_cap_band=0),
    "k256_band6": dict(train_compact_k=256),
    "smoke": SEED_FIT_COMPACT,
}


# phase 11: the TensoRF family's other configurations through the CLI
# (name, flags, kernels the run must launch, seed-view margin over the
# untrained field in dB); the expansion renders in bf16 (kernels A or C)
FAMILY_RUNS = (
    ("cp", ["--model_name", "TensorCP", "--n_lamb_sigma", str(CP_WIDTHS[0]),
            "--n_lamb_sh", str(CP_WIDTHS[1]), "--shadingMode", "MLP_Fea", "--fea_pe", "2",
            "--view_pe", "2", "--L1_weight_inital", "1e-5", "--L1_weight_rest", "1e-5"],
     ("cp_features", "cp_features_bf16", "cp_features_bwd", "shading_mlp_view"), 5.0),
    ("vm", ["--model_name", "TensorVM", "--n_lamb_sigma", "16", "--n_lamb_sh", "48",
            "--shadingMode", "SH"], ("factor_features", "factor_features_bf16",
                                     "factor_features_bwd"), 5.0),
    ("bf16", ["--train_compute_dtype", "bf16"],
     ("factor_features", "factor_features_bf16", "factor_features_bwd_bf16", "shading_mlp"),
     5.0),
    ("ndc", ["--ndc_ray", "1"], ("factor_features", "factor_features_bwd", "shading_mlp"), 0.0),
)
# the phase's one cut: one sub-batch a dense step (the CLI's default is 32;
# the masks' pool 3 keeps every step dense, and 32 host-bound sub-batches
# a step (~275 ms, phase 8) would take ~3 times the phase's budget)
FAMILY_FLAGS = ["--train_microbatch", "1"]
TOL.update({
    # one bf16 step on the card vs the CPU plain versions: kernel A is bit
    # for bit in bf16, but the basis product rounds its fp32 sums to bf16
    # after cuBLAS's and the CPU's orders of summation, so an app feature
    # may differ by one bf16 ulp (2^-8 relative) and each gradient term
    # behind it likewise
    "train_loss_bf16": 2 ** -8,
    "train_grad_bf16": 5e-2,
})
# the cp run's bf16 check: a crop of phase 5's (the CPU's plain C and C'
# at 384 channels), then the dense step's warm-up and timed steps per turn;
# its own count window, in which C and C' in bf16 must be launched
CP_CROP_RAYS = 512
CP_STEP_WARMUP, CP_STEP_TIMED = 2, 5
CP_BF16_STEP_NEED = ("cp_features_bf16", "cp_features_bwd_bf16")


def _family_argv(workdir, flags):
    """Phase 7's fit (module docstring) as the port's command line on the
    procedural services, with a run's flags.  The CLI's masks (pool 3)
    keep every step dense, so phase 7's stage-3 compaction flags would
    only widen the dense steps' app_k: the CLI's default (64) stays."""
    return ["--config", "configs/text2nerf_scenes.txt", "--expname", "seed",
            "--basedir", f"{workdir}/log", "--datadir", f"{workdir}/scene",
            "--prompt", "a beautiful garden with flowers",
            "--hw", str(SEED_FIT_HW[0]), str(SEED_FIT_HW[1]),
            "--pose_traj", PROGRESSIVE_SCENE["pose_traj"],
            "--num_training", str(PROGRESSIVE_SCENE["num_training"]),
            "--n_stage1", str(PROGRESSIVE_EPOCHS[0]), "--n_stage2", str(PROGRESSIVE_EPOCHS[1]),
            "--n_stage3", str(PROGRESSIVE_EPOCHS[2]), "--seed", "11",
            "--eval_compact_k", "-1", "--N_vis", str(CLI_TEST_FRAMES),
            *FAMILY_FLAGS, *flags]


def _render_only_matches(cli, argv, cfg, scene, logfolder, dev):
    """The render-only branch on the fit's final checkpoint (the fit's scene
    snapshot beside it): (wall s, max |frame - the fit's frame| / 255)."""
    import numpy as np
    import torch
    from text2nerf_tpu_torch.data import scene_state as ss
    from text2nerf_tpu_torch.ops import render as render_ops
    from text2nerf_tpu_torch.utils.png import read_png

    test_dir = f"{logfolder}/imgs_test_all"
    names = sorted(os.listdir(f"{test_dir}/rgbs"))
    _require(len(names) == CLI_TEST_FRAMES, f"the fit wrote test frames {names}")
    fit_frames = [read_png(f"{test_dir}/rgbs/{n}") for n in names]
    shutil.move(test_dir, f"{logfolder}/imgs_test_fit")
    ss.save_scene_snapshot(f"{logfolder}/scene_snapshot.npz", scene)
    render_ops._ADAPTIVE_PROBE_CACHE.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(argv + ["--render_only", "1", "--render_test", "1", "--ckpt",
                          f"{logfolder}/{cfg.expname}_final.npz"], device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _require(rc == 0 and sorted(os.listdir(f"{test_dir}/rgbs")) == names,
             f"render-only returned {rc} with frames {os.listdir(test_dir)}")
    dev_max = max(float(np.abs(read_png(f"{test_dir}/rgbs/{n}").astype(np.float64)
                               - f.astype(np.float64)).max()) / 255.0
                  for n, f in zip(names, fit_frames))
    return wall, dev_max


def _family_run(dev, card, report, workdir, name, flags, need, margin_db):
    """One run of phase 11 through main: the kernel counts set to 0 just
    before and read just after, the wall and ms per step, the seed view's
    PSNR against the untrained field's, finite frames."""
    import numpy as np
    import torch
    from text2nerf_tpu_torch import main as cli
    from text2nerf_tpu_torch.data import scene_state as ss
    from text2nerf_tpu_torch.engine import renderer, trainer
    from text2nerf_tpu_torch.engine import train_step as ts
    from text2nerf_tpu_torch.models import tensorf as tf
    from text2nerf_tpu_torch.ops.kernels import factor_features as ff
    from text2nerf_tpu_torch.ops.kernels import shading_mlp as sm

    argv = _family_argv(workdir, flags)
    got = {}
    recon0 = trainer.reconstruction

    def reconstruction(cfg, scene_cfg, services, ex, *, device=None):
        got["cfg"], got["scene_cfg"] = cfg, scene_cfg
        got["out"] = recon0(cfg, scene_cfg, services, ex, device=device)
        return got["out"]

    trainer.reconstruction = reconstruction
    try:
        with _StepProbe(ts, ff, sm) as probe:
            _counts_zeroed()
            t0 = time.perf_counter()
            rc = cli.main(argv, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _read_counts(report, f"family_{name}", need)
    finally:
        trainer.reconstruction = recon0
    _require(rc == 0, f"main returned {rc} on the {name} run")
    cfg, scene_cfg = got["cfg"], got["scene_cfg"]
    mcfg, field, aabb, scene, logfolder = got["out"]
    steps = probe.ms["dense"] + probe.ms["compact"]
    print(f"family {name}: {' '.join(flags)}; model {mcfg.model_name} "
          f"{tf.component_counts(mcfg)} {mcfg.shading_mode}, grid "
          f"{tf.grid_resolution(field)}, ndc {cfg.ndc_ray}, train dtype "
          f"{cfg.train_compute_dtype}; launches {launches}", flush=True)

    eval_kw = _eval_kw(cfg, scene_cfg, scene, dev)
    _, f0, aabb0, _ = trainer.init_field(cfg, scene, device=dev)
    f0.requires_grad_(False)
    n_samples = tf.default_n_samples(tf.grid_resolution(f0), f0.cfg.step_ratio,
                                     cfg.n_samples_cap)
    z_floor = ss.supervised_z_floor(scene)
    psnr0 = renderer.evaluation(
        f0, aabb0, scene.rays_gen_split[:1], scene.hw, gt_rgbs=scene.rgbs_gen_split,
        eval_z_min=z_floor, n_samples=n_samples, ndc=cfg.ndc_ray, **eval_kw)["psnr"][0]
    del f0
    psnr, loop = _final_psnrs(cfg, scene, logfolder, n_samples, eval_kw)
    frames = [read for read in os.listdir(f"{logfolder}/imgs_test_all/rgbs")]
    _require(len(frames) == CLI_TEST_FRAMES, f"the {name} run wrote test frames {frames}")
    rec = {"wall": wall, "steps": len(steps), "dense_ms": _median(probe.ms["dense"]),
           "compact_ms": _median(probe.ms["compact"]) if probe.ms["compact"] else None,
           "dense_busy_ms": probe.busy, "psnr0": psnr0, "psnr": psnr, "launches": launches}
    busy = "not measured" if probe.busy is None else (
        f"{probe.busy[0]:.2f} ms busy in {probe.busy[1]:.2f} ms ("
        + ", ".join(f"{k} {v:.2f}" for k, v in probe.split.items()) + " ms)")
    rec["dense_split_ms"] = probe.split
    print(f"family {name}: wall {wall:.3f} s; {len(probe.ms['dense'])} dense steps median "
          f"{rec['dense_ms']:.2f} ms, {len(probe.ms['compact'])} compacted median "
          f"{rec['compact_ms'] if rec['compact_ms'] is None else round(rec['compact_ms'], 2)} "
          f"ms (each between device syncs); one dense step under the profiler: {busy}; "
          f"seed view PSNR untrained {psnr0:.4f} dB, final "
          f"{psnr[0]:.4f} dB, generated view {psnr[1]:.4f} dB (step {loop['global_step']}); "
          f"on {card}", flush=True)
    _require(all(np.isfinite(psnr)) and np.isfinite(psnr0), f"{name}: PSNR {psnr0} {psnr}")
    _require(psnr[0] > psnr0 + margin_db,
             f"{name}: seed view PSNR {psnr[0]} is not {margin_db} dB above {psnr0}")
    if name == "cp":
        rec["render_only_s"], rec["render_only_max_dev"] = _render_only_matches(
            cli, argv, cfg, scene, logfolder, dev)
        print(f"family cp render-only: {CLI_TEST_FRAMES} test frames in "
              f"{rec['render_only_s']:.2f} s, max |frame - fit's frame| "
              f"{rec['render_only_max_dev']:.3e} (tol {TOL['render_only']:g})", flush=True)
        _require(rec["render_only_max_dev"] <= TOL["render_only"],
                 f"cp render-only frames differ by {rec['render_only_max_dev']}")
    return rec


def _bf16_step_checks(dev, card, train):
    """Phase 5's configuration in bf16: ms/step beside fp32 (both timed here,
    the same steps), and one crop step on the card against the CPU."""
    import torch
    from text2nerf_tpu_torch.data import synthetic as syn
    from text2nerf_tpu_torch.engine import checkpoints as ckpt
    from text2nerf_tpu_torch.engine import train_step as ts

    rays, rgb, depth = syn.training_targets(dev)
    field, aabb, mask, cfg, kw = syn.training_setup(dev)
    kw_bf = dict(kw, compute_dtype="bf16")
    sampler = ts.PermutationSampler(rays.shape[0], cfg.batch_size, seed=cfg.seed)
    ids = torch.as_tensor(sampler.next_ids()[:CROP_RAYS], device=dev)
    batch = {"rays": rays[ids], "rgb": rgb[ids], "depth": depth[ids]}
    loss_err, grad_errs, _ = crop_step_check(field, aabb, mask, batch, cfg, kw_bf, dev)
    grad_err = max(grad_errs.values())
    print(f"bf16 train step on the card vs the CPU plain versions, {CROP_RAYS} rays: loss "
          f"within {loss_err:.3e} relative (tol {TOL['train_loss_bf16']:.3e}), gradients within "
          f"{grad_err:.3e} of each leaf's largest (tol {TOL['train_grad_bf16']:g})", flush=True)
    _require(loss_err <= TOL["train_loss_bf16"], f"bf16 train loss differs: {loss_err}")
    _require(grad_err <= TOL["train_grad_bf16"], f"bf16 train gradients differ: {grad_errs}")
    ms = {}
    flat = ckpt.params_to_jax(field)
    for dtype in ("fp32", "bf16", "bf16", "fp32"):
        f = ckpt.params_from_jax(flat, field.cfg, device=dev)
        state, opt = ts.make_train_state(f, cfg.lr_init, cfg.lr_basis, runtime_decay=True)
        step = ts.make_train_step(f.cfg, opt, device=dev, **dict(kw, compute_dtype=dtype))
        gen = torch.Generator(device=dev).manual_seed(0)
        smp = ts.PermutationSampler(rays.shape[0], cfg.batch_size, seed=cfg.seed)

        def one(state):
            ids = torch.as_tensor(smp.next_ids(), device=dev)
            b = {"rays": rays[ids], "rgb": rgb[ids], "depth": depth[ids]}
            return step(state, aabb, b, gen, alpha_mask=mask)

        for _ in range(TRAIN_WARMUP):
            state, _ = one(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            state, m = one(state)
        torch.cuda.synchronize()
        ms.setdefault(dtype, []).append((time.perf_counter() - t0) / TRAIN_STEPS * 1e3)
        del f, state, opt, step
    print(f"train ms/step, phase 5's configuration (compacted K {kw['compact_k']}, batch "
          f"{cfg.batch_size}), in turns fp32, bf16, bf16, fp32: fp32 "
          f"{[round(v, 3) for v in ms['fp32']]}, bf16 {[round(v, 3) for v in ms['bf16']]} "
          f"(phase 5's fp32 {train['train_ms_per_step']:.2f}) on {card}", flush=True)
    return {"bf16_step_ms": ms["bf16"], "fp32_step_ms": ms["fp32"],
            "bf16_crop_loss_err": loss_err, "bf16_crop_grad_err": grad_err}


def _cp_step_setup(dev, workdir):
    """Phase 11's TensorCP configuration (the cp run's flags through the
    CLI's parser, with main's production overrides: a 300^3 grid, batch
    16384) as the trainer's dense step toward phase 5's room-shell
    targets: (field, aabb, train config, step kwargs, (rays, rgb, depth))."""
    import numpy as np
    import torch
    from text2nerf_tpu_torch import config
    from text2nerf_tpu_torch.data import synthetic as syn
    from text2nerf_tpu_torch.engine import trainer as TR
    from text2nerf_tpu_torch.models import tensorf as tf

    here = os.path.dirname(os.path.abspath(__file__))
    flags = next(run[1] for run in FAMILY_RUNS if run[0] == "cp")
    args = config.parse_args([os.path.join(here, a) if a.startswith("configs/") else a
                              for a in _family_argv(workdir, flags)])
    args.N_voxel_init = args.N_voxel_final = 27_000_000
    args.batch_size = 1024 * 16
    cfg = config.to_configs(args)[0]
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    field = tf.init_params(cfg.model, FULL_RESO, generator=gen, device=dev)
    reso = tf.grid_resolution(field)
    n_samples = tf.default_n_samples(reso, cfg.model.step_ratio, cfg.n_samples_cap)
    group, block = TR._resolve_group(cfg, np.asarray(syn.AABB, np.float32), reso,
                                     cfg.model.step_ratio)
    kw = TR._step_kwargs(cfg, n_samples=n_samples, group=group, block=block, white_bg=True)
    return (field.requires_grad_(True), torch.tensor(syn.AABB, device=dev), cfg, kw,
            syn.training_targets(dev))


def _cp_bf16_step_checks(dev, card, report, workdir):
    """The cp run's configuration trained in bf16 on the card (the JAX
    trainer's --train_compute_dtype bf16 with --model_name TensorCP): one
    dense crop step held against the CPU plain versions, then the dense
    step timed in turns fp32, bf16, bf16, fp32, each bf16 step making one
    bf16 copy of each line.  The kernel counts are set to 0 once the field
    and targets are made and read at the end, under family_cp_bf16_step."""
    import numpy as np
    import torch
    from text2nerf_tpu_torch.engine import checkpoints as ckpt
    from text2nerf_tpu_torch.engine import train_step as ts
    from text2nerf_tpu_torch.ops.kernels import factor_features as ff

    field, aabb, cfg, kw, (rays, rgb, depth) = _cp_step_setup(dev, workdir)
    _counts_zeroed()
    sampler = ts.PermutationSampler(rays.shape[0], cfg.batch_size, seed=cfg.seed)
    ids = torch.as_tensor(sampler.next_ids()[:CP_CROP_RAYS], device=dev)
    batch = {"rays": rays[ids], "rgb": rgb[ids], "depth": depth[ids]}
    loss_err, grad_errs, _ = crop_step_check(field, aabb, None, batch, cfg,
                                             dict(kw, compute_dtype="bf16"), dev)
    grad_err = max(grad_errs.values())
    print(f"family cp bf16 train step on the card vs the CPU plain versions, {CP_CROP_RAYS} "
          f"rays, dense: loss within {loss_err:.3e} relative (tol "
          f"{TOL['train_loss_bf16']:.3e}), gradients within {grad_err:.3e} of each leaf's "
          f"largest (tol {TOL['train_grad_bf16']:g})", flush=True)
    _require(loss_err <= TOL["train_loss_bf16"], f"cp bf16 train loss differs: {loss_err}")
    _require(grad_err <= TOL["train_grad_bf16"], f"cp bf16 train gradients differ: {grad_errs}")
    ms, copies = {}, []
    flat = ckpt.params_to_jax(field)
    for dtype in ("fp32", "bf16", "bf16", "fp32"):
        f = ckpt.params_from_jax(flat, field.cfg, device=dev)
        state, opt = ts.make_train_state(f, cfg.lr_init, cfg.lr_basis, runtime_decay=True)
        step = ts.make_train_step(f.cfg, opt, device=dev, **dict(kw, compute_dtype=dtype))
        gen = torch.Generator(device=dev).manual_seed(0)
        smp = ts.PermutationSampler(rays.shape[0], cfg.batch_size, seed=cfg.seed)

        def one(state):
            ids = torch.as_tensor(smp.next_ids(), device=dev)
            b = {"rays": rays[ids], "rgb": rgb[ids], "depth": depth[ids]}
            return step(state, aabb, b, gen)  # no mask: the dense branch

        for _ in range(CP_STEP_WARMUP):
            state, _ = one(state)
        torch.cuda.synchronize()
        made = ff.BF16_COPIES
        t0 = time.perf_counter()
        for _ in range(CP_STEP_TIMED):
            state, m = one(state)
        torch.cuda.synchronize()
        ms.setdefault(dtype, []).append((time.perf_counter() - t0) / CP_STEP_TIMED * 1e3)
        if dtype == "bf16":
            copies.append((ff.BF16_COPIES - made) / CP_STEP_TIMED)
        _require(all(np.isfinite(float(v)) for v in m.values()), f"cp {dtype} step: {m}")
        del f, state, opt, step
    print(f"family cp dense train ms/step (batch {cfg.batch_size}, {kw['n_samples']} samples "
          f"a ray, app_k {kw['app_k']}, R = {kw['microbatch']}), in turns fp32, bf16, bf16, "
          f"fp32: fp32 {[round(v, 3) for v in ms['fp32']]}, bf16 "
          f"{[round(v, 3) for v in ms['bf16']]}; bf16 line copies per step {copies} on {card}",
          flush=True)
    _require(all(c == 3 for c in copies), f"bf16 line copies per cp step: {copies}, not 3")
    launches = _read_counts(report, "family_cp_bf16_step", CP_BF16_STEP_NEED)
    print(f"family cp bf16 step checks: launches {launches}", flush=True)
    return {"bf16_step_ms": ms["bf16"], "fp32_step_ms": ms["fp32"],
            "bf16_crop_loss_err": loss_err, "bf16_crop_grad_err": grad_err,
            "bf16_copies_per_step": copies}


def phase_model_family(dev, card, report, workdir, train):
    """Phase 11 (module docstring): four runs of phase 7's fit through the
    CLI, TensorCP, TensorVM, the bf16 train step and NDC rays, each with
    its gates; the bf16 steps' card-vs-CPU checks and times (TensorCP's in
    a count window of its own, after the cp run's)."""
    rec = {}
    t0 = time.perf_counter()
    for name, flags, need, margin in FAMILY_RUNS:
        run_dir = f"{workdir}/{name}"
        shutil.rmtree(run_dir, ignore_errors=True)
        try:
            rec[name] = _family_run(dev, card, report, run_dir, name, flags, need, margin)
            if name == "cp":
                rec[name].update(_cp_bf16_step_checks(dev, card, report, run_dir))
        finally:
            shutil.rmtree(run_dir, ignore_errors=True)
        if name == "bf16":
            rec[name].update(_bf16_step_checks(dev, card, train))
    wall = time.perf_counter() - t0
    print(f"phase 11 wall {wall:.1f} s", flush=True)
    out = {"family_wall_s": wall}
    for name, r in rec.items():
        for k, v in r.items():
            if k != "launches":
                out[f"family_{name}_{k}"] = v
    return out


# phase 12: the scene farm (two scenes of phase 7's configuration, two
# workers on the one card), then fit_scenes_mesh
FARM_HW = (256, 256)  # cut: phase 7 runs 512^2
FARM_MERGE_ITERS = 100  # cut: ExpansionConfig's default is 500
FARM_PROMPTS = ("a cozy living room", "a beautiful garden with flowers")
FARM_MARGIN_DB = 5.0
MESH_FIT_STEPS = 10
# phase 13: the mesh's train step on the card, two gloo ranks
MESH_RAYS = N_RAYS_TRAIN
# phase 14: merge pretraining, the discriminator, the filters' device backend
PRETRAIN_STEPS = 20
PRETRAIN_NET = (1024, 10)  # unet_1024: net size, levels
FILTER_REPS = 3


def _farm_configs(workdir):
    """(TrainConfig, SceneConfig, ExpansionConfig) of a farm scene: phase
    7's configuration at FARM_HW with FARM_MERGE_ITERS merge iterations
    (prompt, datadir and basedir are the farm's)."""
    from text2nerf_tpu_torch.engine import expansion

    n1, n2, n3 = PROGRESSIVE_EPOCHS
    cfg, scene_cfg = _seed_fit_configs(
        workdir, FARM_HW, scene=PROGRESSIVE_SCENE, n_stage1=n1, n_stage2=n2, n_stage3=n3,
        eval_every_epochs=sum(PROGRESSIVE_EPOCHS), expname="farm", **SEED_FIT_COMPACT,
        **PROGRESSIVE_OVERRIDES)
    ex = expansion.ExpansionConfig(prompt=scene_cfg.prompt, push_depth=scene_cfg.push_depth,
                                   trans_range=scene_cfg.trans_range,
                                   merge_iters=FARM_MERGE_ITERS)
    return cfg, scene_cfg, ex


def _untrained_psnr(cfg, scene, field, dev):
    """The seed view's PSNR of the untrained field the fit started from,
    upsampled to the fit's final grid and rendered as progressive_runner
    evaluates."""
    from text2nerf_tpu_torch.data import scene_state as ss
    from text2nerf_tpu_torch.engine import renderer, trainer
    from text2nerf_tpu_torch.models import tensorf as tf

    _, f0, aabb0, _ = trainer.init_field(cfg, scene, device=dev)
    f0 = tf.upsample_volume_grid(f0, tf.grid_resolution(field)).requires_grad_(False)
    return renderer.evaluation(
        f0, aabb0, scene.rays_gen_split[:1], scene.hw, gt_rgbs=scene.rgbs_gen_split,
        n_samples=tf.default_n_samples(tf.grid_resolution(f0), f0.cfg.step_ratio),
        chunk=cfg.batch_size, app_k=cfg.app_k, eval_z_min=ss.supervised_z_floor(scene),
        device=dev)["psnr"][0]


def phase_farm(dev, card, report, workdir):
    """run_farm_parallel over FARM_PROMPTS on [dev, dev] (two workers on
    one card), each scene progressive_runner's whole pipeline on fresh
    default services; then run_farm over the same prompts, served from
    the markers (module docstring, phase 12)."""
    import numpy as np
    import torch
    from text2nerf_tpu_torch.engine import trainer
    from text2nerf_tpu_torch.parallel import scene_farm as farm
    from text2nerf_tpu_torch.services.registry import default_services

    cfg, scene_cfg, ex = _farm_configs(workdir)

    def services_factory(device):
        return default_services(hw=FARM_HW, device=device)

    run = farm.progressive_runner(cfg, scene_cfg, None, ex, services_factory=services_factory)
    fits = {}
    reconstruction0 = trainer.reconstruction

    def reconstruction(t_cfg, s_cfg, *args, **kw):  # keeps each scene's result
        out = reconstruction0(t_cfg, s_cfg, *args, **kw)
        fits[s_cfg.prompt] = (t_cfg, out)
        return out

    print(f"farm: {len(FARM_PROMPTS)} scenes on [{dev}, {dev}], each hw {FARM_HW}, "
          f"{scene_cfg.pose_traj} x {scene_cfg.num_training} views, epochs {PROGRESSIVE_EPOCHS}, "
          f"{SEED_FIT_COMPACT}, merge unet_1024 at random init, {FARM_MERGE_ITERS} merge "
          f"iterations", flush=True)
    data, logs = f"{workdir}/data", f"{workdir}/log"
    trainer.reconstruction = reconstruction
    try:
        _counts_zeroed()
        t0 = time.perf_counter()
        results = farm.run_farm_parallel(FARM_PROMPTS, data, logs, run, devices=[dev, dev])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        trainer.reconstruction = reconstruction0
    launches = _read_counts(report, "farm", ("factor_features", "factor_features_bf16",
                                             "factor_features_bwd", "shading_mlp"))
    _require(len(results) == len(FARM_PROMPTS), f"the farm returned {len(results)} scenes")
    overlap = sum(r["wall_s"] for r in results) / wall
    print(f"farm wall {wall:.3f} s on {card}; sum of scene walls / farm wall {overlap:.3f}; "
          f"launches {launches}", flush=True)
    out = {"farm_wall_s": wall, "farm_overlap": overlap}
    for i, r in enumerate(results):
        t_cfg, (_, field, _, scene, _) = fits[r["prompt"]]
        psnr0 = _untrained_psnr(t_cfg, scene, field, dev)
        psnr = r["per_view_psnr"]
        print(f"  scene {i} {r['prompt']!r} on {r['device']}: wall {r['wall_s']:.3f} s, "
              f"device_idle_s {r['device_idle_s']}, per-view PSNR {psnr} (seed view untrained "
              f"{psnr0:.4f} dB)", flush=True)
        _require(r["device"] == str(dev) and r["views"] == 2 and np.isfinite(psnr).all(),
                 f"scene {i}: {r}")
        _require(psnr[0] > psnr0 + FARM_MARGIN_DB,
                 f"scene {i}: seed view PSNR {psnr[0]} is not {FARM_MARGIN_DB} dB above {psnr0}")
        out.update({f"farm_scene{i}_wall_s": r["wall_s"], f"farm_scene{i}_psnr": psnr,
                    f"farm_scene{i}_device_idle_s": r["device_idle_s"],
                    f"farm_scene{i}_psnr_untrained": psnr0})
    del fits

    # scene 0's pipeline alone on the card, in a folder of its own: the
    # yardstick of the two workers' overlap
    _counts_zeroed()
    t0 = time.perf_counter()
    solo = farm.run_farm(FARM_PROMPTS[:1], f"{workdir}/solo_data", f"{workdir}/solo_log", run)[0]
    torch.cuda.synchronize()
    solo_wall = time.perf_counter() - t0
    _read_counts(report, "farm_solo", ("factor_features", "factor_features_bwd", "shading_mlp"))
    speedup = len(FARM_PROMPTS) * solo_wall / wall
    print(f"scene 0 alone: wall {solo_wall:.3f} s, device_idle_s {solo['device_idle_s']}, "
          f"per-view PSNR {solo['per_view_psnr']}; {len(FARM_PROMPTS)} x alone / farm wall "
          f"{speedup:.3f}", flush=True)
    out.update({"farm_solo_wall_s": solo_wall, "farm_speedup": speedup})

    # the second pass is served from the markers: no scene runs again
    _counts_zeroed()
    t0 = time.perf_counter()
    again = farm.run_farm(FARM_PROMPTS, data, logs, run)
    t_again = time.perf_counter() - t0
    again_launches = _read_counts(report, "farm_markers", ())
    print(f"farm second pass (run_farm): {t_again:.3f} s, launches {again_launches}", flush=True)
    _require([r["wall_s"] for r in again] == [r["wall_s"] for r in results]
             and not any(again_launches.values()), "the second pass ran a scene again")
    return out


def phase_fit_scenes_mesh(dev, card, report):
    """fit_scenes_mesh: two full-width fields (serving shells 2 and 3)
    toward phase 5's targets on the card, MESH_FIT_STEPS dense steps each
    (module docstring, phase 12)."""
    import numpy as np
    import torch
    from text2nerf_tpu_torch.data import synthetic as syn
    from text2nerf_tpu_torch.models import tensorf as tf
    from text2nerf_tpu_torch.parallel import scene_farm as farm

    rays, rgb, depth = syn.training_targets(dev)
    pool = tuple(t.cpu().numpy() for t in (rays, rgb, depth))
    fields = [syn.serving_shell(s, dev) for s in (2, 3)]
    aabbs = np.stack([np.asarray(syn.AABB, np.float32)] * 2)
    n_samples = tf.default_n_samples(tf.grid_resolution(fields[0]), fields[0].cfg.step_ratio)
    _counts_zeroed()
    t0 = time.perf_counter()
    fields, metrics = farm.fit_scenes_mesh(
        fields[0].cfg, fields, aabbs, [pool, pool], n_steps=MESH_FIT_STEPS,
        batch_size=N_RAYS_TRAIN, n_samples=n_samples, devices=[dev], seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts(report, "fit_scenes_mesh", ("factor_features",
                                                        "factor_features_bwd"))
    mse = metrics["mse"]
    print(f"fit_scenes_mesh: 2 scenes x {MESH_FIT_STEPS} dense steps (batch {N_RAYS_TRAIN}, "
          f"{n_samples} samples) in {wall:.3f} s on {card}; mse first {mse[0].tolist()} last "
          f"{mse[-1].tolist()}; launches {launches}", flush=True)
    _require(mse.shape == (MESH_FIT_STEPS, 2) and np.isfinite(mse).all()
             and (mse[-1] < mse[0]).all(), f"a scene's mse did not fall: {mse.tolist()}")
    return {"fit_scenes_mesh_s": wall, "fit_scenes_mesh_mse_first": mse[0].tolist(),
            "fit_scenes_mesh_mse_last": mse[-1].tolist()}


def _mesh_step_errors(mesh, field0, aabb, batch, n_samples, kw, seed):
    """One step of the mesh's shard against the one-process step over the
    whole batch: (mse relative error, worst leaf's gradient error relative
    to its largest reference value, the shard's plane shapes, the kernel
    launches of the sharded step alone)."""
    import copy

    import torch
    from text2nerf_tpu_torch.engine import train_step as ts
    from text2nerf_tpu_torch.ops.kernels import factor_features as ff
    from text2nerf_tpu_torch.ops.kernels import shading_mlp as sm
    from text2nerf_tpu_torch.parallel import mesh as pmesh

    dev = aabb.device
    ref = copy.deepcopy(field0)
    opt = ts.make_optimizer(ref)
    step = ts.make_train_step(ref.cfg, opt, device=dev, **kw)
    _, m_ref = step(ts.TrainState(ref, opt, 0), aabb, batch,
                    torch.Generator(device=dev).manual_seed(seed))
    shard = pmesh.shard_params(field0, mesh)
    opt_s = ts.make_optimizer(shard)
    step_s = ts.make_train_step(shard.cfg, opt_s, device=dev, mesh=mesh, **kw)
    # count the sharded step's launches only, not the reference's
    _counts_zeroed()
    _, m = step_s(ts.TrainState(shard, opt_s, 0), aabb, pmesh.shard_batch(batch, mesh),
                  torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    launches = {"factor_features": ff.DTYPES["fp32"], "factor_features_bwd": ff.BWD_DTYPES["fp32"],
                "shading_mlp": sm.LAUNCHES}
    tables = [p.grad for p in (*ref.planes, *ref.lines)]
    want_tables, want_basis = pmesh.shard_tensors(ref, mesh, tables, ref.basis.grad)
    want = [*want_tables, want_basis, *(ref.mlp[k].grad for k in ("w1", "b1", "w2", "b2",
                                                                 "w3", "b3"))]
    got = [p.grad for p in (*shard.planes, *shard.lines, shard.basis)]
    got += [shard.mlp[k].grad for k in ("w1", "b1", "w2", "b2", "w3", "b3")]
    errs = [float((g - w).abs().max() / w.abs().max().clamp_min(1e-30)) for g, w in zip(got, want)]
    mse_rel = abs(float(m["mse"]) - float(m_ref["mse"])) / float(m_ref["mse"])
    return mse_rel, max(errs), [tuple(t.shape) for t in shard.planes], launches


def _mesh_rank(rank, world, workdir):
    """A rank of phase 13 (run by parallel.dryrun.launch): one full-width
    dense train step at data 2 x model 1 and one at data 1 x model 2, each
    against the one-process step over the same batch, with each sharded
    step's own kernel launches."""
    import torch
    import torch.distributed as dist
    from text2nerf_tpu_torch.data import synthetic as syn
    from text2nerf_tpu_torch.engine import train_step as ts
    from text2nerf_tpu_torch.models import tensorf as tf
    from text2nerf_tpu_torch.parallel import mesh as pmesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    probe = torch.full((4,), float(rank + 1), device=dev)
    try:
        dist.all_reduce(probe)
    except Exception as e:  # noqa: BLE001 — the phase fails with the reason
        raise RuntimeError(f"gloo cannot all-reduce CUDA tensors in this torch build ({e!r}); "
                           "the mesh phase does not copy them to the host instead") from e
    _require(float(probe[0]) == world * (world + 1) / 2, f"gloo's CUDA all-reduce gave {probe}")
    rays, rgb, depth = syn.training_targets(dev)
    field0 = syn.serving_shell(2, dev)
    aabb = torch.tensor(syn.AABB, device=dev)
    n_samples = tf.default_n_samples(tf.grid_resolution(field0), field0.cfg.step_ratio)
    ids = torch.as_tensor(ts.PermutationSampler(rays.shape[0], MESH_RAYS, 0).next_ids(),
                          device=dev)
    batch = {"rays": rays[ids], "rgb": rgb[ids], "depth": depth[ids]}
    kw = dict(n_samples=n_samples, app_k=64, microbatch=1)
    out = {"rank": rank}
    for name, (d, m) in (("data2", (2, 1)), ("model2", (1, 2))):
        mesh = pmesh.make_mesh(data=d, model=m)
        mse_rel, grad_rel, shapes, launches = _mesh_step_errors(mesh, field0, aabb, batch,
                                                                n_samples, kw, seed=5)
        out[name] = {"mse_rel": mse_rel, "grad_rel": grad_rel, "plane_shapes": shapes,
                     "launches": launches}
    return out


def phase_mesh(dev, card, report, workdir):
    """Two gloo ranks on the one card (NCCL refuses two ranks on one GPU),
    each a process of its own (module docstring, phase 13)."""
    from text2nerf_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    ranks = dryrun.launch("chip_smoke:_mesh_rank", 2, workdir, timeout=400, threads=2)
    wall = time.perf_counter() - t0
    out = {"mesh_wall_s": wall}
    for r in ranks:
        for name in ("data2", "model2"):
            e = r[name]
            print(f"mesh rank {r['rank']} {name}: grads within {e['grad_rel']:.3e} of each leaf's "
                  f"largest (tol {TOL['mesh']:g}), mse within {e['mse_rel']:.3e} relative; "
                  f"shard planes {e['plane_shapes']}", flush=True)
            _require(e["grad_rel"] <= TOL["mesh"],
                     f"mesh rank {r['rank']} {name}: gradients {e['grad_rel']} > {TOL['mesh']}")
            out[f"mesh_{name}_grad_rel_r{r['rank']}"] = e["grad_rel"]
            print(f"mesh rank {r['rank']} {name}: the sharded step's launches {e['launches']}",
                  flush=True)
            for kernel, count in e["launches"].items():
                # kernel B is the eval head: a train step shades through autograd
                _require(count > 0 or kernel == "shading_mlp",
                         f"{kernel} was not launched by the sharded step {name} on mesh "
                         f"rank {r['rank']}")
                if not count:
                    continue
                report[kernel]["launches"] = report[kernel].get("launches", 0) + count
                by = report[kernel].setdefault("launches_by_path", {})
                by[f"mesh_{name}"] = by.get(f"mesh_{name}", 0) + count
    print(f"mesh phase: 2 ranks, {MESH_RAYS} rays a step, {wall:.1f} s with the ranks' start "
          f"on {card}", flush=True)
    return out


def phase_merge_filters(dev, card, report):
    """Merge pretraining at unet_1024, the PatchGAN discriminator card vs
    CPU, and the bilateral filter's device backend against the native one
    on the bootstrap's 512^2 inputs (module docstring, phase 14)."""
    import numpy as np
    import torch
    from text2nerf_tpu_torch.data import io as scene_io
    from text2nerf_tpu_torch.models import pix2pix as PP
    from text2nerf_tpu_torch.ops import filters
    from text2nerf_tpu_torch.services import fallbacks
    from text2nerf_tpu_torch.services import merge as PM

    def seed_rgbd(prompt):
        img = fallbacks.procedural_text2img(prompt, hw=SEED_FIT_HW)
        depth = scene_io.depth_process(fallbacks.procedural_depth(img), 2, push_depth=2.0)
        return img.astype(np.float32), np.asarray(depth, np.float32)

    rgbd = [seed_rgbd(p) for p in FARM_PROMPTS]
    svc = PM.DepthMergeService(net_size=PRETRAIN_NET[0], num_downs=PRETRAIN_NET[1], device=dev)
    # warm-up: the generator's init on the CPU, its first steps on the card
    t0 = time.perf_counter()
    PM.pretrain_merge_model(svc, [d for _, d in rgbd], steps=2, outsize=512, seed=1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    losses = PM.pretrain_merge_model(svc, [d for _, d in rgbd], steps=PRETRAIN_STEPS,
                                     outsize=512, seed=0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / PRETRAIN_STEPS * 1e3
    print(f"merge pretraining: {PRETRAIN_NET[0]} / {PRETRAIN_NET[1]} levels, bf16, "
          f"{PRETRAIN_STEPS} steps, {ms:.2f} ms per step (the host's corruption and "
          f"the generator's copy to the card included; after a {warm_s:.2f} s warm-up of 2 "
          f"steps) on {card}; losses {losses[0]:.5f} -> {losses[-1]:.5f}", flush=True)
    _require(len(losses) == PRETRAIN_STEPS and np.isfinite(losses).all(),
             f"merge pretraining losses {losses}")

    disc = PP.PatchDiscriminator(generator=torch.Generator().manual_seed(0))
    x = torch.rand((1, 2, 512, 512), generator=torch.Generator().manual_seed(1)) * 2 - 1
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            want = disc(x)
            got = disc.to(dev)(x.to(dev)).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    disc_err = float((got - want).abs().max() / want.abs().max())
    print(f"PatchDiscriminator card vs CPU (fp32, TF32 off, 512^2): {disc_err:.3e} of the "
          f"largest logit (tol {TOL['disc']:g})", flush=True)
    _require(disc_err <= TOL["disc"], f"PatchDiscriminator card vs CPU: {disc_err}")

    img, depth = rgbd[0]
    t0 = time.perf_counter()
    for _ in range(FILTER_REPS):
        n_img, n_depth = filters.sparse_bilateral_filtering(depth, img, backend="native")
    native_ms = (time.perf_counter() - t0) / FILTER_REPS * 1e3
    d_in, i_in = torch.as_tensor(depth, device=dev), torch.as_tensor(img, device=dev)
    filters.sparse_bilateral_filtering(d_in, i_in)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FILTER_REPS):
        g_img, g_depth = filters.sparse_bilateral_filtering(d_in, i_in)
    torch.cuda.synchronize()
    device_ms = (time.perf_counter() - t0) / FILTER_REPS * 1e3
    err = max(float(np.abs(g_img.cpu().numpy() - n_img).max()),
              float(np.abs(g_depth.cpu().numpy() - n_depth).max()))
    n_diff = int((g_depth.cpu().numpy() != n_depth).sum())
    print(f"bilateral filter {SEED_FIT_HW}, (5, 5, 3, 3): native {native_ms:.2f} ms, device "
          f"{device_ms:.2f} ms on {card}; device vs native max |diff| {err:.3e} (tol "
          f"{TOL['filter']:g}), {n_diff} depth pixels differ", flush=True)
    _require(err <= TOL["filter"], f"the filter's device backend differs from native: {err}")
    return {"merge_pretrain_ms_per_step": ms, "disc_card_vs_cpu": disc_err,
            "bilateral_native_ms": native_ms, "bilateral_device_ms": device_ms}


FULL_SCHEDULE_ARGS = ["--hw", "256", "--views", "2", "--stages", "1", "1", "1", "--grid", "300",
                      "--grid_init", "150", "--upsamp", "8", "16", "--candidates", "2"]
FULL_SCHEDULE_KEYS = ("status", "schedule", "hw", "grid", "views", "grid_init", "upsamp",
                      "stage3_balance", "stage3_gamma", "wall_min_this_attempt",
                      "per_view_psnr", "per_view_ssim", "mean_psnr", "mean_ssim", "logfolder")
# the snapshot rebuilt from the DIBR tree vs the run's own views: one uint8
# level of the PNG (1 / 255) and the bilateral filter's response to it;
# two steps of the uint16 depth PNG (1 / 12000 each)
REBUILD_TOL = {"rgb": 5e-3, "depth": 2.0 / 12000}


def phase_full_schedule(dev, card, report, workdir):
    """The product's quality tool at a cut depth (module docstring, phase
    15): run_full_schedule.main, its post-run tools on its log, then the
    flagged render in every select_impl on its field."""
    import numpy as np
    import torch
    from text2nerf_tpu_torch.engine import trainer
    from text2nerf_tpu_torch.models import tensorf as ptf
    from text2nerf_tpu_torch.ops import render as PRd
    from text2nerf_tpu_torch.tools import compute_metrics, rebuild_scene_snapshot
    from text2nerf_tpu_torch.tools import report_phases, run_full_schedule

    # the fit's result, read as it returns (the tool prints only its line)
    fits = []
    real = trainer.reconstruction

    def capture(*a, **kw):
        fits.append(real(*a, **kw))
        return fits[-1]

    report_path = os.path.join(workdir, "report.jsonl")
    trainer.reconstruction = capture
    try:
        _counts_zeroed()
        t0 = time.perf_counter()
        rc = run_full_schedule.main(["--out", workdir, "--report", report_path,
                                     *FULL_SCHEDULE_ARGS], device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counts(report, "full_schedule", need=(
            "factor_features", "factor_features_bf16", "factor_features_bwd", "shading_mlp"))
    finally:
        trainer.reconstruction = real
    _require(rc == 0 and len(fits) == 1, f"run_full_schedule returned {rc}")
    summary = json.loads(open(report_path).read().splitlines()[-1])
    _require(tuple(summary) == FULL_SCHEDULE_KEYS, f"run_full_schedule keys {list(summary)}")
    _require(summary["status"] == "ok" and len(summary["per_view_psnr"]) == 2
             and all(np.isfinite(summary["per_view_psnr"] + summary["per_view_ssim"])),
             f"run_full_schedule summary {summary}")
    _, field, aabb, scene, logfolder = fits[0]
    print(f"run_full_schedule {' '.join(FULL_SCHEDULE_ARGS)}: {wall:.1f} s on {card}; PSNR "
          f"{summary['per_view_psnr']} SSIM {summary['per_view_ssim']}; launches {launches}",
          flush=True)

    final = os.path.join(logfolder, "imgs_final")
    metrics_path = os.path.join(workdir, "compute_metrics.json")
    _require(compute_metrics.main(["--pred", os.path.join(final, "rgbs"), "--gt",
                                   os.path.join(final, "gt"), "--out", metrics_path],
                                  device=dev) == 0, "compute_metrics failed")
    metrics = json.load(open(metrics_path))
    _require(metrics["n_images"] == 2 and abs(metrics["ssim_mean"] - summary["mean_ssim"]) < 0.02,
             f"compute_metrics {metrics} vs the tool's SSIM {summary['mean_ssim']}")
    _require(report_phases.main([os.path.join(workdir, "log")]) == 0, "report_phases failed")

    # the snapshot rebuilt from the DIBR tree, views 0 and 1, against the
    # fit's final scene
    rebuilt_dir = os.path.join(workdir, "rebuilt")
    shutil.copytree(logfolder, rebuilt_dir)
    os.remove(os.path.join(rebuilt_dir, "scene_snapshot.npz"))
    _require(rebuild_scene_snapshot.main(["--logfolder", rebuilt_dir, "--max_views", "2"],
                                         device=dev) == 0, "rebuild_scene_snapshot failed")
    from text2nerf_tpu_torch.data import scene_state as ss

    rebuilt = ss.load_scene_snapshot(os.path.join(rebuilt_dir, "scene_snapshot.npz"))
    _require(rebuilt.rgbs_gen_split.shape == scene.rgbs_gen_split.shape,
             f"rebuilt {rebuilt.rgbs_gen_split.shape} vs {scene.rgbs_gen_split.shape}")
    rgb_err = float(np.abs(rebuilt.rgbs_gen_split - scene.rgbs_gen_split).max())
    depth_err = float(np.abs(rebuilt.depth_gen_split - scene.depth_gen_split).max())
    print(f"rebuild_scene_snapshot vs the fit's scene: rgb {rgb_err:.3e} (tol "
          f"{REBUILD_TOL['rgb']:g}), depth {depth_err:.3e} (tol {REBUILD_TOL['depth']:g})",
          flush=True)
    _require(rgb_err <= REBUILD_TOL["rgb"] and depth_err <= REBUILD_TOL["depth"],
             f"rebuilt snapshot: rgb {rgb_err}, depth {depth_err}")

    # the flagged compacted render (kernels A and B) on the seed view under
    # each select_impl name; topk and rank must give the sort route's bytes
    mask, _ = ptf.update_alpha_mask(field, aabb, (200, 200, 200), pool=3, device=dev)
    rays = torch.as_tensor(scene.rays_gen_split[0], device=dev)
    n_samples = ptf.default_n_samples(ptf.grid_resolution(field), field.cfg.step_ratio)
    outs = {}
    _counts_zeroed()
    for impl in ("sort", "topk", "rank"):
        outs[impl] = PRd.render_rays_compact_flagged(
            field, aabb, rays, mask, n_samples=n_samples, compact_k=64, app_k=64,
            feature_dtype="fp32", select_impl=impl)
    flagged = _read_counts(report, "flagged_render", need=("factor_features", "shading_mlp"))
    errs = {}
    for impl in ("topk", "rank"):
        errs[impl] = max(float((getattr(outs[impl][0], k) - getattr(outs["sort"][0], k))
                               .abs().max()) for k in ("rgb", "depth", "acc"))
        _require(errs[impl] == 0.0 and int(outs[impl][1]) == int(outs["sort"][1]),
                 f"select_impl={impl} differs from sort: {errs[impl]}")
    print(f"render_rays_compact_flagged on view 0 ({rays.shape[0]} rays, K 64): "
          f"{int(outs['sort'][1])} rays flagged; topk / rank vs sort max |diff| {errs}; "
          f"launches {flagged}", flush=True)
    return {"full_schedule_s": wall, "full_schedule_psnr": summary["per_view_psnr"],
            "full_schedule_ssim": summary["per_view_ssim"],
            "rebuild_err": {"rgb": rgb_err, "depth": depth_err}}


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
    if argv[:1] == ["--microbatch"] and len(argv) == 2 and argv[1].isdigit() and int(argv[1]):
        PROGRESSIVE_OVERRIDES["train_microbatch"] = int(argv[1])
    elif argv:
        variants = argv[1:] or list(SEED_FIT_VARIANTS)
        unknown = [n for n in variants if n not in SEED_FIT_VARIANTS]
        if argv[0] != "--seed-fit-variants" or unknown:
            print(f"usage: chip_smoke.py [--seed-fit-variants [NAME ...] | --microbatch R], "
                  f"NAME in {list(SEED_FIT_VARIANTS)}", file=sys.stderr)
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
    print(f"phases 7, 8, 10 and 12: {PROGRESSIVE_OVERRIDES['train_microbatch']} sub-batches a "
          f"dense step", flush=True)

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

    def mark(phase):  # the smoke's clock at each phase's start
        print(f"[{time.perf_counter() - t_start:.1f} s] phase {phase}", flush=True)

    report = {}
    mark(3)
    phase_kernels(dev, report)
    workdir = str(_build.BUILD_DIR / "smoke")
    os.makedirs(workdir, exist_ok=True)
    try:
        mark(4)
        rays_s, max_dev = phase_main_path(dev, card, report, workdir)
    finally:
        for f in os.listdir(workdir):
            os.remove(os.path.join(workdir, f))
    mark(5)
    train = phase_train(dev, card, report)
    seed_dir, prog_dir, resume_dir = (_build.BUILD_DIR / name for name in (
        "seed_fit", "progressive_fit", "resume"))
    try:
        for d in (seed_dir, prog_dir, resume_dir):
            shutil.rmtree(d, ignore_errors=True)
        try:
            mark(6)
            seed_kept, seed = phase_seed_fit(dev, card, report, str(seed_dir),
                                             str(resume_dir / "seed_fit"))
        finally:
            shutil.rmtree(seed_dir, ignore_errors=True)
        mark(7)
        prog_fit, prog = phase_progressive_fit(dev, card, report, str(prog_dir))
        gen_dir = _build.BUILD_DIR / "generative_fit"
        shutil.rmtree(gen_dir, ignore_errors=True)
        try:
            mark(8)
            gen, booster, fit_seed_image = phase_generative_fit(dev, card, report, str(gen_dir))
        finally:
            shutil.rmtree(gen_dir, ignore_errors=True)
        torch.cuda.empty_cache()
        mark(9)
        depth = phase_depth_family(dev, card, booster, fit_seed_image)
        del booster
        torch.cuda.empty_cache()
        mark(10)
        resumed = phase_resume(dev, card, report, str(resume_dir), prog_fit, seed_kept)
    finally:
        for d in (prog_dir, resume_dir):
            shutil.rmtree(d, ignore_errors=True)
    family_dir = _build.BUILD_DIR / "model_family"
    try:
        mark(11)
        family = phase_model_family(dev, card, report, str(family_dir), train)
    finally:
        shutil.rmtree(family_dir, ignore_errors=True)
    scale_dir = _build.BUILD_DIR / "scale_out"
    shutil.rmtree(scale_dir, ignore_errors=True)
    try:
        mark(12)
        scale = phase_farm(dev, card, report, str(scale_dir / "farm"))
        scale.update(phase_fit_scenes_mesh(dev, card, report))
        torch.cuda.empty_cache()
        mark(13)
        scale.update(phase_mesh(dev, card, report, str(scale_dir / "mesh")))
    finally:
        shutil.rmtree(scale_dir, ignore_errors=True)
    mark(14)
    scale.update(phase_merge_filters(dev, card, report))
    sched_dir = _build.BUILD_DIR / "full_schedule"
    shutil.rmtree(sched_dir, ignore_errors=True)
    try:
        mark(15)
        scale.update(phase_full_schedule(dev, card, report, str(sched_dir)))
    finally:
        shutil.rmtree(sched_dir, ignore_errors=True)
    wall_s = time.perf_counter() - t_start
    print(f"chip_smoke wall {wall_s:.1f} s on {card}", flush=True)
    print(json.dumps({"rays_per_s": rays_s, "max_dev": max_dev, **train, **seed, **prog, **gen,
                      **depth, **resumed, **family, **scale, "card": card,
                      "wall_s": wall_s}), flush=True)
    kernels = [report[k] for k in ("factor_features", "factor_features_bf16", "shading_mlp",
                                   "shading_mlp_view", "factor_features_bwd", "factor_features_bwd_bf16",
                                   "cp_features", "cp_features_bf16", "cp_features_bwd",
                                   "cp_features_bwd_bf16", "eval_prepass")]
    for k in kernels:
        k.setdefault("launches", 0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
