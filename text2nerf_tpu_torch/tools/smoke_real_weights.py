"""Real-weight smoke run (port of ``tools/smoke_real_weights.py``).

With a reference-style ``weights/`` tree (SD 2.1-base, SD 2-inpainting,
LeReS ``res101.pth``, the merge checkpoint, clip-vit-base-patch32), it:

1. validates the tree against the weights manifest and converts the
   merge net's checkpoint (:mod:`..convert_weights`);
2. reports which services resolve to real weights and which fall back to
   the procedural stand-ins, and checks the registry agrees;
3. runs a progressive scene through ``trainer.reconstruction``;
4. prints ONE summary JSON line with the JAX tool's keys.

With an empty or absent weights directory every service falls back and
the run needs no file:

  python -m text2nerf_tpu_torch.tools.smoke_real_weights --weights weights \\
      --hw 512 --views 8 --out runs/smoke

Runs on the device (cuda unless asked).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def service_resolution(weights_dir: str) -> dict:
    """Which families resolve to real weights (as ``default_services``
    decides)."""
    from ..services.registry import MERGE_WEIGHTS, WEIGHTS

    def has(sub):
        return bool(weights_dir) and os.path.exists(os.path.join(weights_dir, sub))

    out = {k: "real" if has(sub) else "fallback" for k, sub in WEIGHTS.items()}
    out["merge"] = "real" if has(MERGE_WEIGHTS) else "init"
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", default="weights")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "text2nerf_smoke"))
    p.add_argument("--prompt", default="a beautiful garden with flowers")
    p.add_argument("--hw", type=int, default=512)
    p.add_argument("--views", type=int, default=4)
    p.add_argument("--grid", type=int, default=300)
    p.add_argument("--stages", type=int, nargs=3, default=(3, 2, 2), metavar=("S1", "S2", "S3"),
                   help="n_stage1/2/3 epochs (reference: 50/50/10)")
    p.add_argument("--candidates", type=int, default=4,
                   help="inpaint candidates per view (reference: 20)")
    p.add_argument("--pose_traj", default="circle0_60")
    p.add_argument("--merge_size", type=int, default=0,
                   help="merge-net size (0: 1024 with a real checkpoint, else 256)")
    p.add_argument("--merge_iters", type=int, default=0,
                   help="per-view merge finetune steps (0: 500 with a real "
                        "checkpoint, else 100)")
    p.add_argument("--skip_convert", action="store_true")
    return p.parse_args(argv)


def configs(args, resolution):
    """(train_cfg, scene_cfg, expansion_cfg) of the run, the JAX tool's."""
    from ..data import scene_state as ss
    from ..engine import expansion, trainer

    scene_cfg = ss.SceneConfig(datadir=os.path.join(args.out, "data"), prompt=args.prompt,
                               pose_traj=args.pose_traj, num_training=args.views,
                               hw=(args.hw, args.hw))
    train_cfg = trainer.TrainConfig(
        expname="smoke", basedir=os.path.join(args.out, "log"),
        n_stage1=args.stages[0], n_stage2=args.stages[1], n_stage3=args.stages[2],
        batch_size=16384, n_voxel_init=args.grid ** 3, eval_every_epochs=10 ** 6, seed=7,
    )
    exp_cfg = expansion.ExpansionConfig(
        prompt=args.prompt, n_candidates=args.candidates, candidates_per_round=args.candidates,
        merge_iters=args.merge_iters or (500 if resolution["merge"] == "real" else 100),
    )
    return train_cfg, scene_cfg, exp_cfg


def main(argv=None, *, device=None) -> int:
    from ..device import resolve_device

    args = parse_args(argv)
    dev = resolve_device(device)
    resolution = service_resolution(args.weights)
    print(json.dumps({"services": resolution}), flush=True)

    if not args.skip_convert and os.path.isdir(args.weights):
        # the manifest first: a present but wrong checkpoint fails here with
        # its file, key and shape differences
        from ..services import weights_manifest

        reports = weights_manifest.validate_tree(args.weights)
        for r in reports:
            print(json.dumps({"manifest": r}), flush=True)
        bad = [r for r in reports if r["status"] == "error"]
        if bad:
            print(json.dumps({
                "status": "error", "detail": "weights manifest validation failed",
                "families": [r["family"] for r in bad],
                "diffs": [d for r in bad for d in r["diffs"]][:20],
            }), flush=True)
            return 1
        from .. import convert_weights

        rc = convert_weights.main(["--weights_dir", args.weights])
        if rc != 0:
            print(json.dumps({"status": "error", "detail": "weight conversion failed"}))
            return rc

    from ..engine import renderer as R
    from ..engine import trainer
    from ..models import tensorf as tf
    from ..services.registry import default_services

    train_cfg, scene_cfg, exp_cfg = configs(args, resolution)
    merge_size = args.merge_size or (1024 if resolution["merge"] == "real" else 256)
    services = default_services(
        weights_dir=args.weights if os.path.isdir(args.weights) else None, hw=scene_cfg.hw,
        merge_net_size=merge_size,
        merge_num_downs={1024: 10, 512: 9, 256: 8, 128: 7}.get(merge_size, 6), device=dev,
    )
    # the registry's resolution must be what the weights tree promises: a
    # tree with real checkpoints flips to the real path visibly
    if services.resolution != resolution:
        print(json.dumps({"status": "error", "detail": "service resolution mismatch",
                          "expected": resolution, "actual": services.resolution}), flush=True)
        return 1

    t0 = time.time()
    mcfg, field, aabb, scene, logfolder = trainer.reconstruction(
        train_cfg, scene_cfg, services, exp_cfg, device=dev)
    wall = time.time() - t0
    res = R.evaluation(
        field, aabb, scene.rays_gen_split, scene.hw,
        n_samples=tf.default_n_samples(tf.grid_resolution(field), mcfg.step_ratio),
        gt_rgbs=scene.rgbs_gen_split, chunk=16384, app_k=48, device=dev,
    )
    print(json.dumps({
        "status": "ok", "services": resolution, "wall_min": round(wall / 60.0, 2),
        "per_view_psnr": [round(float(x), 1) for x in res["psnr"]], "logfolder": logfolder,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
