"""Offline quality metrics over saved renders (port of
``tools/compute_metrics.py``): PSNR, SSIM and, with weights, LPIPS (alex
and vgg) of every PNG of ``--pred`` against the PNG of ``--gt`` at the
same sorted position, one JSON object with the JAX tool's keys.

  python -m text2nerf_tpu_torch.tools.compute_metrics \\
      --pred log/exp/imgs_test_all/rgbs --gt data/scene/rgbs \\
      [--lpips-weights weights] [--out metrics.json]

PNGs are read by the port's codec (no image library).  A prediction of
another size is resized to its ground truth bilinearly, as the JAX
tool's ``cv2.resize`` does.  SSIM and LPIPS run on the device (cuda
unless asked).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np


def main(argv=None, *, device=None) -> int:
    import torch

    from ..data.io import read_rgb
    from ..device import resolve_device
    from ..engine import metrics as M
    from ..services.image_ops import resize

    p = argparse.ArgumentParser()
    p.add_argument("--pred", required=True, help="directory of rendered pngs")
    p.add_argument("--gt", required=True, help="directory of ground-truth pngs")
    p.add_argument("--lpips-weights", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    dev = resolve_device(device)

    preds = sorted(glob.glob(os.path.join(args.pred, "*.png")))
    gts = sorted(glob.glob(os.path.join(args.gt, "*.png")))
    n = min(len(preds), len(gts))
    if n == 0:
        print(json.dumps({"error": "no image pairs found"}))
        return 1

    psnrs, ssims = [], []
    lpips_vals = {"alex": [], "vgg": []}
    for pred_path, gt_path in zip(preds[:n], gts[:n]):
        pred = read_rgb(pred_path)
        gt = read_rgb(gt_path)
        if pred.shape != gt.shape:
            pred = resize(torch.from_numpy(pred), gt.shape[:2], "linear").numpy()
        psnrs.append(M.psnr(pred, gt))
        ssims.append(M.ssim(pred, gt, 1.0, device=dev))
        if args.lpips_weights:
            for net in ("alex", "vgg"):
                try:
                    lpips_vals[net].append(M.lpips(gt, pred, net, args.lpips_weights,
                                                   device=dev))
                except FileNotFoundError:
                    pass

    result = {
        "n_images": n,
        "psnr_mean": float(np.mean(psnrs)),
        "ssim_mean": float(np.mean(ssims)),
        "psnr_per_image": [float(x) for x in psnrs],
        "ssim_per_image": [float(x) for x in ssims],
    }
    for net, vals in lpips_vals.items():
        if vals:
            result[f"lpips_{net}_mean"] = float(np.mean(vals))
    print(json.dumps(result, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
