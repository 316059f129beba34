"""Rebuild a lost or corrupted ``scene_snapshot.npz`` from a run's DIBR
artifact tree (port of ``tools/rebuild_scene_snapshot.py``).

Every quantity the snapshot stores is recoverable from the run's files:

- view 0, the poses and the box: ``bootstrap_scene`` run again on the
  run's data directory (the seed image, depth and poses are on disk, so
  it is deterministic);
- generated view v >= 1:
    rgb   = DIBR/rgbs/%05d.png (before the filter, uint8)
    depth = DIBR/depth/%05d_depth_finetuning2.png / 12000 + push_depth
    mask  = 1 - DIBR/mask/%05d.png (the inpaint mask)
  then the expansion's sparse bilateral filter, run again.  The views
  agree with the originals up to the PNGs' quantization (~4e-3 rgb,
  ~1e-4 depth) and the filter's response to it.

The scene configuration comes from the run's ``args.txt``; ``--datadir``
and ``--prompt`` override it.  Writes ``<logfolder>/scene_snapshot.npz``
(atomically) after checking it loads:

  python -m text2nerf_tpu_torch.tools.rebuild_scene_snapshot --logfolder <run log dir>

The bootstrap's support-set warp runs on the device (cuda unless asked).
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import sys

import numpy as np


def scene_config_from_args_txt(path: str):
    """The trainer's ``args.txt`` dump parsed back into a SceneConfig."""
    from ..data import scene_state as ss

    fields = {f.name: f for f in dataclasses.fields(ss.SceneConfig)}
    kw = {}
    with open(path) as f:
        for line in f:
            k, _, v = line.rstrip("\n").partition(":")
            if k not in fields:
                continue
            kw[k] = v if fields[k].type in ("str", str) else ast.literal_eval(v)
    return ss.SceneConfig(**kw)


def _resume_next_view(logfolder: str):
    """``next_view`` of the newest readable resume point in the log
    folder (``*_resume.npz``, or a ``*_resume/`` directory's
    ``loop_state.json``), or None.  The trainer snapshots the scene before
    each expansion, so the DIBR tree may hold one view newer than the
    resume point; recovering it would make the resumed run append it
    twice."""
    cands = sorted((n for n in os.listdir(logfolder) if n.endswith("_resume.npz") or (
        n.endswith("_resume") and os.path.isdir(os.path.join(logfolder, n)))),
                   key=lambda n: os.path.getmtime(os.path.join(logfolder, n)), reverse=True)
    for name in cands:
        full = os.path.join(logfolder, name)
        try:
            if name.endswith(".npz"):
                data = np.load(full)
                return int(json.loads(bytes(data["__loop_state__"].tobytes()).decode())[
                    "next_view"])
            with open(os.path.join(full, "loop_state.json")) as f:
                return int(json.load(f)["next_view"])
        except Exception as e:  # noqa: BLE001 — a recovery tool reads what it can
            print(f"warning: could not read loop state from {name}: {e}")
    return None


def rebuild(logfolder: str, scene_cfg, max_views=None, *, device=None) -> str:
    from ..data import scene_state as ss
    from ..ops import filters as filter_ops
    from ..utils.png import read_png

    if max_views is None:
        max_views = _resume_next_view(logfolder)
    if max_views is None:
        max_views = scene_cfg.num_training

    scene = ss.bootstrap_scene(scene_cfg, "train", device=device)
    print(f"bootstrap: view 0 rebuilt from {scene_cfg.datadir}")

    dibr = os.path.join(logfolder, "DIBR")
    v = 1
    while v < max_views and os.path.isfile(os.path.join(dibr, "rgbs", "%05d.png" % v)):
        rgb = read_png(os.path.join(dibr, "rgbs", "%05d.png" % v)).astype(np.float32) / 255.0
        fin = read_png(os.path.join(dibr, "depth", "%05d_depth_finetuning2.png" % v))
        depth = fin.astype(np.float32) / 12000.0 + scene_cfg.push_depth
        mask_known = read_png(os.path.join(dibr, "mask", "%05d.png" % v)).astype(np.float32) / 255.0
        # the expansion's filter step (deterministic, native)
        img_j, depth_j = filter_ops.sparse_bilateral_filtering(
            depth, rgb, filter_size=(5, 5, 3, 3), depth_threshold=0.02, num_iter=4)
        scene = ss.append_generated_view(scene, np.asarray(img_j), np.asarray(depth_j),
                                         1.0 - mask_known)
        print(f"view {v}: recovered from DIBR artifacts")
        v += 1

    snap = os.path.join(logfolder, "scene_snapshot.npz")
    ss.save_scene_snapshot(snap, scene)
    # the snapshot loads with the pools the trainer will ask for
    restored = ss.load_scene_snapshot(snap, n_views_pools=v, trans_range=scene_cfg.trans_range,
                                      use_support_set=scene_cfg.use_support_set, device=device)
    if restored.rgbs_gen_split.shape[0] != v:
        raise RuntimeError(f"{snap}: {restored.rgbs_gen_split.shape[0]} views, wrote {v}")
    print(f"wrote {snap}: {v} views, load-verified")
    return snap


def main(argv=None, *, device=None) -> int:
    from ..device import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--logfolder", required=True)
    p.add_argument("--datadir", help="override args.txt datadir")
    p.add_argument("--prompt", help="override args.txt prompt")
    p.add_argument("--max_views", type=int, default=None,
                   help="recover only views < max_views (default: the resume "
                        "checkpoint's next_view)")
    args = p.parse_args(argv)
    dev = resolve_device(device)

    args_txt = os.path.join(args.logfolder, "args.txt")
    if not os.path.isfile(args_txt):
        p.error(f"{args_txt} not found: the scene configuration cannot be read")
    scene_cfg = scene_config_from_args_txt(args_txt)
    overrides = {k: v for k, v in (("datadir", args.datadir), ("prompt", args.prompt))
                 if v is not None}
    if overrides:
        scene_cfg = dataclasses.replace(scene_cfg, **overrides)
    rebuild(args.logfolder, scene_cfg, max_views=args.max_views, device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
