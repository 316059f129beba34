"""The render cells: ``engine.renderer.render_view``, as the trainer's
evaluations and the 360° video call it, over the views of an orbit in
turn, each frame ending in its rgb and depth on the host.

After the window the reference renders a sample of the frames the window
finished, drawn from the seed, with the slowest frame among them.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..reference import field as F
from ..reference import render as RR
from . import inputs
from . import program as P


class RenderCell:
    def __init__(self, cell, seed: int, device, sync):
        from text2nerf_tpu_torch.engine import renderer

        self.cfg, self.traffic, self.dev, self.sync = cell["config"], cell["traffic"], device, sync
        self.render_view = renderer.render_view
        self.seed = seed
        cfg, tr = self.cfg, self.traffic
        self.aabb = torch.tensor(cfg["aabb"], dtype=torch.float32, device=device)
        self.reso = F.n_to_reso(cfg["N_voxel"], cfg["aabb"])
        self.n = F.n_samples_for(self.reso, cfg["step_ratio"])
        self.hw = tuple(tr["hw"])
        self.weights = inputs.make_weights(cfg, self.reso, seed, device)
        spec = tr["mask"]
        res = tuple(min(r, spec["res_cap"]) for r in self.reso)
        self.mask = F.alpha_mask(cfg, self.weights, self.aabb, self.reso, res, spec["pool"])
        self.poses = inputs.circle_poses(tr["orbit_poses"], tr["orbit_radius"])
        self.rays = inputs.rays_of(inputs.camera_dirs(*self.hw, device), self.poses)
        self.field = P.field(cfg, self.reso, self.weights, device).requires_grad_(False)
        self.frames = []
        for pose in tr["warmup_poses"]:
            self.frame(pose)
        self.frames = []
        sync()

    def frame(self, pose: int):
        r = self.traffic["render"]
        t0 = time.perf_counter()
        rgb, depth = self.render_view(
            self.field, self.aabb, self.rays[pose], self.hw, n_samples=self.n,
            chunk=r["chunk"], app_k=r["app_k"], white_bg=True, alpha_mask=self.mask,
            compact_k=r["compact_k"], eval_z_min=r["eval_z_min"],
            feature_dtype=r["feature_dtype"], k_ladder=tuple(r["k_ladder"]), device=self.dev)
        self.frames.append((pose, time.perf_counter() - t0, rgb, depth))

    def window(self, seconds: float):
        """Frames along the orbit, in turn, for ``seconds``.  Returns (frames,
        failed, seconds the window took)."""
        self.frames = []
        n_poses = len(self.poses)
        self.sync()
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            self.frame(i % n_poses)
            i += 1
        elapsed = time.perf_counter() - t0
        failed = sum(not (np.isfinite(f[2]).all() and np.isfinite(f[3]).all())
                     for f in self.frames)
        return i, failed, elapsed

    def traced(self, count: int):
        """Frames for the traced window; the check samples the measured
        window's frames only."""
        kept = len(self.frames)
        for i in range(count):
            self.frame(i % len(self.poses))
        del self.frames[kept:]

    def rays_per_frame(self) -> int:
        return self.hw[0] * self.hw[1]

    def frame_ms(self):
        return [f[1] * 1e3 for f in self.frames]

    def release(self):
        """Keeps a sample of the window's frames (the slowest, and frames
        drawn from the seed along the window) and drops the program's
        objects."""
        rng = np.random.default_rng(inputs.derived_seed(self.seed, 5))
        n, k = len(self.frames), self.traffic["check_frames"]
        pick = {int(np.argmax([f[1] for f in self.frames]))}
        # one frame drawn from each of k - 1 equal stretches of the window,
        # so the checked poses spread over the orbit
        for lo, hi in zip(np.linspace(0, n, k, dtype=int)[:-1], np.linspace(0, n, k, dtype=int)[1:]):
            if hi > lo:
                pick.add(int(rng.integers(lo, hi)))
        self.checked = [self.frames[i] for i in sorted(pick)]
        self.frames, self.field, self.rays = [], None, None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision="fp32"):
        """Per checked frame, {base rung: (rgb, depth)} of the reference."""
        r = self.traffic["render"]
        dirs = inputs.camera_dirs(*self.hw, self.dev)
        out = []
        for pose, _, _, _ in self.checked:
            rays = inputs.rays_of(dirs, self.poses[pose:pose + 1])[0]
            cand = RR.frame(self.cfg, self.weights, self.aabb, rays, self.reso, self.n, self.mask,
                            ladder=tuple(r["k_ladder"]), app_k=r["app_k"], acc_tol=r["acc_tol"],
                            z_min=r["eval_z_min"], precision=precision)
            out.append({b: (rgb.cpu().numpy().reshape(*self.hw, 3),
                             d.cpu().numpy().reshape(self.hw)) for b, (rgb, d) in cand.items()})
        return out


def numbers(checked, ref, far: float) -> dict:
    """The compared numbers, each the largest over the checked frames, a
    frame taken at the base rung that suits it best: ``frame_mean_gap``,
    the mean absolute gap of a pixel's rgb (over its channels) plus the
    mean absolute gap of its depth as a share of the far plane; and, for
    the record, the two means alone and the largest gap of any pixel
    (rgb, or depth over far)."""
    out = dict.fromkeys(("frame_mean_gap", "rgb_mean_gap", "depth_mean_gap", "frame_max_gap"), 0.0)
    for (_, _, rgb, depth), cand in zip(checked, ref):
        best = min(cand.values(), key=lambda c: float(np.mean(np.abs(rgb - c[0]))))
        d_rgb, d_depth = np.abs(rgb - best[0]), np.abs(depth - best[1]) / far
        frame = {"rgb_mean_gap": float(np.mean(d_rgb)), "depth_mean_gap": float(np.mean(d_depth)),
                 "frame_max_gap": max(float(np.max(d_rgb)), float(np.max(d_depth)))}
        frame["frame_mean_gap"] = frame["rgb_mean_gap"] + frame["depth_mean_gap"]
        out = {k: max(v, frame[k]) for k, v in out.items()}
    if not all(np.isfinite(f[2]).all() and np.isfinite(f[3]).all() for f in checked):
        out = dict.fromkeys(out, float("inf"))
    return out
