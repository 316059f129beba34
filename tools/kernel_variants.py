#!/usr/bin/env python3
"""Time the port's CUDA kernels in other versions of the package.

    python3 tools/kernel_variants.py VARIANT [VARIANT ...]

VARIANT is ``NAME[=DIR][:FILE:OLD=>NEW[;;OLD=>NEW...]]``.  DIR holds a
``text2nerf_tpu_torch`` package (an unpacked ``git archive`` of another
commit, say); without it, this checkout's.  With edits, the package is
copied under this checkout's ``text2nerf_tpu_torch/build/variants/`` and
each literal OLD is replaced by NEW in FILE, a path inside the package
such as ``csrc/shading_mlp.cu`` (backslash escapes such as ``\\n`` are
decoded; OLD must occur).

Each version runs in a process of its own that imports the package from
its directory, so it is built by that package's own ``_build`` (its
sources, headers, flags and hash).  There each kernel is held against its
plain version on chip_smoke.py's kernel inputs (kernel A: 1M samples of
the full-width room shell, 65536 rays x 16 consecutive steps; kernel B:
1M rows of the full-width head; kernel A', fused mode: phase 3's three
layouts of 1M samples, 16384 rays x 64 consecutive steps, with random
output gradients, and the output gradients of one compacted train step of
chip_smoke.py's phase 5, caught on their way into kernel A') and timed
with chip_smoke.py's CUDA-event timer, L2 flushed between calls, 20 calls.
The versions run in the order this checkout, v1 .. vn, vn .. v1, this
checkout, so each is timed twice and a drift of the card shows as a gap
between its two readings.  Prints the card's name and power limit, then a
line per kernel and run.  Needs one GPU.
"""

from __future__ import annotations

import codecs
import importlib.util
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
VARIANTS_DIR = REPO / "text2nerf_tpu_torch" / "build" / "variants"
PKG = "text2nerf_tpu_torch"


def parse(spec: str):
    """(name, base directory, [(file, old, new), ...]) of a VARIANT."""
    head, _, edits = spec.partition(":")
    name, _, base = head.partition("=")
    pairs = []
    if edits:
        path, _, rest = edits.partition(":")
        for edit in rest.split(";;"):
            old, sep, new = edit.partition("=>")
            if not sep:
                raise ValueError(f"{spec}: an edit is OLD=>NEW")
            pairs.append((path, codecs.decode(old, "unicode_escape"),
                          codecs.decode(new, "unicode_escape")))
    return name, Path(base).resolve() if base else REPO, pairs


def materialise(name: str, base: Path, pairs, dest: Path = VARIANTS_DIR) -> Path:
    """The directory whose package is the variant: ``base`` itself, or an
    edited copy of its package under ``dest/name``."""
    if not (base / PKG).is_dir():
        raise FileNotFoundError(f"{name}: {base} holds no {PKG} package")
    if not pairs:
        return base
    root = dest / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(base / PKG, root / PKG,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for path, old, new in pairs:
        f = root / PKG / path
        text = f.read_text()
        if old not in text:
            raise ValueError(f"{name}: {old!r} does not occur in {path}")
        f.write_text(text.replace(old, new))
    return root


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _time_version(name: str, root: Path) -> dict:
    """Both kernels of the package under ``root``, on chip_smoke.py's
    inputs (made by this checkout's chip_smoke.py with that package)."""
    sys.path.insert(0, str(root))
    import torch

    from text2nerf_tpu_torch.data import synthetic as syn
    from text2nerf_tpu_torch.ops import rays as R
    from text2nerf_tpu_torch.ops.kernels import _build
    from text2nerf_tpu_torch.ops.kernels import factor_features as ff
    from text2nerf_tpu_torch.ops.kernels import shading_mlp as sm

    if not Path(_build.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"{name}: imported {_build.__file__}, not the package in {root}")
    cs = _chip_smoke()

    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    field = syn.serving_shell(0, dev)
    planes, lines, nd = tuple(field.planes), tuple(field.lines), field.nd
    intr = R.default_intrinsics(*syn.VIEW_HW)
    dirs = R.ray_directions(*syn.VIEW_HW, intr[:2], intr[2:], device=dev)
    rays = torch.cat(R.rays_from_pose(dirs, syn.serving_poses()[0]), -1)
    aabb = torch.tensor(syn.AABB, device=dev)
    xn = cs._chunk_samples(rays, aabb, field, cs.N_SAMPLES_A, gen)
    feats = 2.0 * torch.randn(cs.N_ROWS_B, field.cfg.app_dim, generator=gen, device=dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_

    def run_a():
        return ff.factor_features(xn, planes, lines, nd)

    def run_b():
        return sm.shade_fea_noview(field.mlp, feats, field.cfg.fea_pe)

    exact = all(torch.equal(g, r) for g, r in zip(run_a(), ff.factor_features_plain(
        xn, planes, lines, nd)))
    err = float((run_b() - sm.shade_fea_noview_plain(field.mlp, feats, field.cfg.fea_pe))
                .abs().max())
    out = {"name": name, "a_ms": cs._time_ms(run_a, 20, flush), "a_exact": exact,
           "b_ms": cs._time_ms(run_b, 20, flush), "b_err": err,
           "inputs": [float(xn.sum()), float(feats.sum()), float(field.mlp.w1.sum())]}
    del feats

    # kernel A': phase 3's layouts with random gradients, then one train
    # step's own gradients
    layouts = cs._bwd_layouts(field, aabb, rays, gen)
    n = cs.N_RAYS_TRAIN * cs.K_TRAIN
    na = sum(p.shape[2] - d for p, d in zip(planes, nd))
    d_sig = torch.randn(n, generator=gen, device=dev)
    d_app = torch.randn(n, na, generator=gen, device=dev)
    cases = {k: (x, planes, lines, d_sig, d_app) for k, x in layouts.items()}
    out["inputs"] += [float(x.sum()) for x in layouts.values()] + [float(d_app.sum())]
    cases["step"] = _step_gradients(cs, syn, ff, dev)
    out["bwd_ms"], out["bwd_err"] = {}, {}
    for k, (x, p, l, ds, da) in cases.items():
        got = ff.factor_features_backward(x, p, l, nd, ds, da)
        ref = ff.factor_features_backward_plain(x, p, l, nd, ds, da)
        out["bwd_err"][k] = max(float((g - r).abs().max()) / float(r.abs().max())
                                for g, r in zip((*got[0], *got[1]), (*ref[0], *ref[1])))
        del got, ref
        out["bwd_ms"][k] = cs._time_ms(
            lambda: ff.factor_features_backward(x, p, l, nd, ds, da), 20, flush)
    x, _, _, ds, da = cases["step"]
    out["step_zero_share"] = float(((ds == 0) & (da == 0).all(1)).float().mean())
    out["step_samples"] = x.shape[0]
    return out


def _step_gradients(cs, syn, ff, dev):
    """(xn, planes, lines, d_sigma, d_app_raw) that kernel A' gets in one
    compacted train step of chip_smoke.py's phase 5 (its training
    configuration and step settings, after its warm-up steps), caught on
    the way from FactorFeatures.backward into the kernel's wrapper."""
    import torch
    from text2nerf_tpu_torch.engine import train_step as ts

    rays, rgb, depth = syn.training_targets(dev)
    field, aabb, mask, cfg, kw = syn.training_setup(dev)
    state, opt = ts.make_train_state(field, cfg.lr_init, cfg.lr_basis, runtime_decay=True)
    step = ts.make_train_step(field.cfg, opt, device=dev, **kw)
    sampler = ts.PermutationSampler(rays.shape[0], cfg.batch_size, seed=cfg.seed)
    gen = torch.Generator(device=dev).manual_seed(0)
    caught = []
    wrapped = ff.factor_features_backward

    def catch(xn, planes, lines, nd, d_sigma=None, d_app_raw=None, **kwargs):
        caught.append((xn, planes, lines, d_sigma, d_app_raw))
        return wrapped(xn, planes, lines, nd, d_sigma, d_app_raw, **kwargs)

    try:
        for i in range(cs.TRAIN_WARMUP + 1):
            ff.factor_features_backward = catch if i == cs.TRAIN_WARMUP else wrapped
            ids = torch.as_tensor(sampler.next_ids(), device=dev)
            batch = {"rays": rays[ids], "rgb": rgb[ids], "depth": depth[ids]}
            state, _ = step(state, aabb, batch, gen, alpha_mask=mask)
    finally:
        ff.factor_features_backward = wrapped
    if len(caught) != 1 or caught[0][3] is None or caught[0][4] is None:
        raise RuntimeError(f"the compacted step made {len(caught)} kernel A' calls, not one "
                           "fused call")
    xn, planes, lines, d_sigma, d_app = caught[0]
    return (xn, tuple(t.detach().clone() for t in planes),
            tuple(t.detach().clone() for t in lines), d_sigma, d_app)


def main(argv) -> int:
    if argv[:1] == ["--time"]:
        print(json.dumps(_time_version(argv[1], Path(argv[2]))), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available", file=sys.stderr)
        return 2
    print(_chip_smoke()._card_line(), flush=True)
    setup = time.perf_counter()
    versions = [("this checkout", REPO)] + [
        (name, materialise(name, base, pairs)) for name, base, pairs in map(parse, argv)]
    order = versions + versions[::-1]
    inputs = None
    for i, (name, root) in enumerate(order):
        out = subprocess.run([sys.executable, __file__, "--time", name, str(root)],
                             capture_output=True, text=True, cwd=root)
        if out.returncode:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"{name}: exit code {out.returncode}")
        r = json.loads(out.stdout.strip().splitlines()[-1])
        if inputs is not None and r["inputs"] != inputs:
            raise RuntimeError(f"{name}: its package made other inputs {r['inputs']} "
                               f"than {inputs}")
        inputs = r["inputs"]
        run = 0 if i < len(versions) else 1
        print(f"A {name}, run {run}: {r['a_ms']:.4f} ms, bit-exact {r['a_exact']}", flush=True)
        print(f"B {name}, run {run}: {r['b_ms']:.4f} ms, max_abs_err {r['b_err']:.3e}",
              flush=True)
        times = ", ".join(f"{k} {v:.4f} ms" for k, v in r["bwd_ms"].items())
        print(f"A' {name}, run {run}: {times}; within {max(r['bwd_err'].values()):.3e} of each "
              f"table's largest", flush=True)
    print(f"train step's kernel A' input: {r['step_samples']} samples, "
          f"{r['step_zero_share']:.4f} of them with all-zero gradients; "
          f"{time.perf_counter() - setup:.0f} s in all", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
