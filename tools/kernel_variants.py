#!/usr/bin/env python3
"""Time the port's two CUDA kernels in other versions of the package.

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
sources, headers, flags and hash).  There both kernels are held against
their plain versions on chip_smoke.py's kernel inputs (kernel A: 1M samples
of the full-width room shell, 65536 rays x 16 consecutive steps; kernel B:
1M rows of the full-width head) and timed with chip_smoke.py's CUDA-event
timer, L2 flushed between calls, 20 calls.  The versions run in the order
this checkout, v1 .. vn, vn .. v1, this checkout, so each is timed twice
and a drift of the card shows as a gap between its two readings.  Prints
the card's name and power limit, then a line per kernel and run.  Needs
one GPU.
"""

from __future__ import annotations

import codecs
import importlib.util
import json
import shutil
import subprocess
import sys
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
    xn = cs._chunk_samples(rays, torch.tensor(syn.AABB, device=dev), field, cs.N_SAMPLES_A, gen)
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
    return {"name": name, "a_ms": cs._time_ms(run_a, 20, flush), "a_exact": exact,
            "b_ms": cs._time_ms(run_b, 20, flush), "b_err": err,
            "inputs": [float(xn.sum()), float(feats.sum()), float(field.mlp.w1.sum())]}


def main(argv) -> int:
    if argv[:1] == ["--time"]:
        print(json.dumps(_time_version(argv[1], Path(argv[2]))), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available", file=sys.stderr)
        return 2
    print(_chip_smoke()._card_line(), flush=True)
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
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
