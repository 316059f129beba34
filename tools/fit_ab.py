#!/usr/bin/env python3
"""Time chip_smoke.py's seed fit (phase 6) of several checkouts of the
repository in turns on one GPU, each run in a process of its own.

    python3 tools/fit_ab.py DIR [DIR ...] [--order 0110]

Each DIR is the root of a checkout: this one (``.``), or another unpacked
under a gitignored directory (``git archive <commit> | tar -x -C
.chip_scripts/parent``).  ``--order`` lists the DIRs' indices in the
order of the runs (default: each once, then each once more in reverse:
``0110`` for two).  A run builds its checkout's kernels, sets the smoke's
TF32 flags (off), runs that checkout's ``chip_smoke.phase_seed_fit`` (512²,
a device sync around every step, its checks included) and prints its
output; the last lines are one JSON line a run: the checkout, the wall,
the dense and compacted step medians (alone and end to end), the final
PSNR and the card.
"""

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import collections, json, shutil, sys, tempfile
import torch
sys.path.insert(0, ".")
import chip_smoke as C
from text2nerf_tpu_torch.ops.kernels import _build

_build.build()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
card = C._card_line()
_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
work = tempfile.mkdtemp(dir=str(_build.BUILD_DIR))
try:
    out = C.phase_seed_fit(torch.device("cuda", 0), card, collections.defaultdict(dict), work)
    out = out[1] if isinstance(out, tuple) else out  # newer versions: (kept state, records)
finally:
    shutil.rmtree(work, ignore_errors=True)
print("FIT_AB " + json.dumps({**out, "card": card}), flush=True)
"""

KEYS = ("seed_fit_wall_s", "seed_fit_dense_ms", "seed_fit_dense_loop_ms",
        "seed_fit_compact_ms", "seed_fit_compact_loop_ms", "seed_fit_psnr_final")


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--order", default=None)
    args = ap.parse_args(argv)
    n = len(args.dirs)
    order = [int(c) for c in args.order] if args.order else list(range(n)) + list(
        reversed(range(n)))
    results = []
    for i in order:
        root = os.path.abspath(args.dirs[i])
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=root, text=True,
                              stdout=subprocess.PIPE)
        lines = proc.stdout.splitlines()
        print("\n".join(lines[:-1]), flush=True)
        if proc.returncode != 0 or not lines or not lines[-1].startswith("FIT_AB "):
            print(f"fit_ab: the run of {args.dirs[i]} failed (exit {proc.returncode})",
                  file=sys.stderr)
            return 1
        res = json.loads(lines[-1][len("FIT_AB "):])
        results.append({"dir": args.dirs[i], **{k: res[k] for k in KEYS}, "card": res["card"]})
    for r in results:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
