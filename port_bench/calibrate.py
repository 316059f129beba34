"""Readings that a cell's correctness limits are set from, one JSON line a
seed: the program against the reference (the lower reading), the
control against the reference (the reference in TF32, the precision
below the configuration's fp32 with TF32 off) and, for train cells, the
fault of half the batch left out (the reference on the first half).

    python3 port_bench/calibrate.py --workload <name> --seeds <n> [<n> ...] [--controls <k>]

Train cells take the program's first steps only; render cells a short
window.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, dev, seconds: float = 3.0, control: bool = True) -> dict:
    import torch

    from port_bench.core import render_cell, train_cell

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    if cell["traffic"]["kind"] == "train":
        c = train_cell.TrainCell(cell, seed, dev, sync)
        c.release()
        ref = c.reference()
        out = {"program": train_cell.numbers(c.program, ref),
               "program_detail": train_cell.detail(c.program, ref)}
        if control:
            tf32 = c.reference(precision="tf32")
            out["control"] = train_cell.numbers(tf32, ref)
            out["control_detail"] = train_cell.detail(tf32, ref)
            out["half_batch"] = train_cell.numbers(c.reference(keep=0.5), ref)
    else:
        c = render_cell.RenderCell(cell, seed, dev, sync)
        c.window(seconds)
        c.release()
        ref = c.reference()
        far = c.cfg["far"]
        out = {"program": render_cell.numbers(c.checked, ref, far)}
        if control:
            tf32 = [(pose, s, cand[0][0], cand[0][1]) for (pose, s, _, _), cand
                    in zip(c.checked, c.reference(precision="tf32"))]
            out["control"] = render_cell.numbers(tf32, ref, far)
    out.update(seed=seed, seconds=time.perf_counter() - t0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3,
                    help="how many of the first seeds also read the control and the faults")
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from port_bench.core import spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cell = spec.cell(spec.load_benchmark(ROOT), args.workload, ROOT)
    for i, seed in enumerate(args.seeds):
        print(json.dumps(readings(cell, seed, dev, control=i < args.controls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
