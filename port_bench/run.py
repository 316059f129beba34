"""Runs one cell of the port's benchmark once and prints its result as the
last line of standard output.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(also ``python3 -m port_bench.run``, from the checkout's root).  The cell,
its configuration, traffic, limits and metrics are found by name from
``BENCHMARK.json`` and the files under ``port_bench/``.  Needs as many
CUDA devices as the cell asks for.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "text2nerf_tpu")


def forbidden_modules(modules) -> list:
    """The FORBIDDEN top-level names among ``modules``, each compared whole
    (``text2nerf_tpu_torch`` is not ``text2nerf_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in modules} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def report(result: dict) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, then the result line on standard output."""
    print("clock " + " ".join(f"{k} {v:.3f}" for k, v in result.pop("clock", {}).items()),
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from port_bench.core import spec
    from port_bench.core.drive import drive

    cell = spec.cell(spec.load_benchmark(ROOT), args.workload, ROOT)
    import torch

    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = drive(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T0)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"port_bench: the run loaded {found}", file=sys.stderr)
        return 3
    report(result)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # a run that fails prints why and no result
        traceback.print_exc()
        sys.exit(1)
