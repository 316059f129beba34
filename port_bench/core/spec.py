"""Finds a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic file (``traffic/<traffic>.json``), its
correctness limits (``limits/<workload>.json``) and the readers of its
per-layer metrics (``metrics/<metric>.py``).  Nothing here names a cell:
a new cell is new files and new entries.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """Everything one cell needs, resolved from the data files."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    bench_dir = root / "port_bench"
    return {
        "name": workload,
        "entry": entry,
        "config": _read(root / configs[entry["config"]]["file"]),
        "traffic": _read(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        "limits": _read(bench_dir / "limits" / f"{workload}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if _applies(m, workload)],
        "per_layer": [m for m in bench["per_layer"] if _applies(m, workload)],
        "bench_dir": bench_dir,
    }


def reader(bench_dir: Path, metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = Path(bench_dir) / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
