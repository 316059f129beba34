"""Kernel B (the eval ``MLP_Fea_noview`` head) of a run: bytes and
operations from the rows it shades.  A row reads its appearance features
(``app_dim`` floats) and writes its rgb (3 floats); the weights, read
once a launch, are not counted.  A row's operations are the three
layers' multiply-adds (``arithmetic.head_flops``), counted once at the
TF32 peak, as ``render_frame.py`` counts the head: the kernel's split
operands and its positional encoding are not counted."""

from __future__ import annotations

import sys

from ..core import spec
from .arithmetic import PEAKS, field_widths, head_flops, least_s

KERNEL = "shade_kernel"


def row_bytes(cfg) -> int:
    return 4 * (cfg["app_dim"] + 3)


def row_ops(cfg) -> int:
    return head_flops(field_widths(cfg)[2], cfg["featureC"])


def rows_least_s(cfg, rows: int) -> float:
    return least_s(rows * row_bytes(cfg), rows * row_ops(cfg), PEAKS["tf32_flops"])


def run_config(argv=None):
    """The configuration of the cell this process runs (``--workload`` on
    its command line, as ``run.py`` takes it), or None."""
    argv = sys.argv[1:] if argv is None else argv
    name = None
    for i, a in enumerate(argv):
        if a == "--workload" and i + 1 < len(argv):
            name = argv[i + 1]
        elif a.startswith("--workload="):
            name = a.split("=", 1)[1]
    if name is None:
        return None
    try:
        return spec.cell(spec.load_benchmark(), name)["config"]
    except (KeyError, OSError):
        return None
