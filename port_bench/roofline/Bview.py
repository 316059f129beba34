"""Kernel B's view-dependent mode (the eval ``MLP_Fea`` head) of a run:
bytes and operations from the rows it shades.  A row reads its
appearance features (``app_dim`` floats) and writes its rgb (3 floats):
120 B at TensoRF's head.  Its ray's direction (3 floats) is read once a
ray, not once a row, and the weights once a launch: neither is counted
(a ray's 12 B over its 32 to 64 rows are under 0.4% of their bytes, and
the bound is the operations').  A row's operations are the three layers'
multiply-adds, ``arithmetic.head_flops(150, 128)`` = 2 · (150·128 +
128·128 + 128·3) = 71,936 at TensoRF's CP head (27 features, 3 direction
components, 108 feature PE and 12 direction PE in), counted once at the
TF32 peak, as ``render_frame.py`` counts the head: the kernel's split
operands and its positional encoding are not counted."""

from __future__ import annotations

from .arithmetic import PEAKS, field_widths, head_flops, least_s

KERNEL = "shade_view_kernel"


def row_bytes(cfg) -> int:
    return 4 * (cfg["app_dim"] + 3)


def row_ops(cfg) -> int:
    return head_flops(field_widths(cfg)[2], cfg["featureC"])


def rows_least_s(cfg, rows: int) -> float:
    return least_s(rows * row_bytes(cfg), rows * row_ops(cfg), PEAKS["tf32_flops"])
