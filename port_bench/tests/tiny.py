"""Cells of the benchmark cut to a size the CPU runs in seconds: the same
files, with the grid, the views, the batch and the chunk made small.

Beside the cells of BENCHMARK.json, two train cells that no check runs
yet (PERF.md, open questions) are built here from the compacted cell's
files, so the paths they take through the program and the reference stay
held against each other: the trainer's dense step, and the TensorCP
field family on it."""

from __future__ import annotations

import time

import torch

from port_bench.core import spec
from port_bench.core.drive import drive

SEED = 2 ** 33 + 7
#: the trainer's dense step at TrainConfig() defaults: the compacted
#: cell's traffic with no mask (the pool-3 mask licenses no compaction),
#: so each step renders every march step in 32 sub-batches
DENSE_CELL = "vmsplit_300.train_dense"
DENSE_LIMITS = {"loss_gap": 3e-05, "grad_gap": 5e-06, "change_gap": 0.002}
#: TensoRF's CP widths (its README's CP command) on the dense step
CP_CELL = "cp.train_dense"
CP = {"name": "cp", "model_name": "cp", "n_lamb_sigma": [96], "n_lamb_sh": [288],
      "shadingMode": "MLP_Fea", "fea_pe": 2, "view_pe": 2}
CP_LIMITS = {"loss_gap": 3e-07, "grad_gap": 5e-06, "change_gap": 3e-05}
#: the limits above: from the program's and the TF32 control's readings
#: at the full size on the H100 (PERF.md)


def bench() -> dict:
    return spec.load_benchmark()


def full_cell(workload: str) -> dict:
    """A cell at its own size: one of BENCHMARK.json's, or one built here."""
    if workload not in (DENSE_CELL, CP_CELL):
        return spec.cell(bench(), workload)
    c = spec.cell(bench(), "vmsplit_300.train_compact")
    c["name"] = workload
    t = c["traffic"]
    t["train_config"]["eval_mask_pool"] = 3
    t["mask"], t["trace_units"] = None, 2
    c["limits"] = {"limits": dict(DENSE_LIMITS)}
    if workload == CP_CELL:
        c["config"] = {**c["config"], **CP}
        c["limits"] = {"limits": dict(CP_LIMITS)}
    return c


def cell(workload: str) -> dict:
    c = full_cell(workload)
    c["config"]["N_voxel"] = 24 ** 3
    t = c["traffic"]
    t["hw"], t["orbit_poses"] = [16, 16], 8
    if t["kind"] == "train":
        t["views"] = 2
        t["train_config"].update(batch_size=128, train_microbatch=4)
        t["reference_block"] = 64
        t["trace_units"] = 1
    else:
        t["warmup_poses"] = [0]
        t["render"]["chunk"] = 64
        t["trace_units"] = 2
    return c


def run(c, trace=False, seconds=0.5, seed=SEED):
    torch.manual_seed(0)
    return drive(c, seed, seconds, trace, torch.device("cpu"), time.perf_counter())
