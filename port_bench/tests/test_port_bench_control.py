"""The comparison that decides ``correct`` fails its control: the plain
reference computed in TF32 (the precision below the configurations'
fp32 with TF32 off), put in the program's place, breaks one of each
cell's limits, while the program keeps to all of them.  At a size the
CPU holds; the same readings at the cells' own size come from
``calibrate.py`` on the chip."""

import pytest
import torch

from port_bench import calibrate
from port_bench.tests import tiny

WORKLOADS = [w["name"] for w in tiny.bench()["workloads"]] + [tiny.DENSE_CELL, tiny.CP_CELL]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_fails_and_the_program_passes(workload):
    c = tiny.cell(workload)
    limits = c["limits"]["limits"]
    torch.manual_seed(0)
    r = calibrate.readings(c, tiny.SEED, torch.device("cpu"), seconds=0.5)
    assert all(r["program"][k] <= v for k, v in limits.items()), r["program"]
    assert any(r["control"][k] > v for k, v in limits.items()), r["control"]
    if "half_batch" in r:
        assert any(r["half_batch"][k] > v for k, v in limits.items()), r["half_batch"]
