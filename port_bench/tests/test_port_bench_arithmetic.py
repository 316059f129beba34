"""The roofline and mfu arithmetic against counts made by hand."""

import pytest
import torch

from port_bench.core import spec
from port_bench.roofline import A_bwd, arithmetic, render_frame, train_step
from port_bench.tests import tiny

PEAKS = arithmetic.PEAKS
BENCH = tiny.bench()


def cfg(name):
    return tiny.full_cell(f"{name}.train_compact")["config"]


def test_peaks_are_the_data_sheet_s():
    assert PEAKS["hbm_bytes_per_s"] == 3.35e12
    assert PEAKS["fp32_flops"] == 67e12 and PEAKS["tf32_flops"] == 495e12


def test_head_flops():
    assert arithmetic.head_flops(351, 128) == 2 * (351 * 128 + 128 * 128 + 128 * 3) == 123392
    assert arithmetic.field_widths(cfg("vmsplit_300")) == (48, 144, 351)
    assert arithmetic.field_widths({**cfg("vmsplit_300"), **tiny.CP}) == (96, 288, 150)


def test_train_step_least_time_by_hand():
    c = tiny.full_cell(tiny.DENSE_CELL)
    dens, rows = 16384 * 259, 16384 * 64
    feat = 14 * (48 * dens + 144 * rows)
    mm = (2 * 144 * 27 + 123392) * rows
    want = 3 * (feat + mm) / 67e12  # TF32 off: every product on the CUDA cores
    assert train_step.least_s(c["config"], c["traffic"], 259) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(6.3809e-3, rel=1e-4)
    c = spec.cell(BENCH, "vmsplit_300.train_compact")
    rows = 16384 * 64
    want = 3 * (14 * (48 + 144) + 2 * 144 * 27 + 123392) * rows / 67e12
    assert train_step.least_s(c["config"], c["traffic"], 259) == pytest.approx(want, rel=1e-12)


def test_render_frame_least_time_by_hand():
    c = spec.cell(BENCH, "vmsplit_300.render_view")
    counts = torch.tensor([10, 100, 200])
    dens, rows = 10 + 100 + 128, 10 + 64 + 64
    # the basis product on the CUDA cores, kernel B's head on the tensor cores
    want = 2 * ((14 * (48 * dens + 144 * rows) + 2 * 144 * 27 * rows) / 67e12
                + 123392 * rows / 495e12)
    assert render_frame.least_s(c["config"], c["traffic"], counts, 2.0) == pytest.approx(want)


def test_kernel_launch_bytes_by_hand():
    shapes = {f"planes.{i}": (4, 4, 3) for i in range(3)}
    shapes.update({f"lines.{i}": (4, 3) for i in range(3)})
    xn = torch.zeros(1, 3)  # every coordinate at cell 1.5: rows 1 and 2
    assert A_bwd.touched_rows(xn, shapes) == ([4, 4, 4], [2, 2, 2])
    # a density launch: the sample's 12 + 4 bytes (one d_sigma), and 4 plane
    # rows and 2 line rows a table at one channel, read and written once
    rows = 4 * 3 * (4 + 2)
    assert A_bwd.launch_least_s(xn, [1, 1, 1], 1, shapes) == pytest.approx(
        (12 + 4 + 2 * rows) / 3.35e12)
    # an app launch at 2 channels an axis: 6 d_app floats a sample
    assert A_bwd.launch_least_s(xn, [2, 2, 2], 6, shapes) == pytest.approx(
        (12 + 4 * 6 + 2 * 2 * rows) / 3.35e12)
    xn = torch.zeros(1000, 3)
    ops = 1000 * 3 * 28 / 67e12
    assert A_bwd.launch_least_s(xn, [1, 1, 1], 1, shapes) == pytest.approx(
        max((1000 * 16 + 2 * rows) / 3.35e12, ops))
