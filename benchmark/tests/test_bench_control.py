"""The control of each cell, the reference computed in bfloat16 in the
program's place, fails the cell's limits (at a tiny size on the CPU; the
card's readings at the cells' sizes come from benchmark/control.py)."""

from __future__ import annotations

import torch
from conftest import tiny_cell, tiny_run

from benchmark.harness.runner import execute


def test_control_fails_a_limit(cell_name):
    cell = tiny_cell(cell_name)
    out = execute(tiny_run(cell), cell.loop(), controls=(torch.bfloat16,))
    ctrl = out.control_readings[torch.bfloat16]
    over = [k for k, v in ctrl.items() if v > cell.limits[k]]
    assert over, f"the bfloat16 control passed every limit: {ctrl} vs {cell.limits}"
    assert out.correct, out.checks
