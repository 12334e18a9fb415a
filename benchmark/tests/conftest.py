"""Shared helpers of the benchmark's own tests: each cell at a tiny size,
driven on the CPU through the port's plain versions of its kernels
(backend "cuda" on CPU tensors)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness.core import Cell, Run, load_spec  # noqa: E402

TINY = {"width": 64, "height": 48, "num_points": 60, "iterations": 30, "qat_iterations": 10,
        "densification_interval": 10, "backend": "cuda"}
SEED = 2 ** 31 + 12345  # wider than 32 signed bits, as the driver's seeds are


def tiny_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell with its configuration and traffic cut to a CPU test's size."""
    cell = Cell(name, root)
    cell.config = {**cell.config, **TINY}
    if cell.traffic["loop"] == "encode":
        cell.traffic = {**cell.traffic, "warmup_iterations": 4, "warmup_qat_iterations": 4}
    else:
        cell.traffic = {**cell.traffic, "frames": 6, "check_cycles": 2}
    return cell


def tiny_run(cell: Cell, seconds: float = 1.0, seed: int = SEED) -> Run:
    return Run(cell, seed, seconds, False, torch.device("cpu"))


CELLS = [w["name"] for w in load_spec(ROOT)["workloads"]]


@pytest.fixture(params=CELLS)
def cell_name(request):
    return request.param
