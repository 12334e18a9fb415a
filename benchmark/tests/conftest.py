"""Shared helpers of the benchmark's own tests: each cell at a tiny size,
driven on the CPU through the port's plain versions of its kernels
(backend "cuda" on CPU tensors). What a cell's loop needs beyond the
shared cut it declares itself (`TINY_TRAFFIC`, `TINY_CONFIG`), as it
declares its faults (`FAULTS`, `CARD_FAULTS`)."""

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
    """The cell with its configuration and traffic cut to a CPU test's size:
    `TINY`, then its loop's own cuts."""
    cell = Cell(name, root)
    loop = cell.loop()
    cell.config = {**cell.config, **TINY, **getattr(loop, "TINY_CONFIG", {})}
    cell.traffic = {**cell.traffic, **loop.TINY_TRAFFIC}
    return cell


def tiny_run(cell: Cell, seconds: float = 1.0, seed: int = SEED) -> Run:
    return Run(cell, seed, seconds, False, torch.device("cpu"))


def cells(root: Path = ROOT) -> list:
    return [w["name"] for w in load_spec(root)["workloads"]]


def fault_cases(kind: str, root: Path = ROOT) -> list:
    """(cell, fault) for each fault that each cell's loop lists under
    `kind`: "FAULTS" (planted on any device) or "CARD_FAULTS"."""
    return [(c, f) for c in cells(root) for f in getattr(Cell(c, root).loop(), kind)]


CELLS = cells()


@pytest.fixture(params=CELLS)
def cell_name(request):
    return request.param
