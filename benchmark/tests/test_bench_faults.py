"""A run with the timed path broken underneath reads `correct` false: each
fault a cell can have (its loop's `FAULTS`), planted in the port
at a tiny size on the CPU (the harness's look for a card skipped, the rest
of a run driven); a fault that only a card's run reaches (a graph's
replays, its loop's `CARD_FAULTS`) is planted there."""

from __future__ import annotations

import pytest
import torch
from conftest import SEED, fault_cases, tiny_cell, tiny_run

from benchmark.harness.core import Run
from benchmark.harness.runner import execute

CASES = fault_cases("FAULTS")


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_fault_reads_incorrect(name, fault, monkeypatch):
    fault(monkeypatch.setattr)
    cell = tiny_cell(name)
    out = execute(tiny_run(cell), cell.loop())
    assert not out.correct, out.checks


CARD_CASES = fault_cases("CARD_FAULTS")


@pytest.mark.cuda
@pytest.mark.parametrize("name,fault", CARD_CASES,
                         ids=[f"{c}-{f.__name__}" for c, f in CARD_CASES])
def test_card_fault_reads_incorrect(name, fault, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fault lives in the card's graph replays")
    from benchmark.run import build_kernels

    build_kernels()
    fault(monkeypatch.setattr)
    cell = tiny_cell(name)
    out = execute(Run(cell, SEED, 1.0, False, torch.device("cuda", 0)), cell.loop())
    assert not out.correct, out.checks
