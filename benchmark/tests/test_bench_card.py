"""Each cell run once through benchmark/run.py on the card, untraced and
traced, at a short window, and the check read from graph replays in each
cell whose loop can have a fault there. Card only: skips without a CUDA
device."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch
from conftest import CELLS, ROOT, SEED, fault_cases, tiny_cell

from benchmark.harness.faults import replay_unchanged


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(name, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                        "2147483659", "--seconds", "15", "--trace", str(trace)],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["metrics"]


REPLAYED = [c for c, f in fault_cases("CARD_FAULTS") if f is replay_unchanged]


@pytest.mark.cuda
@pytest.mark.parametrize("name", REPLAYED)
def test_encode_check_reads_replays(name):
    """The checked slices' steps past WARMUP replay a captured graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: step graphs replay only there")
    from benchmark.harness.core import Run
    from benchmark.harness.runner import execute
    from benchmark.run import build_kernels

    build_kernels()
    cell = tiny_cell(name)
    run = Run(cell, SEED, 1.0, False, torch.device("cuda", 0))
    out = execute(run, cell.loop())
    assert run.counters["check_replays"] > 0
    assert out.correct, out.checks
