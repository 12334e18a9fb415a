"""Each cell's set-up, window and check at a tiny size on the CPU, and the
result line's keys."""

from __future__ import annotations

import torch
from conftest import tiny_cell, tiny_run

from benchmark.harness.runner import execute
from benchmark.run import result_line

CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_cell_runs_and_checks_correct(cell_name):
    cell = tiny_cell(cell_name)
    run = tiny_run(cell)
    out = execute(run, cell.loop())
    assert run.attempted > 0 and run.failed == 0
    assert out.correct, out.checks
    assert set(out.readings) == set(cell.limits)
    for m in cell.end_to_end():
        assert run.e2e[m["name"]] > 0, m["name"]


def test_result_line_has_the_contract_keys(cell_name):
    cell = tiny_cell(cell_name)
    run = tiny_run(cell)
    out = execute(run, cell.loop())
    line = result_line(cell, run, out, "cpu test")
    assert list(line) == CONTRACT_KEYS
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert {m["name"] for m in cell.end_to_end()} == set(line["metrics"])
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}, name


def test_same_seed_same_inputs(cell_name):
    cell = tiny_cell(cell_name)
    a, b = (cell.loop().setup(tiny_run(cell)) for _ in range(2))
    for key in ("clip", "stream"):
        if hasattr(a, key):
            x, y = getattr(a, key), getattr(b, key)
            if isinstance(x, dict):
                assert all(torch.equal(x[k], y[k]) for k in x)
            else:
                assert torch.equal(x, y)


def _run_py(cwd):
    import subprocess
    import sys

    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "render.gsvc-1080p-10k",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_without_a_card_prints_no_result():
    from conftest import ROOT

    if torch.cuda.is_available():
        return  # the card's own run is the benchmark's
    r = _run_py(ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_run_without_the_program_prints_no_result(tmp_path):
    import shutil

    from conftest import ROOT

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    r = _run_py(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "not in this checkout" in r.stderr
