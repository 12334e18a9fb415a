"""One run of a cell's loop, from set-up to the check, on any device (the
CPU only in the benchmark's own tests, at their tiny sizes)."""

from __future__ import annotations

import time
from typing import Optional

import torch

from benchmark.harness.core import Run, check_readings


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Outcome:
    setup_s: float
    peak_bytes: int
    readings: dict
    correct: bool
    checks: dict
    control_readings: dict


def execute(run: Run, loop, t_start: Optional[float] = None, control=None,
            controls=()) -> Outcome:
    """Set-up (timed from `t_start`, default now), the window, the
    program's outputs, its state freed, the reference's readings in
    float64 and the check against the cell's limits. `control`, a dtype,
    puts the reference computed in that dtype in the program's place;
    each dtype of `controls` adds that control's readings beside the
    program's (`control_readings`)."""
    t_start = time.perf_counter() if t_start is None else t_start
    out = Outcome()
    st = loop.setup(run)
    _sync(run.device)
    out.setup_s = time.perf_counter() - t_start
    run.e2e["setup_s"] = out.setup_s
    loop.window(run, st)
    _sync(run.device)
    out.peak_bytes = (torch.cuda.max_memory_allocated(run.device)
                      if run.device.type == "cuda" else 0)
    if run.traced:
        run.trace.finish()
        loop.trace_counts(run, st)
    prog = loop.outputs(run, st)
    loop.free(st)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    if control is not None:
        prog = loop.reference(run, st, control, control=True)
    ref = loop.reference(run, st, torch.float64)
    out.readings = loop.compare(prog, ref)
    out.control_readings = {
        dt: loop.compare(loop.reference(run, st, dt, control=True), ref) for dt in controls}
    ok, out.checks = check_readings(out.readings, run.cell.limits)
    out.correct = ok and run.failed == 0 and run.attempted > 0
    return out
