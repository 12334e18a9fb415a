"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine holding the chips the cell asks
for. Set-up (imports, the card, kernel builds or loads, the seeded inputs,
the cell's warm-up) is timed as `setup_s`; then the cell's loop measures
for --seconds; then the reference checks what the window produced. With
--trace 1 a bounded sample of the window runs under torch.profiler and
the line carries the cell's per-layer metrics instead of its end-to-end
ones, and a breakdown. Nothing is written to disk but the program's own
kernel builds, which live inside the checkout.

The last lines on stderr give each number the check compared with its
limit; the last line on stdout is the result, one JSON object. Exit 1,
with no result, where the card or the program is missing, and where a
module of the JAX stack or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
# caches of the program's libraries, inside the checkout at fixed paths
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "benchmark" / ".cache" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "benchmark" / ".cache" / "triton"))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr)
    return 1


def _program_path():
    """The program's package directory, which must be this checkout's."""
    import importlib.util

    spec = importlib.util.find_spec("gsvc_tpu_torch")
    if spec is None or spec.origin is None:
        return None
    path = Path(spec.origin).resolve().parent
    return path if path.parent == ROOT else None


def build_kernels() -> None:
    """Build or load every kernel and host library of the program at once
    (one compiler each; a checkout's first run builds them)."""
    from gsvc_tpu_torch import _build

    _build.build_all(["fill", "segsum", "rasterize_fwd", "rasterize_bwd", "rans"])


def per_layer_values(run, cell) -> dict:
    from benchmark.harness.core import metric_reader

    out = {}
    for m in cell.per_layer():
        v = metric_reader(m["name"], cell.root)(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result_line(cell, run, out, kind: str) -> dict:
    """The run's result: the cell's end-to-end metrics (per-layer ones and
    a breakdown where traced), the device, and last the check's numbers
    beside their limits."""
    if run.traced:
        metrics = per_layer_values(run, cell)
    else:
        metrics = {m["name"]: {"value": run.e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end()}
    result = {
        "correct": out.correct, "attempted": run.attempted, "failed": run.failed,
        "metrics": metrics,
        "device": {"platform": "gpu", "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": int(out.peak_bytes)},
    }
    if run.traced:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = out.checks
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    from benchmark.harness.core import Cell, Run, SpecError, forbidden_loaded

    try:
        cell = Cell(args.workload, ROOT)
    except (SpecError, KeyError, ValueError) as e:
        return fail(str(e))
    if _program_path() is None:
        return fail(f"the program (gsvc_tpu_torch) is not in this checkout, {ROOT}")
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{torch.cuda.device_count()} CUDA devices, the cell needs {cell.chips}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    build_kernels()
    from benchmark.harness.runner import execute
    from benchmark.harness.trace import DeviceTrace

    run = Run(cell, args.seed, args.seconds, bool(args.trace), device)
    run.trace = DeviceTrace() if args.trace else None
    out = execute(run, cell.loop(), T_START)
    result = result_line(cell, run, out, torch.cuda.get_device_name(device))
    bad = forbidden_loaded()
    if bad:
        return fail(f"modules of the JAX stack or package were loaded: {bad}")
    print(json.dumps({"counters": run.counters, "readings": out.readings,
                      "spans": run.spans.seconds}), file=sys.stderr)
    for name, c in out.checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
