"""The readings that a cell's correctness limits are set from, on the card.

    python3 benchmark/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, in one process: the cell's set-up and a short window (whole
frames: at least one), the program's readings against the float64
reference (the lower readings), and the control's: the reference computed
in bfloat16 put in the program's place (the upper readings). Prints one
JSON line a seed and, last, the largest program reading and the smallest
control reading of each number beside the cell's limit. The benchmark's
own runs never run the control. `--fault <name>` plants one of the
faults that the cell's loop lists (`FAULTS`, `CARD_FAULTS` in
`loops/<loop>.py`) in the port first: its readings are the program's. A
name the loop does not list exits 2 and names the loop's faults.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def faults_of(loop) -> dict:
    """The faults a loop lists (`FAULTS`, `CARD_FAULTS`), by name."""
    return {f.__name__: f for f in [*loop.FAULTS, *loop.CARD_FAULTS]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)

    import torch

    from benchmark.harness.core import Cell, Run
    from benchmark.harness.runner import execute
    from benchmark.run import build_kernels

    cell = Cell(args.workload, ROOT)
    loop = cell.loop()
    known = faults_of(loop)
    if args.fault and args.fault not in known:
        print(f"control: loop {cell.traffic['loop']!r} of {args.workload} has no fault "
              f"{args.fault!r}; its faults: {', '.join(known) or 'none'}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 1
    build_kernels()
    if args.fault:
        known[args.fault](setattr)
    device = torch.device("cuda", 0)
    lows, highs = {}, {}
    for seed in args.seeds:
        run = Run(cell, seed, args.seconds, False, device)
        out = execute(run, loop, controls=(torch.bfloat16,))
        ctrl = out.control_readings[torch.bfloat16]
        print(json.dumps({"seed": seed, "correct": out.correct, "program": out.readings,
                          "control": ctrl, "counters": run.counters}), flush=True)
        for k, v in out.readings.items():
            lows[k] = max(lows.get(k, v), v)
        for k, v in ctrl.items():
            highs[k] = min(highs.get(k, v), v)
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds),
                      "largest_program": lows, "smallest_control": highs,
                      "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
