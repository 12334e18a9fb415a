"""The harness's frame: what a run of one cell reads, records and prints.

A cell of BENCHMARK.json names a configuration (its `file`, a JSON object
of sizes), a traffic mix (`traffic/<name>.json`, whose `loop` names the
module under `loops/` that drives it) and, through the per-layer metrics
that list it, the readers under `metrics/<metric name>.py`. Limits of the
correctness check are `limits/<cell name>.json`. Everything is found by
name: a new cell, configuration, traffic mix or metric is a new file and
entry, and no file here changes.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import re
import sys
import time
from pathlib import Path
from typing import Callable, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
# top-level module names no run may load: the JAX stack and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "gsvc_tpu")


class SpecError(RuntimeError):
    """BENCHMARK.json or a file it names is missing or malformed."""


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise SpecError(f"missing {path}")
    return json.loads(path.read_text())


def load_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SpecError(f"no {what} named {name!r} in BENCHMARK.json")


class Cell:
    """A workload of BENCHMARK.json with the files it names, read."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = root
        bench = root / "benchmark"
        spec = load_spec(root)
        self.spec = spec
        self.workload = find(spec["workloads"], name, "workload")
        self.name = name
        conf = find(spec["configs"], self.workload["config"], "config")
        self.config = load_json(root / conf["file"])
        self.traffic = load_json(bench / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(bench / "limits" / f"{name}.json")
        self.chips = int(self.workload["chips"])

    def end_to_end(self) -> list:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.spec["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> list:
        """The per-layer metrics whose readers may find something here:
        those listing this cell, or listing none but moving one of its
        end-to-end metrics."""
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]

    def loop(self):
        """The module that drives this cell's traffic (`loops/<loop>.py`)."""
        return load_module(self.root / "benchmark" / "loops" / f"{self.traffic['loop']}.py")


def load_module(path: Path):
    """A module from a file under the benchmark (names may hold dots)."""
    if not path.is_file():
        raise SpecError(f"missing {path}")
    name = "benchmark_file_" + re.sub(r"\W", "_", str(path.resolve()))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """`read(run)` of metrics/<name>.py: a number, or None where this run
    holds nothing to read."""
    return load_module(root / "benchmark" / "metrics" / f"{name}.py").read


def forbidden_loaded(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is in
    FORBIDDEN, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


class Spans:
    """Host-clock spans by name: the benchmark's own, around its calls into
    the program's layers. `with spans("name"):` adds one; a span around
    device work ends where the caller has synchronised."""

    def __init__(self):
        self.seconds: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds.setdefault(name, []).append(time.perf_counter() - t0)

    def add(self, name: str, secs: float) -> None:
        self.seconds.setdefault(name, []).append(secs)

    def mean(self, name: str) -> Optional[float]:
        v = self.seconds.get(name)
        return sum(v) / len(v) if v else None


class Run:
    """One run of a cell: its arguments, and what the loop records for the
    metrics' readers: `e2e` (end-to-end values by name), `spans`,
    `counters`, `work` (the benchmark's own counts of operations and
    bytes), `trace` (a `trace.DeviceTrace` summary of the traced sample,
    or None), and the run's `attempted` and `failed` counts."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.traced = bool(trace)
        self.device = device
        self.e2e: dict = {}
        self.spans = Spans()
        self.counters: dict = {}
        self.work: dict = {}
        self.trace = None
        self.attempted = 0
        self.failed = 0


def check_readings(readings: dict, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}): each reading at or under its
    limit; a reading with no limit, or a limit with no reading, fails."""
    out, ok = {}, True
    for name in sorted(set(readings) | set(limits)):
        v, lim = readings.get(name), limits.get(name)
        out[name] = {"value": v, "limit": lim}
        if v is None or lim is None or not (v <= lim):
            ok = False
    return ok, out
