"""BENCHMARK.json keeps to the contract's shape, and the harness finds a
configuration, a traffic mix, a cell and a metric added as files and
entries alone."""

from __future__ import annotations

import hashlib
import json
import re
import shutil

from conftest import ROOT, TINY, fault_cases, tiny_cell, tiny_run

from benchmark.control import faults_of
from benchmark.harness.core import Cell, load_spec, metric_reader
from benchmark.harness.runner import execute

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_spec_shape():
    spec = load_spec(ROOT)
    assert set(spec) == TOP
    assert len(json.dumps(spec)) < 64 * 1024
    assert spec["paths"] == ["benchmark"] and 1 <= spec["run_seconds"] <= 51
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) <= set(conf) and c["reduced"] == conf["reduced"]
        names.add(c["name"])
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in (
            "lower", "higher")
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in spec["workloads"]}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").is_file()
        cell = Cell(w["name"], ROOT)
        reported = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer()
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for c in m["workloads"]:
            assert m["moves"] in {x["name"] for x in Cell(c, ROOT).end_to_end()}
        assert callable(metric_reader(m["name"], ROOT))


def test_new_files_are_found_without_an_edit(tmp_path):
    """A configuration, a traffic mix, a cell's limits and a metric reader
    added in a copy, with their entries, are found by name."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    spec = load_spec(ROOT)
    bench = tmp_path / "benchmark"
    conf = json.loads((bench / "configs" / "gsvc-1080p-10k.json").read_text())
    (bench / "configs" / "gsvc-1080p-20k.json").write_text(
        json.dumps({**conf, "num_points": 20000}))
    traffic = json.loads((bench / "traffic" / "render.json").read_text())
    (bench / "traffic" / "render-fast.json").write_text(json.dumps({**traffic, "fast": True}))
    (bench / "limits" / "render-fast.gsvc-1080p-20k.json").write_text('{"render_max_abs": 1}')
    (bench / "metrics" / "render.new_share.py").write_text(
        "def read(run):\n    return 42.0\n")
    spec["configs"].append({"name": "gsvc-1080p-20k", "source": "x",
                            "file": "benchmark/configs/gsvc-1080p-20k.json",
                            "reduced": conf["reduced"], "why": "x"})
    spec["workloads"].append({"name": "render-fast.gsvc-1080p-20k", "config": "gsvc-1080p-20k",
                              "traffic": "render-fast", "chips": 1, "why": "x"})
    spec["end_to_end"][1]["workloads"].append("render-fast.gsvc-1080p-20k")
    spec["per_layer"].append({"name": "render.new_share", "unit": "%", "better": "higher",
                              "source": "program_span", "layer": "render",
                              "moves": "render_fps", "workloads": ["render-fast.gsvc-1080p-20k"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = Cell("render-fast.gsvc-1080p-20k", tmp_path)
    assert cell.config["num_points"] == 20000 and cell.traffic["fast"]
    assert cell.loop().__name__ != "" and hasattr(cell.loop(), "window")
    assert [m["name"] for m in cell.per_layer()] == ["render.new_share"]
    assert metric_reader("render.new_share", tmp_path)(None) == 42.0
    assert {m["name"] for m in cell.end_to_end()} == {"render_fps", "setup_s"}


PROBE = '''"""A loop added as new files alone: render's interface, a fault of its
own, and its own cuts for the CPU tests."""

from benchmark.loops.render import (  # noqa: F401  (the loop's interface)
    State, compare, free, outputs, reference, setup, trace_counts, window)


def probe_dimmed(patch):
    """The eval render halved where it is produced."""
    from gsvc_tpu_torch.models import represent

    orig = represent.render_frame
    patch(represent, "render_frame", lambda *a, **k: orig(*a, **k) * 0.5)


FAULTS = [probe_dimmed]
CARD_FAULTS = []
TINY_TRAFFIC = {"frames": 3, "check_cycles": 1, "check_samples": 2}
TINY_CONFIG = {"num_points": 40}
'''


def _digests(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_loop_is_found_without_an_edit(tmp_path, monkeypatch):
    """A loop added in a copy as new files (its module, traffic mix and
    limits) with its cell's entries brings its faults to the fault tests and
    to control.py and its cuts to the CPU tests; no file that was in the
    copy changes."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = tmp_path / "benchmark"
    before = _digests(bench)
    (bench / "loops" / "probe.py").write_text(PROBE)
    traffic = json.loads((bench / "traffic" / "render.json").read_text())
    (bench / "traffic" / "probe.json").write_text(json.dumps({**traffic, "loop": "probe"}))
    name = "probe.gsvc-1080p-10k"
    (bench / "limits" / f"{name}.json").write_text(
        (bench / "limits" / "render.gsvc-1080p-10k.json").read_text())
    spec = load_spec(ROOT)
    spec["workloads"].append({"name": name, "config": "gsvc-1080p-10k", "traffic": "probe",
                              "chips": 1, "why": "x"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "render.gsvc-1080p-10k" in m.get("workloads", []):
            m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cases = [(c, f.__name__) for c, f in fault_cases("FAULTS", tmp_path)]
    assert cases == [(c, f.__name__) for c, f in fault_cases("FAULTS")] + [
        (name, "probe_dimmed")]
    assert fault_cases("CARD_FAULTS", tmp_path) == fault_cases("CARD_FAULTS")
    cell = tiny_cell(name, tmp_path)
    assert cell.traffic["loop"] == "probe"
    assert [cell.traffic[k] for k in ("frames", "check_cycles", "check_samples")] == [3, 1, 2]
    assert cell.config == {**Cell(name, tmp_path).config, **TINY, "num_points": 40}
    # the check reads two renders of the first cycle, which a loaded CPU
    # reaches in the window
    out = execute(tiny_run(cell, 2.0), cell.loop())
    assert out.correct, out.checks
    faults_of(cell.loop())["probe_dimmed"](monkeypatch.setattr)
    out = execute(tiny_run(cell, 2.0), cell.loop())
    assert not out.correct, out.checks
    after = _digests(bench)
    assert {k: after.get(k) for k in before} == before
