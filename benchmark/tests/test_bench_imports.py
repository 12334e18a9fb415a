"""What the benchmark runs loads no module of the JAX stack or the JAX
package, compared by whole top-level names; the reference loads nothing of
the port either."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from conftest import ROOT

from benchmark.harness.core import FORBIDDEN, forbidden_loaded

REFERENCE = sorted((ROOT / "benchmark" / "reference").glob("*.py"))


def _imports(path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_top_level_names_compared_whole():
    assert forbidden_loaded({"gsvc_tpu_torch.ops": 0, "jaxtyping": 0, "numpy": 0}) == []
    assert forbidden_loaded({"gsvc_tpu.ops": 0, "jax": 0}) == ["gsvc_tpu.ops", "jax"]


def test_reference_imports_no_program():
    for path in REFERENCE:
        bad = _imports(path) & (set(FORBIDDEN) | {"gsvc_tpu_torch"})
        assert not bad, f"{path.name} imports {bad}"


def _loaded_after(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json; print(json.dumps(sorted(sys.modules)))")],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_loads_no_program():
    names = [f"benchmark.reference.{p.stem}" for p in REFERENCE]
    mods = _loaded_after("import " + ", ".join(names))
    assert set(names) <= set(mods)
    bad = [m for m in mods if m.split(".")[0] in set(FORBIDDEN) | {"gsvc_tpu_torch"}]
    assert not bad


def test_a_run_loads_nothing_of_jax():
    code = (
        "import sys; sys.path.insert(0, 'benchmark/tests')\n"
        "from conftest import tiny_cell, tiny_run, CELLS\n"
        "from benchmark.harness.runner import execute\n"
        "import benchmark.run\n"
        "for name in CELLS:\n"
        "    cell = tiny_cell(name)\n"
        "    execute(tiny_run(cell, 0.2), cell.loop())\n")
    mods = _loaded_after(code)
    assert "gsvc_tpu_torch" in mods
    assert forbidden_loaded(dict.fromkeys(mods)) == []
