"""What the benchmark's files promise: no JAX anywhere under ``fitbench/``,
a reference that imports nothing of the program, and a ``BENCHMARK.json``
whose every entry has its file."""
from __future__ import annotations

import ast
import json
import re

import pytest

from conftest import ROOT

FITBENCH = ROOT / "fitbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def imported_top_levels(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


SOURCES = sorted(FITBENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(FITBENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    found = imported_top_levels(path) & {"jax", "jaxlib", "flax", "repro"}
    assert not found, f"{path} imports {found}"


def test_the_reference_imports_nothing_of_the_program():
    names = imported_top_levels(FITBENCH / "reference.py")
    assert "repro_torch" not in names and names <= {"numpy", "__future__"}


def test_nothing_reads_the_jax_benchmarks_folder():
    for path in SOURCES:
        if path.parent.name == "tests":
            continue
        assert "benchmarks" not in path.read_text(), path


def test_benchmark_json_has_a_file_for_every_entry():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    cells = {c["name"] for c in spec["workloads"]}
    for c in spec["configs"]:
        assert NAME.match(c["name"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in spec["paths"]))
        assert all(NAME.match(k) for k in c["reduced"])
    for w in spec["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        traffic = FITBENCH / "traffic" / w["traffic"]
        assert traffic.with_suffix(".json").is_file() or \
            traffic.with_suffix(".py").is_file()
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert (FITBENCH / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        e2e = [m["name"] for m in spec["end_to_end"]
               if cell in m.get("workloads", [cell])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(cell in m.get("workloads", [cell])
                   for m in spec["per_layer"])
    e2e_names = {m["name"] for m in spec["end_to_end"]}
    assert all(m["moves"] in e2e_names for m in spec["per_layer"])
