"""The port's static checker (``repro_torch.analysis``) against the JAX
package's.

The port's checker runs clean over ``src/repro_torch``; its RI004 fires on
the port's host-only modules, where the reference checker (whose host-only
list names ``repro/...`` paths and ``jax`` roots) reports nothing; every
rule fixture of ``tests/test_analysis.py`` gives the same rule codes from
both checkers (a fixture's ``repro`` paths and ``jax`` imports read as
``repro_torch`` and ``torch`` for the port); and the two lock orders agree
on every lock both packages name.
"""
import ast
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import contracts as ref_contracts
from repro.analysis import invariants as ref_invariants
from repro_torch.analysis import contracts, invariants

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
_DEFAULT_PATH = "repro/somewhere/mod.py"   # test_analysis.check's default


def codes(violations):
    return [v.rule for v in violations]


def _reference_fixtures():
    """Every ``check(source[, path=...])`` call of ``tests/test_analysis.py``,
    as (id, source, path)."""
    tree = ast.parse((ROOT / "tests" / "test_analysis.py").read_text())
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef) or \
                not fn.name.startswith("test_"):
            continue
        calls = [c for c in ast.walk(fn) if isinstance(c, ast.Call)
                 and isinstance(c.func, ast.Name) and c.func.id == "check"]
        for i, call in enumerate(calls):
            path = next((kw.value.value for kw in call.keywords
                         if kw.arg == "path"), _DEFAULT_PATH)
            out.append((f"{fn.name}-{i}",
                        textwrap.dedent(call.args[0].value), path))
    return out


FIXTURES = _reference_fixtures()


def _as_port(source: str, path: str) -> tuple[str, str]:
    """The fixture as the port would hold it: its package is repro_torch and
    its accelerator stack torch."""
    source = re.sub(r"\brepro\.", "repro_torch.", source)
    return re.sub(r"\bjax\b", "torch", source), \
        re.sub(r"(^|/)repro/", r"\1repro_torch/", path)


def test_the_reference_fixtures_were_found():
    assert len(FIXTURES) >= 30
    assert {fid.split("-")[0] for fid, _, _ in FIXTURES} >= {
        "test_fires_on_module_scope_jax", "test_allowlisted_builder_is_clean",
        "test_fires_on_cycle_between_functions"}


@pytest.mark.parametrize("source,path", [f[1:] for f in FIXTURES],
                         ids=[f[0] for f in FIXTURES])
def test_rule_fixtures_agree_with_the_reference(source, path):
    want = codes(ref_invariants.check_source(source, path))
    got = codes(invariants.check_source(*_as_port(source, path)))
    assert got == want


@pytest.mark.parametrize("line", [
    "import torch",
    "import triton.language as tl",
    "from .engine import make_engine",
    "from .device_plane import DeviceShardedService",
    "from ..core.torch_index import rescale_keys",
    "from repro_torch.kernels import fitting_lookup",
])
def test_ri004_sees_the_ports_host_only_modules(line):
    """A module-scope accelerator import in the port's ``index/table.py``:
    the port's checker fires, the reference's is blind to the port."""
    path = "src/repro_torch/index/table.py"
    source = f"import numpy as np\n{line}\n"
    vs = invariants.check_source(source, path)
    assert codes(vs) == ["RI004"]
    assert "host-only module imports" in vs[0].message
    assert ref_invariants.check_source(source, path) == []


def test_ri004_allows_lazy_imports_and_device_modules():
    lazy = ("from typing import TYPE_CHECKING\n"
            "if TYPE_CHECKING:\n    import torch\n"
            "def f():\n    import torch\n    return torch\n")
    assert invariants.check_source(lazy,
                                   "src/repro_torch/core/tree.py") == []
    assert invariants.check_source(
        "import torch\n", "src/repro_torch/index/device_plane.py") == []


def test_checker_runs_clean_on_src_repro_torch():
    analyzer = invariants.Analyzer()
    analyzer.check_paths([str(SRC / "repro_torch")])
    violations = analyzer.finish()
    assert violations == [], "\n".join(str(v) for v in violations)
    assert not analyzer.errors, analyzer.errors


def test_cli_strict_exits_zero_on_the_port():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "src/repro_torch",
         "--strict"], capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "repro_torch.analysis: 0 violation(s)" in proc.stderr


def test_cli_reports_violations_with_exit_one(tmp_path):
    bad = tmp_path / "repro_torch" / "index" / "query.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import torch\n\ndef f(svc):\n    return svc.stats()\n")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", str(bad)],
        capture_output=True, text=True,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 1
    assert f"{bad}:1: RI004" in proc.stdout
    assert f"{bad}:4: RI006" in proc.stdout


def test_lock_orders_agree_on_every_shared_lock():
    shared = [n for n in contracts.LOCK_ORDER
              if n in ref_contracts.LOCK_RANK]
    assert shared == [n for n in ref_contracts.LOCK_ORDER
                      if n in contracts.LOCK_RANK]
    assert {"DeviceShardedService._write_lock",
            "DeviceShardedService._counts_lock"} <= set(shared)
    assert len(set(contracts.LOCK_ORDER)) == len(contracts.LOCK_ORDER)


def test_contracts_mirror_the_reference():
    for name in ("FROZEN_CLASSES", "PINNED_FIELDS", "PINNED_SUFFIXES",
                 "FROZEN_ARRAY_FIELDS", "INPLACE_NDARRAY_METHODS",
                 "HOT_PATH_FORBIDDEN_CALLS", "DEPRECATED_CALLS"):
        assert getattr(contracts, name) == getattr(ref_contracts, name), name
    assert "DeviceShardSet" in contracts.FROZEN_CLASSES
    assert all(m.startswith("repro_torch/")
               for m in contracts.HOST_ONLY_MODULES)
    # the reference's host-only modules, in its order, then the port's own
    # (its sharding rules, which the reference writes in jax; the HLO
    # parser with the collective record, and the paged KV bookkeeping,
    # which the reference does not declare)
    port_only = ["repro_torch/launch/sharding.py",
                 "repro_torch/launch/hlo_analysis.py",
                 "repro_torch/serve/paged_kv.py"]
    assert [m.replace("repro_torch/", "repro/")
            for m in contracts.HOST_ONLY_MODULES
            if m not in port_only] == list(ref_contracts.HOST_ONLY_MODULES)
    assert list(contracts.HOST_ONLY_MODULES[
        len(ref_contracts.HOST_ONLY_MODULES):]) == port_only
