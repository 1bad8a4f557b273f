"""The port's root package resolves its subpackages lazily: host-only
modules import without torch, as the JAX package's load without jax."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
HOST_ONLY = ("repro_torch.core.tree", "repro_torch.core.cost_model",
             "repro_torch.index.table", "repro_torch.index.query",
             "repro_torch.index.telemetry", "repro_torch.launch.sharding",
             "repro_torch.launch.hlo_analysis", "repro_torch.serve.paged_kv")


def _run(code: str) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(SRC), env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


@pytest.mark.parametrize("module", HOST_ONLY)
def test_host_only_module_loads_no_torch(module):
    out = _run(f"import sys, {module}; print('torch' in sys.modules)")
    assert out.split() == ["False"]


def test_all_host_only_modules_together_load_no_torch():
    out = _run(f"import sys, {', '.join(HOST_ONLY)}; "
               f"print('torch' in sys.modules)")
    assert out.split() == ["False"]


def test_root_package_still_resolves_its_subpackages():
    out = _run("import repro_torch, sys; "
               "print('torch' in sys.modules); "
               "print(repro_torch.index.ServingHandle.__name__); "
               "print(repro_torch.kernels.rglru_scan.__name__); "
               "print(sorted(repro_torch.__all__) == ['analysis', 'checkpoint', "
               "'configs', 'core', 'data', 'index', 'kernels', 'launch', "
               "'models', 'serve', 'train'])")
    assert out.split() == ["False", "ServingHandle",
                           "repro_torch.kernels.rglru_scan", "True"]


def test_root_package_rejects_unknown_names():
    import repro_torch
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        repro_torch.nope
