"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import neither
``jax`` nor the JAX package ``repro``.

Every module of ``repro_torch`` is imported in a fresh interpreter, which
then reports every loaded module; an AST scan covers ``chip_smoke.py``,
which needs a card to run.
"""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import repro_torch

ROOT = Path(__file__).resolve().parents[1]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, prefix="repro_torch.")
    )


def test_port_imports_no_jax_and_no_reference():
    mods = _port_modules()
    assert {"repro_torch.serve.engine", "repro_torch.kernels.vusa_packed",
            "repro_torch.launch.serve", "repro_torch.convert",
            "repro_torch.kernels.vusa_spmm", "repro_torch.kernels.dense_matmul",
            "repro_torch.core.vusa", "repro_torch.core.growth", "repro_torch.core.simulator",
            "repro_torch.core.hwmodel", "repro_torch.core.workloads"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print('\\n'.join(sys.modules))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    assert "repro_torch.serve.packed" in out
    bad = [m for m in out if _forbidden(m)]
    assert not bad, bad


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_chip_smoke_and_port_sources_import_no_jax():
    files = [ROOT / "chip_smoke.py", *sorted((ROOT / "src" / "repro_torch").rglob("*.py"))]
    assert len(files) > 10
    for f in files:
        bad = [m for m in _imports(f) if _forbidden(m)]
        assert not bad, (f, bad)
