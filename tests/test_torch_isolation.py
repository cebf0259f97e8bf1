"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the
``examples/*_torch.py`` scripts import neither ``jax`` nor the JAX package
``repro``.

Every module of ``repro_torch`` is imported in a fresh interpreter, which
then reports every loaded module; an AST scan covers ``chip_smoke.py``,
which needs a card to run, and the examples.
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
            "repro_torch.core.hwmodel", "repro_torch.core.workloads",
            "repro_torch.checkpoint.ckpt", "repro_torch.serve.faults",
            "repro_torch.serve.journal", "repro_torch.serve.async_engine",
            "repro_torch.data.pipeline", "repro_torch.optim.adamw", "repro_torch.optim.schedule",
            "repro_torch.train.step", "repro_torch.train.trainer",
            "repro_torch.launch.train", "repro_torch.configs.qwen2_0_5b",
            "repro_torch.configs.qwen3_8b", "repro_torch.configs.internlm2_1_8b",
            "repro_torch.configs.olmoe_1b_7b", "repro_torch.configs.moonshot_v1_16b_a3b",
            "repro_torch.configs.paligemma_3b", "repro_torch.configs.recurrentgemma_9b",
            "repro_torch.configs.mamba2_2_7b", "repro_torch.configs.whisper_tiny",
            "repro_torch.models.ssm", "repro_torch.models.opt_flags",
            "repro_torch.launch.op_cost", "repro_torch.launch.dryrun",
            "repro_torch.launch.roofline", "repro_torch.dist.tp",
            "repro_torch.dist.comm", "repro_torch.launch.mesh"} <= set(mods)
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
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    assert [f.name for f in examples] == ["quickstart_torch.py", "serve_sparse_torch.py",
                                          "train_sparse_lm_torch.py", "vusa_explorer_torch.py"]
    files = [ROOT / "chip_smoke.py", *examples,
             *sorted((ROOT / "src" / "repro_torch").rglob("*.py"))]
    assert len(files) > 10
    for f in files:
        bad = [m for m in _imports(f) if _forbidden(m)]
        assert not bad, (f, bad)
