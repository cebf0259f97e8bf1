"""The port's examples (``examples/*_torch.py``) run end to end on the CPU
at smoke size, each in a fresh interpreter with a time limit, and print
what their JAX counterparts print on success.  None of them imports JAX or
the JAX package (``tests/test_torch_isolation.py`` scans them too)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300


def _run(script: str, *args: str) -> str:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, str(ROOT / "examples" / script), *args], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_quickstart():
    out = _run("quickstart_torch.py", "--device", "cpu")
    assert "greedy outputs identical: True" in out and "quickstart OK" in out


@pytest.mark.parametrize("extra", [(), ("--mesh", "1,2", "--dist-backend", "gloo")])
def test_serve_sparse(extra):
    out = _run("serve_sparse_torch.py", "--device", "cpu", "--new", "6", "--batch", "2", *extra)
    assert "outputs identical: True" in out and "scheduler  : 4 requests" in out


def test_train_sparse_lm(tmp_path):
    metrics = tmp_path / "metrics.json"
    out = _run("train_sparse_lm_torch.py", "--preset", "smoke", "--steps", "8", "--device", "cpu",
               "--ckpt", str(tmp_path / "ckpt"), "--out", str(metrics))
    assert "done: 8 steps" in out
    rec = json.loads(metrics.read_text())
    assert rec["steps"] == 8 and rec["device"] == "cpu" and rec["final_sparsity"] > 0.5


def test_vusa_explorer_matches_the_reference_example():
    """The paper model is numpy in both packages: the same table."""
    got = _run("vusa_explorer_torch.py", "--sparsity", "0.8")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    want = subprocess.run([sys.executable, str(ROOT / "examples" / "vusa_explorer.py"),
                           "--sparsity", "0.8"], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=TIMEOUT_S, check=True).stdout
    assert got == want and "paper's (3,6,3)" in got
