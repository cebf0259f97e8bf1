"""Config registry: ``get_config("<arch-id>")`` -> ArchConfig.

Only the architectures the port serves are listed; the JAX package's other
families (moe, ssm, hybrid, encdec, vlm) are still to be ported (ROADMAP.md
queue A) and raise a clear error here.
"""

from __future__ import annotations

import importlib

from .base import SHAPES, ArchConfig, ShapeConfig  # noqa: F401

ARCH_IDS = [
    "llama3_2_1b",
    "vusa_edge",  # the paper's own Edge-AI scale config
]


def _norm(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def _module(arch: str):
    key = _norm(arch)
    if key not in ARCH_IDS:
        raise KeyError(
            f"arch {arch!r} is not served by the PyTorch port yet; ported: {ARCH_IDS} "
            "(the JAX package repro.configs lists the rest)"
        )
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(arch).SMOKE
