"""Config registry: ``get_config("<arch-id>")`` -> ArchConfig.

Every architecture of the JAX package's registry is listed: the
decoder-only families (dense, moe, vlm), the hybrid (RG-LRU + local
attention), the ssm (Mamba-2) and the encoder-decoder (whisper).
"""

from __future__ import annotations

import importlib

from .base import SHAPES, ArchConfig, ShapeConfig  # noqa: F401

ARCH_IDS = [
    "llama3_2_1b",
    "qwen2_0_5b",
    "internlm2_1_8b",
    "qwen3_8b",
    "olmoe_1b_7b",
    "moonshot_v1_16b_a3b",
    "paligemma_3b",
    "recurrentgemma_9b",
    "mamba2_2_7b",
    "whisper_tiny",
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
