"""Model plumbing: parameter specs, a numpy-seeded init, norms and RoPE.

Port of the JAX package's ``models/common.py``.  Parameters are nested
dicts of tensors with the reference's layout, described by a tree of
:class:`ParamSpec` leaves.  ``jax.random`` cannot be reproduced in torch,
so :func:`init_params` draws from a seeded numpy generator with the
reference's std rule (``scale / sqrt(shape[-2])``); parameters exported from
the reference load through :func:`repro_torch.convert.params_from_numpy`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

__all__ = ["ParamSpec", "init_params", "rms_norm", "rope", "apply_rope", "strict_fp32"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Abstract description of one parameter tensor (fp32 by default, as in
    the reference: only activations take the config's dtype)."""

    shape: Tuple[int, ...]
    init: str = "normal"  # normal | zeros
    scale: float = 1.0


def _init_leaf(spec: ParamSpec, rng: np.random.Generator) -> np.ndarray:
    if spec.init == "zeros":
        return np.zeros(spec.shape, np.float32)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = np.float32(spec.scale / math.sqrt(max(fan_in, 1)))
    return rng.standard_normal(spec.shape, dtype=np.float32) * std


def init_params(spec_tree: dict, seed: int, device) -> dict:
    """Random parameters from a ParamSpec tree, drawn from
    ``numpy.random.default_rng(seed)`` leaf by leaf in the tree's key order."""
    rng = np.random.default_rng(seed)

    def build(tree):
        return {
            k: build(v) if isinstance(v, dict)
            else torch.from_numpy(_init_leaf(v, rng)).to(device)
            for k, v in tree.items()
        }

    return build(spec_tree)


def strict_fp32() -> None:
    """Full-precision fp32 matmuls on the card.  PyTorch's default already
    keeps TF32 off for matmuls, but the flag is process-wide and any library
    may flip it; the reference computes in true fp32, so the port sets it
    explicitly at the entry points that own the precision policy
    (``Engine``, the serve launcher and ``chip_smoke.py``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --------------------------------------------------------------------------
# Norms / RoPE
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32 with the reference's ``(1 + scale)`` gain."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(dtype)


def rope(positions: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """Rotary embedding tables (sin, cos) for integer ``positions`` (..., seq).
    No host value is copied to the device, so a decode step that calls it
    stays free of host syncs and can be captured in a CUDA graph."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(float(theta), exps)
    angles = positions[..., None].float() * freqs  # (..., seq, hd/2)
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); sin/cos: (..., seq, head_dim/2).
    Split-halves rotation (not interleaved), as the reference."""
    dtype = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    sin = sin[..., :, None, :]
    cos = cos[..., :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(dtype)
