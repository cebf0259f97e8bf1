"""Plain PyTorch versions of the two packed-matmul kernels.

Port of the JAX package's ``kernels/ref.py`` oracles for the row-wise VUSA
format.  They consume the *packed* operands, so kernel-vs-plain equality
checks the kernel and ``unpack_rows``-vs-dense checks the packer.  The
wrappers in :mod:`repro_torch.kernels.vusa_packed` run these for tensors on
the CPU; ``chip_smoke.py`` holds the CUDA kernels against them on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["vusa_packed_ref", "vusa_fused_mlp_ref", "unpack_dense"]


def unpack_dense(values: torch.Tensor, positions: torch.Tensor, m: int = 128) -> torch.Tensor:
    """Row-pack (T, K, S) -> dense (K, T*m) fp32.

    Slots add into their lanes (a repeated lane sums, as the reference's
    one-hot contraction does); idle slots (position -1) and lanes outside
    the window contribute nothing."""
    t, k, _ = values.shape
    p = positions.long()
    lanes = torch.where((p >= 0) & (p < m), p, m)  # lane m collects what no lane takes
    w = torch.zeros((t, k, m + 1), dtype=torch.float32, device=values.device)
    w.scatter_add_(2, lanes, values.float())
    return w[:, :, :m].permute(1, 0, 2).reshape(k, t * m)


def vusa_packed_ref(
    x: torch.Tensor, values: torch.Tensor, positions: torch.Tensor, m: int = 128
) -> torch.Tensor:
    """``y[b, t*m + l] = sum_k x[b, k] * sum_s values[t, k, s] * [positions[t, k, s] == l]``.

    x: (B, K); values/positions: (T, K, S).  Returns (B, T*m) fp32."""
    return x.float() @ unpack_dense(values, positions, m)


def vusa_fused_mlp_ref(
    x: torch.Tensor,
    gate_values: torch.Tensor,
    gate_positions: torch.Tensor,
    up_values: torch.Tensor,
    up_positions: torch.Tensor,
    down_values: torch.Tensor,
    down_positions: torch.Tensor,
    m: int = 128,
) -> torch.Tensor:
    """``silu(x @ Wg) * (x @ Wu) @ Wd`` over row-packed operands.

    ``gate``/``up`` pack (K, ff); ``down`` packs ``w_down`` *transposed*
    (D, ff), so the ff reduction dim is the windowed one.  Returns (B, D)
    fp32."""
    wg = unpack_dense(gate_values, gate_positions, m)  # (K, T*m)
    wu = unpack_dense(up_values, up_positions, m)
    wdt = unpack_dense(down_values, down_positions, m)  # (D, T*m) = w_down.T padded
    xf = x.float()
    h = F.silu(xf @ wg) * (xf @ wu)  # (B, T*m)
    return h @ wdt.T
