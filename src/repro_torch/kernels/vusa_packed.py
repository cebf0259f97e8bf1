"""Wrappers of the hand-written CUDA kernels in ``csrc/vusa_packed.cu``.

``vusa_packed_matmul`` and ``vusa_fused_mlp_matmul`` are the port's
counterparts of the JAX package's Pallas kernels of the same names
(``repro/kernels/vusa_packed.py``).  Each wrapper checks device, dtype,
shape and contiguity, allocates the output (and the fused MLP's per-window
scratch) with ``torch.empty``, launches on the current stream and raises if
the launch was refused.  Tensors on the CPU take the plain PyTorch version
in :mod:`repro_torch.kernels.ref` — only because they lie on the CPU; a CUDA
tensor launches the kernel or raises.

Each wrapper carries a plain integer ``launches``, incremented where (and
only where) its kernel is launched, so a run can show that the main path
went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import library
from .ref import vusa_fused_mlp_ref, vusa_packed_ref

__all__ = ["vusa_packed_matmul", "vusa_fused_mlp_matmul", "reset_launch_counts"]

_FLOATS = (torch.float32, torch.bfloat16)
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = library("vusa_packed")
    lib.vusa_packed_matmul.argtypes = [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.vusa_packed_matmul.restype = _I
    lib.vusa_fused_mlp_matmul.argtypes = [
        _P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _P,
    ]
    lib.vusa_fused_mlp_matmul.restype = _I
    lib.vusa_error_string.argtypes = [_I]
    lib.vusa_error_string.restype = ctypes.c_char_p
    return lib


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every operand lies on the CPU, False when all lie on one
    CUDA device; anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def _check_pack(name: str, values: torch.Tensor, positions: torch.Tensor, k: int) -> None:
    if values.ndim != 3 or values.shape != positions.shape:
        raise ValueError(
            f"{name}: values {tuple(values.shape)} / positions {tuple(positions.shape)} "
            "must both be (T, K, S)"
        )
    if values.shape[1] != k:
        raise ValueError(f"{name}: pack rows {values.shape[1]} != reduction dim {k}")
    if values.dtype not in _FLOATS:
        raise TypeError(f"{name}: values must be float32 or bfloat16, got {values.dtype}")
    if positions.dtype != torch.int8:
        raise TypeError(f"{name}: positions must be int8, got {positions.dtype}")


def _check_x(x: torch.Tensor, m: int) -> None:
    if x.ndim != 2:
        raise ValueError(f"x must be (B, K), got {tuple(x.shape)}")
    if x.dtype not in _FLOATS:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not 1 <= m <= 128:
        raise ValueError(f"window m={m} outside [1, 128] (int8 lane positions)")


def _require_contiguous(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().vusa_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} ({msg})")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def vusa_packed_matmul(
    x: torch.Tensor, values: torch.Tensor, positions: torch.Tensor, m: int = 128
) -> torch.Tensor:
    """``y[b, t*m + l] = sum_k x[b, k] * sum_s values[t, k, s] * [positions[t, k, s] == l]``.

    x: (B, K) fp32/bf16; values (T, K, S) fp32/bf16; positions (T, K, S)
    int8 (-1 = idle slot).  Returns (B, T*m) fp32.  Row b of the result does
    not depend on B (bitwise)."""
    _check_x(x, m)
    _check_pack("vusa_packed_matmul", values, positions, x.shape[1])
    if _on_cpu(x, values, positions):
        return vusa_packed_ref(x, values, positions, m)
    _require_contiguous(x=x, values=values, positions=positions)
    b, k = x.shape
    t, _, s = values.shape
    out = torch.empty((b, t * m), dtype=torch.float32, device=x.device)
    err = _lib().vusa_packed_matmul(
        x.data_ptr(), int(x.dtype == torch.bfloat16),
        values.data_ptr(), int(values.dtype == torch.bfloat16),
        positions.data_ptr(), out.data_ptr(), b, k, t, s, m, _stream(x.device),
    )
    _raise_on(err, "vusa_packed_matmul")
    vusa_packed_matmul.launches += 1
    return out


vusa_packed_matmul.launches = 0


def vusa_fused_mlp_matmul(
    x: torch.Tensor,
    gate_values: torch.Tensor,
    gate_positions: torch.Tensor,
    up_values: torch.Tensor,
    up_positions: torch.Tensor,
    down_values: torch.Tensor,
    down_positions: torch.Tensor,
    m: int = 128,
) -> torch.Tensor:
    """Whole SwiGLU MLP ``silu(x @ Wg) * (x @ Wu) @ Wd`` over row-packed
    operands, all windowed over the same ff windows: gate/up (T, K, S) pack
    (K, ff), down (T, D, Sd) packs ``w_down`` transposed.  Returns (B, D)
    fp32.  The (B, ff) hidden state never reaches device memory; per-window
    (B, D) partials are summed over windows in order in a second launch."""
    _check_x(x, m)
    k = x.shape[1]
    _check_pack("gate", gate_values, gate_positions, k)
    _check_pack("up", up_values, up_positions, k)
    _check_pack("down", down_values, down_positions, down_values.shape[1])
    t = gate_values.shape[0]
    if up_values.shape[0] != t or down_values.shape[0] != t:
        raise ValueError(
            f"window counts differ: gate {t}, up {up_values.shape[0]}, down {down_values.shape[0]}"
        )
    if not gate_values.dtype == up_values.dtype == down_values.dtype:
        raise TypeError("gate/up/down values must share one dtype")
    ops = (x, gate_values, gate_positions, up_values, up_positions, down_values, down_positions)
    if _on_cpu(*ops):
        return vusa_fused_mlp_ref(*ops, m=m)
    _require_contiguous(
        x=x, gate_values=gate_values, gate_positions=gate_positions, up_values=up_values,
        up_positions=up_positions, down_values=down_values, down_positions=down_positions,
    )
    b = x.shape[0]
    d = down_values.shape[1]
    partial = torch.empty((t, b, d), dtype=torch.float32, device=x.device)
    out = torch.empty((b, d), dtype=torch.float32, device=x.device)
    err = _lib().vusa_fused_mlp_matmul(
        x.data_ptr(), int(x.dtype == torch.bfloat16),
        gate_values.data_ptr(), gate_positions.data_ptr(), gate_values.shape[2],
        up_values.data_ptr(), up_positions.data_ptr(), up_values.shape[2],
        down_values.data_ptr(), down_positions.data_ptr(), down_values.shape[2],
        int(gate_values.dtype == torch.bfloat16),
        partial.data_ptr(), out.data_ptr(), b, k, d, t, m, _stream(x.device),
    )
    _raise_on(err, "vusa_fused_mlp_matmul")
    vusa_fused_mlp_matmul.launches += 1
    return out


vusa_fused_mlp_matmul.launches = 0


def reset_launch_counts() -> None:
    vusa_packed_matmul.launches = 0
    vusa_fused_mlp_matmul.launches = 0
