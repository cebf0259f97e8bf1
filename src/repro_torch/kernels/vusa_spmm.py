"""Wrapper of the hand-written CUDA kernel in ``csrc/vusa_spmm.cu``.

``vusa_spmm`` is the port's counterpart of the JAX package's block-VUSA
Pallas kernel of the same name (``repro/kernels/vusa_spmm.py``).  The
wrapper checks device, dtype, shape and contiguity, allocates the output
with ``torch.empty``, launches on the current stream and raises if the
launch was refused.  Tensors on the CPU take the plain PyTorch version
:func:`repro_torch.kernels.ref.vusa_spmm_ref` — only because they lie on
the CPU; a CUDA tensor launches the kernel or raises.

``vusa_spmm.launches`` is a plain integer, incremented where (and only
where) the kernel is launched.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import library
from .ref import vusa_spmm_ref
from .vusa_packed import _on_cpu, _require_contiguous, _stream

__all__ = ["vusa_spmm", "reset_launch_counts"]

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = library("vusa_spmm")
    lib.vusa_spmm.argtypes = [_P, _I, _P, _P, _P, _I, _I, _I, _I, _P]
    lib.vusa_spmm.restype = _I
    lib.vusa_spmm_error_string.argtypes = [_I]
    lib.vusa_spmm_error_string.restype = ctypes.c_char_p
    return lib


def vusa_spmm(x: torch.Tensor, values: torch.Tensor, row_idx: torch.Tensor) -> torch.Tensor:
    """``y[b, t*Tn + n] = sum_j sum_a x[b, row_idx[t, j, a]] * values[t, j, a, n]``.

    x: (B, K) fp32/bf16; values (T, J, A, Tn = 128) fp32; row_idx (T, J, A)
    int32 in [0, K).  Returns (B, T*Tn) in ``x.dtype``, accumulated in fp32
    (jobs in order, then rows within a job) and rounded once."""
    if x.ndim != 2 or values.ndim != 4 or row_idx.ndim != 3:
        raise ValueError(
            f"x {tuple(x.shape)} / values {tuple(values.shape)} / row_idx "
            f"{tuple(row_idx.shape)} must be (B, K) / (T, J, A, Tn) / (T, J, A)"
        )
    if values.shape[:3] != row_idx.shape:
        raise ValueError(
            f"values {tuple(values.shape)} do not match row_idx {tuple(row_idx.shape)}"
        )
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if values.dtype != torch.float32:
        raise TypeError(f"values must be float32, got {values.dtype}")
    if row_idx.dtype != torch.int32:
        raise TypeError(f"row_idx must be int32, got {row_idx.dtype}")
    if _on_cpu(x, values, row_idx):
        return vusa_spmm_ref(x, values, row_idx)
    t, j, a, tn = values.shape
    if tn != 128:
        raise ValueError(f"the CUDA kernel takes output tiles of 128 lanes, got {tn}")
    _require_contiguous(x=x, values=values, row_idx=row_idx)
    b, k = x.shape
    out = torch.empty((b, t * tn), dtype=x.dtype, device=x.device)
    err = _lib().vusa_spmm(x.data_ptr(), int(x.dtype == torch.bfloat16), values.data_ptr(),
                           row_idx.data_ptr(), out.data_ptr(), b, k, t, j * a, _stream(x.device))
    if err != 0:
        msg = _lib().vusa_spmm_error_string(err).decode()
        raise RuntimeError(f"vusa_spmm: CUDA launch failed with error {err} ({msg})")
    vusa_spmm.launches += 1
    return out


def reset_launch_counts() -> None:
    vusa_spmm.launches = 0


reset_launch_counts()
