"""Wrapper of the hand-written CUDA kernel in ``csrc/dense_matmul.cu``.

``dense_matmul`` is the port's counterpart of the JAX package's Pallas
kernel of the same name (``repro/kernels/dense_matmul.py``), the paper's
standard systolic-array baseline.  It keeps the reference's shape contract:
with ``bm, bn, bk`` cut to at most ``m, n, k``, each must divide its
dimension, or the call raises (the reference asserts).  The CUDA kernel
tiles on its own and checks its own edges, so the block sizes are the
contract only.  Tensors on the CPU take the plain PyTorch version
:func:`repro_torch.kernels.ref.dense_matmul_ref` — only because they lie on
the CPU; a CUDA tensor launches the kernel or raises.

``dense_matmul.launches`` is a plain integer, incremented where (and only
where) the kernel is launched.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import library
from .ref import dense_matmul_ref
from .vusa_packed import _on_cpu, _require_contiguous, _stream

__all__ = ["dense_matmul", "reset_launch_counts"]

_FLOATS = (torch.float32, torch.bfloat16)
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = library("dense_matmul")
    lib.dense_matmul.argtypes = [_P, _I, _P, _I, _P, _I, _I, _I, _P]
    lib.dense_matmul.restype = _I
    lib.dense_matmul_error_string.argtypes = [_I]
    lib.dense_matmul_error_string.restype = ctypes.c_char_p
    return lib


def dense_matmul(
    x: torch.Tensor, w: torch.Tensor, bm: int = 128, bn: int = 128, bk: int = 128
) -> torch.Tensor:
    """``x @ w`` for x (M, K) and w (K, N), each fp32 or bf16.  Returns
    (M, N) fp32, accumulated in fp32 over K in one fixed order."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} are not (M, K) and (K, N)")
    if x.dtype not in _FLOATS or w.dtype not in _FLOATS:
        raise TypeError(f"x and w must be float32 or bfloat16, got {x.dtype} and {w.dtype}")
    m, k = x.shape
    n = w.shape[1]
    bm, bn, bk = min(bm, m), min(bn, n), min(bk, k)
    if m % bm or n % bn or k % bk:
        raise ValueError(f"shape not a multiple of the tiles: {(m, n, k, bm, bn, bk)}")
    if _on_cpu(x, w):
        return dense_matmul_ref(x, w)
    _require_contiguous(x=x, w=w)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    err = _lib().dense_matmul(x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
                              int(w.dtype == torch.bfloat16), out.data_ptr(), m, k, n,
                              _stream(x.device))
    if err != 0:
        msg = _lib().dense_matmul_error_string(err).decode()
        raise RuntimeError(f"dense_matmul: CUDA launch failed with error {err} ({msg})")
    dense_matmul.launches += 1
    return out


def reset_launch_counts() -> None:
    dense_matmul.launches = 0


reset_launch_counts()
