"""Wrapper of the hand-written CUDA kernel in ``csrc/dense_matmul.cu``.

``dense_matmul`` is the port's counterpart of the JAX package's Pallas
kernel of the same name (``repro/kernels/dense_matmul.py``), the paper's
standard systolic-array baseline.  It keeps the reference's shape contract:
with ``bm, bn, bk`` cut to at most ``m, n, k``, each must divide its
dimension, or the call raises (the reference asserts).  The CUDA kernel
tiles on its own and checks its own edges, so the block sizes are the
contract only; the launch plan (``tile_plan.plan``: reduction slices and
tile) depends on K only, and a plan with more than one slice gets an fp32
workspace from ``torch.empty`` and runs the rows in chunks
(``tile_plan.row_chunks``) whose partials fit it.  Tensors on the CPU take
the plain PyTorch version :func:`repro_torch.kernels.ref.dense_matmul_ref`
— only because they lie on the CPU; a CUDA tensor launches the kernel or
raises.

``dense_matmul.launches`` is a plain integer, incremented where (and only
where) the kernel is launched: once a call, whatever the number of CUDA
launches it takes (per row chunk the tile kernel, then the ordered sum of
its slices).  ``cuda_launches()`` reads the library's own count of the CUDA
launches it has issued.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import library
from .ref import dense_matmul_ref
from .tile_plan import plan, row_chunks, workspace_bytes
from .vusa_packed import _on_cpu, _require_contiguous, _stream

__all__ = ["dense_matmul", "reset_launch_counts", "cuda_launches"]

_FLOATS = (torch.float32, torch.bfloat16)
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = library("dense_matmul")
    lib.dense_matmul.argtypes = [_P, _I, _P, _I, _P, _P, *[_I] * 7, _P]
    lib.dense_matmul.restype = _I
    lib.dense_matmul_cuda_launches.argtypes = []
    lib.dense_matmul_cuda_launches.restype = ctypes.c_ulonglong
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
    pl = plan(k)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    part = torch.empty(workspace_bytes(pl, m, n) // 4, dtype=torch.float32, device=x.device)
    lib = _lib()
    for r0, r1 in row_chunks(pl, m, n):
        err = lib.dense_matmul(x.data_ptr() + r0 * k * x.element_size(),
                               int(x.dtype == torch.bfloat16), w.data_ptr(),
                               int(w.dtype == torch.bfloat16), out.data_ptr() + r0 * n * 4,
                               part.data_ptr(), r1 - r0, k, n, *pl, _stream(x.device))
        if err != 0:
            msg = lib.dense_matmul_error_string(err).decode()
            raise RuntimeError(f"dense_matmul: CUDA launch failed with error {err} ({msg})")
    dense_matmul.launches += 1
    return out


def reset_launch_counts() -> None:
    dense_matmul.launches = 0


def cuda_launches() -> int:
    """CUDA launches the kernel library has issued since it was loaded
    (it counts each launch the runtime accepts; builds the library on first
    use)."""
    return int(_lib().dense_matmul_cuda_launches())


reset_launch_counts()
