"""Wrapper of the hand-written CUDA kernel in ``csrc/vusa_spmm.cu``.

``vusa_spmm`` is the port's counterpart of the JAX package's block-VUSA
Pallas kernel of the same name (``repro/kernels/vusa_spmm.py``).  The
wrapper checks device, dtype, shape and contiguity, allocates the output
and, when the plan splits the reduction, the fp32 workspace of its
partials with ``torch.empty``, launches on the current stream (one launch
per row chunk of ``tile_plan.row_chunks``) and raises if a launch was
refused.  The launch plan (``tile_plan.plan``) depends on the pack's J*A
only.  Tensors on the CPU take the plain PyTorch version
:func:`repro_torch.kernels.ref.vusa_spmm_ref` — only because they lie on
the CPU; a CUDA tensor launches the kernel or raises.

``vusa_spmm.launches`` is a plain integer, incremented where (and only
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
from .ref import vusa_spmm_ref
from .tile_plan import plan, row_chunks, workspace_bytes
from .vusa_packed import _on_cpu, _require_contiguous, _stream

__all__ = ["vusa_spmm", "reset_launch_counts", "cuda_launches"]

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = library("vusa_spmm")
    lib.vusa_spmm.argtypes = [_P, _I, _P, _P, _P, _P, *[_I] * 9, _P]
    lib.vusa_spmm.restype = _I
    lib.vusa_spmm_cuda_launches.argtypes = []
    lib.vusa_spmm_cuda_launches.restype = ctypes.c_ulonglong
    lib.vusa_spmm_error_string.argtypes = [_I]
    lib.vusa_spmm_error_string.restype = ctypes.c_char_p
    return lib


def vusa_spmm(
    x: torch.Tensor, values: torch.Tensor, row_idx: torch.Tensor, ncols: int | None = None
) -> torch.Tensor:
    """``y[b, t*Tn + n] = sum_j sum_a x[b, row_idx[t, j, a]] * values[t, j, a, n]``.

    x: (B, K) fp32/bf16; values (T, J, A, Tn = 128) fp32; row_idx (T, J, A)
    int32 in [0, K).  Returns (B, ncols) in ``x.dtype`` (``ncols`` defaults
    to T*Tn, the reference's contract; a smaller one skips the lanes past
    it), accumulated in fp32 (jobs in order, then rows within a job) and
    rounded once."""
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
    t, j, a, tn = values.shape
    ncols = t * tn if ncols is None else ncols
    if not 0 <= ncols <= t * tn:
        raise ValueError(f"ncols {ncols} outside [0, {t * tn}]")
    if _on_cpu(x, values, row_idx):
        return vusa_spmm_ref(x, values, row_idx, ncols)
    if tn != 128:
        raise ValueError(f"the CUDA kernel takes output tiles of 128 lanes, got {tn}")
    _require_contiguous(x=x, values=values, row_idx=row_idx)
    b, k = x.shape
    pl = plan(j * a)
    out = torch.empty((b, ncols), dtype=x.dtype, device=x.device)
    part = torch.empty(workspace_bytes(pl, b, ncols) // 4, dtype=torch.float32, device=x.device)
    lib, size = _lib(), x.element_size()  # out has x's dtype
    for r0, r1 in row_chunks(pl, b, ncols):
        err = lib.vusa_spmm(x.data_ptr() + r0 * k * size, int(x.dtype == torch.bfloat16),
                            values.data_ptr(), row_idx.data_ptr(),
                            out.data_ptr() + r0 * ncols * size, part.data_ptr(), r1 - r0, k, t,
                            j * a, ncols, *pl, _stream(x.device))
        if err != 0:
            msg = lib.vusa_spmm_error_string(err).decode()
            raise RuntimeError(f"vusa_spmm: CUDA launch failed with error {err} ({msg})")
    vusa_spmm.launches += 1
    return out


def reset_launch_counts() -> None:
    vusa_spmm.launches = 0


def cuda_launches() -> int:
    """CUDA launches the kernel library has issued since it was loaded
    (it counts each launch the runtime accepts; builds the library on first
    use)."""
    return int(_lib().vusa_spmm_cuda_launches())


reset_launch_counts()
