"""Wrappers of the hand-written CUDA kernels in ``csrc/vusa_packed.cu``.

``vusa_packed_matmul`` and ``vusa_fused_mlp_matmul`` are the port's
counterparts of the JAX package's Pallas kernels of the same names
(``repro/kernels/vusa_packed.py``), with the same ``value_dtype`` routes:
``"dense"`` (fp32 or bf16 values: ``_kernel`` / ``_fused_mlp_kernel``) and
``"int8"`` / ``"int4"`` (raw quantized value bytes plus per-(window, row)
fp32 scales: ``_qkernel`` / ``_fused_mlp_qkernel``).  Each wrapper checks
device, dtype, shape and contiguity, allocates the output (and the fused
MLP's per-window scratch) with ``torch.empty``, launches on the current
stream and raises if the launch was refused.  Tensors on the CPU take the
plain PyTorch version in :mod:`repro_torch.kernels.ref` (one row at a
time, so that row b does not depend on B there either) — only because they
lie on the CPU; a CUDA tensor launches the kernel or raises.

Each wrapper carries ``launches``, a dict of plain integers by route
(``dense``, ``int8``, ``int4``), incremented where (and only where) its
kernel is launched (once a call), so a run can show which kernels the path
went through.  ``cuda_launches()`` reads the library's own count of the
CUDA launches each entry point has issued: ``vusa_packed_matmul`` takes
one per row chunk with one reduction slice, else two (the sliced kernel and
the ordered sum of its slices, ``row_plan``); ``vusa_fused_mlp_matmul``
two (``mlp_plan``): the cluster kernel, in which each (ff window, batch
tile) cluster of eight blocks forms the window's hidden slice on chip and
writes the window's (B, D) partial, and the ordered sum of the window
partials.  Both are bounded by latency at decode sizes, not by the bytes
of the packs: the plans spread each call over enough blocks to fill the
card, and each block keeps several chunks of packed rows in flight.
``empty_kernel()`` launches an empty kernel of the same library: the floor
of a launch under a timer.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import library
from .mlp_plan import mlp_plan
from .ref import VALUE_DTYPES, vusa_fused_mlp_ref, vusa_packed_ref
from .row_plan import row_chunks, row_plan, workspace_bytes

__all__ = [
    "vusa_packed_matmul", "vusa_fused_mlp_matmul", "reset_launch_counts", "cuda_launches",
    "empty_kernel",
]

_FLOATS = (torch.float32, torch.bfloat16)
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = library("vusa_packed")
    lib.vusa_packed_matmul.argtypes = [_P, _I, _P, _I, _P, _P, _P, _P, *[_I] * 7, _P]
    lib.vusa_packed_matmul.restype = _I
    lib.vusa_fused_mlp_matmul.argtypes = [
        _P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, *[_I] * 8, _P,
    ]
    lib.vusa_fused_mlp_matmul.restype = _I
    lib.vusa_packed_empty.argtypes = [_P]
    lib.vusa_packed_empty.restype = _I
    lib.vusa_packed_cuda_launches.argtypes = [_I]
    lib.vusa_packed_cuda_launches.restype = ctypes.c_ulonglong
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


def _check_pack(
    name: str,
    values: torch.Tensor,
    positions: torch.Tensor,
    k: int,
    scales: torch.Tensor | None,
    value_dtype: str,
) -> None:
    """A (T, K, S) pack of ``value_dtype``: float values of the positions'
    shape, or int8 value bytes that decode to the position slots (two slots
    per byte for int4) with (T, K) fp32 scales."""
    if value_dtype not in VALUE_DTYPES:
        raise ValueError(f"{name}: value_dtype must be one of {VALUE_DTYPES}, got {value_dtype!r}")
    if positions.ndim != 3 or values.ndim != 3:
        raise ValueError(
            f"{name}: values {tuple(values.shape)} / positions {tuple(positions.shape)} "
            "must both be (T, K, S)"
        )
    if positions.shape[1] != k:
        raise ValueError(f"{name}: pack rows {positions.shape[1]} != reduction dim {k}")
    if positions.dtype != torch.int8:
        raise TypeError(f"{name}: positions must be int8, got {positions.dtype}")
    if value_dtype == "dense":
        if values.shape != positions.shape:
            raise ValueError(
                f"{name}: values {tuple(values.shape)} != positions {tuple(positions.shape)}"
            )
        if values.dtype not in _FLOATS:
            raise TypeError(f"{name}: values must be float32 or bfloat16, got {values.dtype}")
        if scales is not None:
            raise ValueError(f"{name}: dense values take no scales")
        return
    if values.dtype != torch.int8:
        raise TypeError(f"{name}: {value_dtype} values must be int8 bytes, got {values.dtype}")
    nib = 2 if value_dtype == "int4" else 1
    if values.shape[:2] != positions.shape[:2] or values.shape[2] * nib != positions.shape[2]:
        raise ValueError(
            f"{name}: {value_dtype} values {tuple(values.shape)} do not decode to "
            f"positions {tuple(positions.shape)}"
        )
    if scales is None:
        raise ValueError(f"{name}: {value_dtype} values need scales")
    if scales.dtype != torch.float32 or scales.shape != positions.shape[:2]:
        raise ValueError(
            f"{name}: scales must be float32 of shape {tuple(positions.shape[:2])}, got "
            f"{scales.dtype} {tuple(scales.shape)}"
        )


def _check_x(x: torch.Tensor, m: int) -> None:
    if x.ndim != 2:
        raise ValueError(f"x must be (B, K), got {tuple(x.shape)}")
    if x.dtype not in _FLOATS:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not 1 <= m <= 128:
        raise ValueError(f"window m={m} outside [1, 128] (int8 lane positions)")


def _require_contiguous(**tensors: torch.Tensor | None) -> None:
    for name, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().vusa_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} ({msg})")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _value_kind(values: torch.Tensor, value_dtype: str) -> int:
    """The C interface's value kind: 0 fp32, 1 bf16, 2 int8, 3 int4."""
    if value_dtype == "dense":
        return int(values.dtype == torch.bfloat16)
    return 2 if value_dtype == "int8" else 3


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def vusa_packed_matmul(
    x: torch.Tensor,
    values: torch.Tensor,
    positions: torch.Tensor,
    scales: torch.Tensor | None = None,
    m: int = 128,
    value_dtype: str = "dense",
) -> torch.Tensor:
    """``y[b, t*m + l] = sum_k x[b, k] * sum_s values[t, k, s] * [positions[t, k, s] == l]``.

    x: (B, K) fp32/bf16; positions (T, K, S) int8 (-1 = idle slot); values
    (T, K, S) fp32/bf16 for ``value_dtype="dense"``, (T, K, S) int8 for
    ``"int8"``, (T, K, S/2) int8 nibble pairs for ``"int4"``, each slot then
    worth ``q * scales[t, k]`` (scales (T, K) fp32).  Returns (B, T*m) fp32.
    Row b of the result does not depend on B (bitwise): the launch plan
    (``row_plan``: ordered slices of the K rows) depends on K alone, and a
    plan with more than one slice gets an fp32 workspace from
    ``torch.empty`` and runs the rows in chunks whose partials fit it."""
    _check_x(x, m)
    _check_pack("vusa_packed_matmul", values, positions, x.shape[1], scales, value_dtype)
    operands = (x, values, positions) + (() if scales is None else (scales,))
    if _on_cpu(*operands):
        return vusa_packed_ref(x, values, positions, scales, m, value_dtype)
    _require_contiguous(x=x, values=values, positions=positions, scales=scales)
    b, k = x.shape
    t, _, s = positions.shape
    ncols = t * m
    pl = row_plan(k)
    out = torch.empty((b, ncols), dtype=torch.float32, device=x.device)
    part = torch.empty(workspace_bytes(pl, b, ncols) // 4, dtype=torch.float32, device=x.device)
    lib, kind, stream = _lib(), _value_kind(values, value_dtype), _stream(x.device)
    for r0, r1 in row_chunks(pl, b, ncols):
        err = lib.vusa_packed_matmul(
            x.data_ptr() + r0 * k * x.element_size(), int(x.dtype == torch.bfloat16),
            values.data_ptr(), kind, _ptr(scales), positions.data_ptr(),
            out.data_ptr() + r0 * ncols * 4, part.data_ptr(), r1 - r0, k, t, s, m, *pl, stream,
        )
        _raise_on(err, "vusa_packed_matmul")
    vusa_packed_matmul.launches[value_dtype] += 1
    return out


def vusa_fused_mlp_matmul(
    x: torch.Tensor,
    gate_values: torch.Tensor,
    gate_positions: torch.Tensor,
    up_values: torch.Tensor,
    up_positions: torch.Tensor,
    down_values: torch.Tensor,
    down_positions: torch.Tensor,
    gate_scales: torch.Tensor | None = None,
    up_scales: torch.Tensor | None = None,
    down_scales: torch.Tensor | None = None,
    m: int = 128,
    value_dtype: str = "dense",
) -> torch.Tensor:
    """Whole SwiGLU MLP ``silu(x @ Wg) * (x @ Wu) @ Wd`` over row-packed
    operands, all windowed over the same ff windows: gate/up (T, K, S) pack
    (K, ff), down (T, D, Sd) packs ``w_down`` transposed.  Quantized packs
    (``value_dtype`` ``"int8"``/``"int4"``) carry scales (T, K) for gate/up
    and (T, D) for down.  Returns (B, D) fp32.  The (B, ff) hidden state
    never reaches device memory; per-window (B, D) partials, in an fp32
    scratch from ``torch.empty``, are summed over windows in order in a
    second launch.  Row b of the result does not depend on B (bitwise): the
    launch plan (``mlp_plan``: ordered slices of the K and the D rows over
    a cluster's blocks) depends on K and D alone."""
    _check_x(x, m)
    k = x.shape[1]
    _check_pack("gate", gate_values, gate_positions, k, gate_scales, value_dtype)
    _check_pack("up", up_values, up_positions, k, up_scales, value_dtype)
    _check_pack("down", down_values, down_positions, down_positions.shape[1], down_scales,
                value_dtype)
    t = gate_positions.shape[0]
    if up_positions.shape[0] != t or down_positions.shape[0] != t:
        raise ValueError(
            f"window counts differ: gate {t}, up {up_positions.shape[0]}, "
            f"down {down_positions.shape[0]}"
        )
    if not gate_values.dtype == up_values.dtype == down_values.dtype:
        raise TypeError("gate/up/down values must share one dtype")
    packs = (gate_values, gate_positions, up_values, up_positions, down_values, down_positions)
    scales = (gate_scales, up_scales, down_scales)
    if _on_cpu(x, *packs, *(s for s in scales if s is not None)):
        return vusa_fused_mlp_ref(x, *packs, *scales, m, value_dtype)
    _require_contiguous(
        x=x, gate_values=gate_values, gate_positions=gate_positions, up_values=up_values,
        up_positions=up_positions, down_values=down_values, down_positions=down_positions,
        gate_scales=gate_scales, up_scales=up_scales, down_scales=down_scales,
    )
    b = x.shape[0]
    d = down_positions.shape[1]
    partial = torch.empty((t, b, d), dtype=torch.float32, device=x.device)
    out = torch.empty((b, d), dtype=torch.float32, device=x.device)
    err = _lib().vusa_fused_mlp_matmul(
        x.data_ptr(), int(x.dtype == torch.bfloat16), _value_kind(gate_values, value_dtype),
        gate_values.data_ptr(), _ptr(gate_scales), gate_positions.data_ptr(),
        gate_positions.shape[2],
        up_values.data_ptr(), _ptr(up_scales), up_positions.data_ptr(), up_positions.shape[2],
        down_values.data_ptr(), _ptr(down_scales), down_positions.data_ptr(),
        down_positions.shape[2],
        partial.data_ptr(), out.data_ptr(), b, k, d, t, m, *mlp_plan(k, d), _stream(x.device),
    )
    _raise_on(err, "vusa_fused_mlp_matmul")
    vusa_fused_mlp_matmul.launches[value_dtype] += 1
    return out


def reset_launch_counts() -> None:
    """Set every launch count of both wrappers to 0."""
    vusa_packed_matmul.launches = dict.fromkeys(VALUE_DTYPES, 0)
    vusa_fused_mlp_matmul.launches = dict.fromkeys(VALUE_DTYPES, 0)


_ENTRIES = ("vusa_packed_matmul", "vusa_fused_mlp_matmul", "empty_kernel")


def cuda_launches(entry: str) -> int:
    """CUDA launches the kernel library has issued since it was loaded, by
    the entry point ``entry`` (``"vusa_packed_matmul"``,
    ``"vusa_fused_mlp_matmul"`` or ``"empty_kernel"``).  The library counts
    each launch the runtime accepts; reading builds it on first use."""
    return int(_lib().vusa_packed_cuda_launches(_ENTRIES.index(entry)))


def empty_kernel(device: torch.device | str = "cuda") -> None:
    """Launch an empty kernel of this library on ``device``'s current
    stream: the floor of one launch under a timer."""
    _raise_on(_lib().vusa_packed_empty(_stream(torch.device(device))), "empty_kernel")


reset_launch_counts()
