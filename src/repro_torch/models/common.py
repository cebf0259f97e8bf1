"""Model plumbing: parameter specs, a numpy-seeded init, norms and RoPE.

Port of the JAX package's ``models/common.py``.  Parameters are nested
dicts of tensors with the reference's layout, described by a tree of
:class:`ParamSpec` leaves.  ``jax.random`` cannot be reproduced in torch,
so :func:`init_params` draws from a seeded numpy generator with the
reference's std rule (``scale / sqrt(shape[-2])``); parameters exported from
the reference load through :func:`repro_torch.convert.params_from_numpy`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["ParamSpec", "init_params", "abstract_params", "rms_norm", "layer_norm", "rope", "apply_rope",
           "strict_fp32", "per_row", "mesh_context", "current_mesh", "current_tp", "current_rows",
           "current_context"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Abstract description of one parameter tensor (fp32 by default, as in
    the reference: only activations take the config's dtype)."""

    shape: Tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones
    scale: float = 1.0
    # logical axis names, one per dim (None: never sharded), read by the
    # mesh rules of ``dist/sharding.py``; empty means all None
    axes: Tuple[Optional[str], ...] = ()

    def __post_init__(self):
        if not self.axes:
            object.__setattr__(self, "axes", (None,) * len(self.shape))
        if len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} do not match shape {self.shape}")


def _init_leaf(spec: ParamSpec, rng: np.random.Generator) -> np.ndarray:
    if spec.init == "zeros":
        return np.zeros(spec.shape, np.float32)
    if spec.init == "ones":
        return np.ones(spec.shape, np.float32)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = np.float32(spec.scale / math.sqrt(max(fan_in, 1)))
    return rng.standard_normal(spec.shape, dtype=np.float32) * std


def init_params(spec_tree: dict, seed: int, device, leaf=None) -> dict:
    """Random parameters from a ParamSpec tree, drawn from
    ``numpy.random.default_rng(seed)`` leaf by leaf in the tree's key order;
    ``leaf(path, tensor)``, when given, maps each whole leaf (on the host)
    before it moves to ``device``."""
    rng = np.random.default_rng(seed)

    def build(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = build(v, path + (k,))
                continue
            t = torch.from_numpy(_init_leaf(v, rng))
            out[k] = (t if leaf is None else leaf(path + (k,), t)).to(device)
        return out

    return build(spec_tree, ())


def abstract_params(spec_tree: dict) -> dict:
    """The parameter tree of ``spec_tree`` as ``meta`` tensors: shapes and
    dtypes with no storage, for tracing a step without allocating it
    (``launch/dryrun.py``; the reference's ``ShapeDtypeStruct`` tree)."""
    return {k: abstract_params(v) if isinstance(v, dict)
            else torch.empty(v.shape, dtype=torch.float32, device="meta")
            for k, v in spec_tree.items()}


def strict_fp32() -> None:
    """Full-precision fp32 matmuls on the card.  PyTorch's default already
    keeps TF32 off for matmuls, but the flag is process-wide and any library
    may flip it; the reference computes in true fp32, so the port sets it
    explicitly at the entry points that own the precision policy
    (``Engine``, the serve launcher and ``chip_smoke.py``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --------------------------------------------------------------------------
# Mesh context
# --------------------------------------------------------------------------

_ctx = threading.local()


@contextlib.contextmanager
def mesh_context(mesh, tp=None, rows=None):
    """Install ``mesh`` for the code inside: the layers that act on a mesh
    (``layers._maybe_seq_sharded_attention``) read it through
    :func:`current_mesh`, and the tensor-parallel layers read ``tp``, the
    serving engine's or the trainer's ``dist.tp.TPPlan`` (its splits and
    storage placements), through :func:`current_tp`.  ``rows``: ``(mesh,
    axes)`` when the caller cut the batch rows of this call over those mesh
    axes, each rank computing its own (``Engine.generate`` and the trainer
    on a data axis); the moe routing reads it through
    :func:`current_rows` to count over the whole batch, as the reference's
    program over the global batch does (``layers.moe``).  The reference's
    context also carries activation rules for its sharding constraints; in
    the port each rank computes on tensors it holds whole or as its shard,
    placed where they are made (``dist/sharding.py``), so there is nothing
    to constrain."""
    prev = current_context()
    _ctx.mesh, _ctx.tp, _ctx.rows = mesh, tp, rows
    try:
        yield
    finally:
        _ctx.mesh, _ctx.tp, _ctx.rows = prev


def current_mesh():
    """The mesh of the innermost ``mesh_context``, or None."""
    return getattr(_ctx, "mesh", None)


def current_tp():
    """The tensor-parallel plan of the innermost ``mesh_context``, or None
    (one device, or a step on gathered parameters)."""
    return getattr(_ctx, "tp", None)


def current_rows():
    """``(mesh, axes)`` of the innermost ``mesh_context`` whose caller split
    the batch rows over ``axes``, or None."""
    return getattr(_ctx, "rows", None)


def current_context() -> tuple:
    """``(mesh, tp, rows)`` of the innermost ``mesh_context``: what a
    recompute on another thread installs again (``families._remat_fn``)."""
    return current_mesh(), current_tp(), current_rows()


# --------------------------------------------------------------------------
# Norms / RoPE
# --------------------------------------------------------------------------


def per_row(fn, x: torch.Tensor, rowwise: bool) -> torch.Tensor:
    """``fn(x)``, or with ``rowwise`` ``fn`` of each batch row alone,
    concatenated.  Each row then goes through exactly the call a batch of
    one makes, shapes included, so its bits are the B = 1 result's.  A GEMM
    or a reduction over B rows is not bitwise the B one-row calls: the
    library picks its kernel, and so its order of operations, by shape.
    Elementwise operations need no such care."""
    if not rowwise or x.shape[0] == 1:
        return fn(x)
    return torch.cat([fn(x[b : b + 1]) for b in range(x.shape[0])])


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             rowwise: bool = False) -> torch.Tensor:
    """RMSNorm in fp32 with the reference's ``(1 + scale)`` gain.  With
    ``rowwise`` the mean, the one reduction, runs one batch row at a time
    (``per_row``)."""
    dtype = x.dtype
    x = x.float()
    var = per_row(lambda r: r.mean(dim=-1, keepdim=True), x.square(), rowwise)
    return (x * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32 (biased variance), as the reference's: no family
    of either package calls it; the encdec family normalises with
    :func:`rms_norm` throughout."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


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
