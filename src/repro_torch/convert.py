"""Parameter trees between numpy and the port.

The JAX package's parameter pytree, fetched as numpy arrays (for example
``jax.tree_util.tree_map(numpy.asarray, params)``), becomes the port's
nested dict of tensors with the same keys and shapes, so both packages
compute the same function on the same weights.  ``params_to_numpy`` is the
inverse, for tests.  ``adam_state_from_numpy`` / ``adam_state_to_numpy``
carry an AdamW state (step, mu, nu) across the same way, so both packages
can start training from one state.  ``packed_linear_from_numpy`` carries a block-VUSA pack
(the reference's ``kernels.ops.PackedLinear``, fetched as numpy) across.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .kernels.ops import PackedLinear
from .optim import AdamState

__all__ = ["params_from_numpy", "params_to_numpy", "adam_state_from_numpy",
           "adam_state_to_numpy", "packed_linear_from_numpy"]


def params_from_numpy(tree: dict, device="cuda", dtype: Optional[torch.dtype] = None) -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``
    (copies; ``dtype`` casts every floating leaf when given)."""

    def leaf(a):
        t = torch.from_numpy(np.array(a, copy=True))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return {k: params_from_numpy(v, device, dtype) if isinstance(v, dict) else leaf(v)
            for k, v in tree.items()}


def params_to_numpy(params: dict) -> dict:
    """Nested dict of tensors -> nested dict of numpy arrays (fp32 for bf16
    leaves, which numpy cannot hold)."""

    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return {k: params_to_numpy(v) if isinstance(v, dict) else leaf(v) for k, v in params.items()}


def adam_state_from_numpy(state, device="cuda") -> AdamState:
    """An AdamW state as numpy (anything with ``step``, ``mu`` and ``nu``:
    the reference's ``AdamState`` fetched with ``numpy.asarray`` leaf by
    leaf) -> the port's :class:`AdamState` on ``device`` (an int32 step)."""
    step = torch.from_numpy(np.array(state.step, dtype=np.int32).reshape(())).to(device)
    return AdamState(step=step, mu=params_from_numpy(state.mu, device),
                     nu=params_from_numpy(state.nu, device))


def adam_state_to_numpy(state: AdamState) -> dict:
    """The port's AdamW state -> ``{"step": int32 array, "mu": ..., "nu":
    ...}`` of numpy arrays (the reference's ``AdamState(**d)``)."""
    return {"step": np.asarray(state.step.cpu().numpy(), dtype=np.int32),
            "mu": params_to_numpy(state.mu), "nu": params_to_numpy(state.nu)}


def packed_linear_from_numpy(
    values, row_idx, k: int, c: int, k_padded: int, device="cuda"
) -> PackedLinear:
    """A block-VUSA pack as numpy (values (T, J, A, Tn), row_idx (T, J, A))
    -> the port's :class:`PackedLinear` on ``device``.  Values land as fp32,
    row indices as int32; an index outside the padded K raises, since the
    kernel would read outside x."""
    vals = np.asarray(values, dtype=np.float32)
    idx = np.asarray(row_idx)
    if vals.ndim != 4 or idx.shape != vals.shape[:3]:
        raise ValueError(
            f"values {vals.shape} / row_idx {idx.shape} are not (T, J, A, Tn) / (T, J, A)"
        )
    if not np.issubdtype(idx.dtype, np.integer):
        raise TypeError(f"row_idx must be integers, got {idx.dtype}")
    bound = max(k_padded, k)
    if idx.size and (idx.min() < 0 or idx.max() >= bound):
        raise ValueError(f"row_idx outside [0, {bound})")
    return PackedLinear(
        values=torch.from_numpy(np.array(vals, copy=True)).to(device),
        row_idx=torch.from_numpy(idx.astype(np.int32)).to(device),
        k=k, c=c, k_padded=k_padded,
    )
