"""Parameter trees between numpy and the port.

The JAX package's parameter pytree, fetched as numpy arrays (for example
``jax.tree_util.tree_map(numpy.asarray, params)``), becomes the port's
nested dict of tensors with the same keys and shapes, so both packages
compute the same function on the same weights.  ``params_to_numpy`` is the
inverse, for tests.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["params_from_numpy", "params_to_numpy"]


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
