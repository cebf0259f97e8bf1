"""Magnitude pruning — the sparsity source for VUSA (paper Section II-B).

Port of the JAX package's ``core/pruning.py`` on tensors and on nested
parameter dicts, with the same semantics: keep ``k = round((1-s) * size)``
entries, the threshold is the k-th largest ``|w|`` over the *whole* leaf
(for layer-stacked weights, across all layers at once), and every entry with
``|w| >= threshold`` survives (ties keep extra).
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["magnitude_mask", "prune", "prune_tree", "tree_sparsity"]


def magnitude_mask(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Boolean keep-mask zeroing the ``sparsity`` fraction of smallest |w|."""
    if sparsity <= 0.0:
        return torch.ones_like(w, dtype=torch.bool)
    if sparsity >= 1.0:
        return torch.zeros_like(w, dtype=torch.bool)
    n = w.numel()
    k = max(int(round((1.0 - sparsity) * n)), 1)
    mag = w.abs()
    # k-th largest magnitude == (n - k + 1)-th smallest
    thresh = torch.kthvalue(mag.reshape(-1), n - k + 1).values
    return mag >= thresh


def prune(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    return torch.where(magnitude_mask(w, sparsity), w, torch.zeros_like(w))


def _prunable(path: tuple, leaf) -> bool:
    """Prune 2-D+ weight matrices; never biases/norm scales/embeddings."""
    if getattr(leaf, "ndim", 0) < 2:
        return False
    name = "/".join(str(p) for p in path).lower()
    return not any(s in name for s in ("embed", "norm", "scale", "bias", "router"))


def _walk(tree, path=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _walk(val, path + (key,))
        else:
            yield path + (key,), val


def prune_tree(params: dict, sparsity: float, prunable: Callable = _prunable) -> dict:
    """Magnitude-prune every prunable leaf of a nested parameter dict
    (returns a new dict; the input is not modified)."""

    def f(tree, path):
        return {
            key: f(val, path + (key,)) if isinstance(val, dict)
            else (prune(val, sparsity) if prunable(path + (key,), val) else val)
            for key, val in tree.items()
        }

    return f(params, ())


def tree_sparsity(params: dict) -> float:
    """Global fraction of exactly-zero entries across prunable leaves."""
    zeros, total = 0, 0
    for path, leaf in _walk(params):
        if _prunable(path, leaf):
            zeros += int((leaf == 0).sum())
            total += leaf.numel()
    return zeros / max(total, 1)
