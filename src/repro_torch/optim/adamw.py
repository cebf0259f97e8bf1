"""AdamW + global-norm clipping on nested parameter dicts.

Port of the JAX package's ``optim/adamw.py``.  The optimizer state mirrors
the parameter tree (fp32 moments), and the update runs in place: the
parameters, the moments and the step counter are overwritten, so a step
holds one copy of the weights on the card.  Leaves are visited in sorted
key order, the order ``jax.tree_util`` flattens a dict in, so the global
norm sums the leaves as the reference does.

As in the reference, decoupled weight decay goes on every leaf with
``ndim >= 2``: with the leading layer axis that includes the stacked norm
scales ``(L, d)`` and the embedding, not only the matrices.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Iterator, NamedTuple, Tuple

import torch

__all__ = ["AdamState", "adamw_init", "adamw_update", "clip_by_global_norm", "tree_items"]


class AdamState(NamedTuple):
    step: torch.Tensor  # int32 scalar: updates taken so far
    mu: dict
    nu: dict


def tree_items(tree: dict, prefix: Tuple[str, ...] = ()) -> Iterator[tuple]:
    """``(path, leaf)`` of a nested dict (or any nested ``Mapping``, such as
    a ``dist.tp.WholeView``, whose leaves are then read one at a time in
    this order), keys sorted at every level."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, Mapping):
            yield from tree_items(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _zeros_like(tree: dict) -> dict:
    return {k: _zeros_like(v) if isinstance(v, dict)
            else torch.zeros_like(v, dtype=torch.float32) for k, v in tree.items()}


def adamw_init(params: dict) -> AdamState:
    device = next(leaf for _, leaf in tree_items(params)).device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     mu=_zeros_like(params), nu=_zeros_like(params))


@torch.no_grad()
def clip_by_global_norm(grads: list, max_norm: float) -> Tuple[list, torch.Tensor]:
    """``grads`` is a list of leaves; returns (scaled leaves, global norm).
    With ``max_norm`` infinite the scale is exactly 1 and ``grads`` itself
    is returned (no copy of every gradient)."""
    gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    if math.isinf(max_norm):
        return grads, gnorm
    scale = torch.clamp(max_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    return [g * scale for g in grads], gnorm


@torch.no_grad()
def adamw_update(
    params: dict,
    grads: list,
    state: AdamState,
    lr: float,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_grad_norm: float = 1.0,
    consume: bool = False,
):
    """One AdamW step in place.  ``grads`` are the leaves of ``params`` in
    :func:`tree_items` order.  Returns ``(params, state, gnorm)``, the same
    objects, updated.  With ``consume`` (and ``max_grad_norm`` infinite, so
    the list is the caller's) the leaves are updated smallest first and
    each entry of ``grads`` is set to None once its leaf is updated: the
    largest leaves' temporaries then meet the fewest gradients still held
    (each leaf's update is its own, so the bits are the same in any
    order)."""
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    state.step.add_(1)
    step = state.step.float()
    c1 = 1.0 - torch.pow(b1, step)
    c2 = 1.0 - torch.pow(b2, step)
    leaves = list(zip(tree_items(params), tree_items(state.mu), tree_items(state.nu)))
    order = range(len(leaves))
    if consume:
        order = sorted(order, key=lambda i: grads[i].numel())
    for i in order:
        (_, p), (_, m), (_, v) = leaves[i]
        g = grads[i].float()
        if consume:
            grads[i] = None
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        delta = (m / c1) / (torch.sqrt(v / c2) + eps)
        if p.ndim >= 2:  # decoupled weight decay on every leaf of rank >= 2
            delta = delta + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, state, gnorm
