"""Training step: loss -> grads -> AdamW, with optional gradient-accumulation
microbatching and int8 gradient compression (stochastic rounding keeps it
unbiased).

Port of the JAX package's ``train/step.py``.  The step is one function of
``(params, opt, batch)`` that updates the parameters and the optimizer state
in place (``optim.adamw``) and returns them with the step's metrics.  The
compression noise comes from a ``torch.Generator`` seeded by ``(0, step)``;
it cannot reproduce the reference's threefry draws (ROADMAP.md C3), so a
compressed run trains alike but not bit for bit.

On a mesh (``make_train_step(..., mesh=, placements=)``) the parameters
and both AdamW moments are each rank's shards under ``placements``
(ZeRO-style: the moments follow the parameters).  A step gathers the
parameters whole for the forward, so it is the single-device program on
this rank's rows of the batch; with ``split`` (the batch rows split over
the pure data axes, ``("pod", "data")``) the gradients and the loss are
summed over those ranks in their flattened rank order, pod-major, and
divided by their count.  The global-norm clip runs on the
whole gradients in the single-device order, and each rank then updates
only its shard.  On a ``model`` axis alone the step is the single-device
step bitwise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from ..optim import AdamState, adamw_update
from ..optim.adamw import clip_by_global_norm, tree_items
from ..optim.schedule import cosine_schedule

__all__ = ["TrainHParams", "make_train_step", "compress_grads"]


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    microbatches: int = 1  # gradient accumulation over the leading batch dim
    grad_compress: bool = False  # int8 + stochastic rounding before the update


def compress_grads(grads: list, step: int) -> list:
    """int8-quantize each tensor (symmetric, per-tensor scale ``max|g|/127``,
    stochastic rounding with uniform noise in [-0.5, 0.5)), dequantize."""
    seed = int(np.random.SeedSequence((0, step)).generate_state(1)[0])
    gen = torch.Generator(device=grads[0].device).manual_seed(seed)
    out = []
    for g in grads:
        g32 = g.float()
        scale = torch.clamp_min(g32.abs().max(), 1e-12) / 127.0
        noise = torch.rand(g.shape, generator=gen, device=g.device) - 0.5
        xi = torch.clamp(torch.round(g32 / scale + noise), -127, 127).to(torch.int8)
        out.append(xi.float() * scale)
    return out


def _value_and_grad(loss_fn: Callable, params: dict, batch: dict):
    """(loss, fp32 grads of every leaf in ``tree_items`` order)."""
    paths, leaves = zip(*tree_items(params))
    live = [p.detach().requires_grad_(True) for p in leaves]
    tree: dict = {}
    for path, t in zip(paths, live):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    loss = loss_fn(tree, batch)
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), [g.float() for g in grads]


def make_train_step(loss_fn: Callable, hp: TrainHParams, mesh=None, placements=None,
                    split: bool = False):
    """``loss_fn(params, batch) -> scalar``.  Returns ``step(params, opt,
    batch) -> (params, opt, {"loss", "gnorm", "lr"})``; params and opt are
    updated in place and returned.  With ``mesh``, ``params`` and ``opt``
    are this rank's shards under ``placements`` and ``batch`` is its rows
    (``split``) or the whole batch (see the module docstring)."""

    def step(params: dict, opt: AdamState, batch: dict):
        t = int(opt.step)  # the lr of this update: the count before it
        lr = cosine_schedule(t, hp.warmup, hp.total_steps, hp.lr)
        shards = None
        if mesh is not None:
            from ..dist.sharding import gather_tree

            shards, params = params, gather_tree(params, placements, mesh)
        if hp.microbatches > 1:
            n = hp.microbatches
            gsum, losses = None, []
            for i in range(n):
                mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                      for k, v in batch.items()}
                loss, g = _value_and_grad(loss_fn, params, mb)
                gsum = g if gsum is None else [a + b for a, b in zip(gsum, g)]
                losses.append(loss)
            grads = [g / n for g in gsum]
            loss = torch.stack(losses).mean()
        else:
            loss, grads = _value_and_grad(loss_fn, params, batch)
        if shards is not None:
            return _sharded_update(shards, params, grads, loss, opt, lr, t)
        if hp.grad_compress:
            grads = compress_grads(grads, t)
        params, opt, gnorm = adamw_update(params, grads, opt, lr,
                                          weight_decay=hp.weight_decay,
                                          max_grad_norm=hp.max_grad_norm)
        return params, opt, {"loss": loss, "gnorm": gnorm, "lr": lr}

    def _sharded_update(shards, whole, grads, loss, opt, lr, t):
        """The update of a rank's ``shards`` from the gradients of the
        ``whole`` parameters: summed over the data ranks in rank order when
        the batch rows split, clipped whole, then cut to the rank's shards
        (the clip already applied, ``adamw_update`` scales them by 1)."""
        from ..dist.comm import axis_size, sum_in_rank_order
        from ..dist.sharding import _batch_axes, local_shard

        if split:
            axes = _batch_axes(mesh)
            n = math.prod(axis_size(mesh, a) for a in axes)
            grads = [sum_in_rank_order(g, mesh, axes) / n for g in grads]
            loss = sum_in_rank_order(loss, mesh, axes) / n
        if hp.grad_compress:
            grads = compress_grads(grads, t)
        grads, gnorm = clip_by_global_norm(grads, hp.max_grad_norm)
        spec = dict(tree_items(placements))
        local = [local_shard(g, spec[path], mesh)
                 for (path, _), g in zip(tree_items(whole), grads)]
        shards, opt, _ = adamw_update(shards, local, opt, lr, weight_decay=hp.weight_decay,
                                      max_grad_norm=float("inf"))
        return shards, opt, {"loss": loss, "gnorm": gnorm, "lr": lr}

    return step
