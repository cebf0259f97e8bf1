"""Training step: loss -> grads -> AdamW, with optional gradient-accumulation
microbatching and int8 gradient compression (stochastic rounding keeps it
unbiased).

Port of the JAX package's ``train/step.py``.  The step is one function of
``(params, opt, batch)`` that updates the parameters and the optimizer state
in place (``optim.adamw``) and returns them with the step's metrics.  The
compression noise comes from a ``torch.Generator`` seeded by ``(0, step)``;
it cannot reproduce the reference's threefry draws (ROADMAP.md C3), so a
compressed run trains alike but not bit for bit.

On a mesh (``make_train_step(..., mesh=, placements=, plan=)``) the
parameters and both AdamW moments are each rank's shards under
``placements`` (ZeRO-style: the moments follow the parameters), and the
step runs under the family's training plan (``dist.tp.training_plan``,
one for every mesh of more than one rank; on a ``model`` axis of 1 it
splits nothing over ``model``).  No rank gathers the tree (ROADMAP A12
item 4): the forward gathers each layer's ``data``-sharded leaves where
the layer runs (``TPPlan.layer``; the top-level leaves where they are
read, ``TPPlan.top``); under ``cfg.remat`` a layer's gathered leaves are
dropped after its forward and gathered again in its recompute (without
remat autograd keeps them for the backward, as it keeps the
activations).  With ``split`` (the batch rows split over the pure data axes,
``("pod", "data")``) the backward of each of those gathers is a
reduce-scatter in rank order (``comm.gather_data``): the gradient arrives
summed over the data ranks in their flattened rank order, pod-major,
divided by their count, and cut to this rank's shard; the loss and the
gradients of the leaves no ``data`` dim holds are summed alike once a step
(``_data_sum``).  The moe family's routing then counts over the whole
batch, as the reference's program over the global batch does
(``models.common.mesh_context``'s ``rows``, ``layers.moe``).  The forward
and the backward run on this rank's ``model`` shards where the plan splits
them, so the gradients are this rank's shards of every leaf.  The global
norm is the ordered sum over every mesh axis of size > 1 of the split
leaves' squares (each counted on the ranks of its distinct shards) plus
the replicated leaves' once: one device's within rounding, the same scalar
on every rank.  With ``microbatches=1``, no compression and no clip a
step gives the bits of gathering the tree, summing the rows' gradients in
rank order and cutting them to the shards (``tests/test_torch_fsdp.py``).
``grad_compress`` takes each leaf's scale from the largest |g| over every
axis (exact) and draws the noise of the whole leaf from the step's
generator, one leaf at a time, keeping this rank's slice: one device's
compressed step within rounding.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from ..optim import AdamState, adamw_update
from ..optim.adamw import tree_items
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
    loss = loss_fn(_tree(paths, live), batch)
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), [g.float() for g in grads]


def make_train_step(loss_fn: Callable, hp: TrainHParams, mesh=None, placements=None,
                    split: bool = False, plan=None):
    """``loss_fn(params, batch) -> scalar``.  Returns ``step(params, opt,
    batch, return_grads=False) -> (params, opt, {"loss", "gnorm", "lr"})``;
    params and opt are updated in place and returned.  With ``mesh``,
    ``params`` and ``opt`` are this rank's shards under ``placements``,
    ``batch`` is its rows (``split``) or the whole batch, and ``plan`` is
    the family's training plan (see the module docstring).
    ``return_grads`` adds ``"grads"``: the gradients the update clips (after
    the sum over the data ranks and the compression), this rank's shards
    under ``placements`` (whole on one device), in ``tree_items`` order."""
    from ..dist.sharding import _batch_axes
    from ..models.common import mesh_context

    if mesh is not None and plan is None:
        raise ValueError("a step on a mesh runs under its training plan "
                         "(dist.tp.training_plan(cfg, mesh))")
    # the axes this rank's rows were cut over, for the moe routing and the
    # reduce-scatters of the gathered leaves' gradients
    rows = (mesh, _batch_axes(mesh)) if split else None

    def step(params: dict, opt: AdamState, batch: dict, return_grads: bool = False):
        t = int(opt.step)  # the lr of this update: the count before it
        lr = cosine_schedule(t, hp.warmup, hp.total_steps, hp.lr)
        if plan is not None:
            return _sharded_step(params, opt, batch, lr, t, return_grads)
        loss, grads = _accumulate(params, batch)
        if hp.grad_compress:
            grads = compress_grads(grads, t)
        kept = grads if return_grads else None
        params, opt, gnorm = adamw_update(params, grads, opt, lr,
                                          weight_decay=hp.weight_decay,
                                          max_grad_norm=hp.max_grad_norm)
        return params, opt, _metrics(loss, gnorm, lr, kept)

    def _accumulate(params, batch):
        """(loss, fp32 grads) of ``batch``, over ``hp.microbatches`` slices
        of its leading dim when above 1: the grads summed in order and
        divided, the losses averaged."""
        if hp.microbatches == 1:
            return _value_and_grad(loss_fn, params, batch)
        n = hp.microbatches
        gsum, losses = None, []
        for i in range(n):
            mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i] for k, v in batch.items()}
            loss, g = _value_and_grad(loss_fn, params, mb)
            gsum = g if gsum is None else [a + b for a, b in zip(gsum, g)]
            losses.append(loss)
        return torch.stack(losses).mean(), [g / n for g in gsum]

    def _data_sum(grads, loss, which):
        """The loss and the gradients ``which`` (indices) summed over the pure
        data axes in flattened rank order and divided by their count, when
        the batch rows split over them: one ordered sum of one buffer (an
        elementwise sum, so the bits of one sum a tensor)."""
        if not split:
            return grads, loss
        from ..dist.comm import axis_size, sum_in_rank_order

        axes = _batch_axes(mesh)
        n = math.prod(axis_size(mesh, a) for a in axes)
        parts = [loss.reshape(1)] + [grads[i].reshape(-1) for i in which]
        total = sum_in_rank_order(torch.cat(parts), mesh, axes) / n
        grads, off = list(grads), 1
        for i in which:
            grads[i] = total[off:off + grads[i].numel()].view_as(grads[i])
            off += grads[i].numel()
        return grads, total[0]

    def _global_norm(grads, pls):
        """The global norm of the gradients from this rank's shards: each
        split leaf's squares counted on the ranks of its distinct shards
        (coordinate 0 on every axis its placement leaves whole), summed
        over every axis in rank order, plus the replicated leaves' once."""
        from ..dist.comm import axis_index, mesh_shape, sum_in_rank_order
        from ..dist.sharding import _names

        axes = tuple(mesh_shape(mesh))
        coord = {a: axis_index(mesh, a) for a in axes}
        zero = torch.zeros((), device=grads[0].device)
        parts, rest = zero, zero
        for g, pl in zip(grads, pls):
            used = {a for e in pl for a in _names(e)}
            q = g.float().square().sum()
            if not used:
                rest = rest + q
            elif all(i == 0 for a, i in coord.items() if a not in used):
                parts = parts + q
        return torch.sqrt(sum_in_rank_order(parts, mesh, axes) + rest)

    def _sharded_step(shards, opt, batch, lr, t, return_grads):
        """The step of a rank's ``shards`` under the plan (module
        docstring)."""
        spec = dict(tree_items(placements))
        pls = [spec[p] for p, _ in tree_items(shards)]
        with mesh_context(mesh, plan, rows):
            loss, grads = _accumulate(shards, batch)
        grads, loss = _data_sum(grads, loss, [i for i, pl in enumerate(pls) if "data" not in pl])
        if hp.grad_compress:
            grads = _sharded_compress(grads, pls, t)
        gnorm = _global_norm(grads, pls)
        kept = list(grads) if return_grads else None
        if not math.isinf(hp.max_grad_norm):  # else the scale is exactly 1: no copy
            scale = torch.clamp(hp.max_grad_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
            for i in range(len(grads)):  # each leaf replaced, so one extra leaf at a time
                grads[i] = grads[i] * scale
        # each gradient dropped once its leaf is updated, the largest leaves last
        shards, opt, _ = adamw_update(shards, grads, opt, lr, weight_decay=hp.weight_decay,
                                      max_grad_norm=float("inf"), consume=True)
        return shards, opt, _metrics(loss, gnorm, lr, kept)

    def _sharded_compress(grads, pls, t):
        """``compress_grads`` of sharded gradients: each leaf's scale from the
        largest |g| over every axis (one gather an axis of every leaf's
        local maximum), the noise of the whole leaf drawn from the step's
        generator in leaf order and cut to this rank's shard."""
        from ..dist.comm import gather_axes, mesh_shape
        from ..dist.sharding import _names, local_shard

        seed = int(np.random.SeedSequence((0, t)).generate_state(1)[0])
        gen = torch.Generator(device=grads[0].device).manual_seed(seed)
        local_max = torch.stack([g.float().abs().max() for g in grads])
        top = gather_axes(local_max, mesh, tuple(mesh_shape(mesh))).amax(dim=0)
        sizes = mesh_shape(mesh)
        out = []
        for g, pl, mx in zip(grads, pls, top):
            shape = [n * math.prod(sizes[a] for a in _names(e)) for n, e in zip(g.shape, pl)]
            noise = local_shard(torch.rand(shape, generator=gen, device=g.device) - 0.5, pl,
                                mesh)
            scale = torch.clamp_min(mx, 1e-12) / 127.0
            xi = torch.clamp(torch.round(g.float() / scale + noise), -127, 127).to(torch.int8)
            out.append(xi.float() * scale)
        return out

    return step


def _tree(paths, leaves) -> dict:
    """The nested dict of ``leaves`` at ``paths`` (``tree_items``'s)."""
    tree: dict = {}
    for path, t in zip(paths, leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return tree


def _metrics(loss, gnorm, lr, grads) -> dict:
    out = {"loss": loss, "gnorm": gnorm, "lr": lr}
    if grads is not None:
        out["grads"] = grads
    return out
