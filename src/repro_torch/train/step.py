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
(ZeRO-style: the moments follow the parameters).  With no plan (a
``model`` axis of 1: the per-layer gather of ROADMAP A12 item 4 is still
to come) a step gathers the parameters whole for the forward, so it is
the single-device program on this rank's rows of the batch; with
``split`` (the batch rows split over the pure data axes, ``("pod",
"data")``) the gradients and the loss are summed over those ranks in
their flattened rank order, pod-major, and
divided by their count; the moe family's routing then counts over the
whole batch, as the reference's program over the global batch does
(``models.common.mesh_context``'s ``rows``, ``layers.moe``).  The
global-norm clip runs on the whole gradients in the single-device order,
and each rank then updates only its shard.  On a ``model`` axis alone the
step is the single-device step bitwise.

With a tensor-parallel plan (``plan=``, ``dist.tp.training_plan``: every
family on a ``model`` axis above 1, the encdec family's encoder and
decoder included) no rank gathers the tree: the step gathers every
``data``-sharded leaf over ``data`` once (one
``comm.gather_leaves`` a dtype), runs the forward and the backward under
the plan (``models.common.mesh_context``), so the gradients are this
rank's ``model`` shards, sums them over the data ranks as above and cuts
them to its ``data`` shards.  The global norm is the ordered sum over
``model`` of the ``model``-sharded leaves' squares plus the replicated
leaves' once: one device's within rounding, the same scalar on every
rank.  ``grad_compress`` takes each leaf's scale from the largest |g| over
``model`` (exact) and draws the noise of the whole leaf from the step's
generator, one leaf at a time, keeping this rank's slice: one device's
compressed step within rounding.
"""

from __future__ import annotations

import contextlib
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
    loss = loss_fn(_tree(paths, live), batch)
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), [g.float() for g in grads]


def make_train_step(loss_fn: Callable, hp: TrainHParams, mesh=None, placements=None,
                    split: bool = False, plan=None):
    """``loss_fn(params, batch) -> scalar``.  Returns ``step(params, opt,
    batch, return_grads=False) -> (params, opt, {"loss", "gnorm", "lr"})``;
    params and opt are updated in place and returned.  With ``mesh``,
    ``params`` and ``opt`` are this rank's shards under ``placements`` and
    ``batch`` is its rows (``split``) or the whole batch; with ``plan`` the
    step is tensor-parallel (see the module docstring).  ``return_grads``
    adds ``"grads"``: the gradients the update clips (after the sum over
    the data ranks and the compression), this rank's shards under
    ``placements`` (whole on one device), in ``tree_items`` order."""
    from ..dist.sharding import _batch_axes
    from ..models.common import mesh_context

    # the axes this rank's rows were cut over, for the moe routing
    rows = (mesh, _batch_axes(mesh)) if split else None

    def step(params: dict, opt: AdamState, batch: dict, return_grads: bool = False):
        t = int(opt.step)  # the lr of this update: the count before it
        lr = cosine_schedule(t, hp.warmup, hp.total_steps, hp.lr)
        if plan is not None:
            return _tp_step(params, opt, batch, lr, t, return_grads)
        shards = None
        if mesh is not None:
            from ..dist.sharding import gather_tree

            shards, params = params, gather_tree(params, placements, mesh)
        with contextlib.nullcontext() if rows is None else mesh_context(None, None, rows):
            loss, grads = _accumulate(params, batch)
        if shards is not None:
            return _sharded_update(shards, params, grads, loss, opt, lr, t, return_grads)
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

    def _data_sum(grads, loss):
        """The gradients and the loss summed over the pure data axes in
        flattened rank order and divided by their count, when the batch
        rows split over them."""
        if not split:
            return grads, loss
        from ..dist.comm import axis_size, sum_in_rank_order
        from ..dist.sharding import _batch_axes

        axes = _batch_axes(mesh)
        n = math.prod(axis_size(mesh, a) for a in axes)
        return ([sum_in_rank_order(g, mesh, axes) / n for g in grads],
                sum_in_rank_order(loss, mesh, axes) / n)

    def _sharded_update(shards, whole, grads, loss, opt, lr, t, return_grads):
        """The update of a rank's ``shards`` from the gradients of the
        ``whole`` parameters: summed over the data ranks in rank order when
        the batch rows split, clipped whole, then cut to the rank's shards
        (the clip already applied, ``adamw_update`` scales them by 1)."""
        from ..dist.sharding import local_shard

        grads, loss = _data_sum(grads, loss)
        if hp.grad_compress:
            grads = compress_grads(grads, t)
        spec = dict(tree_items(placements))
        cut = [spec[path] for path, _ in tree_items(whole)]
        kept = [local_shard(g, pl, mesh) for g, pl in zip(grads, cut)] if return_grads else None
        grads, gnorm = clip_by_global_norm(grads, hp.max_grad_norm)
        local = [local_shard(g, pl, mesh) for g, pl in zip(grads, cut)]
        shards, opt, _ = adamw_update(shards, local, opt, lr, weight_decay=hp.weight_decay,
                                      max_grad_norm=float("inf"))
        return shards, opt, _metrics(loss, gnorm, lr, kept)

    def _tp_step(shards, opt, batch, lr, t, return_grads):
        """The tensor-parallel step of a rank's ``shards`` (module
        docstring)."""
        from ..dist.comm import gather_leaves, sum_in_rank_order
        from ..dist.sharding import local_shard

        paths, leaves = zip(*tree_items(shards))
        spec = dict(tree_items(placements))
        pls = [spec[p] for p in paths]
        held = list(leaves)
        on_data = [i for i, pl in enumerate(pls) if "data" in pl]
        for dtype in sorted({held[i].dtype for i in on_data}, key=str):
            idx = [i for i in on_data if held[i].dtype == dtype]
            whole = gather_leaves([held[i] for i in idx], [pls[i].index("data") for i in idx],
                                  mesh, "data")
            for i, w in zip(idx, whole):
                held[i] = w
        with mesh_context(mesh, plan, rows):
            loss, grads = _accumulate(_tree(paths, held), batch)
        del held
        grads, loss = _data_sum(grads, loss)
        model_pl = [tuple(a if a == "model" else None for a in pl) for pl in pls]
        if hp.grad_compress:
            grads = _tp_compress(grads, model_pl, t)
        split_model = ["model" in pl for pl in model_pl]
        sq = [g.float().square().sum() for g in grads]
        parts = sum((q for q, m in zip(sq, split_model) if m), torch.zeros((), device=sq[0].device))
        rest = sum((q for q, m in zip(sq, split_model) if not m),
                   torch.zeros((), device=sq[0].device))
        gnorm = torch.sqrt(sum_in_rank_order(parts, mesh, "model") + rest)
        data_pl = [tuple(a if a == "data" else None for a in pl) for pl in pls]

        def cut(g, pl):  # to this rank's data shard (a copy only where it cuts)
            return local_shard(g, pl, mesh) if any(pl) else g

        kept = [cut(g, pl) for g, pl in zip(grads, data_pl)] if return_grads else None
        clip = not math.isinf(hp.max_grad_norm)  # else the scale is exactly 1: no copy
        scale = torch.clamp(hp.max_grad_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
        for i, pl in enumerate(data_pl):  # each leaf replaced, so one extra leaf at a time
            grads[i] = cut(grads[i] * scale if clip else grads[i], pl)
        # each gradient dropped once its leaf is updated, the largest leaves last
        shards, opt, _ = adamw_update(shards, grads, opt, lr, weight_decay=hp.weight_decay,
                                      max_grad_norm=float("inf"), consume=True)
        return shards, opt, _metrics(loss, gnorm, lr, kept)

    def _tp_compress(grads, model_pl, t):
        """``compress_grads`` of ``model``-sharded gradients: each leaf's
        scale from the largest |g| over ``model`` (one gather of every
        leaf's local maximum), the noise of the whole leaf drawn from the
        step's generator in leaf order and cut to this rank's slice."""
        from ..dist.comm import all_gather, axis_size
        from ..dist.sharding import local_shard

        seed = int(np.random.SeedSequence((0, t)).generate_state(1)[0])
        gen = torch.Generator(device=grads[0].device).manual_seed(seed)
        local_max = torch.stack([g.float().abs().max() for g in grads])
        top = all_gather(local_max[None], mesh, "model", dim=0).amax(dim=0)
        tp = axis_size(mesh, "model")
        out = []
        for g, pl, mx in zip(grads, model_pl, top):
            shape = [n * (tp if a == "model" else 1) for n, a in zip(g.shape, pl)]
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
