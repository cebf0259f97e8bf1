"""Port: the per-layer FSDP gather with a rank-order reduce-scatter backward
(ROADMAP A12, item 4), on gloo ranks on the CPU.

One 2x2 world (``launch/mesh.spawn``, a rendezvous file under
``tmp_path``) trains on its ``data`` sub-mesh (2x1), on the whole mesh
(2x2) and on the same four ranks as a (pod, data, model) mesh of 2x2x1
(``make_local_mesh(2, 1, pod=2)``: the batch rows split four ways,
pod-major).  Every case starts from one seeded tree of its smoke config
(``torch_tp_cases.tree_of``: the zeros and ones leaves redrawn) and one
synthetic batch, and runs the Trainer's step (``Trainer.step_fn``) from
this rank's shards, the flash attention's probabilities in fp32:

- for one arch of each family (dense ``vusa_edge``, moe ``olmoe_1b_7b``,
  vlm ``paligemma_3b``, ssm ``mamba2_2_7b``, hybrid
  ``recurrentgemma_9b``, encdec ``whisper_tiny``) on 2x1 and 2x2 (and
  ``vusa_edge`` and ``olmoe_1b_7b`` on 2x2x1), with one microbatch, no
  compression and no clip: the loss, the gradient shards
  (``return_grads``), the updated shards and both moments have the bits of
  the gathered-tree oracle, written here: the rank's leaves whole over
  ``data`` at their ``model`` shard (cut from the whole tree), the loss of
  its rows and its gradients under a plan that stores nothing on ``data``
  (on a ``model`` axis of 1 the single-device program), summed over the
  data ranks in rank order (``comm.sum_in_rank_order``), divided by their
  count, cut to the rank's shard, and AdamW's update of those;
- ``vusa_edge`` with a clip of 1.0 and with two microbatches, on 2x1 and
  2x2: the loss within 1e-6 relative, the gradients within ``GRAD_TOL``
  of each leaf's largest, the norm within ``NORM_TOL`` (the clip's
  gradients, taken before it, stay bitwise), the moments within
  ``GRAD_TOL`` and the parameters within the bound Adam's step puts on a
  weight's move;
- every step's collectives equal ``TPPlan.train_collectives``, and its
  ``fsdp-gather`` and ``reduce-scatter`` counts and bytes
  ``TPPlan.fsdp_traffic``;
- under remat (``vusa_edge``, ``recurrentgemma_9b`` with its unrecomputed
  tail, ``whisper_tiny`` with its tied head) the bytes of the gathered
  leaves alive at once (``comm.GATHERED``) never exceed two layers' plus
  the top-level leaves', well under the tree's;
- ``comm.reduce_scatter_in_rank_order`` is bitwise ``local_shard`` of the
  ordered sum on every mesh, receiving (n - 1) / n of the tensor's bytes
  on one axis, and (n - 1) of its chunks over (pod, data);
- C17 on a 1x2 mesh: with the padding columns the largest logits, no
  token of ``generate`` reaches ``vocab``, greedy or at T = 1;
- ``vusa_edge``'s first step on 2x1 against ``repro``'s Trainer step
  (C1's Auto-axis mesh): the loss, the norm and the updated weights.

The module imports no JAX at top level: the ranks import it.
"""

import copy
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.dist import comm
from repro_torch.dist.sharding import _batch_axes, gather_whole, local_shard, shard_tree
from repro_torch.launch.mesh import make_local_mesh, spawn
from repro_torch.models import build_model
from repro_torch.models.common import mesh_context
from repro_torch.optim import AdamState, adamw_init, adamw_update
from repro_torch.optim.adamw import tree_items
from repro_torch.serve import Engine, ServeConfig
from repro_torch.train import TrainConfig, Trainer, TrainHParams
from repro_torch.train.step import _tree as nest
from torch_tp_cases import (
    BATCH, GRAD_TOL, LR, SEQ, batches, fp32_probs, padding_first_config, prompts, rows_of,
    tree_of,
)

NORM_TOL, LOSS_TOL = 1e-6, 1e-6
FAMILIES = {"dense": "vusa_edge", "moe": "olmoe_1b_7b", "vlm": "paligemma_3b",
            "ssm": "mamba2_2_7b", "hybrid": "recurrentgemma_9b", "encdec": "whisper_tiny"}
ARCHS = tuple(FAMILIES.values())
BITWISE = ([(m, a, "") for m in ("2x1", "2x2") for a in ARCHS]
           + [("pod", "vusa_edge", ""), ("pod", "olmoe_1b_7b", "")])
TOLERANCE = [(m, "vusa_edge", x) for m in ("2x1", "2x2") for x in ("clip", "mb2")]
REMAT = [(m, a, "remat") for m in ("2x1", "2x2")
         for a in ("vusa_edge", "recurrentgemma_9b", "whisper_tiny")]
CASES = BITWISE + TOLERANCE + REMAT
C17_NEW = 6


def _cfg(arch: str, extra: str = ""):
    cfg = get_smoke_config(arch)
    return dataclasses.replace(cfg, remat=True) if extra == "remat" else cfg


def _tc(extra: str = "") -> TrainConfig:
    hp = TrainHParams(lr=LR, warmup=1, total_steps=1,
                      max_grad_norm=1.0 if extra == "clip" else float("inf"),
                      microbatches=2 if extra == "mb2" else 1)
    return TrainConfig(steps=1, global_batch=BATCH, seq_len=SEQ, token_range=64,
                       prune_begin=2, log_every=1, hp=hp)


def _only(tree: dict, axis: str) -> dict:
    """A placement tree with every axis but ``axis`` whole."""
    return {k: _only(v, axis) if isinstance(v, dict)
            else tuple(a if a == axis else None for a in v) for k, v in tree.items()}


def _clone(tree: dict) -> dict:
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _oracle(cfg, tree, mesh, tr, batch, hp):
    """The gathered-tree step's loss, gradients (cut to this rank's shards)
    and global norm: the leaves whole over ``data`` at their ``model``
    shard, the loss and gradients of ``batch`` (this rank's rows) under the
    trainer's plan with nothing stored on ``data`` (no plan on a ``model``
    axis of 1: the single-device program), over ``hp.microbatches``
    microbatches as ``train/step.py`` accumulates them, summed over the
    data ranks in rank order and divided by their count where the rows
    split, the norm the ordered sum over ``model`` of the split leaves'
    squares plus the others' once."""
    held_pl = _only(tr.p_shard, "model")
    held = shard_tree(params_from_numpy(tree, "cpu"), held_pl, mesh)
    paths = [p for p, _ in tree_items(held)]
    axes = _batch_axes(mesh)
    rows = (mesh, axes) if tr.rows is not None else None
    plan = tr.plan
    ctx = ((None, None, rows) if plan.tp == 1
           else (mesh, dataclasses.replace(plan, placements=held_pl), rows))
    model = build_model(cfg)

    def value_and_grad(b):
        live = [t.detach().requires_grad_() for _, t in tree_items(held)]
        with mesh_context(*ctx):
            loss = model.loss(nest(paths, live), b)
        return loss.detach(), [g.float() for g in torch.autograd.grad(loss, live)]

    n = hp.microbatches
    if n == 1:
        loss, grads = value_and_grad(batch)
    else:
        gsum, losses = None, []
        for i in range(n):
            mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i] for k, v in batch.items()}
            lo, g = value_and_grad(mb)
            gsum = g if gsum is None else [a + b for a, b in zip(gsum, g)]
            losses.append(lo)
        loss, grads = torch.stack(losses).mean(), [g / n for g in gsum]
    if rows is not None:
        k = math.prod(comm.axis_size(mesh, a) for a in axes)
        grads = [comm.sum_in_rank_order(g, mesh, axes) / k for g in grads]
        loss = comm.sum_in_rank_order(loss, mesh, axes) / k
    pls = [pl for _, pl in tree_items(tr.p_shard)]
    zero = torch.zeros(())
    parts = sum((g.square().sum() for g, pl in zip(grads, pls) if "model" in pl), zero)
    rest = sum((g.square().sum() for g, pl in zip(grads, pls) if "model" not in pl), zero)
    gnorm = torch.sqrt(comm.sum_in_rank_order(parts, mesh, "model") + rest)
    data_pl = [tuple(a if a == "data" else None for a in pl) for pl in pls]
    cut = [local_shard(g, pl, mesh) if any(pl) else g for g, pl in zip(grads, data_pl)]
    return loss, cut, gnorm


def _adam_tol(hp) -> float:
    """How far one AdamW step from one state can move a weight apart: 2 lr
    (Adam's first step is at most 1 in size) plus the decay of a weight
    below 1."""
    return 2 * hp.lr * (1.0 + hp.weight_decay)


def _layer_bytes(tr, shards) -> tuple:
    """(the largest layer's, the top-level leaves') bytes a rank holds
    gathered whole over ``data``: each leaf on ``data`` at its ``model``
    shard, a stack's leaves split per layer."""
    dp = comm.axis_size(tr.mesh, "data")
    layers, tops = {}, 0
    for (path, t), (_, pl) in zip(tree_items(shards), tree_items(tr.p_shard)):
        if "data" not in pl:
            continue
        nbytes = t.numel() * t.element_size() * dp
        if path[0] in ("layers", "enc_layers", "dec_layers", "groups"):
            key = path[:2] if path[0] == "groups" else path[:1]
            layers[key] = layers.get(key, 0) + nbytes // t.shape[0]
        elif path[0] == "tail":
            layers[path[:2]] = layers.get(path[:2], 0) + nbytes
        else:
            tops += nbytes
    return max(layers.values()), tops


def _case(tree, mesh, case) -> dict:
    """One step of ``case`` on this rank beside the oracle (module
    docstring): what is bitwise, the gaps, the collectives and traffic with
    their predictions, and the gathered bytes' peak with its bound."""
    _, arch, extra = case
    cfg, tc = _cfg(arch, extra), _tc(extra)
    hp = tc.hp
    tr = Trainer(cfg, tc, device="cpu", mesh=mesh)
    shards = shard_tree(params_from_numpy(tree, "cpu"), tr.p_shard, mesh)
    opt = adamw_init(shards)
    batch = rows_of(tr, batches(cfg, 1)[0])
    ref, ref_opt = _clone(shards), AdamState(opt.step.clone(), _clone(opt.mu), _clone(opt.nu))
    layer_max, tops = _layer_bytes(tr, shards)
    comm.reset_stats()
    comm.reset_gathered()
    new, state, got = tr.step_fn(shards, opt, batch, return_grads=True)
    stats, peak = copy.deepcopy(comm.STATS), comm.GATHERED["peak"]
    loss, grads, gnorm = _oracle(cfg, tree, mesh, tr, batch, hp)
    clip = not math.isinf(hp.max_grad_norm)
    scale = torch.clamp(hp.max_grad_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    adamw_update(ref, [g * scale for g in grads] if clip else grads, ref_opt, got["lr"],
                 weight_decay=hp.weight_decay, max_grad_norm=float("inf"))

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    leaves = {"params": (new, ref), "mu": (state.mu, ref_opt.mu), "nu": (state.nu, ref_opt.nu)}
    split = tr.rows is not None
    return {
        "bitwise": {
            "loss": torch.equal(got["loss"], loss),
            "grads": all(torch.equal(a, b) for a, b in zip(got["grads"], grads)),
            **{k: all(torch.equal(x, y) for (_, x), (_, y) in zip(tree_items(a), tree_items(b)))
               for k, (a, b) in leaves.items()}},
        "loss_gap": abs(float(got["loss"]) / float(loss) - 1),
        "grad_gap": max(rel(a, b) for a, b in zip(got["grads"], grads)),
        "norm_gap": abs(float(got["gnorm"]) / float(gnorm) - 1),
        "param_gap": max(float((x - y).abs().max())
                         for (_, x), (_, y) in zip(tree_items(new), tree_items(ref))),
        "moment_gap": max(rel(x, y) for k in ("mu", "nu")
                          for (_, x), (_, y) in zip(tree_items(leaves[k][0]),
                                                    tree_items(leaves[k][1]))),
        "param_tol": _adam_tol(hp),
        "collectives": stats["collectives"],
        "predicted": tr.plan.train_collectives(cfg, SEQ, hp.microbatches, split=split),
        "traffic": {k: stats["by_type"].get(k, {"count": 0, "bytes": 0})
                    for k in ("fsdp-gather", "reduce-scatter")},
        "traffic_want": tr.plan.fsdp_traffic(cfg, hp.microbatches, split=split),
        "peak": peak, "bound": 2 * layer_max + tops,
        "tree_bytes": sum(t.numel() * t.element_size() * comm.axis_size(mesh, "data")
                          for _, t in tree_items(shards)),
    }


def _reduce_scatter(mesh) -> dict:
    """``reduce_scatter_in_rank_order`` of a (6, 8) tensor drawn from this
    rank's seed, along each dim, over the mesh's pure data axes: whether it
    is ``local_shard`` of the ordered sum bitwise, the bytes received and
    the collectives counted."""
    import torch.distributed as dist

    axes = _batch_axes(mesh)
    t = torch.randn(6, 8, generator=torch.Generator().manual_seed(100 + dist.get_rank()))
    out = {}
    for dim in (0, 1):
        pl = tuple("data" if i == dim else None for i in range(2))
        want = local_shard(comm.sum_in_rank_order(t, mesh, axes), pl, mesh)
        comm.reset_stats()
        got = comm.reduce_scatter_in_rank_order(t, mesh, axes, dim)
        rs = comm.STATS["by_type"]["reduce-scatter"]
        out[dim] = {"equal": torch.equal(got, want), "bytes": rs["bytes"], "count": rs["count"],
                    "collectives": comm.STATS["collectives"]}
    return out


def _c17(tree, mesh) -> dict:
    """C17 on ``mesh``: ``generate``'s tokens, greedy and at T = 1, with the
    padding columns the largest logits (``padding_first_config``)."""
    cfg = padding_first_config()
    out = {}
    for temp in (0.0, 1.0):
        eng = Engine(cfg, params_from_numpy(tree, "cpu"),
                     ServeConfig(max_len=24, temperature=temp, seed=3), device="cpu", mesh=mesh)
        out[temp] = eng.generate(prompts(cfg), max_new=C17_NEW)["tokens"]
    return out


def _repro_step(tree, mesh) -> dict:
    """``vusa_edge``'s first Trainer step on ``mesh`` with the default clip:
    its loss, norm and the updated weights gathered whole (on the first
    rank)."""
    cfg = get_smoke_config("vusa_edge")
    tc = dataclasses.replace(_tc(), hp=TrainHParams(lr=LR, warmup=1, total_steps=1))
    tr = Trainer(cfg, tc, device="cpu", mesh=mesh)
    shards = shard_tree(params_from_numpy(tree, "cpu"), tr.p_shard, mesh)
    batch = batches(cfg, 1)[0]
    new, _, got = tr.step_fn(shards, adamw_init(shards), rows_of(tr, batch))
    whole = {"/".join(p): gather_whole(t, pl, mesh).numpy()
             for (p, t), (_, pl) in zip(tree_items(new), tree_items(tr.p_shard))}
    return {"loss": float(got["loss"]), "gnorm": float(got["gnorm"]),
            "params": whole if not any(mesh.get_coordinate()) else None,
            "tokens": batch["tokens"].numpy()}


def _ranks(mesh, device, trees, heavy):
    fp32_probs()
    meshes = {"2x1": mesh["data"], "2x2": mesh, "pod": make_local_mesh(2, 1, pod=2)}
    out = {c: _case(trees[c[1]], meshes[c[0]], c) for c in CASES}
    out["rs"] = {name: _reduce_scatter(m) for name, m in meshes.items()}
    out["c17"] = _c17(heavy, mesh["model"])
    out["repro"] = _repro_step(trees["vusa_edge"], meshes["2x1"])
    return out


@pytest.fixture(scope="module")
def trees():
    return {arch: tree_of(get_smoke_config(arch)) for arch in ARCHS}


@pytest.fixture(scope="module")
def heavy():
    from torch_tp_cases import padding_first_tree

    return padding_first_tree()


@pytest.fixture(scope="module")
def world(trees, heavy, tmp_path_factory):
    return spawn(_ranks, 2, 2, "gloo", "cpu", str(tmp_path_factory.mktemp("fsdp")),
                 args=(trees, heavy), timeout_s=300)


def _id(c):
    return "-".join(x for x in c if x)


@pytest.mark.parametrize("case", BITWISE, ids=_id)
def test_step_is_the_gathered_tree_step_bitwise(case, world):
    for rank in world:
        got = rank[case]
        assert got["bitwise"] == dict.fromkeys(("loss", "grads", "params", "mu", "nu"), True), got
        assert got["norm_gap"] <= NORM_TOL, got["norm_gap"]


@pytest.mark.parametrize("case", TOLERANCE, ids=_id)
def test_clip_and_microbatches_within_tolerance(case, world):
    for rank in world:
        got = rank[case]
        assert got["loss_gap"] <= LOSS_TOL, got["loss_gap"]
        assert got["grad_gap"] <= GRAD_TOL, got["grad_gap"]
        assert got["norm_gap"] <= NORM_TOL, got["norm_gap"]
        assert got["moment_gap"] <= GRAD_TOL, got["moment_gap"]
        assert got["param_gap"] <= got["param_tol"], (got["param_gap"], got["param_tol"])
        if case[2] == "clip":  # the gradients are taken before the clip
            assert got["bitwise"]["grads"] and got["bitwise"]["loss"]


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_collectives_and_bytes_as_predicted(case, world):
    for rank in world:
        got = rank[case]
        assert got["collectives"] == got["predicted"], got
        assert got["traffic"] == got["traffic_want"], (got["traffic"], got["traffic_want"])
        assert got["traffic"]["fsdp-gather"]["count"] > 0


@pytest.mark.parametrize("case", REMAT, ids=_id)
def test_remat_holds_at_most_two_layers_gathered(case, world):
    """Under remat a layer's gathered leaves are dropped after its forward
    and gathered again in its recompute: the peak of ``comm.GATHERED`` is at
    most two layers' leaves plus the top-level ones, and well under the
    tree gathered over ``data``."""
    for rank in world:
        got = rank[case]
        assert 0 < got["peak"] <= got["bound"], (got["peak"], got["bound"])
        assert got["peak"] < got["tree_bytes"] / 2, (got["peak"], got["tree_bytes"])


@pytest.mark.parametrize("mesh", ["2x1", "2x2", "pod"])
def test_reduce_scatter_is_the_ordered_sum_cut(mesh, world):
    """Bitwise ``local_shard(sum_in_rank_order(t))``, receiving the chunks
    of the other ranks only: (n - 1) chunks of 1/dp of the tensor, one
    collective an axis of size > 1."""
    n, dp, axes = {"2x1": (2, 2, 1), "2x2": (2, 2, 1), "pod": (4, 2, 2)}[mesh]
    for rank in world:
        for dim in (0, 1):
            got = rank["rs"][mesh][dim]
            assert got["equal"]
            assert got["bytes"] == (n - 1) * 6 * 8 * 4 // dp
            assert got["count"] == got["collectives"] == axes


def test_c17_no_padding_id_on_a_mesh(world):
    cfg = padding_first_config()
    for rank in world:
        for temp, tokens in rank["c17"].items():
            assert tokens.shape == (BATCH, C17_NEW)
            assert int(tokens.max()) < cfg.vocab, (temp, tokens)


def test_first_step_matches_repro_trainer_step(world, trees, monkeypatch):
    """``vusa_edge`` on 2x1 against ``repro``'s Trainer step on the same
    tree and batch (built on C1's Auto-axis mesh): the loss within 1e-6
    relative, the global norm within 1e-3 (``test_torch_train.py``'s
    tolerance) and every updated weight within 2 lr, all but 0.1 % within
    0.1 lr."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as ref_smoke
    from repro.models.opt_flags import FLAGS as REF_FLAGS
    from repro.optim import adamw_init as ref_adamw_init
    from repro.train import TrainConfig as RefTrainConfig
    from repro.train import Trainer as RefTrainer
    from repro.train import TrainHParams as RefHParams

    monkeypatch.setitem(REF_FLAGS, "attn_bf16_probs", False)
    got = world[0]["repro"]
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    ref = RefTrainer(ref_smoke("vusa_edge"),
                     RefTrainConfig(steps=1, global_batch=BATCH, seq_len=SEQ, token_range=64,
                                    hp=RefHParams(lr=LR, warmup=1, total_steps=1)), mesh=mesh)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a, copy=True)),
                                    trees["vusa_edge"])
    new, _, metrics = jax.jit(ref.step_fn)(params, ref_adamw_init(params),
                                           {"tokens": jnp.asarray(got["tokens"])})
    assert got["loss"] == pytest.approx(float(metrics["loss"]), rel=1e-6)
    assert got["gnorm"] == pytest.approx(float(metrics["gnorm"]), rel=1e-3)
    far, total = 0, 0
    for path, want in jax.tree_util.tree_flatten_with_path(new)[0]:
        d = np.abs(got["params"]["/".join(k.key for k in path)] - np.asarray(want))
        assert float(d.max()) <= 2 * LR, path
        far += int((d > 0.1 * LR).sum())
        total += d.size
    assert far <= 1e-3 * total, far
