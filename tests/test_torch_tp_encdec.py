"""Port: the encdec family on a (data, model) mesh (ROADMAP A12, item 3),
and the trainer's checkpoint and result from shards (item 5), on gloo
ranks on the CPU.

Two worlds (``launch/mesh.spawn``), spawned at once: a 2x2 world runs its
``model`` sub-mesh (1x2), its ``data`` sub-mesh (2x1) and the whole mesh;
a 1x4 world four ``model`` ranks.  ``whisper_tiny``'s smoke config (4
heads: they split on every mesh) and a 6-head variant of it (6 heads
split on 1x2 and 2x2 but not on four ranks, where attention stays whole,
the encoder's full-mask attention sequence-sharded), every norm scale and
the encoder's positions redrawn (``torch_family_pairs.perturb``), seeded
stand-in frames.  Held here, against the port's one device and
``repro``:

- serving on every mesh: greedy tokens equal one device's (and
  ``repro``'s), every rank the same bits, a rank's stored bytes its
  placement's, the collectives of a decode step
  ``TPPlan.decode_collectives``', the caches holding the rank's rows and
  kv heads; the first decode step's logits within the larger of 1e-5 and
  one device's own one-ulp floor of the largest (the tied head's small
  logits: a relative 2^-23 move of every parameter moves them 3e-5-7e-5
  of the largest, ``test_torch_encdec.py``'s reason);
- training on 1x2, 1x4 and 2x2: the loss within 1e-6 relative of one
  device's, each gradient shard within the larger of 1e-5 and one
  device's one-ulp floor, the collectives ``train_collectives``',
  ``repro``'s loss within 1e-5 and gradients within 5e-3;
- the gradient traps by name: the encoder's output entering the cross
  attention's column-parallel ``wk``/``wv`` and the decoder states its
  ``wq``;
- no step, mask refresh, checkpoint save or ``train()`` return reaching
  ``gather_tree``; a save's host peak on the writer at most one leaf
  whole and one shard;
- a checkpoint written on 1x2, 1x4 and 2x2 byte-identical, file by file,
  to one device's save of the gathered tree, restored bitwise onto 1x1
  and 1x4; ``train()``'s sparsity bitwise one device's; the 1x2-trained
  shards served on 1x2; the scheduler refusing the family on a mesh as
  on one device; the full config's placement arithmetic: a 1x4 rank keeps
  attention whole (6 heads on four ranks) and stores 0.388 of the tree, a
  2x2 rank at most 0.30.
"""

import dataclasses
import filecmp
import tracemalloc
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.pruning import tree_sparsity
from repro_torch.dist import sharding
from repro_torch.dist.sharding import local_shard
from repro_torch.dist.tp import (
    WholeView, local_config, placement_bytes, storage_placements, training_plan,
)
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build_model
from repro_torch.models.common import mesh_context
from repro_torch.models.layers import cross_attention, encode_cross_kv
from repro_torch.optim import AdamState
from repro_torch.optim.adamw import tree_items
from repro_torch.serve import Scheduler
from repro_torch.train import Trainer
from repro_torch.train.step import _tree as nest
from torch_tp_cases import (
    BATCH, GRAD_TOL, LOGIT_TOL, MAX_LEN, NEW, close, engine, extras, fp32_probs, no_gather,
    prompts, repro_gates, repro_step, serve, shards_of, spawn_worlds, train, train_config,
    train_gates, train_then_serve, tree_of, batches,
)

ARCH = "whisper_tiny"
HEADS = (4, 6)
MESHES_2X2, MESHES_1X4 = ("1x2", "2x1", "2x2"), ("1x4",)
TRAIN_MESHES = ("1x2", "1x4", "2x2")
CKPT_MESHES = ("1x2", "1x4", "2x2")
CKPT_STEPS = 2
TRAPS = ("enc", "x")


def _cfg(heads: int = 4):
    """The smoke config, or its variant with ``heads`` heads and kv heads."""
    cfg = get_smoke_config(ARCH)
    return cfg if heads == cfg.n_heads else dataclasses.replace(cfg, n_heads=heads,
                                                                kv_heads=heads)


def _serve(cfg, tree, mesh) -> dict:
    """``torch_tp_cases.serve``, the prefill's sequence-sharded attention
    calls and the shapes of the cache the prefill leaves on this rank (its
    rows of the batch, its kv heads)."""
    out = serve(cfg, tree, mesh)
    eng = engine(cfg, tree, mesh)
    rows = eng._rows(BATCH)
    p, x = prompts(cfg), extras(cfg)
    if rows is not None:
        p, x = p[rows], {k: v[rows] for k, v in x.items()}
    with torch.no_grad():
        cache = eng.prime(p, x, split=rows is not None)[1]
    out["cache"] = {k: tuple(cache[k].shape) for k in ("k", "xk")}
    return out


def _unit(cfg, tree, mesh) -> dict:
    """Decoder layer 0's cross attention alone under the training plan's
    splits (each leaf at its ``model`` shard; None: one device, whole):
    the encoder's output ``enc`` (2, 12, d) and the decoder states ``x``
    (2, 8, d) drawn from a seed, y and the gradients of y's weighted sum, of
    ``enc``, of ``x`` and of every leaf (with their ranges)."""
    plan = None if mesh is None else training_plan(cfg, mesh)
    pls = sharding.params_shardings(build_model(cfg).specs(), mesh)["dec_layers"]["cross_attn"]
    pls = {k: tuple(a if a == "model" else None for a in pl[1:]) for k, pl in pls.items()}
    leaves = tree["dec_layers"]["cross_attn"]
    p = {k: local_shard(torch.from_numpy(v[0]), pls[k], mesh).requires_grad_()
         for k, v in leaves.items()}
    rng = np.random.default_rng(9)
    enc, x = (torch.from_numpy(rng.standard_normal((2, n, cfg.d_model)).astype(
        np.float32)).requires_grad_() for n in (12, 8))
    g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    lcfg = local_config(cfg, plan)
    with mesh_context(mesh, plan):
        y = cross_attention(p, x, encode_cross_kv(p, enc, lcfg), lcfg)
    grads = torch.autograd.grad((y * g).sum(), [enc, x, *p.values()])
    whole = {"enc": (None,) * 3, "x": (None,) * 3}
    return {"y": y.detach().numpy(),
            "grads": shards_of(dict(zip(["enc", "x", *p], grads)), {**whole, **pls}, mesh)}


def _whole(out) -> dict:
    """The trained state a ``train()`` result holds (on a mesh its views,
    read leaf by leaf in sorted key order on every rank) as whole trees."""
    def tree(t):
        return nest(*zip(*tree_items(t)))

    opt = out["opt"]
    return {"params": tree(out["params"]),
            "opt": AdamState(step=opt.step, mu=tree(opt.mu), nu=tree(opt.nu))}


def _ckpt(cfg, mesh, root: Path) -> dict:
    """The Trainer on ``mesh`` for ``CKPT_STEPS`` steps with pruning, its
    checkpoint written at the last step from the shards (``root /
    "mesh"``), the save's host peak (``tracemalloc``) beside the largest
    leaf and shard; then one device's save of the gathered tree (``root /
    "one"``, by the writer) and the sparsity ``train()`` counted from the
    shards beside one device's on that tree."""
    tc = dataclasses.replace(train_config(CKPT_STEPS), prune_begin=0, prune_end=1,
                             prune_every=1, ckpt_dir=str(root / "mesh"), ckpt_every=CKPT_STEPS)
    tr = Trainer(cfg, tc, device="cpu", mesh=mesh)
    box, save = {}, tr._save

    def measured(step, params, opt):
        box["shard"] = max(t.numel() * t.element_size() for _, t in tree_items(params))
        tracemalloc.start()
        save(step, params, opt)
        box["peak"] = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()

    tr._save = measured
    out = tr.train()
    whole = _whole(out)
    lead = not any(mesh.get_coordinate())
    if lead:
        ckpt.save(root / "one", CKPT_STEPS, whole)
    return {"views": all(isinstance(v, WholeView) for v in (out["params"], out["opt"].mu,
                                                            out["opt"].nu)),
            "sparsity": out["sparsity"], "sparsity_want": tree_sparsity(whole["params"]),
            "peak": box["peak"], "shard": box["shard"], "lead": lead,
            "leaf": max(t.numel() * t.element_size() for _, t in tree_items(whole["params"]))}


def _restore(cfg, roots: list, mesh) -> list:
    """Each checkpoint under ``roots`` restored onto ``mesh``: whether every
    leaf is this rank's shard of one device's save, bitwise."""
    like = {"params": _cpu_like(build_model(cfg).specs())}
    like["opt"] = AdamState(step=torch.zeros((), dtype=torch.int32), mu=like["params"],
                            nu=like["params"])
    pls = sharding.params_shardings(build_model(cfg).specs(), mesh)
    shardings = {"params": pls, "opt": AdamState(step=None, mu=pls, nu=pls)}
    out = []
    for root in roots:
        got = ckpt.restore(Path(root) / "mesh", CKPT_STEPS, like, shardings, mesh)
        want = ckpt.restore(Path(root) / "one", CKPT_STEPS, like)
        flat_pl = ckpt._flatten(shardings)
        out.append(all(
            torch.equal(g, local_shard(w, flat_pl[k], mesh) if flat_pl.get(k) else w)
            for (k, g), (_, w) in zip(sorted(ckpt._flatten(got).items()),
                                      sorted(ckpt._flatten(want).items()))))
    return out


def _cpu_like(tree):
    """A tree of empty CPU tensors in ``tree``'s structure: what ``restore``
    reads of its ``like`` (each leaf's device)."""
    return {k: _cpu_like(v) if isinstance(v, dict) else torch.empty(0) for k, v in tree.items()}


def _sched_refused(cfg, tree, mesh):
    try:
        Scheduler(engine(cfg, tree, mesh), slots=2, segment=3)
    except ValueError as e:
        return str(e)
    return None


def _no_gather(cfg, tree, mesh, root: Path) -> bool:
    """``no_gather`` (``generate``, a step, a mask refresh), then a run of
    the Trainer that saves a checkpoint and returns, with ``gather_tree``
    refusing: True when none called it."""
    calls = []

    def refuse(*a, **kw):
        calls.append(1)
        raise AssertionError("gather_tree on a tensor-parallel path")

    ok = no_gather(cfg, tree, mesh)
    real = sharding.gather_tree
    sharding.gather_tree = refuse
    try:
        tc = dataclasses.replace(train_config(CKPT_STEPS), ckpt_dir=str(root),
                                 ckpt_every=CKPT_STEPS, prune_begin=0, prune_end=1,
                                 prune_every=1)
        Trainer(cfg, tc, device="cpu", mesh=mesh).train()
    finally:
        sharding.gather_tree = real
    return ok and not calls


def _ranks_2x2(mesh, device, trees):
    fp32_probs()
    meshes = {"1x2": mesh["model"], "2x1": mesh["data"], "2x2": mesh}
    group = mesh.get_coordinate()[0]  # this rank's 1x2 mesh
    root = Path(trees["root"])
    out = {}
    for h in HEADS:
        cfg, tree = _cfg(h), trees[h]
        for name, m in meshes.items():
            out[(h, name)] = {"serve": _serve(cfg, tree, m)}
            if name in TRAIN_MESHES:
                out[(h, name)]["train"] = train(cfg, tree, m)
    cfg, tree = _cfg(), trees[4]
    out["unit"] = _unit(cfg, tree, meshes["1x2"])
    out["no_gather"] = _no_gather(cfg, tree, mesh, root / "nogather")
    if group == 0:
        out["ckpt 1x2"] = _ckpt(cfg, meshes["1x2"], root / "1x2")
    out["ckpt 2x2"] = _ckpt(cfg, mesh, root / "2x2")
    dist.barrier()  # every checkpoint written before any is read
    out["restore"] = _restore(cfg, [root / "1x2", root / "2x2"], make_local_mesh(1, 4))
    out["train_serve"] = train_then_serve(cfg, meshes["1x2"])
    out["sched"] = _sched_refused(cfg, tree, meshes["1x2"])
    return out


def _ranks_1x4(mesh, device, trees):
    fp32_probs()
    root = Path(trees["root"])
    out = {}
    for h in HEADS:
        cfg, tree = _cfg(h), trees[h]
        out[(h, "1x4")] = {"serve": _serve(cfg, tree, mesh), "train": train(cfg, tree, mesh)}
    out["unit"] = _unit(_cfg(), trees[4], mesh)
    out["ckpt 1x4"] = _ckpt(_cfg(), mesh, root / "1x4")
    dist.barrier()
    out["restore"] = _restore(_cfg(), [root / "1x4"], mesh)
    return out


# -- the test process ---------------------------------------------------------------


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return {**{h: tree_of(_cfg(h)) for h in HEADS},
            "root": str(tmp_path_factory.mktemp("tpencdec_ckpt"))}


def _logit_floor(cfg, tree, draws: int = 2) -> float:
    """How far one device's first decode-step logits move (of the largest)
    when every parameter moves by about an ulp (a relative 2^-23 x
    normal(0, 1), ``draws`` fixed seeds): ``torch_tp_cases.ulp_floor``'s
    rule for the logits."""
    base = serve(cfg, tree, None)["first"]
    worst = 0.0
    for seed in range(draws):
        gen = torch.Generator().manual_seed(seed)
        items = list(tree_items(params_from_numpy(tree, "cpu")))
        moved = nest([p for p, _ in items], [
            (t * (1 + 2.0**-23 * torch.randn(t.shape, generator=gen))).numpy()
            for _, t in items])
        got = serve(cfg, moved, None)["first"]
        worst = max(worst, float(np.abs(got - base).max()) / max(float(np.abs(base).max()), 1.0))
    return worst


def _one_device(trees) -> dict:
    from repro_torch.models import layers
    from torch_tp_cases import ulp_floor

    saved = layers.FLAGS["attn_bf16_probs"]
    fp32_probs()
    try:
        out = {}
        for h in HEADS:
            cfg, tree = _cfg(h), trees[h]
            out[h] = {"serve": serve(cfg, tree, None), "train": train(cfg, tree, None),
                      "floor": ulp_floor(cfg, tree), "logit_floor": _logit_floor(cfg, tree),
                      "repro": _repro(h, tree)}
        out["unit"] = _unit(_cfg(), trees[4], None)
        out["sched"] = _sched_refused(_cfg(), trees[4], None)
        return out
    finally:
        layers.FLAGS["attn_bf16_probs"] = saved


def _repro(heads: int, tree) -> dict:
    """``repro``'s loss and gradients on the first batch, and its greedy
    tokens of the serving case (``attn_bf16_probs`` off)."""
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as ref_smoke
    from repro.models.opt_flags import FLAGS as REF_FLAGS
    from repro.serve import Engine as RefEngine
    from repro.serve import ServeConfig as RefServeConfig

    ref_cfg = dataclasses.replace(ref_smoke(ARCH), n_heads=heads, kv_heads=heads)
    cfg = _cfg(heads)
    batch = {k: v.numpy() for k, v in batches(cfg, 1)[0].items()}
    out = repro_step(ref_cfg, tree, batch)
    prev = REF_FLAGS["attn_bf16_probs"]
    REF_FLAGS["attn_bf16_probs"] = False
    try:
        eng = RefEngine(ref_cfg, _jnp_tree(tree), RefServeConfig(max_len=MAX_LEN))
        frames = jnp.asarray(extras(cfg)["frames"])
        out["tokens"] = np.asarray(eng.generate(prompts(cfg), max_new=NEW,
                                                extras={"frames": frames})["tokens"])
    finally:
        REF_FLAGS["attn_bf16_probs"] = prev
    return out


def _jnp_tree(tree):
    import jax.numpy as jnp

    return {k: _jnp_tree(v) if isinstance(v, dict) else jnp.asarray(np.array(v, copy=True))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def runs(trees, tmp_path_factory):
    return spawn_worlds({"1x4": (_ranks_1x4, 1, 4), "2x2": (_ranks_2x2, 2, 2)}, trees,
                        tmp_path_factory, lambda: _one_device(trees))


@pytest.fixture(scope="module")
def worlds(runs):
    return runs[0]


@pytest.fixture(scope="module")
def one(runs):
    return runs[1]


def _ranks(mesh, worlds):
    return worlds["2x2" if mesh in MESHES_2X2 else "1x4"]


def _splits(heads: int, mesh: str) -> bool:
    """Whether the heads split over ``mesh``'s ``model`` axis."""
    tp = int(mesh.split("x")[1])
    return tp > 1 and heads % tp == 0


# -- serving ---------------------------------------------------------------------------


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("mesh", MESHES_2X2 + MESHES_1X4)
def test_generate_on_mesh_equals_one_device(mesh, heads, worlds, one):
    """Greedy tokens as one device's, first-step logits within the larger
    of 1e-5 and one device's one-ulp floor of the largest, every rank the
    same bits, its stored bytes its placement's, the collectives of a
    decode step as predicted."""
    want = one[heads]["serve"]
    tol = max(LOGIT_TOL, one[heads]["logit_floor"])
    recs = [r[(heads, mesh)]["serve"] for r in _ranks(mesh, worlds)]
    for got in recs:
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        close(got["first"], want["first"], "first-step logits", tol=tol)
        assert got["digest"] == recs[0]["digest"]
        assert got["bytes"] == got["bytes_want"]
        assert got["collectives"] == got["predicted"], (got["collectives"], got["predicted"])


@pytest.mark.parametrize("heads", HEADS)
def test_one_device_serves_repro_tokens(heads, one):
    """The port's one device, which every mesh equals, serves ``repro``'s
    greedy tokens (the first 0: the prefill drops the prompt, C12)."""
    got = one[heads]["serve"]["tokens"]
    np.testing.assert_array_equal(got, one[heads]["repro"]["tokens"])
    assert not got[:, 0].any()


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("mesh", MESHES_2X2 + MESHES_1X4)
def test_plan_and_cache_hold_the_ranks_heads_and_rows(mesh, heads, worlds):
    """The plan splits ff and the vocabulary wherever ``model`` does, the
    heads where they divide it (6 on four ranks do not); the prefill's
    self and cross K/V hold this rank's rows (2x2 and 2x1 split the batch)
    and kv heads, the cross K/V one row a frame; where the heads do not
    split, the encoder's full-mask attention is sequence-sharded, one call
    a layer."""
    cfg = _cfg(heads)
    dp, tp = (int(n) for n in mesh.split("x"))
    split = _splits(heads, mesh)
    rows, kvh = BATCH // dp, cfg.kv_heads // tp if split else cfg.kv_heads
    for rank in _ranks(mesh, worlds):
        got = rank[(heads, mesh)]["serve"]
        assert got["plan"] == (False, False, split, tp > 1, tp > 1)
        assert got["cache"] == {"k": (cfg.n_layers, rows, MAX_LEN, kvh, cfg.hd),
                                "xk": (cfg.n_layers, rows, cfg.enc_frames, kvh, cfg.hd)}
        assert got["seq_shard_calls"] == (cfg.enc_layers if tp > 1 and not split else 0)


def test_scheduler_refuses_encdec_on_a_mesh(worlds, one):
    """A request carries no frames: the scheduler refuses the family on a
    mesh with one device's message (C12)."""
    assert one["sched"] is not None and "frames" in one["sched"]
    for rank in worlds["2x2"]:
        assert rank["sched"] == one["sched"]


# -- training ---------------------------------------------------------------------------


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("mesh", TRAIN_MESHES)
def test_train_step_on_mesh_matches_one_device(mesh, heads, worlds, one):
    """The loss within 1e-6 relative, each gradient shard within the larger
    of 1e-5 and one device's one-ulp floor, the collectives as
    ``train_collectives`` predicts; where the heads do not split, the
    encoder's and the decoder's self-attention sequence-sharded under
    grad (each layer once forward)."""
    cfg = _cfg(heads)
    for rank in _ranks(mesh, worlds):
        got = rank[(heads, mesh)]["train"]
        train_gates(got, one[heads]["train"], one[heads]["floor"])
        want = 0 if _splits(heads, mesh) else cfg.enc_layers + cfg.n_layers
        assert got["seq_shard_calls"] == want


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("mesh", TRAIN_MESHES)
def test_train_step_on_mesh_matches_repro(mesh, heads, worlds, one):
    for rank in _ranks(mesh, worlds):
        repro_gates(rank[(heads, mesh)]["train"], one[heads]["repro"])


@pytest.mark.parametrize("mesh", ("1x2", "1x4"))
@pytest.mark.parametrize("trap", TRAPS)
def test_gradient_trap(mesh, trap, worlds, one):
    """The cross attention's whole inputs, read by the ranks' column
    products: ``enc``, the encoder's output, cut by ``wk``/``wv`` to each
    rank's kv heads (entered through ``enter_model`` in
    ``encode_cross_kv``: without it its gradient misses the other ranks'
    heads), and ``x``, the decoder states, cut by ``wq``.  Each gradient
    on every rank is one device's within 1e-5 of its largest, and y
    one device's."""
    want = one["unit"]
    for rank in _ranks(mesh, worlds):
        got = rank["unit"]
        close(got["y"], want["y"], "y")
        g, w = got["grads"][trap][1], want["grads"][trap][1]
        assert float(np.abs(g - w).max()) <= GRAD_TOL * float(np.abs(w).max()), trap


@pytest.mark.parametrize("mesh", ("1x2", "1x4"))
def test_every_cross_attention_gradient_is_one_devices(mesh, worlds, one):
    """Every cross-attention leaf's gradient shard, not only the traps:
    the column-parallel ``wq``/``wk``/``wv`` and the row-parallel
    ``wo``."""
    want = one["unit"]["grads"]
    for rank in _ranks(mesh, worlds):
        for k, (ranges, g) in rank["unit"]["grads"].items():
            w = want[k][1]
            if ranges is not None:
                w = w[tuple(slice(s, s + n) for s, n in ranges)]
            assert float(np.abs(g - w).max()) <= GRAD_TOL * float(
                np.abs(want[k][1]).max()), k


# -- no whole tree; checkpoints and the result from shards --------------------------------


def test_no_step_refresh_save_or_return_gathers_the_tree(worlds):
    """``generate``, a training step, a mask refresh, a checkpoint save and
    ``train()``'s return on 2x2, its data and model axes both split: none
    reaches ``gather_tree``."""
    for rank in worlds["2x2"]:
        assert rank["no_gather"]


@pytest.mark.parametrize("mesh", CKPT_MESHES)
def test_checkpoint_from_shards_is_one_devices_bytes(mesh, worlds, trees):
    """Written on ``mesh`` one leaf at a time, the checkpoint's files (every
    leaf and the manifest) are one device's save of the gathered tree,
    byte for byte."""
    step = f"step_{CKPT_STEPS:08d}"
    got, want = (Path(trees["root"]) / mesh / d / step for d in ("mesh", "one"))
    names = sorted(p.name for p in want.iterdir())
    assert names == sorted(p.name for p in got.iterdir()) and "manifest.json" in names
    same, diff, errors = filecmp.cmpfiles(got, want, names, shallow=False)
    assert not diff and not errors and len(same) == len(names)


@pytest.mark.parametrize("mesh", CKPT_MESHES)
def test_checkpoint_restores_bitwise_on_one_device_and_1x4(mesh, worlds, trees):
    """The checkpoint written on ``mesh`` restores onto 1x1 as one device's
    save (every leaf bitwise) and onto 1x4 as each rank's shard of it."""
    cfg = _cfg()
    step, root = CKPT_STEPS, Path(trees["root"]) / mesh
    model = build_model(cfg)
    like = {"params": model.init(0, device="cpu")}
    like["opt"] = AdamState(step=torch.zeros((), dtype=torch.int32), mu=like["params"],
                            nu=like["params"])
    got, want = (ckpt.restore(root / d, step, like) for d in ("mesh", "one"))
    for (k, g), (_, w) in zip(tree_items(got["params"]), tree_items(want["params"])):
        assert torch.equal(g, w), k
    assert torch.equal(got["opt"].step, want["opt"].step)
    index = 0 if mesh == "1x4" else ["1x2", "2x2"].index(mesh)
    for rank in _ranks("1x4" if mesh == "1x4" else "2x2", worlds):
        assert rank["restore"][index]


@pytest.mark.parametrize("mesh", CKPT_MESHES)
def test_train_returns_views_and_the_exact_sparsity(mesh, worlds):
    """On a mesh ``train()`` returns views of the whole params and moments
    (nothing gathered until read) and the sparsity counted from the shards:
    bitwise one device's ``tree_sparsity`` of the gathered tree."""
    recs = [r[f"ckpt {mesh}"] for r in _ranks(mesh, worlds) if f"ckpt {mesh}" in r]
    assert len(recs) == int(mesh[0]) * int(mesh[-1])
    for got in recs:
        assert got["views"]
        assert got["sparsity"] == got["sparsity_want"] and got["sparsity"] > 0


@pytest.mark.parametrize("mesh", CKPT_MESHES)
def test_save_holds_one_leaf_on_the_writer(mesh, worlds):
    """The save's host peak on the writer (``tracemalloc``: the numpy
    arrays and the read-back buffer) is at most the largest leaf whole and
    one shard, with 64 KiB of slack: the tree is never whole on the host."""
    for got in (r[f"ckpt {mesh}"] for r in _ranks(mesh, worlds) if f"ckpt {mesh}" in r):
        if got["lead"]:
            bound = got["leaf"] + got["shard"] + (64 << 10)
            assert got["peak"] <= bound, (got["peak"], bound)


def test_trained_shards_serve_on_the_mesh(worlds):
    """Trained and pruned on 1x2, served on 1x2 with frames: one device's
    tokens on the tree read from ``train()``'s views."""
    for rank in worlds["2x2"]:
        got = rank["train_serve"]
        np.testing.assert_array_equal(got["got"], got["want"])
        assert got["sparsity"] > 0


def _spec_bytes(tree, keep=lambda path: True, path=()) -> int:
    return sum(_spec_bytes(v, keep, path + (k,)) if isinstance(v, dict)
               else 4 * int(np.prod(v.shape)) * keep(path + (k,)) for k, v in tree.items())


def test_full_whisper_rank_storage_is_the_placement_arithmetic():
    """``whisper_tiny``'s full config, on specs alone, under the engine's
    and the trainer's placements.  A 1x4 rank stores a quarter of ff (1536
    -> 384) and of the padded vocabulary (51968 -> 12992) and every
    attention leaf whole (6 heads on four ranks: 12 attention groups of 4 x
    384^2), ``enc_pos`` (1500 x 384) and the norm scales whole: 0.388 of
    the tree, no more; a 2x2 rank (heads, ff and vocab over ``model``, the
    embed dim over ``data``) at most 0.30."""
    specs = build_model(get_config(ARCH)).specs()
    whole = _spec_bytes(specs)
    assert whole == placement_bytes(specs, storage_placements(specs, None), None)
    attn = ("attn", "self_attn", "cross_attn")
    kept = _spec_bytes(specs, lambda p: any(a in p for a in attn) or "norm" in p[-1]
                       or p == ("enc_pos",))
    quartered = _spec_bytes(specs, lambda p: p == ("embed",) or "ffn" in p)
    assert kept + quartered == whole
    m14, m22 = {"data": 1, "model": 4}, {"data": 2, "model": 2}
    for place in (storage_placements, sharding.params_shardings):
        got = placement_bytes(specs, place(specs, m14), m14)
        assert got == kept + quartered // 4 and 0.38 < got / whole < 0.39
        assert placement_bytes(specs, place(specs, m22), m22) <= 0.30 * whole
