"""Port: the vlm family on a (data, model) mesh (ROADMAP A12, items 1-2):
paligemma's dense compute on its shards, on gloo ranks on the CPU.

Two worlds (``launch/mesh.spawn``), spawned at once: a 2x2 world runs its
``model`` sub-mesh (1x2), its ``data`` sub-mesh (2x1) and the whole mesh;
a 1x4 world four ``model`` ranks.  ``paligemma_3b``'s smoke config (4
heads over 1 kv head, so attention stays whole and ``wq`` is gathered over
``model``; ff 128 and vocab 512 split; 8 patch tokens) with every bias and
norm scale redrawn (``torch_family_pairs.perturb``), seeded stand-in
patches.  Held here, against the port's one device and ``repro``:

- the three faults a plan met in the vlm family (``models/families.py``):
  the token embeddings' sqrt(d_model) scale under the vocab-parallel
  lookup; the text-only logits under the training plan (the loss would
  score the patch positions); ``patch_proj``, stored on ``data`` on 2x2,
  gathered at use;
- serving on every mesh: ``generate``'s greedy tokens equal one device's,
  the first decode step's logits within 1e-5 of the largest, every rank
  the same bits, a rank's stored bytes its placement's, the collectives of
  a decode step ``TPPlan.decode_collectives``', the prefill's attention
  sequence-sharded under the prefix mask wherever ``model`` splits;
- training on 1x2, 1x4 and 2x2: the loss within 1e-6 relative of one
  device's, each gradient shard within the larger of 1e-5 and one
  device's one-ulp floor, the collectives ``train_collectives``',
  ``repro``'s loss within 1e-5 and gradients within 5e-3;
- no step, mask refresh or serving call reaching ``gather_tree``, the
  1x2-trained shards served on 1x2, the scheduler refusing the family on a
  mesh as on one device (its requests carry no patches), and the full
  config's placement on 1x4 at most 0.30 of the tree.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.dist import sharding
from repro_torch.dist.sharding import shard_tree
from repro_torch.dist.tp import (
    placement_bytes, serving_plan, storage_placements, training_plan,
)
from repro_torch.models import build_model
from repro_torch.models.common import mesh_context
from repro_torch.models.families import _embed_tokens
from repro_torch.serve import Scheduler
from torch_tp_cases import (
    close, engine, fp32_probs, no_gather, prompts, repro_gates, repro_step,
    serve, serve_gates, spawn_worlds, train, train_gates, train_then_serve, tree_of, batches,
)

ARCH = "paligemma_3b"
MESHES_2X2, MESHES_1X4 = ("1x2", "2x1", "2x2"), ("1x4",)
TRAIN_MESHES = ("1x2", "1x4", "2x2")


def _cfg():
    return get_smoke_config(ARCH)


def _stored(tree, plan, mesh) -> dict:
    """This rank's shards of ``tree`` under ``plan``'s placements."""
    return shard_tree(params_from_numpy(tree, "cpu"), plan.placements, mesh)


def _held(tree, plan, mesh) -> dict:
    """This rank's leaves of ``tree`` as ``plan``'s embedding reads them:
    stored, and under the training plan with the top-level leaves the
    forward gathers over ``data`` before the lookup (``TPPlan.top``)."""
    shards = _stored(tree, plan, mesh)
    return {**shards, **plan.top(shards, ("embed", "patch_proj"))} if plan.train else shards


def _embeddings(tree, mesh):
    """Step 0, fault 1: the token rows of ``prompts`` under the serving and
    the training plan on ``mesh``, and whether each plan exists."""
    cfg, out = _cfg(), {}
    tokens = torch.from_numpy(prompts(cfg)).long()
    for name, plan in (("serve", serving_plan(cfg, mesh)), ("train", training_plan(cfg, mesh))):
        out[name + "_plan"] = plan is not None
        if plan is not None:
            with torch.no_grad(), mesh_context(mesh, plan):
                out[name] = _embed_tokens(_held(tree, plan, mesh), tokens, cfg).numpy()
    return out


def _text_logits(tree, mesh):
    """Step 0, fault 2: the training forward's logits under the training
    plan on ``mesh``: this rank's vocab columns and where they start."""
    cfg = _cfg()
    plan = training_plan(cfg, mesh)
    if plan is None:
        return None
    with torch.no_grad(), mesh_context(mesh, plan):
        logits, _ = build_model(cfg).forward(_stored(tree, plan, mesh), batches(cfg, 1)[0])
    return {"logits": logits.numpy(), "start": plan.rank * logits.shape[-1]}


def _patch_proj(tree, mesh):
    """Step 0, fault 3: the shape ``patch_proj`` is stored at on ``mesh``,
    and ``generate`` there."""
    eng = engine(_cfg(), tree, mesh)
    return {"shape": tuple(eng.params["patch_proj"].shape), "plan": eng.plan is not None}


def _sched_refused(tree, mesh):
    try:
        Scheduler(engine(_cfg(), tree, mesh), slots=2, segment=3)
    except ValueError as e:
        return str(e)
    return None


def _ranks_2x2(mesh, device, trees):
    fp32_probs()
    meshes = {"1x2": mesh["model"], "2x1": mesh["data"], "2x2": mesh}
    tree, cfg = trees[ARCH], _cfg()
    out = {}
    for name, m in meshes.items():
        out[name] = {"serve": serve(cfg, tree, m)}
        if name in TRAIN_MESHES:
            out[name]["train"] = train(cfg, tree, m)
    out["embed"] = {n: _embeddings(tree, meshes[n]) for n in ("1x2", "2x2")}
    out["text"] = _text_logits(tree, meshes["2x2"])
    out["patch_proj"] = _patch_proj(tree, mesh)
    out["no_gather"] = no_gather(cfg, tree, mesh)
    out["train_serve"] = train_then_serve(cfg, meshes["1x2"])
    out["sched"] = _sched_refused(tree, meshes["1x2"])
    return out


def _ranks_1x4(mesh, device, trees):
    fp32_probs()
    tree, cfg = trees[ARCH], _cfg()
    return {"1x4": {"serve": serve(cfg, tree, mesh), "train": train(cfg, tree, mesh)},
            "text": _text_logits(tree, mesh)}


# -- the test process ---------------------------------------------------------------


@pytest.fixture(scope="module")
def trees():
    return {ARCH: tree_of(_cfg())}


def _one_device(trees) -> dict:
    from repro_torch.models import layers
    from torch_tp_cases import ulp_floor

    saved = layers.FLAGS["attn_bf16_probs"]
    fp32_probs()
    try:
        cfg, tree = _cfg(), trees[ARCH]
        params = params_from_numpy(tree, "cpu")
        with torch.no_grad():
            logits, _ = build_model(cfg).forward(params, batches(cfg, 1)[0])
            rows = _embed_tokens(params, torch.from_numpy(prompts(cfg)).long(), cfg)
        return {"serve": serve(cfg, tree, None), "train": train(cfg, tree, None),
                "floor": ulp_floor(cfg, tree), "logits": logits.numpy(), "rows": rows.numpy(),
                "sched": _sched_refused(tree, None), "repro": _repro_train(trees)}
    finally:
        layers.FLAGS["attn_bf16_probs"] = saved


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


def _repro_train(trees) -> dict:
    """``repro``'s loss and gradients on the first batch (its patches too)."""
    from repro.configs import get_smoke_config as ref_smoke

    batch = {k: v.numpy() for k, v in batches(_cfg(), 1)[0].items()}
    return repro_step(ref_smoke(ARCH), trees[ARCH], batch)


@pytest.fixture(scope="module")
def repro_train(one):
    return one["repro"]


def _ranks(mesh, worlds):
    return worlds["2x2" if mesh in MESHES_2X2 else "1x4"]


# -- step 0: the faults a plan met ----------------------------------------------------


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("plan", ["serve", "train"])
def test_step0_embedding_keeps_the_vlm_scale(mesh, plan, worlds, one):
    """Under either plan the token rows come from the vocab-parallel lookup
    and then take the vlm family's sqrt(d_model) scale: bitwise one
    device's rows (each looked-up row is one rank's, the others add 0)."""
    for rank in worlds["2x2"]:
        got = rank["embed"][mesh]
        assert got[plan + "_plan"]
        np.testing.assert_array_equal(got[plan], one["rows"])


@pytest.mark.parametrize("world", ["2x2", "1x4"])
def test_step0_training_logits_are_the_text_positions(world, worlds, one):
    """The training plan's logits are this rank's vocab columns of the
    text positions only, (B, S - P, V / tp), one device's columns within
    1e-5 of the largest: the vocab-parallel loss never scores a patch."""
    cfg = _cfg()
    for rank in worlds[world]:
        got = rank["text"]
        assert got is not None
        b, s, v = got["logits"].shape
        assert (b, s) == one["logits"].shape[:2] and s == 16 - cfg.patch_tokens
        want = one["logits"][..., got["start"]:got["start"] + v]
        close(got["logits"], want, "text logits")


def test_step0_patch_proj_is_stored_on_data_and_gathered_at_use(worlds, one):
    """On 2x2 ``patch_proj`` (d, d) on ``("embed", "embed2")`` is stored as
    a (d / 2, d) shard over ``data``; the prefill gathers it over ``data``
    (whole over ``model``), so ``generate`` there is one device's."""
    d = _cfg().d_model
    for rank in worlds["2x2"]:
        assert rank["patch_proj"] == {"shape": (d // 2, d), "plan": True}
        np.testing.assert_array_equal(rank["2x2"]["serve"]["tokens"], one["serve"]["tokens"])


# -- serving and training on the mesh --------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES_2X2 + MESHES_1X4)
def test_generate_on_mesh_equals_one_device(mesh, worlds, one):
    """Greedy tokens, first-step logits within 1e-5 of the largest, every
    rank the same bits, its stored bytes its placement's, the collectives of
    a decode step as predicted."""
    serve_gates([r[mesh]["serve"] for r in _ranks(mesh, worlds)], one["serve"])


@pytest.mark.parametrize("mesh", ["1x2", "1x4", "2x2"])
def test_prefill_attention_is_sequence_sharded(mesh, worlds):
    """paligemma's one kv head does not divide ``model``: the prefill's
    attention over the patch prefix and the prompt runs on each rank's
    slice of the queries (every layer), and the plan splits ff and the
    vocabulary but not the heads."""
    for rank in _ranks(mesh, worlds):
        got = rank[mesh]["serve"]
        assert got["seq_shard_calls"] == _cfg().n_layers
        assert got["plan"] == (False, False, False, True, True)


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
def test_train_step_on_mesh_matches_one_device(mesh, worlds, one):
    """The loss within 1e-6 relative, each gradient shard within the larger
    of 1e-5 and one device's one-ulp floor, the collectives as
    ``train_collectives`` predicts, the attention sequence-sharded under
    grad."""
    for rank in _ranks(mesh, worlds):
        got = rank[mesh]["train"]
        train_gates(got, one["train"], one["floor"])
        assert got["seq_shard_calls"] == _cfg().n_layers


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
def test_train_step_on_mesh_matches_repro(mesh, worlds, repro_train):
    for rank in _ranks(mesh, worlds):
        repro_gates(rank[mesh]["train"], repro_train)


def test_no_step_or_refresh_gathers_the_tree(worlds):
    """``generate`` (its prefill too), a training step and a mask refresh
    on 2x2, its data and model axes both split: none reaches
    ``gather_tree``."""
    for rank in worlds["2x2"]:
        assert rank["no_gather"]


def test_trained_shards_serve_on_the_mesh(worlds):
    """Trained and pruned on 1x2, served on 1x2 with patches: one device's
    tokens on the gathered tree."""
    for rank in worlds["2x2"]:
        got = rank["train_serve"]
        np.testing.assert_array_equal(got["got"], got["want"])
        assert got["sparsity"] > 0


def test_scheduler_refuses_the_vlm_on_a_mesh(worlds, one):
    """A request carries no patches: the scheduler refuses the family on a
    mesh with one device's message."""
    assert one["sched"] is not None and "patch" in one["sched"]
    for rank in worlds["2x2"]:
        assert rank["sched"] == one["sched"]


def test_full_paligemma_rank_stores_under_three_tenths():
    """A 1x4 rank of ``paligemma_3b``'s full config (a quarter of ff and of
    the vocabulary; its 8 heads split, its one kv head, the patch
    projection and the norm scales whole) stores at most 0.30 of the
    tree, on specs alone, under the engine's and the trainer's
    placements."""
    specs = build_model(get_config(ARCH)).specs()
    mesh = {"data": 1, "model": 4}
    whole = placement_bytes(specs, storage_placements(specs, None), None)
    for pls in (storage_placements(specs, mesh), sharding.params_shardings(specs, mesh)):
        assert placement_bytes(specs, pls, mesh) <= 0.30 * whole
