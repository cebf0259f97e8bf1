"""Port: the recurrent families on a (data, model) mesh (ROADMAP A12, items
1-2): Mamba-2 on its SSM heads and the RG-LRU on its channels, on gloo
ranks on the CPU.

Two worlds (``launch/mesh.spawn``, a rendezvous file under ``tmp_path``),
spawned at once: a 2x2 world runs its ``model`` sub-mesh (1x2), its
``data`` sub-mesh (2x1) and the whole mesh; a 1x4 world four ``model``
ranks.  The smoke configs' parameters with every bias, norm scale and
``A_log``/``D``/``dt_bias``/``lam`` redrawn (``torch_family_pairs.perturb``):
``mamba2_2_7b`` (4 SSM heads, ``in_proj``'s 292 columns and the conv's 160
channels split evenly, not at the ``z | x | B | C | dt`` seams) and
``recurrentgemma_9b`` at 5 layers (one stacked group and the unstacked
two-layer ``rglru`` tail, 64 channels, local attention of 4 heads over 1
kv head, so attention stays whole); the fallback is Mamba-2 at d_model 96
with 6 SSM heads on 1x4 (the SSD whole on every rank, the conv and
``out_proj`` split, ``in_proj``'s 422 columns whole).  Held here, against
the port's one device (each case made once in this process while the
ranks run) and ``repro``:

- serving on every mesh: ``generate``'s greedy tokens equal one device's,
  the first decode step's logits within 1e-5 of the largest, every rank
  the same bits, the bytes a rank stores equal ``placement_bytes``, the
  collectives of a decode step equal ``TPPlan.decode_collectives``;
- training on 1x2, 1x4 and 2x2: a step's loss within 1e-6 relative of one
  device's, each gradient shard within the larger of 1e-5 and one
  device's one-ulp floor of the leaf's largest (``test_torch_ep.py``'s
  rule), the collectives equal ``TPPlan.train_collectives``; ``repro``'s
  loss within 1e-5 relative and gradients within 5e-3;
- each gradient trap by name, on one mixer under the training plan on 1x2
  and 1x4 (``_unit``): ``in_proj``'s ``B`` and ``C`` columns and its
  ``z`` columns (through the norm's summed squares), the gathered
  ``conv_w`` and ``conv_b``, the sliced ``A_log``, ``D`` and ``dt_bias``,
  the norm scale; the RG-LRU's ``w_a`` and ``w_i`` (their summed gates)
  and ``lam``; the block input's gradient in each;
- the hybrid's unstacked tail, the fallback, the slot-pool scheduler on
  1x2 and 2x2 against one device's, no step, mask refresh or serving call
  reaching ``gather_tree``, the 1x2-trained shards served on 1x2, and the
  full configs' placement on 1x4 at most 0.30 of the tree.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.dist import sharding
from repro_torch.dist.sharding import local_shard
from repro_torch.dist.tp import placement_bytes, storage_placements, training_plan
from repro_torch.models import build_model
from repro_torch.models.common import mesh_context
from repro_torch.models.ssm import mamba2_block, rglru_block
from repro_torch.serve import Request, Scheduler
from torch_tp_cases import (
    GRAD_TOL, close, cut, engine, fp32_probs, no_gather, repro_gates, repro_step, serve,
    serve_gates, shard_gaps, shards_of, spawn_worlds, train, train_gates, train_then_serve,
    tree_of, ulp_floor, batches,
)

ARCHS = {"mamba2_2_7b": {}, "recurrentgemma_9b": {"n_layers": 5}}
FALLBACK = {"d_model": 96, "ssm_heads": 6}  # Mamba-2: 6 heads do not divide 4 ranks
MESHES_2X2, MESHES_1X4 = ("1x2", "2x1", "2x2"), ("1x4",)
TRAIN_MESHES = ("1x2", "1x4", "2x2")
CASES = [(m, a) for m in MESHES_2X2 + MESHES_1X4 for a in ARCHS]


def _cfg(arch, **extra):
    return dataclasses.replace(get_smoke_config(arch), **{**ARCHS[arch], **extra})


def _mixer(cfg, tree):
    """The first recurrent mixer of the tree: (its path, its block, its
    layer-0 leaves as numpy)."""
    if cfg.family == "ssm":
        return ("layers", "mixer"), mamba2_block, tree["layers"]["mixer"]
    return ("groups", "p0_rglru", "mixer"), rglru_block, tree["groups"]["p0_rglru"]["mixer"]


def _unit(cfg, tree, mesh):
    """One mixer (layer 0's) on (2, 8) rows drawn from a seed under the
    training plan's splits (each leaf at its ``model`` shard; None: one
    device, whole): y and the gradients of y's weighted sum, of the input
    ``x`` and of every leaf (with their ranges)."""
    plan = None if mesh is None else training_plan(cfg, mesh)
    path, block, leaves = _mixer(cfg, tree)
    pls = sharding.params_shardings(build_model(cfg).specs(), mesh)
    for k in path:
        pls = pls[k]
    pls = {k: tuple(a if a == "model" else None for a in pl[1:]) for k, pl in pls.items()}
    p = {k: local_shard(torch.from_numpy(v[0]), pls[k], mesh).requires_grad_()
         for k, v in leaves.items()}
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(np.random.default_rng(10).standard_normal(x.shape).astype(np.float32))
    with mesh_context(mesh, plan):
        y = block(p, x, cfg)
    grads = torch.autograd.grad((y * g).sum(), [x, *p.values()])
    return {"y": y.detach().numpy(),
            "grads": shards_of(dict(zip(["x", *p], grads)), {"x": (None,) * 3, **pls}, mesh)}


def _requests(cfg):
    rng = np.random.default_rng(6)
    return [Request(prompt=rng.integers(1, cfg.vocab, int(rng.integers(3, 9))).astype(np.int32),
                    max_new=int(rng.integers(3, 6)), seed=r) for r in range(3)]


def _sched(cfg, tree, mesh):
    """The slot-pool scheduler (sequential admission, greedy) on ``mesh``:
    every completion."""
    sched = Scheduler(engine(cfg, tree, mesh), slots=2, segment=3, admission="sequential")
    reqs = _requests(cfg)
    for r in reqs:
        sched.submit(r)
    done = sched.run()
    return [done[i].tokens for i in range(len(reqs))]


def _ranks_2x2(mesh, device, trees):
    fp32_probs()
    meshes = {"1x2": mesh["model"], "2x1": mesh["data"], "2x2": mesh}
    out = {}
    for name, m in meshes.items():
        for arch in ARCHS:
            cfg = _cfg(arch)
            out[(name, arch)] = {"serve": serve(cfg, trees[arch], m)}
            if name in TRAIN_MESHES:
                out[(name, arch)]["train"] = train(cfg, trees[arch], m)
    for arch in ARCHS:
        cfg = _cfg(arch)
        out[("unit", "1x2", arch)] = _unit(cfg, trees[arch], meshes["1x2"])
        out[("sched", arch)] = {n: _sched(cfg, trees[arch], meshes[n]) for n in ("1x2", "2x2")}
        out[("no_gather", arch)] = no_gather(cfg, trees[arch], mesh)
    out["train_serve"] = train_then_serve(_cfg("mamba2_2_7b"), meshes["1x2"])
    return out


def _ranks_1x4(mesh, device, trees):
    fp32_probs()
    out = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        out[("1x4", arch)] = {"serve": serve(cfg, trees[arch], mesh),
                              "train": train(cfg, trees[arch], mesh)}
        out[("unit", "1x4", arch)] = _unit(cfg, trees[arch], mesh)
    fb = _cfg("mamba2_2_7b", **FALLBACK)
    out["fallback"] = {"serve": serve(fb, trees["fallback"], mesh),
                       "train": train(fb, trees["fallback"], mesh),
                       "unit": _unit(fb, trees["fallback"], mesh)}
    return out


# -- the test process: trees, worlds, one device's references ---------------------------


@pytest.fixture(scope="module")
def trees():
    out = {a: tree_of(_cfg(a)) for a in ARCHS}
    out["fallback"] = tree_of(_cfg("mamba2_2_7b", **FALLBACK))
    return out


def _one_device(trees) -> dict:
    """One device's runs of every case (serve, train, unit, the
    scheduler), each tree's one-ulp floor and ``repro``'s training step
    (``_repro_steps``)."""
    from repro_torch.models import layers

    saved = layers.FLAGS["attn_bf16_probs"]
    fp32_probs()
    try:
        out = {}
        for arch in ARCHS:
            cfg = _cfg(arch)
            out[arch] = {"serve": serve(cfg, trees[arch], None),
                         "train": train(cfg, trees[arch], None),
                         "unit": _unit(cfg, trees[arch], None),
                         "sched": _sched(cfg, trees[arch], None),
                         "floor": ulp_floor(cfg, trees[arch])}
        fb = _cfg("mamba2_2_7b", **FALLBACK)
        out["fallback"] = {"serve": serve(fb, trees["fallback"], None),
                           "train": train(fb, trees["fallback"], None),
                           "unit": _unit(fb, trees["fallback"], None),
                           "floor": ulp_floor(fb, trees["fallback"])}
        out["repro"] = _repro_steps(trees)
        return out
    finally:
        layers.FLAGS["attn_bf16_probs"] = saved


@pytest.fixture(scope="module")
def runs(trees, tmp_path_factory):
    """The 2x2 and 1x4 worlds, spawned at once, and one device's runs made
    in this process meanwhile."""
    return spawn_worlds({"1x4": (_ranks_1x4, 1, 4), "2x2": (_ranks_2x2, 2, 2)}, trees,
                        tmp_path_factory, lambda: _one_device(trees))


@pytest.fixture(scope="module")
def worlds(runs):
    return runs[0]


@pytest.fixture(scope="module")
def one(runs):
    return runs[1]


def _repro_steps(trees) -> dict:
    """``repro``'s loss and gradients of each arch on the first batch."""
    from repro.configs import get_smoke_config as ref_smoke

    return {arch: repro_step(dataclasses.replace(ref_smoke(arch), **ARCHS[arch]), trees[arch],
                             {"tokens": batches(_cfg(arch), 1)[0]["tokens"].numpy()})
            for arch in ARCHS}


@pytest.fixture(scope="module")
def repro_steps(one):
    return one["repro"]


def _ranks(mesh, worlds):
    return worlds["2x2" if mesh in MESHES_2X2 else "1x4"]


def _id(c):
    return "-".join(str(x) for x in c)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_generate_on_mesh_equals_one_device(case, worlds, one):
    """Greedy tokens, first-step logits within 1e-5 of the largest, every
    rank the same bits, a rank's stored bytes its placement's, the
    collectives of a decode step ``decode_collectives``'."""
    mesh, arch = case
    serve_gates([r[case]["serve"] for r in _ranks(mesh, worlds)], one[arch]["serve"])


@pytest.mark.parametrize("case", [(m, a) for m in TRAIN_MESHES for a in ARCHS], ids=_id)
def test_train_step_on_mesh_matches_one_device(case, worlds, one):
    """A step's loss within 1e-6 relative, each gradient shard within the
    larger of 1e-5 and one device's one-ulp floor, the collectives as
    ``train_collectives`` predicts."""
    mesh, arch = case
    for rank in _ranks(mesh, worlds):
        train_gates(rank[case]["train"], one[arch]["train"], one[arch]["floor"])


@pytest.mark.parametrize("case", [(m, a) for m in TRAIN_MESHES for a in ARCHS], ids=_id)
def test_train_step_on_mesh_matches_repro(case, worlds, repro_steps):
    """``repro``'s loss within 1e-5 relative and each gradient shard within
    5e-3 of the leaf's largest, as ``test_torch_tp_train.py`` holds its
    steps against ``repro``."""
    mesh, arch = case
    for rank in _ranks(mesh, worlds):
        repro_gates(rank[case]["train"], repro_steps[arch])


def test_plans_split_heads_and_channels(worlds):
    """Mamba-2's 4 heads split on 1x2, 1x4 and 2x2, the RG-LRU's 64
    channels too; recurrentgemma's attention (4 heads over 1 kv head) stays
    whole, its ff and both vocabularies split; 2x1 splits nothing over
    ``model``."""
    for mesh in ("1x2", "1x4", "2x2", "2x1"):
        split = mesh != "2x1"
        for rank in _ranks(mesh, worlds):
            assert rank[(mesh, "mamba2_2_7b")]["serve"]["plan"] == (split, False, False, False,
                                                                   split)
            assert rank[(mesh, "recurrentgemma_9b")]["serve"]["plan"] == (False, split, False,
                                                                         split, split)


# -- the gradient traps, by name ------------------------------------------------------


def _unit_gap(got, want, leaf, cols=None):
    """``leaf``'s gradient gap (of one device's largest), on the columns
    ``cols`` (a range of the whole leaf's last dim) of this rank's shard."""
    ranges, g = got["grads"][leaf]
    w = want["grads"][leaf][1]
    if cols is not None:
        lo, n = ranges[-1] if ranges is not None else (0, w.shape[-1])
        a, b = max(cols[0], lo), min(cols[1], lo + n)
        if a >= b:
            return 0.0
        g, ranges = g[..., a - lo:b - lo], None if ranges is None else ranges[:-1] + [(a, b - a)]
    return float(np.abs(g - cut(w, ranges)).max()) / float(np.abs(w).max())


def _mamba_cols(cfg, part):
    din, n = cfg.expand * cfg.d_model, cfg.ssm_state
    return {"z": (0, din), "B|C": (2 * din, 2 * din + 2 * n)}[part]


SSM_TRAPS = ("in_proj[B|C]", "in_proj[z]", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm",
             "x")
RGLRU_TRAPS = ("w_a", "w_i", "lam", "b_a", "b_i", "x")
UNIT_CASES = ([("mamba2_2_7b", t) for t in SSM_TRAPS]
              + [("recurrentgemma_9b", t) for t in RGLRU_TRAPS])


@pytest.mark.parametrize("mesh", ("1x2", "1x4"))
@pytest.mark.parametrize("arch,trap", UNIT_CASES, ids=[f"{a}-{t}" for a, t in UNIT_CASES])
def test_gradient_trap(mesh, arch, trap, worlds, one):
    """Each leaf or column range the ranks read differently from a whole
    tensor: its gradient on every rank is one device's within 1e-5 of the
    leaf's largest.  ``in_proj[B|C]``: the shared ``B`` and ``C`` columns
    every rank's heads read; ``in_proj[z]``: the gate's columns, whose
    gradient passes the norm's summed squares; ``conv_w``, ``conv_b``:
    gathered, then cut to the rank's channels and ``B``/``C``; ``A_log``,
    ``D``, ``dt_bias``, ``lam``: replicated, sliced; ``w_a``, ``w_i``: the
    summed gates' partial products; ``x``: the block's input."""
    cfg = _cfg(arch)
    want = one[arch]["unit"]
    leaf, _, part = trap.partition("[")
    cols = _mamba_cols(cfg, part[:-1]) if part else None
    for rank in _ranks(mesh, worlds):
        got = rank[("unit", mesh, arch)]
        close(got["y"], want["y"], "y")
        assert _unit_gap(got, want, leaf, cols) <= GRAD_TOL, trap


@pytest.mark.parametrize("mesh", ("1x2", "1x4"))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_mixer_gradient_is_one_devices(mesh, arch, worlds, one):
    """Every leaf of the mixer, not only the traps: the row-parallel
    ``out_proj`` / ``w_out``, the column-parallel ``in_proj`` / ``w_x`` /
    ``w_gate_branch`` and the per-channel conv."""
    want = one[arch]["unit"]
    for rank in _ranks(mesh, worlds):
        got = rank[("unit", mesh, arch)]
        gaps = {k: _unit_gap(got, want, k) for k in got["grads"]}
        assert max(gaps.values()) <= GRAD_TOL, gaps


def test_hybrid_tail_is_split_and_one_devices(worlds, one):
    """recurrentgemma at 5 layers: the unstacked tail's two RG-LRU layers
    store their channel shards (no layer dim) and their gradients are one
    device's within the gate on every mesh."""
    cfg = _cfg("recurrentgemma_9b")
    want, floor = one["recurrentgemma_9b"]["train"], one["recurrentgemma_9b"]["floor"]
    r = cfg.rglru_dim
    for mesh in TRAIN_MESHES:
        for rank in _ranks(mesh, worlds):
            got = rank[(mesh, "recurrentgemma_9b")]["train"]["grads"]
            tail = {k: v for k, v in got.items() if k.startswith("tail/")}
            assert {k.split("/")[1] for k in tail} == {"t0_rglru", "t1_rglru"}
            shape = tail["tail/t0_rglru/mixer/w_a"][1].shape
            assert shape == (r // int(mesh[-1]), r)
            gaps = shard_gaps(tail, want["grads"])
            assert max(gaps.values()) <= max(GRAD_TOL, floor), gaps


def test_fallback_runs_the_ssd_whole(worlds, one):
    """6 SSM heads on 4 ranks: the heads stay whole (the SSD on every rank),
    ``in_proj``'s 422 columns whole, the conv's and ``out_proj``'s rows
    split; tokens, logits, the training step and the mixer's gradients as
    one device's."""
    want = one["fallback"]
    for rank in worlds["1x4"]:
        got = rank["fallback"]
        assert got["serve"]["plan"][0] is False
        np.testing.assert_array_equal(got["serve"]["tokens"], want["serve"]["tokens"])
        close(got["serve"]["first"], want["serve"]["first"])
        assert got["serve"]["collectives"] == got["serve"]["predicted"]
        train_gates(got["train"], want["train"], want["floor"])
        assert got["unit"]["grads"]["in_proj"][0][-1] == (0, 422)
        gaps = {k: _unit_gap(got["unit"], want["unit"], k) for k in got["unit"]["grads"]}
        assert max(gaps.values()) <= GRAD_TOL, gaps


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_on_mesh_equals_one_device(mesh, arch, worlds, one):
    """Sequential admission on the slot pool, greedy: every completion as
    one device's scheduler gives it (which ``test_torch_ssm.py`` and
    ``test_torch_hybrid.py`` hold bitwise to one-shot ``generate`` at
    B = 1)."""
    for rank in worlds["2x2"]:
        for a, b in zip(rank[("sched", arch)][mesh], one[arch]["sched"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_no_step_or_refresh_gathers_the_tree(arch, worlds):
    """``generate`` (its priming steps too), a training step and a mask
    refresh on 2x2, its data and model axes both split: none reaches
    ``gather_tree``."""
    for rank in worlds["2x2"]:
        assert rank[("no_gather", arch)]


def test_trained_shards_serve_on_the_mesh(worlds):
    """Mamba-2 trained and pruned on 1x2, served on 1x2: one device's tokens
    on the gathered tree."""
    for rank in worlds["2x2"]:
        got = rank["train_serve"]
        np.testing.assert_array_equal(got["got"], got["want"])
        assert got["sparsity"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_rank_stores_under_three_tenths(arch):
    """A 1x4 rank of the full config (a quarter of the SSM's inner width and
    heads or of the RG-LRU's channels, of ff and of the vocabulary) stores
    at most 0.30 of the tree, on specs alone, under the engine's and the
    trainer's placements."""
    specs = build_model(get_config(arch)).specs()
    mesh = {"data": 1, "model": 4}
    whole = placement_bytes(specs, storage_placements(specs, None), None)
    for pls in (storage_placements(specs, mesh), sharding.params_shardings(specs, mesh)):
        assert placement_bytes(specs, pls, mesh) <= 0.30 * whole


def test_encdec_keeps_the_whole_tree_path():
    """Every family has a plan now, the encdec family (whisper) too
    (``tests/test_torch_tp_encdec.py`` holds it on meshes); the trainer's
    whole-tree path is gone (ROADMAP A12 item 4): on a ``model`` axis of 1
    the training plan splits nothing over ``model`` and gathers each
    layer's leaves over ``data`` at use, for whisper as for every family,
    and no mesh has no plan."""
    from repro_torch.dist.tp import PLAN_FAMILIES, serving_plan
    from repro_torch.models.families import FAMILIES

    cfg = get_smoke_config("whisper_tiny")
    assert set(PLAN_FAMILIES) == set(FAMILIES)
    for arch in ("whisper_tiny", "mamba2_2_7b"):
        plan = training_plan(get_smoke_config(arch), {"data": 2, "model": 1})
        assert plan is not None and plan.tp == 1 and plan.train
        assert not (plan.heads or plan.ff or plan.vocab or plan.ssm or plan.rglru)
    assert serving_plan(cfg, None) is None and training_plan(cfg, None) is None
