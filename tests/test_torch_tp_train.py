"""Port: tensor-parallel training of the dense family (ROADMAP A12, item 1),
on gloo ranks on the CPU.

Two worlds (``launch/mesh.spawn``, a rendezvous file under ``tmp_path``):
a 2x2 world trains on its ``model`` sub-mesh (1x2) and on the whole mesh;
a 1x4 world on four ``model`` ranks, where the smoke configs' 2 kv heads
do not divide four and training takes the sequence-sharded attention.
Every case starts from one numpy tree (the port's init with every bias and
norm scale redrawn, so a misplaced one shows) and reads one synthetic
stream; the step is the Trainer's (``Trainer.step_fn``), held against the
port's one-device step:

- the three differentiable collectives of ``dist/comm.py`` against their
  single-process compositions, forward and backward;
- ``vusa_edge``, ``llama3_2_1b`` (tied), ``qwen3_8b`` (qk-norm, kv 2) and
  ``qwen2_0_5b`` (QKV bias, tied) on 1x2 (heads split) and 1x4 (sequence
  split; ``vusa_edge``'s 4 kv heads split), the flash attention's
  probabilities in fp32 (``_fp32_probs``): the first step's loss within
  1e-6 relative, each rank's gradient shards within 1e-5 of the leaf's
  largest |g| and the global norm within 1e-6, or within one device's own
  floor where that is larger (how far its step moves when its parameters
  move by an ulp, ``_floor``: the redrawn norm scales make these tiny
  models' gradients that sensitive), the parameters after 3 steps within
  the bound Adam's steps put on a weight's move (``_adam_bound``); every
  rank's loss, norm and replicated-leaf gradients bitwise the others';
- the first step's loss and gradients (the shards gathered) against
  ``jax.value_and_grad`` of ``repro``'s loss, at
  ``test_torch_train.py``'s tolerances (loss 1e-6, gradients 5e-3);
- the four on 2x2 (the batch split over ``data``) against one device's
  step over the same batch in two microbatches; ``grad_compress`` on 1x2 against one
  device's compressed step (each gradient entry within one int8 quantum);
- the collectives of a step equal ``TPPlan.train_collectives``, with and
  without remat; a stand-in ``gather_tree`` that raises never runs in a
  step or a mask refresh on 1x2, 2x1 or 2x2; masks refreshed leaf by leaf
  bitwise the whole-tree masks;
- the 1x2-trained, pruned shards served by ``Engine(mesh=)`` give one
  device's greedy tokens on the gathered tree;
- ``launch/train.py --model 2`` trains.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.pruning import masks_tree
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.dist import comm
from repro_torch.dist import sharding
from repro_torch.dist.sharding import gather_whole, local_shard, shard_tree
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import spawn
from repro_torch.models import build_model
from repro_torch.optim import AdamState, adamw_init
from repro_torch.optim.adamw import tree_items
from repro_torch.serve import Engine, ServeConfig
from repro_torch.train import TrainConfig, Trainer, TrainHParams
from repro_torch.train.step import _tree as nest

ARCHS = ("vusa_edge", "llama3_2_1b", "qwen3_8b", "qwen2_0_5b")
STEPS = 3
LR = 1e-3
BATCH, SEQ = 4, 16
LOSS_TOL, GRAD_TOL, NORM_TOL = 1e-6, 1e-5, 1e-6
# (mesh, arch, extra) of each case: extra names what differs from the plain
# step ("mb2": one device's step in two microbatches, "compress", "remat")
CASES_2X2 = ([("1x2", a, "") for a in ARCHS] + [("1x2", "vusa_edge", "remat"),
                                               ("1x2", "qwen3_8b", "remat"),
                                               ("1x2", "vusa_edge", "compress")]
             + [("2x2", a, "mb2") for a in ARCHS])
CASES_1X4 = [("1x4", a, "") for a in ARCHS] + [("1x4", "qwen2_0_5b", "remat")]
PLAIN = [c for c in CASES_2X2 + CASES_1X4 if c[2] in ("", "remat")]


def _perturbed(arch: str) -> dict:
    """The port's seeded init of ``arch``'s smoke config with every bias and
    norm scale redrawn from normal(0, 0.5), as numpy."""
    params = build_model(get_smoke_config(arch)).init(0, device="cpu")
    rng = np.random.default_rng(1)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else (
            rng.normal(0, 0.5, tuple(v.shape)).astype(np.float32)
            if k in ("bq", "bk", "bv") or "norm" in k else v.numpy().copy())
            for k, v in sorted(t.items())}

    return walk(params)


def _cfg(arch, extra=""):
    cfg = get_smoke_config(arch)
    return dataclasses.replace(cfg, remat=True) if extra == "remat" else cfg


def _tc(extra="", steps=STEPS, **kw):
    hp = TrainHParams(lr=LR, warmup=1, total_steps=steps, grad_compress=extra == "compress",
                      microbatches=2 if extra == "mb2" else 1)
    return TrainConfig(steps=steps, global_batch=BATCH, seq_len=SEQ, token_range=64,
                       prune_begin=steps + 1, log_every=1, hp=hp, **kw)


def _adam_bound(t: int, b1: float = 0.9, b2: float = 0.95) -> float:
    """The largest |m_hat / sqrt(v_hat)| Adam's ``t``-th update (1-based) can
    take, by Cauchy-Schwarz over the gradients so far (eps ignored)."""
    w1 = [(1 - b1) * b1 ** (t - i) for i in range(1, t + 1)]
    w2 = [(1 - b2) * b2 ** (t - i) for i in range(1, t + 1)]
    return math.sqrt(sum(a * a / b for a, b in zip(w1, w2))) * math.sqrt(1 - b2**t) / (1 - b1**t)


def _param_tol(tc) -> float:
    """How far two runs' weights may part after ``tc.steps`` steps from one
    state: each step moves a weight by at most lr x (Adam's bound + decay
    of a weight below 1), in either direction."""
    from repro_torch.optim.schedule import cosine_schedule

    hp = tc.hp
    return sum(2 * cosine_schedule(t, hp.warmup, hp.total_steps, hp.lr)
               * (_adam_bound(t + 1) + hp.weight_decay) for t in range(tc.steps))


def _gap(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def _case(tree, mesh, case):
    """One case on this rank: the TP trainer's steps from this rank's shards
    of ``tree`` beside one device's from the whole tree, on the same
    batches; the first step's gaps (loss, norm, each gradient shard), the
    parameters' and moments' gaps after ``STEPS``, digests of what every
    rank must hold alike, the first step's collectives and prediction, and
    on the lead rank the first step's gradients gathered whole."""
    name, arch, extra = case
    cfg = _cfg(arch, extra)
    tc = _tc(extra)
    one = Trainer(cfg, tc, device="cpu")
    tp = Trainer(cfg, tc, device="cpu", mesh=mesh)
    params = params_from_numpy(tree, "cpu")
    opt = adamw_init(params)
    shard = functools.partial(shard_tree, placements=tp.p_shard, mesh=mesh)
    shards, topt = shard(params), AdamState(opt.step.clone(), shard(opt.mu), shard(opt.nu))
    data = iter(SyntheticDataset(cfg, tc.global_batch, tc.seq_len, seed=tc.seed,
                                 token_range=tc.token_range))
    spec = [pl for _, pl in tree_items(tp.p_shard)]
    out = {}
    for step in range(STEPS):
        host = next(data)
        batch = {k: torch.from_numpy(v) for k, v in host.items()}
        rows = batch if tp.rows is None else {k: torch.from_numpy(v[tp.rows])
                                              for k, v in host.items()}
        comm.reset_stats()
        shards, topt, got = tp.step_fn(shards, topt, rows, return_grads=True)
        collectives = comm.STATS["collectives"]
        params, opt, want = one.step_fn(params, opt, batch, return_grads=True)
        if step:
            continue
        wants = [local_shard(w, pl, mesh) for w, pl in zip(want["grads"], spec)]
        out.update(
            loss_gap=abs(float(got["loss"]) / float(want["loss"]) - 1),
            norm_gap=abs(float(got["gnorm"]) / float(want["gnorm"]) - 1),
            grad_gaps={"/".join(p): float((g - w).abs().max()) / float(wf.abs().max())
                       for (p, _), g, w, wf in zip(tree_items(tp.p_shard), got["grads"],
                                                   wants, want["grads"])},
            quanta={"/".join(p): float((g - w).abs().max()) / (float(wf.abs().max()) / 127)
                    for (p, _), g, w, wf in zip(tree_items(tp.p_shard), got["grads"], wants,
                                                want["grads"])},
            collectives=collectives,
            predicted=tp.plan.train_collectives(cfg, SEQ, tc.hp.microbatches,
                                                split=tp.rows is not None,
                                                compress=tc.hp.grad_compress),
            same=[float(got["loss"]), float(got["gnorm"])],
            replicated=[g.numpy().tobytes() for g, pl in zip(got["grads"], spec)
                        if "model" not in pl],
            data_rank=comm.axis_index(mesh, "data"),
            tokens=host["tokens"],
            grads={"/".join(p): gather_whole(g, pl, mesh).numpy()
                   for (p, _), g, pl in zip(tree_items(tp.p_shard), got["grads"], spec)})
    for what, a, b in (("params", shards, params), ("mu", topt.mu, opt.mu),
                       ("nu", topt.nu, opt.nu)):
        out[what] = max(_gap(x, local_shard(y, pl, mesh)) if what != "params"
                        else float((x - local_shard(y, pl, mesh)).abs().max())
                        for (_, x), (_, y), pl in zip(tree_items(a), tree_items(b), spec))
    out["param_tol"] = _param_tol(tc)
    if any(mesh.get_coordinate()):
        del out["grads"], out["tokens"]
    return out


def _floor(arch: str, extra: str, tree: dict, draws: int = 4) -> dict:
    """How far one device's first step of a case moves when every parameter
    moves by about an ulp (a relative 2^-23 x normal(0, 1), ``draws`` draws
    from fixed seeds), the conditioning any reordered sum meets: the
    largest over the draws of the gradients' gap (of each leaf's largest
    |g|) and of the norm's.  At the smoke configs' redrawn norm scales one
    draw moves the gradients by 1.2e-6 (``qwen3_8b``) to 1.2e-4
    (``qwen2_0_5b``) of the largest and the norm by up to 4.2e-5; the TP
    step is gated at the larger of this floor and ``GRAD_TOL`` /
    ``NORM_TOL``."""
    cfg, tc = _cfg(arch, extra), _tc(extra)
    one = Trainer(cfg, tc, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in next(iter(SyntheticDataset(
        cfg, tc.global_batch, tc.seq_len, seed=tc.seed, token_range=tc.token_range))).items()}
    params = params_from_numpy(tree, "cpu")
    _, _, want = one.step_fn(params, adamw_init(params), batch, return_grads=True)
    grad, norm = 0.0, 0.0
    for seed in range(draws):
        gen = torch.Generator().manual_seed(seed)
        params = params_from_numpy(tree, "cpu")
        for _, leaf in tree_items(params):
            leaf.mul_(1 + 2.0**-23 * torch.randn(leaf.shape, generator=gen))
        _, _, moved = one.step_fn(params, adamw_init(params), batch, return_grads=True)
        grad = max(grad, *(_gap(a, b) for a, b in zip(moved["grads"], want["grads"])))
        norm = max(norm, abs(float(moved["gnorm"]) / float(want["gnorm"]) - 1))
    return {"floor_grad": grad, "floor_norm": norm}


def _no_gather(tree, mesh):
    """One training step and one mask refresh on ``mesh`` with
    ``gather_tree`` replaced by a stand-in that raises: whether either
    called it."""
    cfg = get_smoke_config("vusa_edge")
    tp = Trainer(cfg, _tc(), device="cpu", mesh=mesh)
    shards = shard_tree(params_from_numpy(tree, "cpu"), tp.p_shard, mesh)
    batch = {k: torch.from_numpy(v) for k, v in next(iter(SyntheticDataset(
        cfg, BATCH, SEQ, seed=0, token_range=64))).items()}
    calls = []

    def refuse(*a, **kw):
        calls.append(1)
        raise AssertionError("gather_tree in a tensor-parallel step")

    real = sharding.gather_tree
    sharding.gather_tree = refuse
    try:
        tp.step_fn(shards, adamw_init(shards), batch)
        tp.refresh_masks(shards, 0.5)
    finally:
        sharding.gather_tree = real
    return not calls


def _masks(tree, mesh):
    """Masks refreshed leaf by leaf against the whole tree's, this rank's
    shards, at two sparsities: bitwise."""
    tp = Trainer(get_smoke_config("vusa_edge"), _tc(), device="cpu", mesh=mesh)
    whole = params_from_numpy(tree, "cpu")
    shards = shard_tree(whole, tp.p_shard, mesh)
    ok = []
    for s in (0.5, 0.85):
        got = tp.refresh_masks(shards, s)
        want = shard_tree(masks_tree(whole, s), tp.p_shard, mesh)
        ok.append(all((x is None and y is None) or torch.equal(x, y)
                      for (_, x), (_, y) in zip(tree_items(got), tree_items(want))))
    return all(ok)


def _serve(mesh):
    """The trainer on 1x2 with pruning, its shards served through
    ``Engine(mesh=)`` on the packed route, beside one device's engine on the
    gathered tree: both greedy tokens, and the sparsity."""
    cfg = get_smoke_config("vusa_edge")
    tc = dataclasses.replace(_tc(steps=4), prune_begin=1, prune_end=3, prune_every=2)
    out = Trainer(cfg, tc, device="cpu", mesh=mesh).train()
    sc = ServeConfig(max_len=48, packed_weights="all")
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (4, 8))
    tp = Engine(cfg, out["shards"], sc, device="cpu", mesh=mesh).generate(prompts, max_new=6)
    whole = nest(*zip(*tree_items(out["params"])))  # the trainer's view, leaf by leaf
    one = Engine(cfg, whole, sc, device="cpu").generate(prompts, max_new=6)
    return {"tp": tp["tokens"], "one": one["tokens"], "sparsity": out["sparsity"]}


def _functions(mesh):
    """``enter_model``, ``sum_model`` and ``gather_model`` on this rank's
    inputs (drawn from the rank's seed), forward and backward, against the
    single-process composition over every rank's inputs (each rank draws
    them all from the same seeds)."""
    tp, r = comm.axis_size(mesh, "model"), comm.axis_index(mesh, "model")
    xs = [torch.randn(3, 4, generator=torch.Generator().manual_seed(i)) for i in range(tp)]
    ws = [torch.randn(4, 5, generator=torch.Generator().manual_seed(10 + i)) for i in range(tp)]
    # enter: y_r = x @ w_r on every rank; d/dx of sum_r sum(y_r) is sum_r of
    # each rank's part, in rank order
    x = xs[0].clone().requires_grad_()
    comm.enter_model(x, mesh).matmul(ws[r]).sum().backward()
    want_dx = functools.reduce(torch.add, [torch.ones(3, 5) @ w.T for w in ws])
    enter = torch.equal(x.grad, want_dx)
    # sum: y = sum_r x_r @ w_r; its gradient passes unchanged to every rank
    x = xs[r].clone().requires_grad_()
    y = comm.sum_model(x @ ws[r], mesh)
    want_y = functools.reduce(torch.add, [a @ b for a, b in zip(xs, ws)])
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(99))
    y.backward(g)
    summ = torch.equal(y, want_y) and torch.equal(x.grad, g @ ws[r].T)
    # gather: the slices joined along dim 1; the gradient is this rank's slice
    x = xs[r].clone().requires_grad_()
    y = comm.gather_model(x * 2, mesh, dim=1)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(98))
    y.backward(g)
    gather = torch.equal(y, torch.cat([a * 2 for a in xs], dim=1)) and torch.equal(
        x.grad, 2 * g[:, 4 * r:4 * (r + 1)])
    return {"enter": enter, "sum": summ, "gather": gather}


def _fp32_probs():
    """The flash attention's probabilities in fp32 on both sides, as the
    family pairs and the card's TP gates hold them: in bf16 an ordered
    sum's last-bit difference flips a probability's bf16 rounding, and
    ``wv``'s gradient then parts by 4.6e-4 of its largest."""
    from repro_torch.models.layers import FLAGS

    FLAGS["attn_bf16_probs"] = False


def _thread_backward(tree, mesh) -> bool:
    """``qwen2_0_5b``'s loss under the training plan with remat (its
    sequence-split attention recomputed in the backward), made on this
    thread, its gradients taken here and on another thread, as autograd
    takes a card's backward on its device thread, where this thread's
    ``mesh_context`` does not reach: whether both equal."""
    import threading

    from repro_torch.dist.tp import training_plan
    from repro_torch.models.common import mesh_context

    cfg = _cfg("qwen2_0_5b", "remat")
    plan = training_plan(cfg, mesh)
    shards = shard_tree(params_from_numpy(tree, "cpu"), plan.placements, mesh)
    batch = {k: torch.from_numpy(v) for k, v in next(iter(SyntheticDataset(
        cfg, BATCH, SEQ, seed=0, token_range=64))).items()}

    def grads(run):
        leaves = [t.detach().requires_grad_() for _, t in tree_items(shards)]
        params = {}
        for (path, _), t in zip(tree_items(shards), leaves):
            node = params
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = t
        with mesh_context(mesh, plan):
            loss = build_model(cfg).loss(params, batch)
        box = {}

        def backward():
            try:
                box["g"] = torch.autograd.grad(loss, leaves)
            except Exception as e:  # reported as a mismatch
                box["error"] = repr(e)

        run(backward)
        return box.get("g")

    def in_thread(fn):
        t = threading.Thread(target=fn)
        t.start()
        t.join()

    here, there = grads(lambda fn: fn()), grads(in_thread)
    return there is not None and all(torch.equal(a, b) for a, b in zip(here, there))


def _ranks_2x2(mesh, device, trees):
    _fp32_probs()
    meshes = {"1x2": mesh["model"], "2x2": mesh}
    out = {c: _case(trees[c[1]], meshes[c[0]], c) for c in CASES_2X2}
    out["functions"] = _functions(mesh["model"])
    out["no_gather"] = {name: _no_gather(trees["vusa_edge"], m) for name, m in
                        (("1x2", mesh["model"]), ("2x1", mesh["data"]), ("2x2", mesh))}
    out["masks"] = _masks(trees["vusa_edge"], mesh)
    out["serve"] = _serve(mesh["model"])
    return out


def _ranks_1x4(mesh, device, trees):
    from repro_torch.models.layers import _maybe_seq_sharded_attention

    _fp32_probs()
    out = {}
    for c in CASES_1X4:
        before = _maybe_seq_sharded_attention.calls
        out[c] = _case(trees[c[1]], mesh, c)
        out[c]["seq_calls"] = _maybe_seq_sharded_attention.calls - before
    out["functions"] = _functions(mesh)
    out["thread_backward"] = _thread_backward(trees["qwen2_0_5b"], mesh)
    return out


@pytest.fixture(scope="module")
def trees():
    return {arch: _perturbed(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def floors(trees):
    """``_floor`` of every case's one-device step, with the ranks' fp32
    attention probabilities (the flag put back after)."""
    from repro_torch.models.layers import FLAGS

    saved = FLAGS["attn_bf16_probs"]
    FLAGS["attn_bf16_probs"] = False
    try:
        return {(a, e): _floor(a, e, trees[a]) for _, a, e in set(CASES_2X2 + CASES_1X4)
                if e != "compress"}
    finally:
        FLAGS["attn_bf16_probs"] = saved


@pytest.fixture(scope="module")
def world_2x2(trees, tmp_path_factory):
    return spawn(_ranks_2x2, 2, 2, "gloo", "cpu", str(tmp_path_factory.mktemp("tp_train2x2")),
                 args=(trees,), timeout_s=300)


@pytest.fixture(scope="module")
def world_1x4(trees, tmp_path_factory):
    return spawn(_ranks_1x4, 1, 4, "gloo", "cpu", str(tmp_path_factory.mktemp("tp_train1x4")),
                 args=(trees,), timeout_s=300)


def _ranks(case, world_2x2, world_1x4):
    return world_2x2 if case in CASES_2X2 else world_1x4


def _id(c):
    return "-".join(x for x in c if x)


@pytest.mark.parametrize("world", ["2x2", "1x4"])
def test_differentiable_collectives(world, world_2x2, world_1x4):
    for rank in (world_2x2 if world == "2x2" else world_1x4):
        assert rank["functions"] == {"enter": True, "sum": True, "gather": True}


@pytest.mark.parametrize("case", PLAIN, ids=_id)
def test_tp_step_matches_one_device(case, world_2x2, world_1x4, floors):
    for rank in _ranks(case, world_2x2, world_1x4):
        _within(rank[case], floors[case[1:]])


def _within(got, floor) -> None:
    """The first step's gates: the loss; the norm and each gradient shard
    within the stated tolerance or one device's own one-ulp floor
    (``_floor``), whichever is larger; the parameters after ``STEPS``."""
    assert got["loss_gap"] <= LOSS_TOL, got["loss_gap"]
    assert got["norm_gap"] <= max(NORM_TOL, floor["floor_norm"]), (got, floor)
    assert max(got["grad_gaps"].values()) <= max(GRAD_TOL, floor["floor_grad"]), (got, floor)
    assert got["params"] <= got["param_tol"], (got["params"], got["param_tol"])


@pytest.mark.parametrize("case", [c for c in CASES_2X2 + CASES_1X4 if c[2] != "compress"],
                         ids=_id)
def test_tp_ranks_agree_bitwise(case, world_2x2, world_1x4):
    """Every rank's loss and norm, and the replicated leaves' gradients of
    every rank of one data coordinate (a leaf on ``data`` holds its own
    rows there), bitwise."""
    ranks = [r[case] for r in _ranks(case, world_2x2, world_1x4)]
    for rank in ranks[1:]:
        assert rank["same"] == ranks[0]["same"]
        lead = next(r for r in ranks if r["data_rank"] == rank["data_rank"])
        assert rank["replicated"] == lead["replicated"]


@pytest.mark.parametrize("case", [c for c in CASES_2X2 + CASES_1X4], ids=_id)
def test_tp_step_collectives_as_predicted(case, world_2x2, world_1x4):
    for rank in _ranks(case, world_2x2, world_1x4):
        assert rank[case]["collectives"] == rank[case]["predicted"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", ["1x2", "1x4", "2x2"])
def test_tp_first_step_matches_repro(arch, mesh, world_2x2, world_1x4, monkeypatch):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import build_model as ref_build
    from repro.models.opt_flags import FLAGS as REF_FLAGS

    case = (mesh, arch, "mb2" if mesh == "2x2" else "")
    got = _ranks(case, world_2x2, world_1x4)[0][case]
    monkeypatch.setitem(REF_FLAGS, "attn_bf16_probs", False)
    tree = _perturbed(arch)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a, copy=True)), tree)
    loss, grads = jax.value_and_grad(ref_build(ref_smoke(arch)).loss)(
        params, {"tokens": jnp.asarray(got["tokens"])})
    assert got["same"][0] == pytest.approx(float(loss), rel=1e-6)
    for path, want in jax.tree_util.tree_flatten_with_path(grads)[0]:
        name = "/".join(k.key for k in path)
        want = np.asarray(want)
        gap = np.abs(got["grads"][name] - want).max() / np.abs(want).max()
        assert gap <= 5e-3, (name, gap)


def test_tp_sequence_split_runs_under_grad(world_1x4):
    """On 1x4 the smoke configs' 2 kv heads do not divide four: training
    takes the sequence-sharded attention (each layer, each step), and
    ``vusa_edge``'s 4 kv heads split instead."""
    layers = get_smoke_config("qwen2_0_5b").n_layers
    for rank in world_1x4:
        for arch in ("llama3_2_1b", "qwen3_8b", "qwen2_0_5b"):
            assert rank[("1x4", arch, "")]["seq_calls"] == STEPS * layers
        assert rank[("1x4", "qwen2_0_5b", "remat")]["seq_calls"] == 2 * STEPS * layers
        assert rank[("1x4", "vusa_edge", "")]["seq_calls"] == 0


def test_tp_remat_recompute_keeps_the_plan_on_another_thread(world_1x4):
    assert all(rank["thread_backward"] for rank in world_1x4)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_2x2_step_matches_the_microbatched_step(arch, world_2x2, floors):
    for rank in world_2x2:
        _within(rank[("2x2", arch, "mb2")], floors[(arch, "mb2")])


def test_tp_compressed_step_matches_one_device(world_2x2):
    """Compression rounds each entry to one of 255 levels by stochastic
    rounding with the same noise: an entry whose gradient moved by rounding
    across a level boundary differs by one quantum (max|g| / 127)."""
    case = ("1x2", "vusa_edge", "compress")
    for rank in world_2x2:
        got = rank[case]
        assert got["loss_gap"] <= LOSS_TOL, got["loss_gap"]
        assert max(got["quanta"].values()) <= 1.0 + 1e-4, got["quanta"]
        assert got["params"] <= got["param_tol"]


def test_tp_step_never_gathers_the_tree(world_2x2):
    """On every mesh, a ``data`` axis alone (2x1) included: no step and no
    mask refresh calls ``gather_tree``."""
    for rank in world_2x2:
        assert rank["no_gather"] == {"1x2": True, "2x1": True, "2x2": True}


def test_tp_masks_refreshed_leaf_by_leaf_are_the_whole_tree_masks(world_2x2):
    assert all(rank["masks"] for rank in world_2x2)


def test_tp_trained_shards_serve_on_the_mesh(world_2x2):
    for rank in world_2x2:
        got = rank["serve"]
        np.testing.assert_array_equal(got["tp"], got["one"])
        assert got["sparsity"] > 0


def test_train_launcher_trains_tensor_parallel(capfd):
    out = launch_train.main(["--arch", "vusa_edge", "--smoke", "--device", "cpu", "--model",
                             "2", "--dist-backend", "gloo", "--steps", "2", "--batch", "4",
                             "--seq", "16"])
    assert np.isfinite(out["final_loss"])
    assert "final loss" in capfd.readouterr().out
