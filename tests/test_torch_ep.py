"""Port: the moe family on a (data, model) mesh (ROADMAP A12, items 1-2):
expert parallelism and the whole-batch routing, on gloo ranks on the CPU.

Two worlds (``launch/mesh.spawn``, a rendezvous file under ``tmp_path``):
a 2x2 world runs its ``model`` sub-mesh (1x2), its ``data`` sub-mesh (2x1)
and the whole mesh; a 1x4 world four ``model`` ranks.  Both moe smoke
pairs (``tests/torch_family_pairs.py``: ``repro``'s smoke init with every
bias and norm scale redrawn, 8 experts, 4 heads and 4 kv heads): olmoe at
top-2 and moonshot at top-3 (its published router picks 6; its smoke
config is olmoe's shape, and three experts a token make an expert-parallel
sum add more than two nonzero partials), each at ``moe_cf`` 4.0
(dropless), 1.25 and 0.5 (tokens dropped), the flash attention's
probabilities in fp32 on both sides.  Held here, against the port's one
device (each rank computes it too) and ``repro``:

- C16: on 2x1 at ``moe_cf`` 0.5 ``generate``'s greedy tokens and
  first-step logits and a training step's loss and gradients against
  ``repro``'s whole-batch program (``prefill`` / ``decode_step``, ``loss``
  under ``jax.value_and_grad``): logits within 1e-5 of the largest, as
  ``test_torch_moe.py``; loss within 1e-5 relative, gradients within 5e-3
  of the leaf's largest, ``test_torch_tp_train.py``'s against ``repro``
  (one device's own gap to ``repro`` at this batch is 2e-5 of the
  embedding's largest);
- on every mesh, arch and capacity, against one device's runs of the same
  config (made once in this process while the ranks run): each routed call's integers (expert
  ids, places over the whole batch, drops) bitwise one device's rows;
  ``generate``'s tokens equal one device's, its first-step logits within
  1e-5 of the largest; layer 0's ``layers.moe`` under the training plan
  against ``repro``'s within 1e-5; a training step's loss within 1e-6
  relative and each gradient shard within the larger of 1e-5 and one
  device's one-ulp floor of the leaf's largest (``_ulp_floor``, as
  ``test_torch_tp_train.py`` gates its steps, two draws at ``moe_cf``
  1.25: at these redrawn norm scales one device's gradients move about
  9e-5 (olmoe) to 2.3e-4 (moonshot) when its parameters move an ulp; the
  mesh's gaps are about 1e-5), and at ``moe_cf`` 1.25 the
  parameters after 3 steps within the bound Adam's steps put on a
  weight's move (``_adam_bound``); the collectives of a step equal
  ``TPPlan.train_collectives``; ``repro``'s loss and gradients at
  ``moe_cf`` 0.5 on every mesh, at the C16 tolerances;
- each gradient trap of the expert-parallel forward, by name: the config's
  whole ``e`` (``local_config`` keeps it; the drops equal one device's);
  the gate weights, not the router's probabilities, enter the split (the
  aux loss's router gradient is one device's, not ``tp`` times it); the
  token rows enter once (their gradient is one device's); a row-wise call
  makes one collective for the batch; remat redoes the routing (the same
  integers, the collectives as predicted);
- the slot-pool scheduler on 1x2, 1x4 and 2x2 completes every request as
  one device's ``generate`` at B = 1; the E-does-not-divide-``model``
  fallback (6 experts on 1x4: the experts whole, their ff dim split); no
  step or mask refresh calls ``gather_tree``; the 1x2-trained, pruned
  shards served on 1x2 give one device's tokens on the gathered tree;
- a 1x4 rank of ``olmoe_1b_7b``'s full config stores at most 0.30 of the
  one-device tree (``placement_bytes``, on specs alone).
"""

import dataclasses
import math
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.dist import comm, sharding
from repro_torch.dist.sharding import local_shard, shard_ranges, shard_tree
from repro_torch.dist.tp import (
    local_config, placement_bytes, serving_plan, storage_placements, training_plan,
)
from repro_torch.launch.mesh import spawn
from repro_torch.models import build_model, layers
from repro_torch.models.common import mesh_context
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_items
from repro_torch.serve import Engine, Request, Scheduler, ServeConfig
from repro_torch.train import TrainConfig, Trainer, TrainHParams
from repro_torch.train.step import _tree as _nest

ARCHS = {"olmoe_1b_7b": {}, "moonshot_v1_16b_a3b": {"top_k": 3}}
CFS = (4.0, 1.25, 0.5)
MESHES_2X2, MESHES_1X4 = ("1x2", "2x1", "2x2"), ("1x4",)
BATCH, PROMPT, NEW, SEQ, LR = 4, 8, 5, 16, 1e-3
STEPS = {4.0: 1, 1.25: 3, 0.5: 1}  # steps a case trains: 3 where Adam's bound is held
LOGIT_TOL, LOSS_TOL, GRAD_TOL, REPRO_GRAD_TOL = 1e-5, 1e-6, 1e-5, 5e-3
CASES = [(m, a, cf) for m in MESHES_2X2 + MESHES_1X4 for a in ARCHS for cf in CFS]
FALLBACK = ("olmoe_1b_7b", 1.25, 6)  # on 1x4: 6 experts do not divide 4 ranks


def _cfg(arch, cf, experts=None):
    cfg = dataclasses.replace(get_smoke_config(arch), moe_cf=cf, **ARCHS[arch])
    return cfg if experts is None else dataclasses.replace(cfg, n_experts=experts)


def _key(cfg):
    return (cfg.name, cfg.moe_cf, cfg.n_experts)


def _tree(cfg) -> dict:
    """The port's seeded init of ``cfg`` with every bias and norm scale
    redrawn (``torch_family_pairs.perturb``), as numpy."""
    from torch_family_pairs import perturb

    return perturb(params_to_numpy(build_model(cfg).init(0, device="cpu")))


def _prompts(cfg):
    return np.random.default_rng(5).integers(0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)


def _batches(cfg, n):
    data = iter(SyntheticDataset(cfg, BATCH, SEQ, seed=0, token_range=64))
    return [{k: torch.from_numpy(v) for k, v in next(data).items()} for _ in range(n)]


def _fp32_probs():
    layers.FLAGS["attn_bf16_probs"] = False


def _trace(fn):
    """``fn()`` with ``layers.moe.trace`` on: (its result, every routed
    call's integers as numpy)."""
    layers.moe.trace = []
    try:
        out = fn()
        return out, [{k: v.numpy() for k, v in t.items()} for t in layers.moe.trace]
    finally:
        layers.moe.trace = None


def _span(s):
    return None if s is None else (s.start, s.stop)


def _serve(cfg, tree, mesh):
    """``generate`` on ``mesh`` (None: one device): its tokens, the first
    decode step's whole logits (the first the engine chooses from) and
    every routed call's integers (this rank's rows)."""
    eng = Engine(cfg, params_from_numpy(tree, "cpu"), ServeConfig(max_len=24), device="cpu",
                 mesh=mesh)
    seen, choose = [], eng._choose

    def keep(logits, *a):
        seen.append(logits.numpy().copy())
        return choose(logits, *a)

    eng._choose = keep
    tokens, ints = _trace(lambda: eng.generate(_prompts(cfg), max_new=NEW)["tokens"])
    return {"first": seen[0], "tokens": tokens, "ints": ints, "rows": _span(eng._rows(BATCH))}


def _tc(steps):
    return TrainConfig(steps=steps, global_batch=BATCH, seq_len=SEQ, token_range=64,
                       prune_begin=steps + 1, log_every=1,
                       hp=TrainHParams(lr=LR, warmup=1, total_steps=steps))


def _shards(tree, placements, mesh) -> dict:
    """Each leaf of ``tree`` (this rank's shards under ``placements``) as
    ``(ranges, values)``: its ``shard_ranges`` in the whole leaf (None on
    one device), for the test process to cut one device's leaf alike."""
    pls = dict(tree_items(placements)) if mesh is not None else {}
    out = {}
    for path, t in tree_items(tree):
        ranges = None
        if mesh is not None:
            pl = pls[path]
            whole = [d * math.prod(comm.axis_size(mesh, a) for a in sharding._names(e))
                     for d, e in zip(t.shape, pl)]
            ranges = [tuple(r) for r in shard_ranges(whole, pl, mesh)]
        out["/".join(path)] = (ranges, t.detach().numpy().copy())
    return out


def _train(cfg, tree, mesh):
    """``STEPS[cf]`` steps of the Trainer's step on ``mesh`` (None: one
    device) from this rank's shards of ``tree``: the first step's loss,
    gradient shards, routed integers and collectives (and the plan's
    prediction), the parameters after the last step."""
    steps = STEPS[cfg.moe_cf]
    tr = Trainer(cfg, _tc(steps), device="cpu", mesh=mesh)
    params = params_from_numpy(tree, "cpu")
    if mesh is not None:
        params = shard_tree(params, tr.p_shard, mesh)
    opt = adamw_init(params)
    out = {}
    for step, batch in enumerate(_batches(cfg, steps)):
        rows = batch if tr.rows is None else {k: v[tr.rows] for k, v in batch.items()}
        comm.reset_stats()
        (params, opt, got), ints = _trace(lambda: tr.step_fn(params, opt, rows,
                                                             return_grads=True))
        if step == 0:
            grads = _nest([p for p, _ in tree_items(params)], got["grads"])
            out.update(loss=float(got["loss"]), ints=ints, rows=_span(tr.rows),
                       collectives=comm.STATS["collectives"],
                       grads=_shards(grads, tr.p_shard, mesh),
                       predicted=None if tr.plan is None else tr.plan.train_collectives(
                           cfg, SEQ, split=tr.rows is not None),
                       plan=None if tr.plan is None else (tr.plan.experts, tr.plan.ff))
    out["params"] = _shards(params, tr.p_shard, mesh)
    return out


def _unit(cfg, tree, mesh):
    """Layer 0's ``layers.moe`` on (2, 8) rows drawn from a seed, under the
    training plan's splits (the experts at their ``model`` shard; this
    rank's rows where ``data`` splits them; None: one device, whole): y,
    aux, and where ``data`` does not split the rows the gradients of y's
    weighted sum and of the aux loss alone (``x`` and the router whole,
    the experts' shards with their ranges)."""
    plan = None if mesh is None else training_plan(cfg, mesh)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    g = torch.from_numpy(np.random.default_rng(10).standard_normal(x.shape).astype(np.float32))
    whole = {k: torch.from_numpy(v[0]) for k, v in tree["layers"]["ffn"].items()}
    pls = storage_placements(build_model(cfg).specs(), mesh)["layers"]["ffn"]
    pls = {k: tuple(a if a == "model" else None for a in pl[1:]) for k, pl in pls.items()}
    p = {k: local_shard(v, pls[k], mesh).requires_grad_() for k, v in whole.items()}
    dp, r = comm.axis_size(mesh, "data"), comm.axis_index(mesh, "data")
    rows = slice(r * 2 // dp, (r + 1) * 2 // dp)
    xs = x[rows].clone().requires_grad_()
    with mesh_context(mesh, plan, (mesh, ("data",)) if dp > 1 else None):
        y, aux = layers.moe(p, xs, cfg)
    out = {"y": y.detach().numpy(), "aux": float(aux.detach()), "rows": _span(rows),
           "experts": bool(plan and plan.experts)}
    if dp == 1:
        for what, loss in (("y", (y * g).sum()), ("aux", aux)):
            grads = torch.autograd.grad(loss, [xs, *p.values()], retain_graph=True,
                                        allow_unused=True)
            out[what + "_grads"] = _shards({k: v for k, v in zip(["x", *p], grads)
                                            if v is not None},
                                {"x": (None,) * 3, **pls}, mesh)
    return out


def _rowwise(cfg, tree, mesh):
    """Trap 4: the pool step's row-wise ``layers.moe`` on 3 rows under the
    serving plan: the collectives it makes and its rows."""
    plan = serving_plan(cfg, mesh)
    pls = plan.placements["layers"]["ffn"]
    p = {k: local_shard(torch.from_numpy(v[0]), pls[k][1:], mesh)
         for k, v in tree["layers"]["ffn"].items()}
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (3, 1, cfg.d_model)).astype(np.float32))
    comm.reset_stats()
    with torch.no_grad(), mesh_context(mesh, plan):
        y, _ = layers.moe(p, x, cfg, rowwise=True)
    return {"collectives": comm.STATS["collectives"], "y": y.numpy()}


def _remat(cfg, tree, mesh):
    """Trap 5: one step with remat and one without on ``mesh``: each one's
    collectives and prediction, routed integers (the recompute's too) and
    the gradients' largest gap."""
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        tr = Trainer(c, _tc(1), device="cpu", mesh=mesh)
        shards = shard_tree(params_from_numpy(tree, "cpu"), tr.p_shard, mesh)
        batch = _batches(c, 1)[0]
        rows = batch if tr.rows is None else {k: v[tr.rows] for k, v in batch.items()}
        comm.reset_stats()
        (_, _, m), ints = _trace(lambda: tr.step_fn(shards, adamw_init(shards), rows,
                                                    return_grads=True))
        out[remat] = {"collectives": comm.STATS["collectives"], "ints": ints, "grads": m["grads"],
                      "predicted": tr.plan.train_collectives(c, SEQ, split=tr.rows is not None)}
    g0, g1 = out[False].pop("grads"), out[True].pop("grads")
    out["grad_gap"] = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                          for a, b in zip(g1, g0))
    return out


def _requests(cfg):
    rng = np.random.default_rng(6)
    return [Request(prompt=rng.integers(1, cfg.vocab, int(rng.integers(3, 9))).astype(np.int32),
                    max_new=int(rng.integers(3, 6)), seed=r) for r in range(3)]


def _sched(cfg, tree, mesh):
    """The slot-pool scheduler (sequential admission, greedy) on ``mesh``:
    every completion."""
    eng = Engine(cfg, params_from_numpy(tree, "cpu"), ServeConfig(max_len=24), device="cpu",
                 mesh=mesh)
    sched = Scheduler(eng, slots=2, segment=3, admission="sequential")
    reqs = _requests(cfg)
    for r in reqs:
        sched.submit(r)
    done = sched.run()
    return [done[i].tokens for i in range(len(reqs))]


def _no_gather(cfg, tree, mesh):
    """One step and one mask refresh with ``gather_tree`` replaced by a
    stand-in that raises: whether either called it."""
    tr = Trainer(cfg, _tc(1), device="cpu", mesh=mesh)
    shards = shard_tree(params_from_numpy(tree, "cpu"), tr.p_shard, mesh)
    batch = _batches(cfg, 1)[0]
    rows = batch if tr.rows is None else {k: v[tr.rows] for k, v in batch.items()}
    calls = []

    def refuse(*a, **kw):
        calls.append(1)
        raise AssertionError("gather_tree in an expert-parallel step")

    real = sharding.gather_tree
    sharding.gather_tree = refuse
    try:
        tr.step_fn(shards, adamw_init(shards), rows)
        tr.refresh_masks(shards, 0.5)
    finally:
        sharding.gather_tree = real
    return not calls


def _train_then_serve(cfg, mesh):
    """The Trainer on ``mesh`` with pruning, its shards served through
    ``Engine(mesh=)`` beside one device's engine on the gathered tree."""
    tc = dataclasses.replace(_tc(4), prune_begin=1, prune_end=3, prune_every=2)
    out = Trainer(cfg, tc, device="cpu", mesh=mesh).train()
    sc = ServeConfig(max_len=24)
    got = Engine(cfg, out["shards"], sc, device="cpu", mesh=mesh).generate(_prompts(cfg), NEW)
    whole = _nest(*zip(*tree_items(out["params"])))  # the trainer's view, leaf by leaf
    want = Engine(cfg, whole, sc, device="cpu").generate(_prompts(cfg), NEW)
    return {"got": got["tokens"], "want": want["tokens"], "sparsity": out["sparsity"],
            "expert_bytes": sum(v.numel() * 4 for k, v in out["shards"]["layers"]["ffn"].items()
                                if k != "router")}


def _case(cfg, tree, mesh):
    return {"serve": _serve(cfg, tree, mesh), "train": _train(cfg, tree, mesh),
            "unit": _unit(cfg, tree, mesh)}


def _ranks_2x2(mesh, device, trees):
    _fp32_probs()
    meshes = {"1x2": mesh["model"], "2x1": mesh["data"], "2x2": mesh}
    out = {(m, a, cf): _case(_cfg(a, cf), trees[a], meshes[m])
           for m, a, cf in CASES if m in meshes}
    olmoe, tree = _cfg("olmoe_1b_7b", 1.25), trees["olmoe_1b_7b"]
    out["sched"] = {n: _sched(olmoe, tree, meshes[n]) for n in ("1x2", "2x2")}
    out["no_gather"] = {n: _no_gather(olmoe, tree, meshes[n]) for n in ("1x2", "2x2")}
    out["train_serve"] = _train_then_serve(olmoe, meshes["1x2"])
    out["remat"] = _remat(_cfg("olmoe_1b_7b", 0.5), tree, mesh)
    return out


def _ranks_1x4(mesh, device, trees):
    _fp32_probs()
    out = {("1x4", a, cf): _case(_cfg(a, cf), trees[a], mesh) for a in ARCHS for cf in CFS}
    out["sched"] = {"1x4": _sched(_cfg("olmoe_1b_7b", 1.25), trees["olmoe_1b_7b"], mesh)}
    out["rowwise"] = _rowwise(_cfg("olmoe_1b_7b", 0.5), trees["olmoe_1b_7b"], mesh)
    out["remat"] = _remat(_cfg("moonshot_v1_16b_a3b", 0.5), trees["moonshot_v1_16b_a3b"], mesh)
    fb = _cfg(*FALLBACK)
    out["fallback"] = {"serve": _serve(fb, trees["fallback"], mesh),
                       "train": _train(fb, trees["fallback"], mesh)}
    whole = _cfg("olmoe_1b_7b", 1.25)
    out["local_experts"] = local_config(whole, training_plan(whole, mesh)).n_experts
    return out


# -- the test process: trees, worlds, one device's references ---------------------------


@pytest.fixture(scope="module")
def trees():
    out = {a: _tree(_cfg(a, 1.25)) for a in ARCHS}
    out["fallback"] = _tree(_cfg(*FALLBACK))
    return out


def _ulp_floor(cfg, tree, draws: int = 2) -> float:
    """How far one device's first step's gradients move (of each leaf's
    largest) when every parameter moves by about an ulp (a relative 2^-23
    x normal(0, 1), ``draws`` fixed seeds): the conditioning any reordered
    sum meets, as ``test_torch_tp_train.py`` measures it."""
    base = _train(cfg, tree, None)["grads"]
    worst = 0.0
    for seed in range(draws):
        gen = torch.Generator().manual_seed(seed)
        items = list(tree_items(params_from_numpy(tree, "cpu")))
        moved = _nest([p for p, _ in items], [
            (t * (1 + 2.0**-23 * torch.randn(t.shape, generator=gen))).numpy()
            for _, t in items])
        got = _train(cfg, moved, None)["grads"]
        worst = max(worst, *(np.abs(got[k][1] - w).max() / np.abs(w).max()
                             for k, (_, w) in base.items()))
    return worst


def _one_device(trees) -> dict:
    """One device's runs of every config the cases take (serve, train,
    unit, the scheduler at 1.25) and each tree's one-ulp floor (taken at
    ``moe_cf`` 1.25: the gradients' conditioning, whatever drops)."""
    saved = layers.FLAGS["attn_bf16_probs"]
    _fp32_probs()
    try:
        out, floors = {}, {}
        for arch, cf, experts in [(a, cf, None) for a in ARCHS for cf in CFS] + [FALLBACK]:
            cfg = _cfg(arch, cf, experts)
            name = "fallback" if experts else arch
            if name not in floors:
                floors[name] = _ulp_floor(_cfg(arch, 1.25, experts), trees[name])
            out[_key(cfg)] = {**_case(cfg, trees[name], None), "floor": floors[name],
                              "sched": _sched(cfg, trees[name], None) if cf == 1.25 and not experts
                              else None}
        return out
    finally:
        layers.FLAGS["attn_bf16_probs"] = saved


@pytest.fixture(scope="module")
def runs(trees, tmp_path_factory):
    """The 2x2 and 1x4 worlds, spawned at once (their start-up overlaps),
    and one device's runs made in this process meanwhile."""
    box = {}
    # made here: the factory's first call creates its base directory, which
    # two threads would race for
    dirs = {name: str(tmp_path_factory.mktemp(f"ep{name}")) for name in ("1x4", "2x2")}

    def run(name, fn, data, model):
        try:
            box[name] = spawn(fn, data, model, "gloo", "cpu", dirs[name], args=(trees,),
                              timeout_s=300)
        except BaseException as e:  # re-raised in the test process's thread
            box[name] = e

    threads = [threading.Thread(target=run, args=args) for args in
               (("1x4", _ranks_1x4, 1, 4), ("2x2", _ranks_2x2, 2, 2))]
    # eight ranks and this process share the cores: a rank takes one intra-op
    # thread (spawn gives each this process's count over its world's size),
    # this process two; smoke-sized products gain nothing from more, and a
    # rank waiting for a descheduled partner costs every collective
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    for t in threads:
        t.start()
    try:
        one = _one_device(trees)
    finally:
        for t in threads:
            t.join()
        torch.set_num_threads(saved)
    for v in box.values():
        if isinstance(v, BaseException):
            raise v
    return box, one


@pytest.fixture(scope="module")
def worlds(runs):
    return runs[0]


@pytest.fixture(scope="module")
def one(runs):
    return runs[1]


@pytest.fixture
def ref_fp32():
    from repro.models.opt_flags import FLAGS as REF_FLAGS

    prev = REF_FLAGS["attn_bf16_probs"]
    REF_FLAGS["attn_bf16_probs"] = False
    yield
    REF_FLAGS["attn_bf16_probs"] = prev


@pytest.fixture(scope="module")
def repro_olmoe(trees):
    """``repro`` on olmoe at ``moe_cf`` 0.5: greedy ``generate`` of the
    whole batch (its prefill's argmax, then decode steps; the first
    step's logits) and the first training batch's loss and gradients."""
    import jax
    import jax.numpy as jnp

    from repro.models import build_model as ref_build
    from repro.models.opt_flags import FLAGS as REF_FLAGS

    cfg = _cfg("olmoe_1b_7b", 0.5)
    model = ref_build(_ref_cfg("olmoe_1b_7b", 0.5))
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a, copy=True)),
                                    trees["olmoe_1b_7b"])
    prev = REF_FLAGS["attn_bf16_probs"]
    REF_FLAGS["attn_bf16_probs"] = False
    try:
        logits, cache = model.prefill(params, {"tokens": jnp.asarray(_prompts(cfg))}, 24)
        tok = jnp.argmax(logits, axis=-1)[:, None]
        step = jax.jit(model.decode_step)
        toks, first = [tok], None
        for _ in range(NEW - 1):
            lg, cache = step(params, tok, cache)
            first = lg[:, -1] if first is None else first
            tok = jnp.argmax(lg[:, -1], axis=-1)[:, None]
            toks.append(tok)
        tokens = _batches(cfg, 1)[0]["tokens"].numpy()
        loss, grads = jax.jit(jax.value_and_grad(model.loss))(
            params, {"tokens": jnp.asarray(tokens)})
    finally:
        REF_FLAGS["attn_bf16_probs"] = prev
    return {"tokens": np.asarray(jnp.concatenate(toks, 1)), "first": np.asarray(first),
            "loss": float(loss), "grads": {"/".join(k.key for k in path): np.asarray(w)
                                           for path, w in
                                           jax.tree_util.tree_flatten_with_path(grads)[0]}}


def _ref_cfg(arch, cf):
    """``repro``'s smoke config of a case."""
    from repro.configs import get_smoke_config as ref_smoke

    return dataclasses.replace(ref_smoke(arch), moe_cf=cf, **ARCHS[arch])


def _ranks(mesh, worlds):
    return worlds["2x2" if mesh in MESHES_2X2 else "1x4"]


def _id(c):
    return "-".join(str(x) for x in c)


def _close(got, want, what="", tol=LOGIT_TOL):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1.0), (what, err)


def _cut(whole, ranges):
    return whole if ranges is None else whole[tuple(slice(s, s + n) for s, n in ranges)]


def _shard_gaps(got: dict, want: dict) -> dict:
    """Each leaf's largest gap of this rank's shard from one device's same
    slice, of the largest |value| of one device's whole leaf."""
    return {k: float(np.abs(v - _cut(want[k][1], r)).max()) / max(
        float(np.abs(want[k][1]).max()), 1e-30) for k, (r, v) in got.items()}


def _ints_equal(got, want, rows):
    """Each routed call's integers against one device's: the rows ``rows``
    of it (token-major, so a row's assignments are contiguous) where the
    call held this rank's rows of the batch."""
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        for k in ("eids", "pos", "dropped"):
            ww = w[k] if rows is None else w[k].reshape(BATCH, -1)[rows[0]:rows[1]].reshape(-1)
            np.testing.assert_array_equal(g[k], ww, err_msg=k)


def test_c16_data_split_routes_the_whole_batch(worlds, one, repro_olmoe):
    """olmoe-smoke at ``moe_cf`` 0.5 (tokens dropped) on 2x1: ``generate``
    and a training step against ``repro``'s whole-batch program; the
    routed integers bitwise one device's whole-batch ones."""
    want = one[_key(_cfg("olmoe_1b_7b", 0.5))]
    for rank in worlds["2x2"]:
        got = rank[("2x1", "olmoe_1b_7b", 0.5)]
        _close(got["serve"]["first"], repro_olmoe["first"], "first-step logits")
        np.testing.assert_array_equal(got["serve"]["tokens"], repro_olmoe["tokens"])
        assert got["train"]["loss"] == pytest.approx(repro_olmoe["loss"], rel=1e-5)
        for name, (ranges, g) in got["train"]["grads"].items():
            w = _cut(repro_olmoe["grads"][name], ranges)
            assert np.abs(g - w).max() <= REPRO_GRAD_TOL * np.abs(w).max(), name
        assert any(t["dropped"].any() for t in got["train"]["ints"])
        _ints_equal(got["train"]["ints"], want["train"]["ints"], got["train"]["rows"])
        _ints_equal(got["serve"]["ints"], want["serve"]["ints"], got["serve"]["rows"])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_routing_integers_are_one_devices(case, worlds, one):
    """Every routed call of ``generate`` (prefill and decode) and of a
    training step, on every rank: bitwise one device's rows; tokens drop
    at ``moe_cf`` 0.5 and never at the dropless 4.0."""
    want = one[_key(_cfg(*case[1:]))]
    dropped = any(t["dropped"].any() for t in want["train"]["ints"])
    assert dropped if case[2] == 0.5 else not dropped or case[2] != 4.0
    for rank in _ranks(case[0], worlds):
        got = rank[case]
        _ints_equal(got["serve"]["ints"], want["serve"]["ints"], got["serve"]["rows"])
        _ints_equal(got["train"]["ints"], want["train"]["ints"], got["train"]["rows"])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_generate_on_mesh_equals_one_device(case, worlds, one):
    want = one[_key(_cfg(*case[1:]))]["serve"]
    for rank in _ranks(case[0], worlds):
        got = rank[case]["serve"]
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        _close(got["first"], want["first"], "first-step logits")


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_moe_layer_on_mesh_matches_repro(case, worlds, trees, ref_fp32):
    """Layer 0's ``layers.moe`` under the training plan (each rank its
    experts, its rows on a data axis) against ``repro``'s on the whole
    rows: y within 1e-5 of the largest, the aux loss within 1e-5."""
    import jax.numpy as jnp

    from repro.models import layers as ref_layers

    mesh, arch, cf = case
    x = np.random.default_rng(9).standard_normal(
        (2, 8, get_smoke_config(arch).d_model)).astype(np.float32)
    p = {k: jnp.asarray(v[0]) for k, v in trees[arch]["layers"]["ffn"].items()}
    want, want_aux = ref_layers.moe(p, jnp.asarray(x), _ref_cfg(arch, cf))
    for rank in _ranks(mesh, worlds):
        got = rank[case]["unit"]
        assert got["experts"] == (mesh != "2x1")
        lo, hi = got["rows"]
        _close(got["y"], np.asarray(want)[lo:hi], "y")
        assert got["aux"] == pytest.approx(float(want_aux), rel=1e-5)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_train_step_on_mesh_matches_one_device(case, worlds, one):
    """The first step's loss and gradient shards against one device's
    whole-batch step; at ``moe_cf`` 1.25 the parameters after 3 steps
    within the bound Adam's steps put on a weight's move; the collectives
    as ``TPPlan.train_collectives`` predicts."""
    want = one[_key(_cfg(*case[1:]))]
    for rank in _ranks(case[0], worlds):
        got = rank[case]["train"]
        _train_gates(got, want["train"], want["floor"], case[2])
        # on 2x1 a plan that splits nothing over ``model``
        assert got["plan"] == ((False, False) if case[0] == "2x1" else (True, False))
        assert got["collectives"] == got["predicted"]


def _adam_bound(t: int, b1: float = 0.9, b2: float = 0.95) -> float:
    """The largest |m_hat / sqrt(v_hat)| Adam's ``t``-th update (1-based) can
    take, by Cauchy-Schwarz over the gradients so far (eps ignored)."""
    w1 = [(1 - b1) * b1 ** (t - i) for i in range(1, t + 1)]
    w2 = [(1 - b2) * b2 ** (t - i) for i in range(1, t + 1)]
    return math.sqrt(sum(a * a / b for a, b in zip(w1, w2))) * math.sqrt(1 - b2**t) / (1 - b1**t)


def _param_tol(steps: int) -> float:
    """How far two runs' weights may part after ``steps`` steps from one
    state: each step moves a weight by at most lr x (Adam's bound + decay
    of a weight below 1), in either direction."""
    from repro_torch.optim.schedule import cosine_schedule

    hp = _tc(steps).hp
    return sum(2 * cosine_schedule(t, hp.warmup, hp.total_steps, hp.lr)
               * (_adam_bound(t + 1) + hp.weight_decay) for t in range(steps))


def _train_gates(got, want, floor, cf):
    """A step on a mesh against one device's: the first step's loss within
    ``LOSS_TOL`` relative; each gradient shard within ``GRAD_TOL`` or one
    device's one-ulp ``floor``, whichever is larger, of the leaf's
    largest; the parameters after the case's steps within Adam's bound."""
    assert abs(got["loss"] / want["loss"] - 1) <= LOSS_TOL, (got["loss"], want["loss"])
    gaps = _shard_gaps(got["grads"], want["grads"])
    assert max(gaps.values()) <= max(GRAD_TOL, floor), (gaps, floor)
    moved = max(float(np.abs(v - _cut(want["params"][k][1], r)).max())
                for k, (r, v) in got["params"].items())
    assert moved <= _param_tol(STEPS[cf]), (moved, _param_tol(STEPS[cf]))


@pytest.mark.parametrize("mesh", MESHES_2X2 + MESHES_1X4)
def test_train_step_on_mesh_matches_repro(mesh, worlds, repro_olmoe):
    """olmoe at ``moe_cf`` 0.5 on every mesh: the first step's loss and each
    gradient shard against ``jax.value_and_grad`` of ``repro``'s whole
    batch loss (loss 1e-5 relative, gradients 5e-3 of the leaf's largest,
    as ``test_torch_tp_train.py`` holds its steps against ``repro``)."""
    for rank in _ranks(mesh, worlds):
        got = rank[(mesh, "olmoe_1b_7b", 0.5)]["train"]
        assert got["loss"] == pytest.approx(repro_olmoe["loss"], rel=1e-5)
        gaps = _shard_gaps(got["grads"], {k: (None, v) for k, v in repro_olmoe["grads"].items()})
        assert max(gaps.values()) <= REPRO_GRAD_TOL, gaps


def test_trap1_expert_count_stays_global(worlds, one):
    """``local_config`` keeps the config's whole ``e`` on 1x4 (a rank's
    ``E / tp`` would give 4x the capacity), and the drops at ``moe_cf`` 0.5
    are one device's, bitwise."""
    want = one[_key(_cfg("olmoe_1b_7b", 0.5))]["train"]["ints"]
    for rank in worlds["1x4"]:
        assert rank["local_experts"] == get_smoke_config("olmoe_1b_7b").n_experts
        got = rank[("1x4", "olmoe_1b_7b", 0.5)]["train"]["ints"]
        assert any(t["dropped"].any() for t in got)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["dropped"], w["dropped"])


def _unit_gaps(mesh, arch, worlds, one):
    """Every rank's layer-0 gradient gaps (``_unit``) from one device's, by
    loss and leaf, over the three capacities."""
    out = []
    for cf in CFS:
        want = one[_key(_cfg(arch, cf))]["unit"]
        for rank in _ranks(mesh, worlds):
            got = rank[(mesh, arch, cf)]["unit"]
            for what in ("y", "aux"):
                g, w = got[what + "_grads"], want[what + "_grads"]
                assert set(g) == set(w)
                out.append({f"{what}/{k}": v for k, v in _shard_gaps(g, w).items()})
    return {k: max(d.get(k, 0.0) for d in out) for d in out for k in d}


@pytest.mark.parametrize("mesh", ("1x2", "1x4"))
@pytest.mark.parametrize("arch", ARCHS)
def test_trap2_gate_weights_enter_not_the_probabilities(mesh, arch, worlds, one):
    """The aux loss reads the router's probabilities outside the split: its
    router gradient is one device's on every rank (entering the
    probabilities would sum it ``tp`` times), and so is the router's
    gradient through the experts' weighted outputs."""
    gaps = _unit_gaps(mesh, arch, worlds, one)
    assert gaps["aux/router"] <= 1e-6 and gaps["y/router"] <= 1e-6, gaps


@pytest.mark.parametrize("mesh", ("1x2", "1x4"))
@pytest.mark.parametrize("arch", ARCHS)
def test_trap3_token_rows_enter_once(mesh, arch, worlds, one):
    """The token rows enter the split once, for the experts and (through
    the gate weights) the router: their gradient, and every expert shard's,
    is one device's."""
    gaps = _unit_gaps(mesh, arch, worlds, one)
    assert gaps["y/x"] <= 1e-6 and gaps["aux/x"] <= 1e-6, gaps
    assert max(gaps[f"y/{k}"] for k in ("w_gate", "w_up", "w_down")) <= 1e-6, gaps


def test_trap4_rowwise_call_makes_one_collective(worlds, trees):
    """The pool step's row-wise call on 3 rows: one ordered sum for the
    batch, not one a row, and its rows one device's row-wise call's."""
    cfg = _cfg("olmoe_1b_7b", 0.5)
    p = {k: torch.from_numpy(v[0]) for k, v in trees["olmoe_1b_7b"]["layers"]["ffn"].items()}
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (3, 1, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        want, _ = layers.moe(p, x, cfg, rowwise=True)
    for rank in worlds["1x4"]:
        assert rank["rowwise"]["collectives"] == 1
        _close(rank["rowwise"]["y"], want.numpy(), "rows", 1e-6)


@pytest.mark.parametrize("world", ["2x2", "1x4"])
def test_trap5_remat_redoes_the_routing(world, worlds):
    """With remat each layer's routing runs again in the backward (last
    layer first): the same integers, the collectives as predicted with and
    without it, and the gradients within 1e-6 of the step without remat."""
    n_layers = get_smoke_config("olmoe_1b_7b").n_layers
    for rank in worlds[world]:
        got = rank["remat"]
        for remat in (False, True):
            assert got[remat]["collectives"] == got[remat]["predicted"], got
        plain, again = got[False]["ints"], got[True]["ints"]
        assert len(plain) == n_layers and len(again) == 2 * n_layers
        for g, w in zip(again[n_layers:][::-1] + again[:n_layers], plain + plain):
            for k in ("eids", "pos", "dropped"):
                np.testing.assert_array_equal(g[k], w[k])
        assert got["grad_gap"] <= 1e-6


@pytest.mark.parametrize("mesh", ["1x2", "1x4", "2x2"])
def test_scheduler_on_mesh_equals_one_shot_generate(mesh, worlds, one):
    """Sequential admission on the slot pool, greedy: every completion as
    one device's scheduler gives it, which ``test_torch_moe.py`` holds
    bitwise to one-shot ``generate`` at B = 1."""
    want = one[_key(_cfg("olmoe_1b_7b", 1.25))]["sched"]
    for rank in _ranks(mesh, worlds):
        for a, b in zip(rank["sched"][mesh], want):
            np.testing.assert_array_equal(a, b)


def test_fallback_keeps_the_experts_whole(worlds, one):
    """6 experts on 4 ranks: the experts stay whole and their ff dim splits
    (the reference's rules); tokens, logits and the training step as one
    device's."""
    want = one[_key(_cfg(*FALLBACK))]
    for rank in worlds["1x4"]:
        got = rank["fallback"]
        np.testing.assert_array_equal(got["serve"]["tokens"], want["serve"]["tokens"])
        _close(got["serve"]["first"], want["serve"]["first"])
        assert got["train"]["plan"] == (False, True)
        assert got["train"]["collectives"] == got["train"]["predicted"]
        _train_gates(got["train"], want["train"], want["floor"], FALLBACK[1])


def test_step_and_mask_refresh_never_gather_the_tree(worlds):
    for rank in worlds["2x2"]:
        assert rank["no_gather"] == {"1x2": True, "2x2": True}


def test_trained_shards_serve_on_the_mesh(worlds):
    """Trained and pruned on 1x2, served on 1x2: one device's tokens on the
    gathered tree; each rank holds half the expert bytes."""
    cfg = get_smoke_config("olmoe_1b_7b")
    whole = 3 * cfg.n_layers * cfg.n_experts * cfg.d_model * cfg.d_ff * 4
    for rank in worlds["2x2"]:
        got = rank["train_serve"]
        np.testing.assert_array_equal(got["got"], got["want"])
        assert got["sparsity"] > 0
        assert got["expert_bytes"] == whole // 2


def test_full_olmoe_rank_stores_under_three_tenths():
    """A 1x4 rank of ``olmoe_1b_7b``'s full config (16 experts of 64, a
    quarter of the heads and the vocab) stores at most 0.30 of the tree,
    on specs alone."""
    specs = build_model(get_config("olmoe_1b_7b")).specs()
    mesh = {"data": 1, "model": 4}
    rank = placement_bytes(specs, storage_placements(specs, mesh), mesh)
    one = placement_bytes(specs, storage_placements(specs, None), None)
    assert rank <= 0.30 * one, rank / one
