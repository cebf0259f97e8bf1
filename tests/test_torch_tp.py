"""Port: tensor-parallel dense compute on sharded dense storage (ROADMAP
A12.1), the trainer's pod split (C14) and the scheduler's one clock on a
mesh (C15), on gloo ranks on the CPU.

Three worlds (``launch/mesh.spawn``, a rendezvous file under
``tmp_path``): a 2x2 world serves its whole mesh and its ``model``
sub-mesh (1x2); a 1x4 world four tensor-parallel ranks; a 2x2x1
(pod, data, model) world trains.  The serving cases, each rank against
the single-device port (and greedy against ``repro``'s single-device
engine, from the same seeded numpy parameters, every bias and norm scale
redrawn so a misplaced one shows):

- ``vusa_edge`` on 1x2, 2x2 and 1x4, dense and "all" routes, greedy and
  sampled (2x1 greedy): ``generate``'s tokens equal one device's; first-step logits
  within 1e-5 of the largest; every rank's logits bitwise the others';
  each rank's stored dense bytes the placement arithmetic
  (``dist.tp.placement_bytes``), below the whole tree's; on ``model``
  alone a decode step's collectives two a layer plus two on either route;
  the scheduler on 2x2 on the slot and paged pools (dense and packed)
  equal one device's;
- ``pack_lm_weights(split_heads=True)``: each rank's q/k/v columns
  bitwise the whole pack's columns of its heads, its ``wo`` partials
  summing to the whole pack's product;
- ``qwen3`` (qk-norm, GQA kv = 2) and ``llama3_2`` (tied head) on 1x2;
  ``qwen2`` on 1x4, whose 2 kv heads do not divide four ranks: attention
  stays whole (the sequence-sharded prefill applies), ff and vocab split;
- an engine handed this rank's shards (the trainer's placement) equals one
  handed whole leaves, and a leaf of another shape raises;
- ``comm.broadcast_mesh`` on a mesh and a sub-mesh, ``comm.gather_leaves``
  against a gather a leaf;
- C15: a 2x2 scheduler whose ranks read clocks with their own offsets and
  skews, under staggered arrivals and deadlines, completes within the
  collectives' timeout with the same completions on every rank, equal to a
  one-device run on rank 0's clock;
- C14: a 2x2x1 training step (the batch split over pod x data) sums the
  gradients bitwise as one device's step over the same batch in four
  microbatches and updates its shards bitwise as one device's update of
  them at the step's clip scale; its global norm (an ordered sum of the
  shards' squares) within 1e-6 of that step's.
"""

import dataclasses
import functools
import hashlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.dist import comm
from repro_torch.dist.sharding import params_shardings, shard_tree
from repro_torch.dist.tp import placement_bytes
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import spawn
from repro_torch.models import build_model
from repro_torch.optim import AdamState
from repro_torch.optim.adamw import tree_items
from repro_torch.serve import Engine, Request, Scheduler, ServeConfig, Status
from repro_torch.train import TrainConfig, Trainer, TrainHParams

ROUTES = {"dense": {}, "all": {"packed_weights": "all"}}
TEMPS = (0.0, 0.8)
LOGIT_TOL = 1e-5
# (arch, mesh, route, temperature) of each world; the single-device port runs all
CASES_2X2 = ([("vusa_edge", m, r, t) for m in ("1x2", "2x2") for r in ROUTES for t in TEMPS]
             + [("vusa_edge", "2x1", r, 0.0) for r in ROUTES]
             + [("qwen3_8b", "1x2", "dense", 0.0), ("llama3_2_1b", "1x2", "dense", 0.0),
                ("llama3_2_1b", "1x2", "all", 0.0)])
CASES_1X4 = ([("vusa_edge", "1x4", r, t) for r in ROUTES for t in TEMPS]
             + [("qwen2_0_5b", "1x4", r, 0.0) for r in ROUTES])
# the cases on ``model`` alone whose heads split (qwen2's do not divide four)
MODEL_ONLY = [c for c in CASES_2X2 + CASES_1X4 if c[1] in ("1x2", "1x4") and c[0] != "qwen2_0_5b"]
SCHED = {"slot": {}, "paged": {"page_size": 16}, "paged-chunk": {"page_size": 16,
                                                                  "prefill_chunk": 16}}
# C15: rank r's clock reads OFFSETS[r] + SKEWS[r] * t of the run's virtual time t
OFFSETS = (0.0, 5.0, -3.0, 100.0)
SKEWS = (1.0, 1.7, 0.6, 1.3)
SEGMENT_S = 0.01  # virtual seconds a decode segment takes
TRAIN_STEPS = 2


def _perturbed(arch: str) -> dict:
    """The port's seeded init of ``arch``'s smoke config, pruned to 85 %,
    with every bias and norm scale redrawn from normal(0, 0.5), as numpy."""
    cfg = get_smoke_config(arch)
    from repro_torch.core.pruning import prune_tree

    params = prune_tree(build_model(cfg).init(0, device="cpu"), 0.85)
    rng = np.random.default_rng(1)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else (
            rng.normal(0, 0.5, tuple(v.shape)).astype(np.float32)
            if k in ("bq", "bk", "bv") or "norm" in k else v.numpy().copy())
            for k, v in sorted(t.items())}

    return walk(params)


def _prompts(cfg):
    return np.random.default_rng(2).integers(0, cfg.vocab, (4, 8))


def _engine(arch, params, mesh, route, temp=0.0, **kw):
    sc = ServeConfig(max_len=64, temperature=temp, seed=3, **ROUTES[route], **kw)
    return Engine(get_smoke_config(arch), params, sc, device="cpu", mesh=mesh)


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()


def _case(arch, params, mesh, route, temp):
    """One generate case: tokens, the first decode step's whole logits, a
    digest of every step's whole logits (gathered over ``data``), and the
    dense bytes stored against the placement arithmetic."""
    eng = _engine(arch, params, mesh, route, temp)
    prompts = _prompts(eng.cfg)
    steps = []
    eng._emit = lambda st, lg: (steps.append(_digest(eng._whole(lg, st.rows))),
                                Engine._emit(eng, st, lg))
    tokens = eng.generate(prompts, max_new=8)["tokens"]
    del eng._emit
    rows = eng._rows(len(prompts))
    with torch.no_grad():
        nxt, cache = eng.prime(prompts if rows is None else prompts[rows])
        comm.reset_stats()
        step = eng._logits(nxt, cache, eng._route_pack())[:, -1].float()
        collectives = comm.STATS["collectives"]
        first = eng._whole(step, rows)
    specs = build_model(eng.cfg).specs()
    placements = params_shardings(specs, None) if eng.plan is None else eng.plan.placements
    want = placement_bytes(specs, placements, eng.mesh)
    return {"tokens": tokens, "first": first, "steps": steps, "collectives": collectives,
            "bytes": eng.dense_param_bytes, "bytes_want": want}


def _schedule(params, mesh, case, route, temp=0.0):
    sc_kw = SCHED[case]
    eng = _engine("vusa_edge", params, mesh, route, temp, **sc_kw)
    rng = np.random.default_rng(5)
    reqs = [Request(prompt=rng.integers(1, 500, int(rng.integers(4, 30))).astype(np.int32),
                    max_new=int(rng.integers(2, 9)), seed=i) for i in range(8)]
    sched = Scheduler(eng, slots=4, segment=4, admission="sequential")
    done = sched.run(reqs)
    assert sched.verify_paged_mirror()
    return {rid: c.tokens.tolist() for rid, c in done.items()}


class _VirtualClock:
    """A clock reading ``offset + skew * t`` of a virtual time ``t`` that
    advances by ``SEGMENT_S`` a decode segment and by each sleep (in this
    clock's units)."""

    def __init__(self, offset: float, skew: float):
        self.offset, self.skew, self.t = offset, skew, 0.0

    def __call__(self) -> float:
        return self.offset + self.skew * self.t

    def sleep(self, secs: float) -> None:
        self.t += secs / self.skew


def _clocked_run(params, mesh, rank: int):
    """Staggered arrivals and deadlines through a 2x2 (or one-device)
    scheduler on rank ``rank``'s virtual clock: each rid's status and
    tokens."""
    clock = _VirtualClock(OFFSETS[rank], SKEWS[rank])
    eng = _engine("vusa_edge", params, mesh, "dense", page_size=16)
    segment = eng.pool_segment

    def timed_segment(st):
        out = segment(st)
        clock.t += SEGMENT_S
        return out

    eng.pool_segment = timed_segment
    rng = np.random.default_rng(9)
    reqs = [Request(prompt=rng.integers(1, 500, int(rng.integers(4, 20))).astype(np.int32),
                    max_new=int(rng.integers(3, 12)), seed=i, arrival_s=0.004 * i,
                    deadline_s=0.03 if i % 3 == 1 else None) for i in range(12)]
    sched = Scheduler(eng, slots=4, segment=2, admission="batched", clock=clock,
                      sleep=clock.sleep)
    done = sched.run(reqs)
    return {rid: (c.status.value, c.tokens.tolist()) for rid, c in done.items()}


def _shards_equal_whole(params, mesh):
    """``generate`` of an engine handed this rank's shards (the trainer's
    placement) and of one handed whole leaves: tokens and first logits."""
    cfg = get_smoke_config("vusa_edge")
    whole = _engine("vusa_edge", params, mesh, "all")
    shards = shard_tree(params, params_shardings(build_model(cfg).specs(), mesh), mesh)
    handed = _engine("vusa_edge", shards, mesh, "all")
    bad = dict(shards, final_norm=shards["final_norm"][:3])
    try:
        _engine("vusa_edge", bad, mesh, "dense")
        refused = False
    except ValueError:
        refused = True
    prompts = _prompts(cfg)
    a, b = whole.generate(prompts, max_new=6), handed.generate(prompts, max_new=6)
    return {"tokens": np.array_equal(a["tokens"], b["tokens"]),
            "params": all(torch.equal(x, y) for (_, x), (_, y) in
                          zip(tree_items(whole.params), tree_items(handed.params))),
            "refused": refused}


def _params(trees: dict) -> dict:
    return {arch: params_from_numpy(tree, "cpu") for arch, tree in trees.items()}


def _ranks_2x2(mesh, device, trees):
    params = _params(trees)
    meshes = {"1x2": mesh["model"], "2x1": mesh["data"], "2x2": mesh}
    out = {"gen": {c: _case(c[0], params[c[0]], meshes[c[1]], c[2], c[3]) for c in CASES_2X2}}
    out["sched"] = {(case, route): _schedule(params["vusa_edge"], mesh, case, route)
                    for case in SCHED for route in ROUTES}
    out["sched_sampled"] = _schedule(params["vusa_edge"], mesh, "paged", "all", 0.8)
    out["shards"] = _shards_equal_whole(params["vusa_edge"], mesh)
    out["clock"] = _clocked_run(params["vusa_edge"], mesh, dist.get_rank())
    out["comm"] = _comm_checks(mesh)
    return out


def _comm_checks(mesh):
    """``broadcast_mesh`` on the whole mesh and on a sub-mesh (one
    broadcast an axis), and ``gather_leaves`` against one ``all_gather`` a
    leaf."""
    from repro_torch.dist import comm

    rank = dist.get_rank()
    whole = comm.broadcast_mesh(torch.tensor([float(rank)], dtype=torch.float64), mesh)
    sub = comm.broadcast_mesh(torch.tensor([float(rank)], dtype=torch.float64), mesh["model"])
    g = torch.Generator().manual_seed(rank)
    leaves = [torch.randn(3, 4, generator=g), torch.randn(2, 5, 6, generator=g)]
    got = comm.gather_leaves(leaves, [1, 0], mesh, "data")
    want = [comm.all_gather(leaves[0], mesh, "data", dim=1),
            comm.all_gather(leaves[1], mesh, "data", dim=0)]
    return {"whole": float(whole[0]), "sub": float(sub[0]),
            "sub_first": int(mesh["model"].mesh.flatten()[0]),
            "gather": all(torch.equal(a, b) for a, b in zip(got, want))}


def _ranks_1x4(mesh, device, trees):
    from repro_torch.models.layers import _maybe_seq_sharded_attention

    params = _params(trees)
    before = _maybe_seq_sharded_attention.calls
    out = {"gen": {c: _case(c[0], params[c[0]], mesh, c[2], c[3]) for c in CASES_1X4}}
    out["seq_shard_calls"] = _maybe_seq_sharded_attention.calls - before
    return out


@pytest.fixture(scope="module")
def trees():
    return {arch: _perturbed(arch) for arch in ("vusa_edge", "qwen3_8b", "llama3_2_1b",
                                                 "qwen2_0_5b")}


@pytest.fixture(scope="module")
def world_2x2(trees, tmp_path_factory):
    return spawn(_ranks_2x2, 2, 2, "gloo", "cpu", str(tmp_path_factory.mktemp("tp2x2")),
                 args=(trees,), timeout_s=300)


@pytest.fixture(scope="module")
def world_1x4(trees, tmp_path_factory):
    return spawn(_ranks_1x4, 1, 4, "gloo", "cpu", str(tmp_path_factory.mktemp("tp1x4")),
                 args=(trees,), timeout_s=300)


@pytest.fixture(scope="module")
def single(trees):
    params = _params(trees)
    gen = {c: _case(c[0], params[c[0]], None, c[2], c[3]) for c in CASES_2X2 + CASES_1X4}
    sched = {(case, route): _schedule(params["vusa_edge"], None, case, route)
             for case in SCHED for route in ROUTES}
    return {"gen": gen, "sched": sched,
            "sched_sampled": _schedule(params["vusa_edge"], None, "paged", "all", 0.8),
            "clock": _clocked_run(params["vusa_edge"], None, 0)}


@pytest.fixture(scope="module")
def repro_greedy(trees):
    """``repro``'s single-device greedy tokens of every greedy case."""
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as ref_smoke
    from repro.serve import Engine as RefEngine
    from repro.serve import ServeConfig as RefServeConfig

    def jnp_tree(t):
        return {k: jnp_tree(v) if isinstance(v, dict) else jnp.asarray(np.array(v, copy=True))
                for k, v in t.items()}

    out = {}
    for arch, route in sorted({(c[0], c[2]) for c in CASES_2X2 + CASES_1X4 if c[3] == 0.0}):
        cfg = ref_smoke(arch)
        eng = RefEngine(cfg, jnp_tree(trees[arch]), RefServeConfig(max_len=64, **ROUTES[route]))
        out[(arch, route)] = np.asarray(eng.generate(_prompts(cfg), max_new=8)["tokens"])
    return out


def _world(case, world_2x2, world_1x4):
    return world_2x2 if case in CASES_2X2 else world_1x4


@pytest.mark.parametrize("case", CASES_2X2 + CASES_1X4, ids=lambda c: "-".join(map(str, c)))
def test_tp_generate_equals_single_device(case, world_2x2, world_1x4, single, repro_greedy):
    want = single["gen"][case]
    ranks = _world(case, world_2x2, world_1x4)
    for rank in ranks:
        got = rank["gen"][case]
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        gap = float((got["first"] - want["first"]).abs().max())
        assert gap <= LOGIT_TOL * float(want["first"].abs().max()), gap
    if case[3] == 0.0:
        np.testing.assert_array_equal(want["tokens"], repro_greedy[(case[0], case[2])])


@pytest.mark.parametrize("case", CASES_2X2 + CASES_1X4, ids=lambda c: "-".join(map(str, c)))
def test_tp_ranks_hold_the_same_logits_bits(case, world_2x2, world_1x4):
    ranks = _world(case, world_2x2, world_1x4)
    first = ranks[0]["gen"][case]
    for rank in ranks[1:]:
        assert torch.equal(rank["gen"][case]["first"], first["first"])
        assert rank["gen"][case]["steps"] == first["steps"]


@pytest.mark.parametrize("case", CASES_2X2 + CASES_1X4, ids=lambda c: "-".join(map(str, c)))
def test_tp_rank_stores_its_shard(case, world_2x2, world_1x4, single):
    whole = single["gen"][case]["bytes"]
    assert whole == single["gen"][case]["bytes_want"]
    for rank in _world(case, world_2x2, world_1x4):
        got = rank["gen"][case]
        assert got["bytes"] == got["bytes_want"] < whole


@pytest.mark.parametrize("case,route", [(c, r) for c in SCHED for r in ROUTES])
def test_tp_scheduler_on_2x2_equals_single_device(world_2x2, single, case, route):
    for rank in world_2x2:
        assert rank["sched"][(case, route)] == single["sched"][(case, route)]


def test_tp_scheduler_on_2x2_sampled(world_2x2, single):
    for rank in world_2x2:
        assert rank["sched_sampled"] == single["sched_sampled"]


def test_qwen2_keeps_whole_heads_on_four_ranks(world_1x4):
    for rank in world_1x4:
        assert rank["seq_shard_calls"] > 0  # its prefill attention is sequence-sharded


def test_engine_takes_shards_or_whole_leaves(world_2x2):
    for rank in world_2x2:
        assert rank["shards"] == {"tokens": True, "params": True, "refused": True}


def test_mesh_broadcast_and_leaf_gather(world_2x2):
    for rank in world_2x2:
        c = rank["comm"]
        assert c["whole"] == 0.0 and c["sub"] == c["sub_first"] and c["gather"], c


def test_scheduler_on_skewed_clocks_agrees(world_2x2, single):
    want = single["clock"]
    statuses = {s for s, _ in want.values()}
    assert Status.OK.value in statuses and Status.TIMEOUT.value in statuses, statuses
    for rank in world_2x2:
        assert rank["clock"] == want


# -- C14: the trainer's pod split ---------------------------------------------


def _tc():
    return TrainConfig(steps=TRAIN_STEPS, global_batch=4, seq_len=16, token_range=64,
                       prune_begin=TRAIN_STEPS + 1, log_every=1,
                       hp=TrainHParams(lr=1e-3, warmup=1, total_steps=TRAIN_STEPS))


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(tree_items(a), tree_items(b)))


def _pod_lockstep(mesh, device):
    """Each step of the (pod, data, model) trainer from this rank's shards
    of one device's state and its rows of the batch, beside one device's
    step over the same batch in four microbatches (the ranks' rows, in
    flattened pod-major order): the rows taken, the loss gap, the global
    norm's gap (an ordered sum of the shards' squares, not one device's
    sum over each whole leaf), and whether the summed gradients are the
    microbatched step's bitwise, cut to this rank's shards (each layer's
    leaves gathered at use, their gradients reduce-scattered over (pod,
    data) in rank order), and the updated shards one device's update of
    them at the step's clip scale, bitwise."""
    from repro_torch.dist.sharding import local_shard
    from repro_torch.optim import adamw_update

    cfg = get_smoke_config("vusa_edge")
    tc = _tc()
    one = Trainer(cfg, tc, device="cpu")
    mb = Trainer(cfg, dataclasses.replace(tc, hp=dataclasses.replace(tc.hp, microbatches=4)),
                 device="cpu")
    dp = Trainer(cfg, tc, device="cpu", mesh=mesh)
    params, opt = one.init_state()
    data = iter(SyntheticDataset(cfg, tc.global_batch, tc.seq_len, seed=tc.seed,
                                 token_range=tc.token_range))
    shard = functools.partial(shard_tree, placements=dp.p_shard, mesh=mesh)
    spec = [pl for _, pl in tree_items(dp.p_shard)]
    out = {"rows": (dp.rows.start, dp.rows.stop), "steps": []}
    for _ in range(TRAIN_STEPS):
        host = next(data)
        batch = {k: torch.from_numpy(v) for k, v in host.items()}
        rows = {k: torch.from_numpy(v[dp.rows]) for k, v in host.items()}
        new, state, got = dp.step_fn(shard(params), AdamState(opt.step.clone(), shard(opt.mu),
                                                              shard(opt.nu)), rows,
                                     return_grads=True)
        _, _, want = mb.step_fn(
            _clone(params), AdamState(opt.step.clone(), _clone(opt.mu), _clone(opt.nu)), batch,
            return_grads=True)
        scale = torch.clamp(tc.hp.max_grad_norm / torch.clamp_min(got["gnorm"], 1e-9), max=1.0)
        ref, ref_opt = _clone(params), AdamState(opt.step.clone(), _clone(opt.mu), _clone(opt.nu))
        adamw_update(ref, [g * scale for g in want["grads"]], ref_opt, got["lr"],
                     weight_decay=tc.hp.weight_decay, max_grad_norm=float("inf"))
        params, opt, _ = one.step_fn(params, opt, batch)
        grads = all(torch.equal(g, local_shard(w, pl, mesh))
                    for g, w, pl in zip(got["grads"], want["grads"], spec))
        out["steps"].append((
            abs(float(got["loss"]) / float(want["loss"]) - 1),
            abs(float(got["gnorm"]) / float(want["gnorm"]) - 1),
            grads and _equal(new, shard(ref)) and _equal(state.mu, shard(ref_opt.mu))
            and _equal(state.nu, shard(ref_opt.nu))))
    return out


def test_pod_data_training_step_is_the_microbatched_step(tmp_path):
    ranks = spawn(_pod_lockstep, 2, 1, "gloo", "cpu", str(tmp_path), pod=2, timeout_s=300)
    assert [r["rows"] for r in ranks] == [(0, 1), (1, 2), (2, 3), (3, 4)]
    for rank in ranks:
        gaps, norms, bitwise = zip(*rank["steps"])
        assert max(gaps) <= 1e-6 and max(norms) <= 1e-6 and all(bitwise), rank["steps"]


# -- launchers ------------------------------------------------------------------


def test_serve_launcher_serves_tensor_parallel():
    base = ["--arch", "vusa_edge", "--smoke", "--device", "cpu", "--max-new", "4",
            "--prompt-len", "8"]
    one = launch_serve.main(base)
    tp = launch_serve.main(base + ["--mesh", "1,2", "--dist-backend", "gloo"])
    np.testing.assert_array_equal(tp["tokens"], one["tokens"])


def test_train_launcher_takes_a_pod_axis(capfd):
    out = launch_train.main(["--arch", "vusa_edge", "--smoke", "--device", "cpu", "--pod", "2",
                             "--dist-backend", "gloo", "--steps", "2", "--batch", "4",
                             "--seq", "16"])
    assert np.isfinite(out["final_loss"])
    assert "final loss" in capfd.readouterr().out


@pytest.mark.parametrize("case", MODEL_ONLY, ids=lambda c: "-".join(map(str, c)))
def test_tp_step_makes_two_collectives_a_layer(case, world_2x2, world_1x4):
    """On ``model`` alone a decode step makes two ordered sums a layer
    (``wo``, and ``w_down`` or the packed MLP's window partials) plus the
    embedding's sum and the logits' gather, on either route: a packed
    attention runs on the rank's own heads (``split_heads``), gathering
    neither q/k/v nor the heads."""
    layers = get_smoke_config(case[0]).n_layers
    for rank in _world(case, world_2x2, world_1x4):
        assert rank["gen"][case]["collectives"] == 2 * layers + 2


@pytest.mark.parametrize("value_dtype", ["dense", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_split_heads_packs_are_the_whole_packs_heads(trees, tp, value_dtype):
    """``pack_lm_weights(split_heads=True)``: each rank's q/k/v columns are
    bitwise the whole pack's columns of its heads (the same windows, cut
    after the kernel), and the ranks' ``wo`` partials on their heads add
    up to the whole pack's product within rounding."""
    from repro_torch.kernels.ops import apply_row_packed
    from repro_torch.serve.packed import _as_linear, pack_lm_weights

    cfg = get_smoke_config("vusa_edge")
    params = _params(trees)["vusa_edge"]
    whole = pack_lm_weights(cfg, params, value_dtype=value_dtype)["attn"]
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(3, cfg.d_model))).float()
    heads = torch.from_numpy(np.random.default_rng(5).normal(
        size=(3, cfg.n_heads * cfg.hd))).float()
    width = cfg.n_heads * cfg.hd // tp
    wo = torch.zeros(3, cfg.d_model)
    for r in range(tp):
        own = pack_lm_weights(cfg, params, value_dtype=value_dtype, shards=tp, rank=r,
                              split_heads=True)["attn"]
        for name in ("wq", "wk", "wv"):
            off, w = own[name]["cols"]
            assert w == width
            got = apply_row_packed(x, _as_linear(own[name], 0))[:, off:off + w]
            want = apply_row_packed(x, _as_linear(whole[name], 0))[:, r * w:(r + 1) * w]
            assert torch.equal(got, want), name
        assert own["wo"]["partial"] and own["wo"]["k"] == width
        wo += apply_row_packed(heads[:, r * width:(r + 1) * width], _as_linear(own["wo"], 0))
    want = apply_row_packed(heads, _as_linear(whole["wo"], 0))
    torch.testing.assert_close(wo, want, rtol=0, atol=1e-5 * float(want.abs().max()))
