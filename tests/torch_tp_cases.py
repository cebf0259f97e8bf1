"""Shared cases of the tensor-parallel family tests on gloo ranks
(``test_torch_tp_vlm.py``, ``test_torch_tp_recurrent.py``).

Each case runs on a mesh (a rank of a spawned world) or on one device
(``mesh`` None) and returns what the test process compares: ``serve``
(``generate``'s tokens, the first decode step's logits, the collectives a
decode step made beside ``TPPlan.decode_collectives``, the bytes a rank
stores beside ``placement_bytes``), ``train`` (one Trainer step's loss,
gradient shards with their ranges in the whole leaf, collectives beside
``TPPlan.train_collectives``), ``ulp_floor`` (how far one device's
gradients move when the parameters move an ulp, ``test_torch_ep.py``'s
rule), the ``gather_tree`` refusal and the trained shards served.  The
module imports no JAX: the spawned ranks import it.
"""

import dataclasses
import hashlib
import math

import numpy as np
import torch

from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.dist import comm, sharding
from repro_torch.dist.sharding import shard_ranges, shard_tree
from repro_torch.dist.tp import placement_bytes
from repro_torch.models import build_model, layers
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_items
from repro_torch.serve import Engine, ServeConfig
from repro_torch.train import TrainConfig, Trainer, TrainHParams
from repro_torch.train.step import _tree as nest

BATCH, PROMPT, NEW, SEQ, LR, MAX_LEN = 4, 8, 5, 16, 1e-3, 24
LOGIT_TOL, LOSS_TOL, GRAD_TOL, REPRO_GRAD_TOL = 1e-5, 1e-6, 1e-5, 5e-3


def tree_of(cfg) -> dict:
    """The port's seeded init of ``cfg`` with the zeros and ones leaves
    redrawn (``torch_family_pairs.perturb``), as numpy."""
    from torch_family_pairs import perturb

    return perturb(params_to_numpy(build_model(cfg).init(0, device="cpu")))


def prompts(cfg):
    return np.random.default_rng(5).integers(0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)


def extras(cfg):
    """The vlm family's seeded stand-in patches, (B, P, d), the encdec
    family's stand-in frames, (B, enc_frames, d); None for the others."""
    rng = np.random.default_rng(7)
    if cfg.family == "vlm":
        return {"patches": rng.normal(0, 0.02, (BATCH, cfg.patch_tokens, cfg.d_model)).astype(
            np.float32)}
    if cfg.family == "encdec":
        return {"frames": rng.normal(0, 0.02, (BATCH, cfg.enc_frames, cfg.d_model)).astype(
            np.float32)}
    return None


def batches(cfg, n):
    data = iter(SyntheticDataset(cfg, BATCH, SEQ, seed=0, token_range=64))
    return [{k: torch.from_numpy(v) for k, v in next(data).items()} for _ in range(n)]


PAD_VOCAB = 500  # vusa_edge's smoke config at this vocab pads to 512: 12 padding ids


def padding_first_config():
    """``vusa_edge``'s smoke config with ``PAD_VOCAB`` ids, padded to 512."""
    from repro_torch.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config("vusa_edge"), vocab=PAD_VOCAB)


def padding_first_tree() -> dict:
    """The port's seeded init of ``padding_first_config`` (numpy) whose
    padding columns are the largest logits of every position (ROADMAP
    C17): the head's padding columns set to +-c along the first six
    coordinates of d_model, c 1e4 x the largest real column's norm, so
    one of them is ``c max_k |h_k|`` for every final-normed ``h``, far
    above every real logit and any Gumbel noise."""
    cfg = padding_first_config()
    params = build_model(cfg).init(0, device="cpu")
    w = params["lm_head"]
    c = 1e4 * float(w[:, :cfg.vocab].norm(dim=0).max())
    w[:, cfg.vocab:] = 0.0
    for j in range(cfg.padded_vocab - cfg.vocab):
        w[j // 2, cfg.vocab + j] = c if j % 2 == 0 else -c
    return params_to_numpy(params)


def fp32_probs():
    layers.FLAGS["attn_bf16_probs"] = False


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def engine(cfg, tree, mesh):
    return Engine(cfg, params_from_numpy(tree, "cpu"), ServeConfig(max_len=MAX_LEN),
                  device="cpu", mesh=mesh)


def serve(cfg, tree, mesh):
    """``generate`` on ``mesh`` (None: one device): its tokens, the first
    decode step's whole logits and their digest, the collectives a decode
    step made and the plan's prediction, the bytes this rank stores and
    what its placement says, the plan's splits, and the sequence-sharded
    attention's calls (the vlm prefill's)."""
    eng = engine(cfg, tree, mesh)
    seen, choose, box, segment = [], eng._choose, {}, eng.decode_segment

    def keep(logits, *a):
        seen.append(logits.numpy().copy())
        return choose(logits, *a)

    def counted(*a, **kw):
        comm.reset_stats()
        out = segment(*a, **kw)
        box["collectives"] = comm.STATS["collectives"]
        return out

    eng._choose, eng.decode_segment = keep, counted
    calls = layers._maybe_seq_sharded_attention.calls
    tokens = eng.generate(prompts(cfg), max_new=NEW, extras=extras(cfg))["tokens"]
    out = {"tokens": tokens, "first": seen[0], "digest": digest(tokens, seen[0]),
           "collectives": box["collectives"] / (NEW - 1), "bytes": eng.dense_param_bytes,
           "seq_shard_calls": layers._maybe_seq_sharded_attention.calls - calls}
    plan = eng.plan
    if plan is not None:
        out.update(predicted=plan.decode_collectives(cfg, eng._rows(BATCH) is not None),
                   bytes_want=placement_bytes(build_model(cfg).specs(), plan.placements, mesh),
                   plan=(plan.ssm, plan.rglru, plan.heads, plan.ff, plan.vocab))
    return out


def train_config(steps):
    return TrainConfig(steps=steps, global_batch=BATCH, seq_len=SEQ, token_range=64,
                       prune_begin=steps + 1, log_every=1,
                       hp=TrainHParams(lr=LR, warmup=1, total_steps=steps))


def shards_of(tree, placements, mesh) -> dict:
    """Each leaf of ``tree`` (this rank's shards under ``placements``) as
    ``(ranges, values)``: its ``shard_ranges`` in the whole leaf (None on
    one device)."""
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


def rows_of(tr, batch):
    return batch if tr.rows is None else {k: v[tr.rows] for k, v in batch.items()}


def train(cfg, tree, mesh):
    """One step of the Trainer's step on ``mesh`` (None: one device) from
    this rank's shards of ``tree``: the loss, gradient shards, collectives,
    the plan's prediction and the sequence-sharded attention's calls."""
    tr = Trainer(cfg, train_config(1), device="cpu", mesh=mesh)
    params = params_from_numpy(tree, "cpu")
    if mesh is not None:
        params = shard_tree(params, tr.p_shard, mesh)
    calls = layers._maybe_seq_sharded_attention.calls
    comm.reset_stats()
    params, _, got = tr.step_fn(params, adamw_init(params), rows_of(tr, batches(cfg, 1)[0]),
                                return_grads=True)
    grads = nest([p for p, _ in tree_items(params)], got["grads"])
    return {"loss": float(got["loss"]), "grads": shards_of(grads, tr.p_shard, mesh),
            "collectives": comm.STATS["collectives"],
            "seq_shard_calls": layers._maybe_seq_sharded_attention.calls - calls,
            "predicted": None if tr.plan is None else tr.plan.train_collectives(
                cfg, SEQ, split=tr.rows is not None)}


def ulp_floor(cfg, tree, draws: int = 2) -> float:
    """How far one device's step's gradients move (of each leaf's largest)
    when every parameter moves by about an ulp (a relative 2^-23 x
    normal(0, 1), ``draws`` fixed seeds): the conditioning any reordered
    sum meets, as ``test_torch_ep.py`` measures it."""
    base = train(cfg, tree, None)["grads"]
    worst = 0.0
    for seed in range(draws):
        gen = torch.Generator().manual_seed(seed)
        items = list(tree_items(params_from_numpy(tree, "cpu")))
        moved = nest([p for p, _ in items], [
            (t * (1 + 2.0**-23 * torch.randn(t.shape, generator=gen))).numpy()
            for _, t in items])
        got = train(cfg, moved, None)["grads"]
        worst = max(worst, *(np.abs(got[k][1] - w).max() / np.abs(w).max()
                             for k, (_, w) in base.items()))
    return worst


def no_gather(cfg, tree, mesh) -> bool:
    """``generate``, one training step and one mask refresh with
    ``gather_tree`` replaced by a stand-in that raises: True when none
    called it."""
    calls = []

    def refuse(*a, **kw):
        calls.append(1)
        raise AssertionError("gather_tree on a tensor-parallel path")

    real = sharding.gather_tree
    sharding.gather_tree = refuse
    try:
        engine(cfg, tree, mesh).generate(prompts(cfg), max_new=3, extras=extras(cfg))
        tr = Trainer(cfg, train_config(1), device="cpu", mesh=mesh)
        shards = shard_tree(params_from_numpy(tree, "cpu"), tr.p_shard, mesh)
        tr.step_fn(shards, adamw_init(shards), rows_of(tr, batches(cfg, 1)[0]))
        tr.refresh_masks(shards, 0.5)
    finally:
        sharding.gather_tree = real
    return not calls


def train_then_serve(cfg, mesh) -> dict:
    """The Trainer on ``mesh`` with pruning, its shards served through
    ``Engine(mesh=)`` beside one device's engine on the gathered tree."""
    tc = dataclasses.replace(train_config(4), prune_begin=1, prune_end=3, prune_every=2)
    out = Trainer(cfg, tc, device="cpu", mesh=mesh).train()
    sc = ServeConfig(max_len=MAX_LEN)
    got = Engine(cfg, out["shards"], sc, device="cpu", mesh=mesh).generate(
        prompts(cfg), NEW, extras=extras(cfg))
    whole = nest(*zip(*tree_items(out["params"])))  # the trainer's view, leaf by leaf
    want = Engine(cfg, whole, sc, device="cpu").generate(prompts(cfg), NEW, extras=extras(cfg))
    return {"got": got["tokens"], "want": want["tokens"], "sparsity": out["sparsity"]}


# -- the test process's gates ---------------------------------------------------------


def close(got, want, what="", tol=LOGIT_TOL):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1.0), (what, err)


def cut(whole, ranges):
    return whole if ranges is None else whole[tuple(slice(s, s + n) for s, n in ranges)]


def shard_gaps(got: dict, want: dict) -> dict:
    """Each leaf's largest gap of this rank's shard from one device's same
    slice, of the largest |value| of one device's whole leaf."""
    return {k: float(np.abs(v - cut(want[k][1], r)).max()) / max(
        float(np.abs(want[k][1]).max()), 1e-30) for k, (r, v) in got.items()}


def serve_gates(recs: list, want: dict) -> None:
    """Every rank's ``serve`` record: tokens and first-step logits as one
    device's, rank 0's bits, its storage its placement's, its collectives
    as predicted."""
    for got in recs:
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        close(got["first"], want["first"], "first-step logits")
        assert got["digest"] == recs[0]["digest"]
        assert got["bytes"] == got["bytes_want"]
        assert got["collectives"] == got["predicted"], (got["collectives"], got["predicted"])


def train_gates(got: dict, want: dict, floor: float) -> None:
    """A ``train`` record against one device's: the loss within 1e-6
    relative, each gradient shard within the larger of 1e-5 and the
    one-ulp ``floor``, the collectives as predicted."""
    assert abs(got["loss"] / want["loss"] - 1) <= LOSS_TOL, (got["loss"], want["loss"])
    gaps = shard_gaps(got["grads"], want["grads"])
    assert max(gaps.values()) <= max(GRAD_TOL, floor), (gaps, floor)
    assert got["collectives"] == got["predicted"], (got["collectives"], got["predicted"])


def repro_gates(got: dict, want: dict) -> None:
    """A ``train`` record against ``repro``'s loss (1e-5 relative) and
    gradients (5e-3 of the leaf's largest), as ``test_torch_tp_train.py``
    holds its steps against ``repro``."""
    assert abs(got["loss"] / want["loss"] - 1) <= 1e-5, (got["loss"], want["loss"])
    gaps = shard_gaps(got["grads"], {k: (None, v) for k, v in want["grads"].items()})
    assert max(gaps.values()) <= REPRO_GRAD_TOL, gaps


def repro_step(ref_cfg, tree, batch: dict) -> dict:
    """``repro``'s loss and gradients of ``batch`` (numpy) on ``tree``,
    ``attn_bf16_probs`` off (imports JAX: the test process only)."""
    import jax
    import jax.numpy as jnp

    from repro.models import build_model as ref_build
    from repro.models.opt_flags import FLAGS as REF_FLAGS

    prev = REF_FLAGS["attn_bf16_probs"]
    REF_FLAGS["attn_bf16_probs"] = False
    try:
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a, copy=True)), tree)
        loss, grads = jax.jit(jax.value_and_grad(ref_build(ref_cfg).loss))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    finally:
        REF_FLAGS["attn_bf16_probs"] = prev
    return {"loss": float(loss), "grads": {"/".join(k.key for k in path): np.asarray(w)
                                           for path, w in
                                           jax.tree_util.tree_flatten_with_path(grads)[0]}}


def spawn_worlds(worlds: dict, trees, tmp_path_factory, one_device):
    """Spawn each of ``worlds`` ({name: (rank fn, data, model)}) at once on
    gloo ranks while this process runs ``one_device()``: (each world's
    results, one device's)."""
    import threading

    from repro_torch.launch.mesh import spawn

    box = {}
    dirs = {name: str(tmp_path_factory.mktemp(f"tp{name}")) for name in worlds}

    def run(name, fn, data, model):
        try:
            box[name] = spawn(fn, data, model, "gloo", "cpu", dirs[name], args=(trees,),
                              timeout_s=300)
        except BaseException as e:  # re-raised in the test process's thread
            box[name] = e

    threads = [threading.Thread(target=run, args=(name, *args)) for name, args in worlds.items()]
    # the ranks and this process share the cores: a rank takes one intra-op
    # thread, this process two (``test_torch_ep.py``'s reason)
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    for t in threads:
        t.start()
    try:
        one = one_device()
    finally:
        for t in threads:
            t.join()
        torch.set_num_threads(saved)
    for v in box.values():
        if isinstance(v, BaseException):
            raise v
    return box, one
