"""Port vs reference: the moe family (``olmoe_1b_7b``, ``moonshot_v1_16b_a3b``).

Smoke configs (64-wide, 8 experts, top-2, the smoke ``moe_cf`` 4.0 =
dropless); parameters from ``repro`` with the norm scales drawn from a seed
(``torch_family_pairs``), both sides with ``attn_bf16_probs`` off.
``layers.moe`` matches the reference's (the default route, sort-based
positions, one dump slot) within 1e-5 of the largest magnitude at a
dropping and a dropless capacity factor and on a router whose scores tie
exactly (the lower expert index wins, as ``jax.lax.top_k`` orders ties).
The model's forward, aux loss, ``lm_loss`` and its gradients, prefill,
decode and chunked prefill match too; decode reproduces the teacher-forced
logits within 2e-4 (the reference's own check).  Batched admission and the
paged pool are offered only when dropless, and the scheduler's completions
equal one-shot ``generate`` at B = 1 on both pools, bitwise: the pool step
routes each slot alone, as the reference's pool step (a B = 1 step mapped
over the slots) does.  Pruning, tree checkpoints and a train step cover
the expert leaves.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.core.pruning import prune_tree as ref_prune
from repro.models import families as ref_families
from repro.models import layers as ref_layers
from repro_torch.checkpoint import restore, save
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.pruning import prune_tree
from repro_torch.models import build_model, families, layers
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_items
from repro_torch.serve import Engine, Request, Scheduler, ServeConfig
from repro_torch.train import TrainHParams, make_train_step
from torch_family_pairs import Pair, close, fp32_attention_probs, np_  # noqa: F401

pytestmark = pytest.mark.usefixtures("fp32_attention_probs")

ARCHS = ["olmoe_1b_7b", "moonshot_v1_16b_a3b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return Pair(request.param)


def _ffn0(pair):
    """Layer 0's expert leaves on both sides."""
    ref = {k: v[0] for k, v in pair.params["layers"]["ffn"].items()}
    return ref, {k: v[0] for k, v in pair.tparams["layers"]["ffn"].items()}


def _x(pair, b=2, s=8, seed=0):
    return np.random.default_rng(seed).standard_normal((b, s, pair.cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("cf", [0.5, None])  # 0.5 drops; None = the smoke 4.0, dropless
def test_moe_unit_matches_reference(pair, cf):
    ref_p, p = _ffn0(pair)
    x = _x(pair)
    want, want_aux = ref_layers.moe(ref_p, jnp.asarray(x), pair.ref_cfg, capacity_factor=cf)
    got, aux = layers.moe(p, torch.from_numpy(x), pair.cfg, capacity_factor=cf)
    close(got, want)
    close(aux, want_aux)
    if cf is not None:  # tokens were dropped: the dropless result differs
        full, _ = layers.moe(p, torch.from_numpy(x), pair.cfg)
        assert float((full - got).abs().max()) > 1e-3


@pytest.mark.parametrize("how", ["zero_router", "twin_columns"])
def test_moe_ties_break_to_the_lower_expert(pair, how):
    """A zero router makes every expert's score equal (top-2 = experts 0
    and 1 for every token, most assignments dropped); twin router columns
    make pairs of experts tie exactly.  Both sides pick the same experts."""
    ref_p, p = _ffn0(pair)
    router = np.asarray(ref_p["router"]).copy()
    if how == "zero_router":
        router[:] = 0
    else:
        router[:, 1::2] = router[:, 0::2]
    ref_p = {**ref_p, "router": jnp.asarray(router)}
    p = {**p, "router": torch.from_numpy(router)}
    x = _x(pair, seed=1)
    probs = torch.softmax(torch.from_numpy(x).reshape(-1, pair.cfg.d_model) @ p["router"], -1)
    _, eids = layers._top_k(probs, pair.cfg.top_k)
    if how == "zero_router":
        assert (eids == torch.arange(pair.cfg.top_k)).all()
    else:
        assert (eids[:, 0] % 2 == 0).all() and (eids[:, 1] == eids[:, 0] + 1).all()
    want, want_aux = ref_layers.moe(ref_p, jnp.asarray(x), pair.ref_cfg, capacity_factor=1.0)
    got, aux = layers.moe(p, torch.from_numpy(x), pair.cfg, capacity_factor=1.0)
    close(got, want)
    close(aux, want_aux)


def test_forward_aux_and_loss_with_grads(pair):
    tokens = np.random.default_rng(0).integers(0, pair.cfg.vocab, (2, 12)).astype(np.int32)
    want, want_aux = pair.ref_model.forward(pair.params, {"tokens": jnp.asarray(tokens)})
    got, aux = pair.model(pair.tparams, {"tokens": torch.from_numpy(tokens).long()})
    close(got, want)
    close(aux, want_aux)
    assert float(aux) > 0
    want_loss, want_g = jax.value_and_grad(pair.ref_model.loss)(
        pair.params, {"tokens": jnp.asarray(tokens)})
    live = params_from_numpy(pair.tree, "cpu")
    for _, leaf in tree_items(live):
        leaf.requires_grad_(True)
    loss = pair.model.loss(live, {"tokens": torch.from_numpy(tokens).long()})
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    loss.backward()
    flat = jax.tree_util.tree_flatten_with_path(want_g)[0]
    for path, w in flat:
        node = live
        for key in path:
            node = node[key.key]
        close(node.grad, w, "/".join(k.key for k in path))


def test_decode_matches_teacher_forcing_and_reference(pair):
    """Stepwise decode reproduces the forward's logits (2e-4, as
    ``tests/test_models.py``) and the reference's decode (1e-5)."""
    b, s = 2, 12
    tokens = np.random.default_rng(2).integers(0, pair.cfg.vocab, (b, s)).astype(np.int32)
    tf, _ = pair.model(pair.tparams, {"tokens": torch.from_numpy(tokens).long()})
    cache = pair.model.init_cache(b, s + 4, device="cpu")
    ref_cache = pair.ref_model.init_cache(b, s + 4)
    step = jax.jit(pair.ref_model.decode_step)
    outs = []
    for t in range(s):
        lg, cache = pair.model.decode_step(pair.tparams, torch.from_numpy(tokens[:, t : t + 1]).long(),
                                           cache)
        want, ref_cache = step(pair.params, jnp.asarray(tokens[:, t : t + 1]), ref_cache)
        close(lg, want, f"step {t}")
        outs.append(lg[:, 0])
    close(torch.stack(outs, 1), np_(tf), tol=2e-4)


@pytest.mark.parametrize("use_lengths", [False, True])
def test_prefill_matches_reference(pair, use_lengths):
    tokens = np.random.default_rng(3).integers(0, pair.cfg.vocab, (3, 10)).astype(np.int32)
    lengths = np.array([10, 6, 3], np.int32) if use_lengths else None
    want, ref_cache = pair.ref_model.prefill(
        pair.params, {"tokens": jnp.asarray(tokens)}, 16,
        lengths=None if lengths is None else jnp.asarray(lengths))
    got, cache = pair.model.prefill(
        pair.tparams, {"tokens": torch.from_numpy(tokens).long()}, 16,
        lengths=None if lengths is None else torch.from_numpy(lengths).long())
    close(got, want)
    close(cache["k"], ref_cache["k"])


def test_prefill_chunk_matches_reference(pair):
    """Two chunks of a 20-token prompt through the paged arena (pages of 8,
    the second chunk padded): the final chunk's logits and the arena rows."""
    page, n_pages, c = 8, 4, 16
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, pair.cfg.vocab, 20).astype(np.int32)
    table = np.array([3, 0, 5, 2], np.int32)
    kv = (pair.cfg.n_layers, 7, page, pair.cfg.kv_heads, pair.cfg.hd)
    arena = {n: torch.zeros(kv) for n in ("k", "v")}
    ref_arena = {n: jnp.zeros(kv) for n in ("k", "v")}
    for start in (0, c):
        chunk = np.zeros((1, c), np.int32)
        true_len = min(c, 20 - start)
        chunk[0, :true_len] = prompt[start : start + true_len]
        want, ref_arena = ref_families.lm_prefill_chunk(
            pair.params, jnp.asarray(chunk), pair.ref_cfg, ref_arena, jnp.asarray(table),
            jnp.int32(start), jnp.int32(true_len), jnp.int32(0))
        got, arena = pair.model.prefill_chunk(
            pair.tparams, torch.from_numpy(chunk).long(), arena,
            torch.from_numpy(table).long(), start, true_len, 0)
    close(got, want)
    for n in ("k", "v"):
        close(arena[n], ref_arena[n], n)


def test_batched_prefill_and_paging_only_when_dropless(pair):
    assert pair.cfg.moe_cf >= pair.cfg.n_experts / pair.cfg.top_k
    eng = Engine(pair.cfg, pair.tparams, ServeConfig(max_len=32), device="cpu")
    assert eng.batched_prefill and eng.paged_supported
    droppy = dataclasses.replace(pair.cfg, moe_cf=1.25)
    eng = Engine(droppy, pair.tparams, ServeConfig(max_len=32, page_size=8), device="cpu")
    assert not eng.batched_prefill and not eng.paged_supported
    with pytest.raises(NotImplementedError, match="dropless"):
        eng.prime_many(np.ones((2, 8), np.int32), np.array([4, 8]))
    assert not Scheduler(eng, slots=2).paged  # falls back to the slot pool
    with pytest.raises(ValueError, match="dense family"):
        Engine(pair.cfg, pair.tparams, ServeConfig(max_len=32, speculative=True), device="cpu")
    with pytest.raises(ValueError, match="dense family"):
        Engine(pair.cfg, pair.tparams, ServeConfig(max_len=32, packed_weights="all"),
               device="cpu")


def _requests(cfg, n=4):
    rng = np.random.default_rng(6)
    return [Request(prompt=rng.integers(1, cfg.vocab, int(rng.integers(3, 12))).astype(np.int32),
                    max_new=int(rng.integers(4, 8)), seed=r) for r in range(n)]


@pytest.fixture(scope="module")
def olmoe():
    return Pair("olmoe_1b_7b")


@pytest.mark.parametrize("pool,cf", [("slot", None), ("paged", None), ("slot", 1.25)])
def test_scheduler_completions_equal_one_shot_generate(olmoe, pool, cf):
    """Sequential admission, greedy: every completion equals ``generate`` of
    its prompt at B = 1, bitwise, dropless on both pools, and at the
    published (dropping) capacity factor on the slot pool, since the pool
    step routes each slot alone.  olmoe only: moonshot's smoke config has
    the same shapes, so its run would repeat this one."""
    pair = olmoe
    cfg = pair.cfg if cf is None else dataclasses.replace(pair.cfg, moe_cf=cf)
    sc = ServeConfig(max_len=32, page_size=8 if pool == "paged" else 0)
    eng = Engine(cfg, pair.tparams, sc, device="cpu")
    sched = Scheduler(eng, slots=3, segment=4, admission="sequential")
    assert sched.paged == (pool == "paged")
    reqs = _requests(cfg)
    for r in reqs:
        sched.submit(r)
    done = sched.run()
    for rid, r in enumerate(reqs):
        want = eng.generate(r.prompt[None], max_new=r.max_new)["tokens"][0]
        np.testing.assert_array_equal(done[rid].tokens, want)


def test_pruning_checkpoint_and_train_step_cover_the_experts(pair, tmp_path):
    """``prune_tree`` skips the router and the embedding and prunes the 3-D
    expert leaves as the reference does; a tree checkpoint of the moe
    params written by the port restores in the reference bitwise; a train
    step moves every expert leaf."""
    got = params_to_numpy(prune_tree(pair.tparams, 0.85))
    want = jax.tree_util.tree_map(np.asarray, ref_prune(pair.params, 0.85))
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, w)
    ffn = got["layers"]["ffn"]
    assert (ffn["router"] != 0).all() and (got["embed"] != 0).all()
    assert 0.84 < float((ffn["w_gate"] == 0).mean()) < 0.86
    save(tmp_path, 1, {"params": pair.tparams})
    back = ref_ckpt.restore(tmp_path, 1, {"params": pair.params})
    for path, w in jax.tree_util.tree_flatten_with_path(back["params"])[0]:
        node = pair.tree
        for key in path:
            node = node[key.key]
        assert np.asarray(w).tobytes() == node.tobytes()
    again = restore(tmp_path, 1, {"params": params_from_numpy(pair.tree, "cpu")})
    assert torch.equal(again["params"]["layers"]["ffn"]["w_up"],
                       pair.tparams["layers"]["ffn"]["w_up"])

    params = params_from_numpy(pair.tree, "cpu")
    step = make_train_step(build_model(pair.cfg).loss, TrainHParams(lr=1e-2, warmup=1))
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(7).integers(0, 256, (2, 16)).astype(np.int32))}
    before = {k: v.clone() for k, v in params["layers"]["ffn"].items()}
    _, _, metrics = step(params, adamw_init(params), batch)
    assert np.isfinite(float(metrics["loss"]))
    for k, v in params["layers"]["ffn"].items():
        assert not torch.equal(v, before[k]), k


def test_rowwise_moe_routes_each_row_alone(pair):
    """The pool step's MoE (``rowwise``) is, row by row, the B = 1 call: at
    a dropping capacity factor the batched call couples the rows, the
    row-wise one does not."""
    _, p = _ffn0(pair)
    cfg = dataclasses.replace(pair.cfg, moe_cf=0.5)
    x = torch.from_numpy(_x(pair, b=4, s=1, seed=8))
    rows, _ = families._ffn(p, x, cfg, rowwise=True)
    for b in range(4):
        assert torch.equal(rows[b : b + 1], layers.moe(p, x[b : b + 1], cfg)[0])
    assert not torch.equal(rows, layers.moe(p, x, cfg)[0])
