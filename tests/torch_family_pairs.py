"""Shared setup of the port-vs-reference family tests
(``test_torch_families.py``, ``test_torch_moe.py``, ``test_torch_vlm.py``,
``test_torch_hybrid.py``, ``test_torch_ssm.py``, ``test_torch_encdec.py``).

A pair is one smoke config's parameters from ``repro``'s
``build_model(cfg).init(key(0))`` with every leaf the init sets to zeros or
ones (biases, qk-norm and norm scales, the SSM's ``A_log``/``D``/``dt_bias``
and conv bias, the RG-LRU's gate biases and ``lam``) and the encoder's
positions overwritten by seeded numpy values (a constant init would hide a
missing or misplaced bias, gate or norm), held as numpy and crossed to the
reference (``jnp``) and to the port (``params_from_numpy``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import build_model as ref_build
from repro.models.opt_flags import FLAGS as REF_FLAGS
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers

# leaves the init sets to zero: the norms' (1 + scale) gains, the QKV biases,
# the SSM's and RG-LRU's biases; and the encoder's position table
PERTURBED = ("bq", "bk", "bv", "q_norm", "k_norm", "norm1", "norm2", "final_norm",
             "norm", "norm_x", "enc_norm", "conv_b", "dt_bias", "b_a", "b_i", "enc_pos")
# leaves the init sets to one: drawn around one
PERTURBED_ONES = ("A_log", "D", "lam")


def perturb(tree: dict, seed: int = 0) -> dict:
    """A copy of the numpy tree with every ``PERTURBED`` leaf drawn from
    normal(0, 0.5) and every ``PERTURBED_ONES`` leaf from normal(1, 0.5),
    leaf by leaf in sorted key order."""
    rng = np.random.default_rng(seed)

    def walk(t):
        out = {}
        for k in sorted(t):
            v = t[k]
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in PERTURBED or k in PERTURBED_ONES:
                out[k] = rng.normal(k in PERTURBED_ONES, 0.5, v.shape).astype(np.float32)
            else:
                out[k] = np.array(v, copy=True)
        return out

    return walk(tree)


class Pair:
    """One arch on both sides: ``ref_cfg``/``cfg``, the numpy tree ``tree``,
    the reference's ``params`` and the port's ``tparams``, and models."""

    def __init__(self, arch: str, seed: int = 0, **overrides):
        self.arch = arch
        self.ref_cfg = dataclasses.replace(ref_smoke(arch), **overrides)
        self.cfg = dataclasses.replace(get_smoke_config(arch), **overrides)
        raw = jax.tree_util.tree_map(np.asarray, ref_build(self.ref_cfg).init(jax.random.key(seed)))
        self.tree = perturb(raw, seed)
        self.params = jax.tree_util.tree_map(lambda a: jnp.asarray(a.copy()), self.tree)
        self.tparams = params_from_numpy(self.tree, "cpu")
        self.ref_model = ref_build(self.ref_cfg)
        from repro_torch.models import build_model

        self.model = build_model(self.cfg)


def np_(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def close(got, want, what="", tol=1e-5):
    """max |got - want| <= tol * max(|want|, 1)."""
    got, want = np_(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max()) if got.size else 0.0
    assert err <= tol * max(float(np.abs(want).max()) if want.size else 0.0, 1.0), (what, err)


@pytest.fixture
def fp32_attention_probs():
    """Pin ``attn_bf16_probs`` off on both sides, as the reference's model
    tests do, so prefill (flash) and decode (direct) run one fp32 pipeline."""
    prev = REF_FLAGS["attn_bf16_probs"], layers.FLAGS["attn_bf16_probs"]
    REF_FLAGS["attn_bf16_probs"] = layers.FLAGS["attn_bf16_probs"] = False
    yield
    REF_FLAGS["attn_bf16_probs"], layers.FLAGS["attn_bf16_probs"] = prev


def ref_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def port_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype.kind in "iu" else torch.from_numpy(v)
            for k, v in batch.items()}


def ref_leaf(tree, name: str):
    """The reference tree's leaf at the port's flat ``/``-joined name."""
    for key in name.split("/"):
        tree = tree[key]
    return tree


def check_loss_and_grads(pair: Pair, batch: dict, tol: float = 1e-5,
                         grad_tol: float = 0.0) -> None:
    """``Model.loss`` within ``tol`` and every leaf's gradient against
    ``jax.grad`` of the reference's loss within ``grad_tol`` (default
    ``tol``) of the largest reference value; no gradient is NaN."""
    want_loss, want_g = jax.value_and_grad(pair.ref_model.loss)(pair.params, ref_batch(batch))
    live = params_from_numpy(pair.tree, "cpu")
    from repro_torch.optim.adamw import tree_items

    for _, leaf in tree_items(live):
        leaf.requires_grad_(True)
    loss = pair.model.loss(live, port_batch(batch))
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=tol)
    loss.backward()
    for path, w in jax.tree_util.tree_flatten_with_path(want_g)[0]:
        name = "/".join(k.key for k in path)
        got = ref_leaf(live, name).grad
        assert torch.isfinite(got).all(), name
        close(got, w, name, grad_tol or tol)


def check_cache(cache: dict, ref_cache, tol: float = 1e-5) -> None:
    """Every leaf of the port's flat cache against the reference's nested
    one (``pos``: each row's against the reference's scalar)."""
    for name, leaf in cache.items():
        want = np.asarray(ref_leaf(ref_cache, name))
        if name == "pos":
            assert (np_(leaf) == want).all(), (np_(leaf), want)
        else:
            close(leaf, want, name, tol)


def decode_both(pair: Pair, tokens: np.ndarray, cache: dict, ref_cache, tol: float = 1e-5):
    """Step both packages through ``tokens`` (B, S) one token at a time,
    each step's logits within ``tol``; returns the port's (B, S, V) logits
    and both caches."""
    step = jax.jit(pair.ref_model.decode_step)
    outs = []
    for t in range(tokens.shape[1]):
        want, ref_cache = step(pair.params, jnp.asarray(tokens[:, t : t + 1]), ref_cache)
        got, cache = pair.model.decode_step(pair.tparams,
                                            torch.from_numpy(tokens[:, t : t + 1]).long(), cache)
        close(got, want, f"step {t}", tol)
        outs.append(got[:, 0])
    return torch.stack(outs, 1), cache, ref_cache


def scheduler_requests(cfg, n: int = 5, seed: int = 6) -> list:
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(1, cfg.vocab, int(rng.integers(3, 12))).astype(np.int32),
                    max_new=int(rng.integers(4, 9)), seed=r) for r in range(n)]


def one_shot(eng, req) -> np.ndarray:
    """``generate`` of the request's prompt at B = 1 with its seed."""
    eng.sc.seed = req.seed
    return eng.generate(req.prompt[None], max_new=req.max_new)["tokens"][0]


# ---- the recurrent families on the scheduler (hybrid, ssm) -------------------


def _engine(pair: Pair, **kw):
    from repro_torch.serve import Engine, ServeConfig

    return Engine(pair.cfg, pair.tparams, ServeConfig(max_len=48, **kw), device="cpu")


def check_scheduler_bitwise(pair: Pair, temperature: float, admission: str,
                            page_size: int = 0) -> None:
    """Every completion bitwise one-shot ``generate`` at B = 1 with the
    request's seed; batched admission primes each request alone and a page
    size is ignored (no masked prefill, no KV to page)."""
    from repro_torch.serve import Scheduler

    eng = _engine(pair, temperature=temperature, page_size=page_size)
    assert not eng.batched_prefill and not eng.paged_supported
    sched = Scheduler(eng, slots=3, segment=4, admission=admission)
    assert not sched.paged
    reqs = scheduler_requests(pair.cfg)
    done = sched.run(reqs)
    for rid, r in enumerate(reqs):
        np.testing.assert_array_equal(done[rid].tokens, one_shot(eng, r), err_msg=f"rid {rid}")


def check_reference_scheduler(pair: Pair) -> None:
    """Greedy completions equal the reference scheduler's."""
    from repro.serve import Engine as RefEngine
    from repro.serve import Request as RefRequest
    from repro.serve import Scheduler as RefScheduler
    from repro.serve import ServeConfig as RefServeConfig
    from repro_torch.serve import Scheduler

    reqs = scheduler_requests(pair.cfg)
    done = Scheduler(_engine(pair), slots=3, segment=4).run(reqs)
    ref = RefScheduler(RefEngine(pair.ref_cfg, pair.params, RefServeConfig(max_len=48)),
                       slots=3, segment=4)
    want = ref.run([RefRequest(prompt=r.prompt, max_new=r.max_new, seed=r.seed) for r in reqs])
    for rid in range(len(reqs)):
        np.testing.assert_array_equal(done[rid].tokens, want[rid].tokens, err_msg=f"rid {rid}")


def check_slot_roundtrip(pair: Pair) -> None:
    """``write_slots`` / ``read_slot`` round-trip one slot's whole state
    without touching its neighbours; ``reset_slot`` returns it to zeros."""
    from repro_torch.models.cache import batch_axes, read_slot, reset_slot, write_slots

    model = pair.model
    pool = model.init_slot_cache(3, 32, device="cpu")
    axes = model.cache_batch_axes(32)
    assert axes == batch_axes(model.cache_specs(1, 32), model.cache_specs(2, 32))
    for name, ax in axes.items():  # the batch axis: 0 for pos and tail leaves, else 1
        assert ax == (0 if name == "pos" or name.startswith("tail/") else 1), (name, ax)
    sub = {k: torch.full_like(v, 1 + i) for i, (k, v) in enumerate(
        model.init_cache(1, 32, device="cpu").items())}
    write_slots(pool, [1], sub, axes, [5])
    got = read_slot(pool, 1, axes)
    for name, leaf in sub.items():
        want = torch.tensor([5]) if name == "pos" else leaf
        assert torch.equal(got[name], want), name
    for other in (0, 2):
        assert all(not v.any() for v in read_slot(pool, other, axes).values())
    reset_slot(pool, 1, axes)
    assert all(not v.any() for v in pool.values())


def check_pool_rows(pair: Pair, dtype: str = "float32") -> None:
    """The pool step (``rowwise``) on three slots primed at ragged lengths:
    row b's logits and cache row bitwise a B = 1 step on its own cache.  In
    bf16 the pool step casts the weights once for all rows, the B = 1 step
    its own."""
    from repro_torch.models.cache import read_slot, write_slots
    from repro_torch.serve import Engine, ServeConfig

    eng = Engine(dataclasses.replace(pair.cfg, dtype=dtype), pair.tparams,
                 ServeConfig(max_len=48), device="cpu")
    rng = np.random.default_rng(3)
    primed = [eng.prime(rng.integers(1, pair.cfg.vocab, (1, n)).astype(np.int32))
              for n in (3, 7, 5)]
    axes = eng.model.cache_batch_axes(48)
    pool = eng.model.init_slot_cache(3, 48, device="cpu")
    for i, (_, c) in enumerate(primed):
        write_slots(pool, [i], c, axes, [int(c["pos"][0])])
    token = torch.cat([t for t, _ in primed])
    with torch.no_grad():
        rows = eng._logits(token, pool, None, rowwise=True)
        for i, (_, c) in enumerate(primed):
            assert torch.equal(rows[i : i + 1], eng._logits(token[i : i + 1], c, None))
            for name, leaf in read_slot(pool, i, axes).items():
                assert torch.equal(leaf, c[name]), (i, name)


def check_prime_many_refused(pair: Pair) -> None:
    eng = _engine(pair)
    with pytest.raises(NotImplementedError, match="batched masked prefill"):
        eng.prime_many(np.ones((2, 8), np.int32), np.array([4, 8]))
    with pytest.raises(NotImplementedError, match="no prefill"):
        pair.model.prefill(pair.tparams, {"tokens": torch.ones((1, 4), dtype=torch.long)}, 16)
    assert pair.model.paged_seq_len(48) is None


def check_generate_matches_reference(pair: Pair, prompt_len: int, max_new: int,
                                     max_len: int) -> None:
    """Greedy ``generate`` at B = 2 equals the reference's tokens, also when
    prompt + max_new runs past ``max_len`` (no bound for a recurrent state;
    the hybrid's ring wraps)."""
    from repro.serve import Engine as RefEngine
    from repro.serve import ServeConfig as RefServeConfig
    from repro_torch.serve import Engine, ServeConfig

    prompts = np.random.default_rng(4).integers(1, pair.cfg.vocab, (2, prompt_len)).astype(
        np.int32)
    want = RefEngine(pair.ref_cfg, pair.params, RefServeConfig(max_len=max_len)).generate(
        prompts, max_new=max_new)["tokens"]
    got = Engine(pair.cfg, pair.tparams, ServeConfig(max_len=max_len), device="cpu").generate(
        prompts, max_new=max_new)
    assert got["finite"]
    np.testing.assert_array_equal(got["tokens"], np.asarray(want))


def check_graph_decode_in_chunks(pair: Pair, temperature: float) -> None:
    """Two ``generate`` calls whose decode runs past ``max_len`` replay one
    step graph in chunks of ``max_len`` steps, and their tokens equal the
    eager loop's bitwise, sampled too (each chunk takes its rows of the
    noise table).  The graph is stood in for by a replay of its body, so
    the chunking runs on the CPU."""
    from types import SimpleNamespace

    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.serve.engine import _Graph

    prompts = np.random.default_rng(5).integers(1, pair.cfg.vocab, (2, 6)).astype(np.int32)
    sc = ServeConfig(max_len=8, temperature=temperature)
    eager = Engine(pair.cfg, pair.tparams, sc, device="cpu")
    graphed = Engine(pair.cfg, pair.tparams, sc, device="cpu")
    graphed._graphed = lambda: True
    graphed._capture = lambda body, st: _Graph(SimpleNamespace(replay=lambda: body(st)), st, {})
    for max_new in (13, 21):
        want = eager.generate(prompts, max_new=max_new)["tokens"]
        got = graphed.generate(prompts, max_new=max_new)
        assert got["finite"]
        np.testing.assert_array_equal(got["tokens"], want, err_msg=f"max_new {max_new}")
    assert [k[0] for k in graphed._graphs].count("step") == 1
