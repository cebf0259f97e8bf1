"""Port: bucketed admission — masked prefill against exact-length prefill,
``Engine.prime_many``, the prompt-length buckets and the slot-pool writes.

The reference asserts masked prefill bitwise equal to unpadded prefill
(``tests/test_admission.py::test_masked_prefill_bitexact``).  In the port it
is not: a GEMM over the padded batch's rows sums in another order than one
over the prompt's own rows (ROADMAP C9).  ``test_masked_prefill_gap`` holds
the gap to 1e-5 of the largest |logit| (and of the largest K/V value) and
reports whether the rows happen to be bitwise equal.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.core.pruning import prune_tree as ref_prune
from repro.models import build_model as ref_build
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model
from repro_torch.models.cache import batch_axes, read_slot, reset_slot, write_slots
from repro_torch.serve import Engine, Request, Scheduler, ServeConfig

GAP_TOL = 1e-5  # of the largest |logit| or K/V value (ROADMAP C9)


@pytest.fixture(scope="module")
def tparams():
    cfg = ref_smoke("vusa_edge")
    params = ref_prune(ref_build(cfg).init(jax.random.key(0)), 0.85)
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")


def _gap(a, b) -> float:
    b = b.float()
    return float((a.float() - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["vusa_edge", "llama3_2_1b"])
def test_masked_prefill_gap(arch, dtype, tparams, record_property):
    """The reference test's shapes: lengths 3, 5 and 7 right-padded to 8,
    ``max_len`` 32.  Each row's logits and real K/V rows against a B = 1
    prefill at the exact length."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    model = build_model(cfg)
    params = tparams if arch == "vusa_edge" else model.init(0, device="cpu")
    rng = np.random.default_rng(0)
    lens = [3, 5, 7]
    prompts = [rng.integers(0, 100, n) for n in lens]
    padded = np.zeros((len(lens), 8), np.int64)
    for i, p in enumerate(prompts):
        padded[i, : len(p)] = p
    with torch.no_grad():
        logits_b, cache_b = model.prefill(params, {"tokens": torch.from_numpy(padded)}, 32,
                                          lengths=torch.tensor(lens))
        bitwise, worst = True, 0.0
        for i, p in enumerate(prompts):
            logits_1, cache_1 = model.prefill(params, {"tokens": torch.from_numpy(p[None])}, 32)
            pairs = [(logits_b[i], logits_1[0])] + [
                (cache_b[k][:, i, : lens[i]], cache_1[k][:, 0, : lens[i]]) for k in ("k", "v")]
            for got, want in pairs:
                worst = max(worst, _gap(got, want))
                bitwise &= torch.equal(got, want)
    record_property("bitwise", bitwise)
    record_property("gap_of_largest", worst)
    print(f"masked prefill {arch} {dtype}: bitwise {bitwise}, gap {worst:.3g} of the largest")
    assert worst <= GAP_TOL, worst


def test_prime_many_matches_prime(tparams):
    """``Engine.prime_many`` emits each row's ``prime`` first token, and its
    logits are within 1e-5 of the largest (C9)."""
    eng = Engine(get_smoke_config("vusa_edge"), tparams, ServeConfig(max_len=64), device="cpu")
    rng = np.random.default_rng(1)
    lens = [4, 6, 6, 5]
    prompts = [rng.integers(1, 500, n).astype(np.int32) for n in lens]
    bucket = eng.bucket_len(max(lens))
    assert bucket == 8
    padded = np.zeros((len(lens), bucket), np.int32)
    for i, p in enumerate(prompts):
        padded[i, : len(p)] = p
    nxt, cache = eng.prime_many(padded, np.asarray(lens))
    assert cache["pos"].tolist() == [bucket] * len(lens)
    with torch.no_grad():
        many, _ = eng.model.prefill(eng.params, {"tokens": torch.from_numpy(padded).long()}, 64,
                                    lengths=torch.tensor(lens))
        for i, p in enumerate(prompts):
            one, _ = eng.prime(p[None])
            assert torch.equal(nxt[i], one[0]), f"row {i}"
            want, _ = eng.model.prefill(eng.params, {"tokens": torch.from_numpy(p[None]).long()},
                                        64)
            assert _gap(many[i], want[0]) <= GAP_TOL
    with pytest.raises(ValueError, match="vocab"):
        eng.prime_many(np.array([[1, 600]], np.int32), np.array([2]))
    with pytest.raises(ValueError, match="max_len"):
        eng.prime_many(np.ones((1, 65), np.int32), np.array([65]))


def test_buckets_always_cover_max_len(tparams):
    cfg = get_smoke_config("vusa_edge")
    eng = Engine(cfg, tparams, ServeConfig(max_len=64, prefill_buckets=(8, 16)), device="cpu")
    assert eng.prefill_buckets == (8, 16, 64)
    assert eng.bucket_len(17) == 64 and eng.bucket_len(3) == 8
    assert Engine(cfg, tparams, ServeConfig(max_len=100), device="cpu").prefill_buckets == (
        8, 16, 32, 64, 100)
    with pytest.raises(ValueError, match="prefill_buckets"):
        Engine(cfg, tparams, ServeConfig(max_len=64, prefill_buckets=(8, 128)), device="cpu")
    assert eng.batched_prefill and eng.paged_supported


def test_write_slots_scatter_roundtrip():
    """One ``write_slots`` of a batched (B = 3) cache lands each row in its
    slot with its own ``pos`` and drops the out-of-range (padding) row;
    ``read_slot`` gives the row back and ``reset_slot`` returns a slot to
    the init state, neighbours untouched."""
    model = build_model(get_smoke_config("vusa_edge"))
    max_len, slots = 32, 4
    axes = model.cache_batch_axes(max_len)
    assert axes == batch_axes(model.cache_specs(1, max_len), model.cache_specs(3, max_len))
    assert axes == {"k": 1, "v": 1, "pos": 0}
    subs = [{k: torch.full_like(v, val) for k, v in model.init_cache(1, max_len, "cpu").items()}
            for val in (1, 2, 3)]
    batched = {k: torch.cat([s[k] for s in subs], dim=axes[k]) for k in subs[0]}
    pool = model.init_slot_cache(slots, max_len, device="cpu")
    write_slots(pool, [2, 0, slots], batched, axes, [5, 7, 9])
    for slot_i, (row, want_pos) in {2: (0, 5), 0: (1, 7)}.items():
        got = read_slot(pool, slot_i, axes)
        for k in ("k", "v"):
            assert torch.equal(got[k], subs[row][k])
        assert got["pos"].tolist() == [want_pos]
    empty = model.init_cache(1, max_len, "cpu")
    for untouched in (1, 3):
        got = read_slot(pool, untouched, axes)
        assert all(torch.equal(got[k], empty[k]) for k in got)
    model.reset_slot(pool, 2, max_len)  # the model's facade over the same helpers
    assert all(torch.equal(model.read_slot(pool, 2, max_len)[k], empty[k]) for k in empty)
    assert torch.equal(read_slot(pool, 0, axes)["k"], subs[1]["k"])
    reset_slot(pool, 0, axes)
    assert all(torch.equal(read_slot(pool, 0, axes)[k], empty[k]) for k in empty)


@pytest.mark.parametrize("admission", ["batched", "sequential"])
def test_ragged_traffic_parity(tparams, admission):
    """Mixed prompt lengths, out-of-order arrivals and EOS-heavy retirement:
    every completion equals one-shot generate at B = 1 (bitwise under
    sequential admission; batched greedy tokens on this config)."""
    cfg = get_smoke_config("vusa_edge")
    ref = Engine(cfg, tparams, ServeConfig(max_len=64), device="cpu")

    def one_shot(p, seed):
        ref.sc.seed = seed
        return ref.generate(p[None], max_new=8)["tokens"][0]

    rng = np.random.default_rng(7)
    lens = [3, 9, 5, 12, 4, 7, 6, 10]
    prompts = [rng.integers(0, 500, n).astype(np.int32) for n in lens]
    arrivals = [0.02, 0.0, 0.01, 0.0, 0.03, 0.0, 0.02, 0.01]
    reqs = []
    for i, p in enumerate(prompts):
        eos = int(one_shot(p, i)[2]) if i % 2 == 0 else None
        reqs.append(Request(prompt=p, max_new=8, eos_id=eos, seed=i, arrival_s=arrivals[i]))
    done = Scheduler(Engine(cfg, tparams, ServeConfig(max_len=64), device="cpu"), slots=3,
                     segment=4, admission=admission).run(reqs)
    assert sorted(done) == list(range(len(reqs)))
    for rid, c in done.items():
        one = one_shot(prompts[rid], rid)
        if reqs[rid].eos_id is not None:
            one = one[: int(np.argmax(one == reqs[rid].eos_id)) + 1]
        np.testing.assert_array_equal(c.tokens, one, err_msg=f"rid {rid}")
